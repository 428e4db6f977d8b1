"""The port's whole serving slice — ``make_beam_searcher(...,
use_enhancer=True)`` from waveform to hypotheses — against the JAX
package's searcher on the CPU, float32."""

import dataclasses

import pytest

pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from robust_e2e_gan_tpu import config as jax_config  # noqa: E402
from robust_e2e_gan_tpu.data.synthetic import SyntheticConfig, make_batch  # noqa: E402
from robust_e2e_gan_tpu.decode.beam import (  # noqa: E402
    make_beam_searcher as jax_make_beam_searcher,
)
from robust_e2e_gan_tpu.pipeline import RobustE2E as JaxRobustE2E  # noqa: E402
from robust_e2e_gan_torch.config import BeamSearchConfig  # noqa: E402
from robust_e2e_gan_torch.configs import tiny_config  # noqa: E402
from robust_e2e_gan_torch.convert import from_flax, init_params  # noqa: E402
from robust_e2e_gan_torch.decode.beam import make_beam_searcher  # noqa: E402
from robust_e2e_gan_torch.pipeline import build_model  # noqa: E402

SEARCHES = {
    # the serving configuration's form: all steps, no host sync
    "fixed_steps": BeamSearchConfig(beam_size=3, ctc_weight=0.3, max_steps=8,
                                    early_exit=False),
    # early exit, end detection and per-utterance length bounds
    "early_exit_end_detect": BeamSearchConfig(
        beam_size=3, ctc_weight=0.5, max_steps=8, early_exit=True,
        end_detect=True, end_detect_window=2, maxlen_ratio=0.4,
        minlen_ratio=0.05, length_normalize=True),
}


def _jax(cfg):
    """The JAX package's config of the same class name and field values."""
    return jax_config.from_dict(getattr(jax_config, type(cfg).__name__),
                                dataclasses.asdict(cfg))


@pytest.mark.parametrize("name", list(SEARCHES), ids=list(SEARCHES))
def test_beam_search_slice_matches_jax(name):
    bcfg = SEARCHES[name]
    jcfg = tiny_config()
    params = init_params(jcfg, 7)
    batch = make_batch(3, SyntheticConfig(vocab_size=12, min_tokens=2,
                                          max_tokens=4),
                       np.random.default_rng(3))
    wav, lens = batch["noisy_wav"], batch["wav_lengths"]
    want = jax_make_beam_searcher(JaxRobustE2E(_jax(jcfg)), _jax(jcfg.e2e),
                                  _jax(bcfg), use_enhancer=True)(
        params, jnp.asarray(wav), jnp.asarray(lens))

    # the kernel impls on CPU tensors run the plain versions
    auto = dataclasses.replace(
        jcfg,
        e2e=dataclasses.replace(jcfg.e2e, encoder=dataclasses.replace(
            jcfg.e2e.encoder, lstm_impl="auto")),
        enhancer=dataclasses.replace(jcfg.enhancer, lstm_impl="auto"))
    model = build_model(auto)
    model.load_state_dict(from_flax(params))
    got = make_beam_searcher(model, auto.e2e, bcfg, use_enhancer=True)(
        torch.from_numpy(wav), torch.from_numpy(lens))

    # token-exact: the same search over values that agree to float32 ulps
    np.testing.assert_array_equal(got.beam_tokens.numpy(),
                                  np.asarray(want.beam_tokens))
    np.testing.assert_array_equal(got.beam_lengths.numpy(),
                                  np.asarray(want.beam_lengths))
    np.testing.assert_array_equal(got.tokens.numpy(), np.asarray(want.tokens))
    # best scores sum ~10 log-probs of O(1-10): 1e-3 relative
    np.testing.assert_allclose(got.scores.numpy(), np.asarray(want.scores),
                               rtol=1e-3)
    assert np.isfinite(got.scores.numpy()).all()
