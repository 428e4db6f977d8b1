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


def test_clean_speech_lm_fusion_slice_matches_jax():
    """The clean-speech serving path: ``FrontendConfig(fused=True)``, no
    enhancer, RNNLM shallow fusion. The JAX side runs its fused frontend in
    interpret mode; the port's kernel impls run their plain versions."""
    from robust_e2e_gan_tpu.models import lm as jax_lm
    from robust_e2e_gan_torch.config import LMConfig
    from robust_e2e_gan_torch.convert import init_lm_params
    from robust_e2e_gan_torch.models.lm import RNNLM
    from robust_e2e_gan_torch.ops.fbank_fused import fbank_fused_plain
    from robust_e2e_gan_torch.ops.lm_step import lm_step_plain

    base = tiny_config()
    jcfg = dataclasses.replace(base, e2e=dataclasses.replace(
        base.e2e,
        frontend=dataclasses.replace(base.e2e.frontend, fused=True),
        encoder=dataclasses.replace(base.e2e.encoder, lstm_impl="auto")))
    lmcfg = LMConfig(vocab_size=12, embed_dim=16, hidden_dim=24)
    bcfg = BeamSearchConfig(beam_size=3, ctc_weight=0.3, max_steps=8,
                            early_exit=False, lm_weight=0.4)
    params = init_params(jcfg, 7)
    lm_params = init_lm_params(lmcfg, seed=2)
    batch = make_batch(3, SyntheticConfig(vocab_size=12, min_tokens=2,
                                          max_tokens=4),
                       np.random.default_rng(4))
    wav, lens = batch["clean_wav"], batch["wav_lengths"]
    want = jax_make_beam_searcher(
        JaxRobustE2E(_jax(jcfg)), _jax(jcfg.e2e), _jax(bcfg),
        use_enhancer=False,
        lm=jax_lm.RNNLM(jax_lm.LMConfig(**dataclasses.asdict(lmcfg))),
        lm_params=lm_params)(
        params, jnp.asarray(wav), jnp.asarray(lens))

    model = build_model(jcfg)
    model.load_state_dict(from_flax(params))
    lm = RNNLM(lmcfg)
    lm.load_state_dict(from_flax(lm_params))
    calls = (fbank_fused_plain.calls, lm_step_plain.calls)
    got = make_beam_searcher(model, jcfg.e2e, bcfg, use_enhancer=False,
                             lm=lm)(torch.from_numpy(wav),
                                    torch.from_numpy(lens))
    # one fused frontend call, one LM step per beam step
    assert (fbank_fused_plain.calls - calls[0],
            lm_step_plain.calls - calls[1]) == (1, bcfg.max_steps)
    np.testing.assert_array_equal(got.beam_tokens.numpy(),
                                  np.asarray(want.beam_tokens))
    np.testing.assert_array_equal(got.tokens.numpy(), np.asarray(want.tokens))
    np.testing.assert_allclose(got.beam_scores.numpy(),
                               np.asarray(want.beam_scores), rtol=1e-4)


def test_per_utterance_prefix_search_matches_jax():
    """``prefix_impl="pallas"``: the per-utterance psi and the state of the
    chosen extensions, against the JAX searcher with the same config (its
    Pallas kernel in interpret mode)."""
    from robust_e2e_gan_torch.ops import ctc_prefix

    bcfg = BeamSearchConfig(beam_size=3, ctc_weight=0.5, max_steps=8,
                            early_exit=False, prefix_impl="pallas")
    jcfg = tiny_config()
    params = init_params(jcfg, 5)
    batch = make_batch(3, SyntheticConfig(vocab_size=12, min_tokens=2,
                                          max_tokens=4),
                       np.random.default_rng(6))
    wav, lens = batch["noisy_wav"], batch["wav_lengths"]
    want = jax_make_beam_searcher(JaxRobustE2E(_jax(jcfg)), _jax(jcfg.e2e),
                                  _jax(bcfg), use_enhancer=True)(
        params, jnp.asarray(wav), jnp.asarray(lens))
    model = build_model(jcfg)
    model.load_state_dict(from_flax(params))
    calls = (ctc_prefix.prefix_psi_recursion_plain.calls,
             ctc_prefix.prefix_state_plain.calls)
    got = make_beam_searcher(model, jcfg.e2e, bcfg, use_enhancer=True)(
        torch.from_numpy(wav), torch.from_numpy(lens))
    # psi and the chosen extensions' state once per step
    assert (ctc_prefix.prefix_psi_recursion_plain.calls - calls[0],
            ctc_prefix.prefix_state_plain.calls - calls[1]) == (8, 8)
    np.testing.assert_array_equal(got.beam_tokens.numpy(),
                                  np.asarray(want.beam_tokens))
    np.testing.assert_array_equal(got.tokens.numpy(), np.asarray(want.tokens))
    np.testing.assert_allclose(got.beam_scores.numpy(),
                               np.asarray(want.beam_scores), rtol=1e-4,
                               atol=1e-3)


def test_pipelined_searcher_matches_sequential():
    """``make_pipelined_beam_searcher`` (batch i+1's encode issued before
    batch i's beam loop; on the CPU the same calls in the same order, no
    streams) yields the sequential searcher's results, in order: one batch
    (stage and flush only), three batches, a mid-stream shape change
    (flush and stage anew) and an empty stream (JAX
    ``tests/test_beam.py:670-721``). Its tokens are the JAX staged
    searcher's on the same batches."""
    from robust_e2e_gan_tpu.decode.beam import (
        make_pipelined_beam_searcher as jax_make_pipelined,
    )
    from robust_e2e_gan_torch.decode.beam import make_pipelined_beam_searcher

    jcfg = tiny_config()
    params = init_params(jcfg, 7)
    model = build_model(jcfg)
    model.load_state_dict(from_flax(params))
    bcfg = BeamSearchConfig(beam_size=3, ctc_weight=0.3, max_steps=8)
    scfg = SyntheticConfig(vocab_size=12, min_tokens=2, max_tokens=4)
    rng = np.random.default_rng(11)
    batches = []
    for _ in range(3):
        b = make_batch(2, scfg, rng)
        batches.append((b["noisy_wav"], b["wav_lengths"]))
    b_long = make_batch(2, scfg, rng,
                        pad_to_samples=2 * batches[0][0].shape[1])
    mixed = batches[:2] + [(b_long["noisy_wav"], b_long["wav_lengths"])]
    seq = make_beam_searcher(model, jcfg.e2e, bcfg, use_enhancer=True)
    pipe = make_pipelined_beam_searcher(model, jcfg.e2e, bcfg,
                                        use_enhancer=True)
    for stream in (batches[:1], batches, mixed):
        want = [seq(torch.from_numpy(w), torch.from_numpy(n))
                for w, n in stream]
        got = list(pipe(iter(stream)))
        assert len(got) == len(want)
        for g, w in zip(got, want):
            for name in w._fields:  # the same calls: bit for bit
                assert torch.equal(getattr(g, name), getattr(w, name)), name
    assert list(pipe(iter([]))) == []

    # the JAX staged program once (stage, staged step, flush): compiles
    # are the cost here
    jax_pipe = jax_make_pipelined(JaxRobustE2E(_jax(jcfg)), _jax(jcfg.e2e),
                                  _jax(bcfg), use_enhancer=True)
    want = list(jax_pipe(params, [(jnp.asarray(w), jnp.asarray(n))
                                  for w, n in batches[:2]]))
    assert len(want) == 2
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.tokens.numpy(), np.asarray(w.tokens))
        np.testing.assert_allclose(g.scores.numpy(), np.asarray(w.scores),
                                   rtol=1e-3)
