"""The port's ``encode_for_decode`` (waveform -> enhancer -> fbank ->
VGG2L -> BLSTMP -> CTC logits and encoder projection) against the JAX
package, on the XLA scan path and the Pallas BLSTM kernel (interpret)."""

import dataclasses

import pytest

pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from robust_e2e_gan_tpu import config as jax_config  # noqa: E402
from robust_e2e_gan_tpu.data.synthetic import SyntheticConfig, make_batch  # noqa: E402
from robust_e2e_gan_tpu.models.encoder import VGG2L as JaxVGG2L  # noqa: E402
from robust_e2e_gan_tpu.pipeline import RobustE2E as JaxRobustE2E  # noqa: E402
from robust_e2e_gan_torch.configs import tiny_config  # noqa: E402
from robust_e2e_gan_torch.convert import from_flax, init_params  # noqa: E402
from robust_e2e_gan_torch.models.encoder import VGG2L  # noqa: E402
from robust_e2e_gan_torch.pipeline import build_model  # noqa: E402

# float32 through conv, two BLSTM stacks and three projections: a few ulps
# of the O(1) activations, compounded over the depth
RTOL, ATOL = 1e-4, 1e-5


def _jax(cfg):
    """The JAX package's config of the same class name and field values."""
    return jax_config.from_dict(getattr(jax_config, type(cfg).__name__),
                                dataclasses.asdict(cfg))


def _with_lstm_impl(jcfg, impl):
    return dataclasses.replace(
        jcfg,
        e2e=dataclasses.replace(jcfg.e2e, encoder=dataclasses.replace(
            jcfg.e2e.encoder, lstm_impl=impl)),
        enhancer=dataclasses.replace(jcfg.enhancer, lstm_impl=impl),
    )


def test_vgg2l_flatten_layout_matches_jax():
    rng = np.random.default_rng(0)
    params = init_params(tiny_config(), 0)["asr"]["encoder"]["vgg"]
    x = rng.standard_normal((2, 9, 24)).astype(np.float32)  # odd T: ceil pool
    want = JaxVGG2L((4, 8)).apply({"params": params}, jnp.asarray(x))
    vgg = VGG2L((4, 8), torch.float32)
    vgg.load_state_dict(from_flax(params))
    got = vgg(torch.from_numpy(x))
    assert got.shape == want.shape == (2, 3, 6 * 8)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)


@pytest.mark.parametrize("use_enhancer", [True, False],
                         ids=["enhancer", "no_enhancer"])
def test_encode_for_decode_matches_jax(use_enhancer):
    jcfg = tiny_config()
    params = init_params(jcfg, 1)
    batch = make_batch(3, SyntheticConfig(vocab_size=12, min_tokens=2,
                                          max_tokens=4),
                       np.random.default_rng(2))
    wav, lens = batch["noisy_wav"], batch["wav_lengths"]

    model = build_model(_with_lstm_impl(jcfg, "auto"))
    model.load_state_dict(from_flax(params))
    with torch.inference_mode():
        got = model.encode_for_decode(torch.from_numpy(wav),
                                      torch.from_numpy(lens), use_enhancer)
    names = ("hs", "hmask", "hlens", "ctc_logits", "enc_proj")
    for impl in ("scan", "tiled"):  # XLA scan; Pallas kernel, interpreted
        want = JaxRobustE2E(_jax(_with_lstm_impl(jcfg, impl))).apply(
            {"params": params}, jnp.asarray(wav), jnp.asarray(lens),
            use_enhancer, method=JaxRobustE2E.encode_for_decode)
        for name, g, w in zip(names, got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=RTOL,
                                       atol=ATOL, err_msg=f"{name} ({impl})")
