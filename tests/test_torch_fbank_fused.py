"""The port's fused log-mel frontend (``ops/fbank_fused.py``) against the
JAX package's fused kernel (``ops/fbank_pallas.py``, interpret mode on the
CPU) and against its split chain, float32: features, masks, the
degenerate lengths, and the waveform gradient of the trainable form."""

import dataclasses

import pytest

pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from robust_e2e_gan_tpu import config as jax_config  # noqa: E402
from robust_e2e_gan_tpu.ops import fbank as jfb  # noqa: E402
from robust_e2e_gan_tpu.ops import fbank_pallas as jfp  # noqa: E402
from robust_e2e_gan_torch.config import FrontendConfig  # noqa: E402
from robust_e2e_gan_torch.ops import fbank_fused as tff  # noqa: E402

CFG = FrontendConfig(n_mels=40)
JCFG = jax_config.FrontendConfig(**dataclasses.asdict(CFG))
# the same folded bases and the same float32 products in another summation
# order: features of O(1) after CMVN agree to a few 1e-6; 1e-4 leaves room
# for frames whose mel energy sits near the log floor
ATOL = 1e-4
# the split chain folds DC removal, pre-emphasis and the window in another
# order (the JAX package's own fused-vs-split tolerance)
SPLIT_RTOL, SPLIT_ATOL = 1e-3, 2e-3

CASES = {  # B, N, wav_lengths, norm_var
    "full": (2, 16000, None, True),
    "ragged": (3, 12000, [12000, 7000, 4800], True),
    "one_frame": (1, 400, None, True),
    "no_var_norm": (2, 8000, None, False),
}


def _signal(b, n, seed=0):
    rng = np.random.default_rng(seed)
    t = np.arange(n) / CFG.sample_rate
    x = np.stack([np.sin(2 * np.pi * (200 + 40 * i) * t)
                  + 0.3 * rng.standard_normal(n) for i in range(b)])
    return x.astype(np.float32)


def _lengths(lens):
    if lens is None:
        return None, None
    return jnp.asarray(lens, jnp.int32), torch.tensor(lens, dtype=torch.int32)


@pytest.mark.parametrize("name", list(CASES))
def test_fbank_fused_matches_jax(name):
    b, n, lens, norm_var = CASES[name]
    wav = _signal(b, n)
    jl, tl = _lengths(lens)
    want, want_mask = jfp.fbank_fused(jnp.asarray(wav), JCFG, wav_lengths=jl,
                                      norm_var=norm_var)
    got, mask = tff.fbank_fused_plain(torch.from_numpy(wav), CFG,
                                      wav_lengths=tl, norm_var=norm_var)
    np.testing.assert_array_equal(mask.numpy(), np.asarray(want_mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=ATOL)
    assert np.all(got.numpy()[mask.numpy() == 0.0] == 0.0)  # exact zeros

    # the wrapper on CPU tensors is the plain version
    with torch.no_grad():
        wrapped, _ = tff.fbank_fused(torch.from_numpy(wav), CFG,
                                     wav_lengths=tl, norm_var=norm_var)
    torch.testing.assert_close(wrapped, got, rtol=0, atol=0)

    # and the split chain, at the JAX package's fused-vs-split tolerance
    jwav = jnp.asarray(wav)
    if norm_var:
        ref, _ = jfb.fbank(jwav, JCFG, wav_lengths=jl, cmvn="utterance")
    else:
        ref = jfb.utterance_cmvn(jfb.log_mel(jfb.stft_power(jwav, JCFG), JCFG),
                                 None, norm_var=False)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=SPLIT_RTOL,
                               atol=SPLIT_ATOL)


def test_fbank_fused_zero_frames():
    wav = torch.zeros((2, 300))  # shorter than one frame
    for fn in (tff.fbank_fused, tff.fbank_fused_plain,
               tff.fbank_fused_trainable):
        feats, mask = fn(wav, CFG)
        assert feats.shape == (2, 0, CFG.n_mels) and mask.shape == (2, 0)


def test_fbank_fused_refuses_what_jax_refuses():
    odd = dataclasses.replace(CFG, frame_length=397)
    wav = torch.zeros((1, 4000))
    for fn in (tff.fbank_fused, tff.fbank_fused_plain,
               tff.fbank_fused_trainable):
        with pytest.raises(ValueError, match="multiple of 8"):
            fn(wav, odd)
    with pytest.raises(ValueError, match="multiple of 8"):
        jfp.fbank_fused(jnp.zeros((1, 4000)),
                        dataclasses.replace(JCFG, frame_length=397))
    magnitude = dataclasses.replace(CFG, use_power=False)
    with pytest.raises(NotImplementedError):
        tff.fbank_fused_trainable(wav, magnitude)
    with pytest.raises(NotImplementedError):
        jfp.fbank_fused_trainable(jnp.zeros((1, 4000)),
                                  dataclasses.replace(JCFG, use_power=False))


@pytest.mark.parametrize("bwd", [tff.fbank_fused_bwd,
                                 tff.fbank_fused_bwd_plain],
                         ids=["wrapper", "plain"])
def test_fbank_fused_bwd_refuses_magnitude_spectra(bwd):
    """Both backward entry points implement the power spectrum only, as the
    trainable form says, rather than return a wrong gradient."""
    magnitude = dataclasses.replace(CFG, use_power=False)
    wav = torch.zeros((1, 4000))
    n_valid = tff.valid_frames(wav, magnitude, None)
    g = torch.zeros((1, int(n_valid[0]), CFG.n_mels))
    with pytest.raises(NotImplementedError, match="power spectrum"):
        bwd(wav, n_valid, g, magnitude)


@pytest.mark.parametrize("norm_var", [True, False], ids=["cmvn", "mean_only"])
def test_fbank_fused_trainable_gradient_matches_jax(norm_var):
    """d(sum(feats * w)) / d wav through the backward's plain version
    against the JAX custom-VJP backward kernel; ragged lengths."""
    b, n = 3, 9600
    lens = [9600, 6000, 4800]
    wav = _signal(b, n, seed=1)
    w = np.random.default_rng(2).standard_normal(
        (1, 58, CFG.n_mels)).astype(np.float32)
    jl, tl = _lengths(lens)

    def loss_jax(x):
        feats, _ = jfp.fbank_fused_trainable(x, JCFG, wav_lengths=jl,
                                             norm_var=norm_var)
        return jnp.sum(feats * w[:, :feats.shape[1]])

    v_want, g_want = jax.value_and_grad(loss_jax)(jnp.asarray(wav))
    x = torch.from_numpy(wav).requires_grad_()
    feats, mask = tff.fbank_fused_trainable(x, CFG, wav_lengths=tl,
                                            norm_var=norm_var)
    loss = (feats * torch.from_numpy(w)[:, :feats.shape[1]]).sum()
    loss.backward()
    g_got, g_want = x.grad.numpy(), np.asarray(g_want)
    np.testing.assert_allclose(float(loss.detach()), float(v_want), rtol=1e-4)
    # normalised by the largest gradient, as the JAX package's own test
    scale = np.abs(g_want).max()
    np.testing.assert_allclose(g_got / scale, g_want / scale, rtol=1e-4,
                               atol=1e-4)
    for i, length in enumerate(lens):  # nothing past each utterance's end
        assert np.all(g_got[i, length:] == 0.0)
