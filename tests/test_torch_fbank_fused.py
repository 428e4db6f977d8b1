"""The port's fused log-mel frontend (``ops/fbank_fused.py``) against the
JAX package's fused kernel (``ops/fbank_pallas.py``, interpret mode on the
CPU) and against its split chain, float32: features, masks, the
degenerate lengths, and the waveform gradient of the trainable form. Then
the forward's "tc" route on the CPU: its plan (integer arithmetic), the
bases in the order its lanes read them, the skewed span, its numerics
(3xTF32 products emulated by bit masking, the banded mel) against the JAX
kernel, and the banded mel against the dense product."""

import dataclasses
import os
import re

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


# ---------------------------------------------------------------------------
# route "tc" of csrc/fbank.cu on the CPU
# ---------------------------------------------------------------------------

H100_SMS, H100_SMEM = 132, 232_448
FLAGSHIP = FrontendConfig()
# decode (B=128, 111,360 samples) and train (B=32, 46,080) shapes
DECODE, TRAIN = (128, 111_360), (32, 46_080)


def _kernel_constants():
    path = os.path.join(os.path.dirname(tff.__file__), "..", "csrc",
                        "fbank.cu")
    with open(path) as f:
        src = f.read()
    return {k: int(v) for k, v in
            re.findall(r"constexpr int (TC_\w+) = (\d+);", src)}


def test_tc_constants_match_the_kernel():
    got = _kernel_constants()
    assert got == {"TC_WARP_BINS": tff.TC_WARP_BINS,
                   "TC_MAX_WARPS": tff.TC_MAX_WARPS,
                   "TC_STAGES": tff.TC_STAGES, "TC_SKEW": tff.TC_SKEW,
                   "TC_PPAD": tff.TC_PPAD}
    assert tff.TC_STEP == 32 * 2 * (2 * tff.TC_WARP_BINS // 8) == 512


@pytest.mark.parametrize("n_mels", [80, 40])
@pytest.mark.parametrize("use_power", [True, False], ids=["power", "mag"])
@pytest.mark.parametrize("shape,tm,smem", [(DECODE, 64, 151_456),
                                           (TRAIN, 32, 109_472)],
                         ids=["decode", "train"])
def test_fbank_plan_fits_every_flagship_configuration(n_mels, use_power,
                                                      shape, tm, smem):
    """Decode and train shapes, 80 and 40 mels, power and magnitude: the
    band 1..255 padded to 256 bins (8 warps), 64-frame tiles at the
    decode's 11 x 128 blocks (a tie with 32 on waves x tm goes to the
    larger tile), 32 at train's (5 x 32 = 160 blocks take two waves of 64
    frames, 9 x 32 = 288 three of 32); one block an SM within the H100's
    opt-in shared memory."""
    cfg = dataclasses.replace(FLAGSHIP, n_mels=n_mels, use_power=use_power)
    plan = tff.fbank_plan(cfg, *shape, H100_SMS, H100_SMEM)
    # tm = 64 at L = 400, shift = 160: spans of 10,480 samples + 65 skews
    # (10,740 words, hi and lo), then 8 rings of 4 x 512 floats
    assert plan == tff.FbankPlan(tm, 256, smem, True)
    assert plan.smem == tff.tc_smem(tm, 400, 160, 256, n_mels) <= H100_SMEM


def test_fbank_plan_copy_mode():
    """16-byte copies of the waveform only where N % 4 == 0 and the base is
    16-byte aligned; 4-byte ones otherwise."""
    for n in (16_000, 16_001, 16_002, 16_003):
        for ptr in (0, 4, 8, 256):
            plan = tff.fbank_plan(FLAGSHIP, 4, n, H100_SMS, H100_SMEM, ptr)
            assert plan.copy16 == (n % 4 == 0 and ptr % 16 == 0)


@pytest.mark.parametrize("change", ["shift_164", "shift_4", "length_404",
                                    "n_fft_1024", "smem", "no_frame",
                                    "no_sms"])
def test_fbank_plan_refuses(change):
    """A shift or length off a multiple of 8, a band wider than 8 warps'
    256 bins, too little shared memory, no frame, no SM: route "simt"."""
    cfg, b, n, smem, sms = FLAGSHIP, 4, 16_000, H100_SMEM, H100_SMS
    if change == "shift_164":
        cfg = dataclasses.replace(cfg, frame_shift=164)
    elif change == "shift_4":
        cfg = dataclasses.replace(cfg, frame_shift=4)
    elif change == "length_404":
        cfg = dataclasses.replace(cfg, frame_length=404)
    elif change == "n_fft_1024":
        cfg = dataclasses.replace(cfg, n_fft=1024)  # band 1..511
    elif change == "smem":
        smem = tff.tc_smem(32, 400, 160, 256, 80) - 1
    elif change == "no_frame":
        n = 399
    else:
        sms = 0
    assert tff.fbank_plan(cfg, b, n, sms, smem) is None


def test_fbank_plan_pads_the_band_to_whole_warps():
    """A band of 129..255 (f_min 4,000 Hz) takes 127 bins -> 128, 4 warps,
    and a smaller block; the padding bins carry zero bases."""
    cfg = dataclasses.replace(FLAGSHIP, f_min=4000.0, n_mels=24)
    bands = tff.mel_bands(cfg)
    assert (bands.first, bands.n_bins) == (129, 127)
    plan = tff.fbank_plan(cfg, *DECODE, H100_SMS, H100_SMEM)
    assert plan.nbins == 128
    assert plan.smem == tff.tc_smem(plan.tm, 400, 160, 128, 24)
    m_cos, m_sin, _ = tff.combined_bases(cfg)
    bm = _kernel_view(tff.pack_bases(m_cos, m_sin, bands, 128), 400, 128)
    assert not bm[:, 2 * 127:].any()


def _kernel_view(packed, length, nbins):
    """The (L, 2 nbins) B operand as the kernel's lanes read it: at k8 step
    s, warp w, lane 4 g + t's piece q holds (b0, b1) of n8 tile 2q, then of
    2q + 1, where b0 is row 8 s + t and b1 row 8 s + t + 4 of column
    64 w + 8 nt + g."""
    warps = nbins // 32
    x = packed.reshape(length // 8, warps, 4, 32, 4)
    out = np.full((length, 2 * nbins), np.nan, np.float32)
    s, w = np.arange(length // 8), np.arange(warps)
    for lane in range(32):
        g, t = divmod(lane, 4)
        for q in range(4):
            for e, (nt, h) in enumerate(((2 * q, 0), (2 * q, 1),
                                         (2 * q + 1, 0), (2 * q + 1, 1))):
                out[np.ix_(8 * s + t + 4 * h, 64 * w + 8 * nt + g)] = \
                    x[:, :, q, lane, e]
    return out


def _interleaved(cfg, nbins):
    """Columns 2j, 2j + 1: M_cos and M_sin of bin first + j, zeros past the
    band: a C fragment's column pair (2t, 2t + 1) is one bin's (re, im)."""
    m_cos, m_sin, _ = tff.combined_bases(cfg)
    bands = tff.mel_bands(cfg)
    bm = np.zeros((cfg.frame_length, 2 * nbins), np.float32)
    cols = slice(bands.first, bands.first + bands.n_bins)
    bm[:, 0:2 * bands.n_bins:2] = m_cos[:, cols]
    bm[:, 1:2 * bands.n_bins:2] = m_sin[:, cols]
    return bm


def test_pack_bases_is_what_the_lanes_read():
    bands = tff.mel_bands(FLAGSHIP)
    m_cos, m_sin, _ = tff.combined_bases(FLAGSHIP)
    packed = tff.pack_bases(m_cos, m_sin, bands, 256)
    assert packed.shape == (400 * 512,)
    np.testing.assert_array_equal(_kernel_view(packed, 400, 256),
                                  _interleaved(FLAGSHIP, 256))


@pytest.mark.parametrize("shift", [160, 80, 8])
def test_span_skew_spreads_the_ldmatrix_rows(shift):
    """Sample p of the span at p + 4 (p // shift): frame r's sample k sits
    at r (shift + 4) + k + 4 (k // shift), four samples of a row are
    contiguous, and the 8 rows of every ldmatrix phase (frames m ... m + 7
    at one k, a multiple of 4) start in 8 different 16-byte bank groups,
    where without the skew (shift % 8 == 0) they share them (all 8 rows
    in one at shift = 160)."""
    tm, length = 64, 400

    def pos(p):
        return p + tff.TC_SKEW * (p // shift)

    r = np.arange(tm)[:, None]
    k = np.arange(length)[None, :]
    at = r * (shift + tff.TC_SKEW) + k + tff.TC_SKEW * (k // shift)
    np.testing.assert_array_equal(at, pos(r * shift + k))
    assert np.all(at[:, 1:][:, k[0, 1:] % 4 != 0]
                  == at[:, :-1][:, k[0, 1:] % 4 != 0] + 1)
    for m in range(0, tm, 8):
        for kk in range(0, length, 4):
            groups = at[m:m + 8, kk] // 4 % 8
            assert len(set(groups)) == 8
            assert len(set((r[m:m + 8, 0] * shift + kk) // 4 % 8)) < 8
    words = (tm - 1) * shift + length
    assert pos(words - 1) < -(-(words + tff.TC_SKEW * ((words - 1) // shift))
                              // 4) * 4


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """x rounded to tf32 (to nearest, ties away, as cvt.rna.tf32.f32 and
    common.cuh's tf32) by masking its float32 bits."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _banded_mel(power: torch.Tensor, cfg) -> torch.Tensor:
    """Each filter's band in ascending bin order as a float32 fmaf chain
    (the product exact in float64, one rounding of the sum; float64 then
    float32 rounds twice at most 2^-29 of the time). power (..., nbins)
    starts at the band's first bin."""
    bands = tff.mel_bands(cfg)
    width = max(int(bands.length.max()), 1)
    j = np.arange(width)[None, :]
    idx = bands.lo[:, None] + np.minimum(j, np.maximum(bands.length[:, None]
                                                       - 1, 0))
    w = np.where(j < bands.length[:, None],
                 bands.weights[np.minimum(bands.off[:, None] + j,
                                          bands.weights.size - 1)], 0.0)
    p = power.double()[..., torch.from_numpy(idx)]  # (..., M, width)
    w = torch.from_numpy(w)
    acc = torch.zeros(p.shape[:-1], dtype=torch.float32)
    for i in range(width):  # zero weights past a band add exactly 0
        acc = (acc.double() + p[..., i] * w[:, i]).float()
    return acc


def _tc_route_emulated(wav, cfg, wav_lengths, norm_var, eps=1e-8,
                       passes=3):
    """Route "tc"'s arithmetic: frames @ the interleaved band, each k8
    step's lo hi + hi lo + hi hi summed apart and added to the running sums
    in float32 (``passes=1``: hi hi alone, single-pass TF32); power from
    each column pair; the banded mel; log floor, mask, CMVN (the second
    launch, as the plain version)."""
    nbins = tff.padded_bins(cfg)
    frames = tff.fbank_ref.frame_signal(wav, cfg)
    b, t, length = frames.shape
    a = frames.reshape(-1, length)
    bm = torch.from_numpy(_interleaved(cfg, nbins))
    ah, bh = _tf32(a), _tf32(bm)
    al, bl = _tf32(a - ah), _tf32(bm - bh)
    acc = torch.zeros(a.shape[0], 2 * nbins)
    for s in range(length // 8):
        k = slice(8 * s, 8 * s + 8)
        if passes == 1:
            acc = acc + ah[:, k] @ bh[k]
        else:
            acc = acc + (al[:, k] @ bh[k] + ah[:, k] @ bl[k]
                         + ah[:, k] @ bh[k])
    power = acc[:, 0::2] * acc[:, 0::2] + acc[:, 1::2] * acc[:, 1::2]
    if not cfg.use_power:
        power = torch.sqrt(torch.clamp_min(power, 0.0))
    mel = _banded_mel(power, cfg).reshape(b, t, cfg.n_mels)
    n_valid = tff.valid_frames(wav, cfg, wav_lengths)
    valid = (torch.arange(t)[None, :] < n_valid[:, None])[..., None]
    feats = torch.where(valid, torch.log(torch.clamp_min(mel, cfg.log_floor)),
                        0.0)
    denom = torch.clamp_min(n_valid.float(), 1.0)[:, None, None]
    out = torch.where(valid, feats - feats.sum(1, keepdim=True) / denom, 0.0)
    if norm_var:
        out = out * torch.rsqrt((out * out).sum(1, keepdim=True) / denom + eps)
    return out


@pytest.mark.parametrize("name", list(CASES))
def test_tc_route_numerics_match_jax(name):
    """The emulated "tc" route against the JAX kernel (interpret mode)
    within ATOL on every case; single-pass TF32 does not meet it (it misses
    by ~4e-3 to ~7e-3 on the cases with more than one frame, whose
    CMVN'd features are not all exact zeros)."""
    b, n, lens, norm_var = CASES[name]
    wav = _signal(b, n)
    jl, tl = _lengths(lens)
    want, _ = jfp.fbank_fused(jnp.asarray(wav), JCFG, wav_lengths=jl,
                              norm_var=norm_var)
    want = np.asarray(want)
    got = _tc_route_emulated(torch.from_numpy(wav), CFG, tl, norm_var)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL)
    single = _tc_route_emulated(torch.from_numpy(wav), CFG, tl, norm_var,
                                passes=1)
    if name != "one_frame":  # one frame: CMVN leaves exact zeros
        assert np.abs(single.numpy() - want).max() > 10 * ATOL


@pytest.mark.parametrize("n_mels", [80, 40])
def test_banded_mel_matches_the_dense_product(n_mels):
    """The bands rebuild the filterbank exactly and span the band; the
    banded chain equals the dense product to float64 rounding in float64
    and to summation order in float32."""
    cfg = dataclasses.replace(FLAGSHIP, n_mels=n_mels)
    bands = tff.mel_bands(cfg)
    fb = tff.fbank_ref.mel_filterbank(cfg).astype(np.float32)
    dense = np.zeros_like(fb)
    for m in range(n_mels):
        a = bands.first + bands.lo[m]
        dense[a:a + bands.length[m], m] = bands.weights[
            bands.off[m]:bands.off[m] + bands.length[m]]
    np.testing.assert_array_equal(dense, fb)
    assert (bands.first, bands.n_bins) == (1, 255)
    assert bands.length.sum() < 0.05 * fb.size  # 95-98% of fb is zeros
    rng = np.random.default_rng(n_mels)
    power = rng.gamma(0.5, 10.0, size=(64, cfg.n_freqs)).astype(np.float32)
    band = torch.from_numpy(power[:, 1:1 + tff.padded_bins(cfg)])
    got = _banded_mel(band, cfg).numpy()
    want = power.astype(np.float64) @ fb.astype(np.float64)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    np.testing.assert_allclose(got, power @ fb, rtol=1e-5, atol=0)
