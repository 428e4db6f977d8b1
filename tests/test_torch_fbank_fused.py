"""The port's fused log-mel frontend (``ops/fbank_fused.py``) against the
JAX package's fused kernel (``ops/fbank_pallas.py``, interpret mode on the
CPU) and against its split chain, float32: features, masks, the
degenerate lengths, and the waveform gradient of the trainable form. Then
the forward's "tc" route on the CPU: its plan (integer arithmetic), the
bases in the order its lanes read them, the skewed span, its numerics
(3xTF32 products emulated by bit masking, the banded mel) against the JAX
kernel, and the banded mel against the dense product. Last, the backward's
"tc" frame pass on the CPU: its plan, its packed transposed bases and bin
filter table as its lanes read them, the band-limited transposed product,
and its numerics emulated against the JAX backward."""

import dataclasses
import functools
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


def test_frontend_tables_are_the_callers_own():
    """The frontend's table functions must not hand out their cached
    arrays: ``torch.from_numpy`` aliases them on the CPU, so one write into
    them would change every later result (``test_fbank_fused_matches_jax``
    once failed with the port's side off, a way that could happen).
    Writing into what they return changes no later result, of the fused
    frontend (bases folded anew) or of the split chain."""
    cfg = dataclasses.replace(CFG, n_mels=23, n_fft=1024)  # its own caches
    wav = torch.from_numpy(_signal(1, 4000))

    def outputs():
        tff.device_bases.cache_clear()
        fused, _ = tff.fbank_fused_plain(wav, cfg)
        split = tff.fbank_ref.log_mel(tff.fbank_ref.stft_power(wav, cfg), cfg)
        return fused, split

    try:
        before = outputs()
        for table in (*tff.fbank_ref.dft_matrices(cfg.n_fft),
                      tff.fbank_ref.mel_filterbank(cfg)):
            table *= 2.0
        for got, want in zip(outputs(), before):
            torch.testing.assert_close(got, want, rtol=0, atol=0)
    finally:
        tff.device_bases.cache_clear()


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
    band: a C fragment's column pair (2t, 2t + 1) is one bin's (re, im).
    A copy of each call's own."""
    return _interleaved_once(cfg, nbins).copy()


@functools.lru_cache(maxsize=None)
def _interleaved_once(cfg, nbins):
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


def _banded_sum(x: torch.Tensor, lo, length, off, weights) -> torch.Tensor:
    """out[..., i] = sum over j < length[i] of x[..., lo[i] + j] *
    weights[off[i] + j] in ascending j as a float32 fmaf chain (the product
    exact in float64, one rounding of the sum; float64 then float32 rounds
    twice at most 2^-29 of the time)."""
    width = max(int(length.max()), 1)
    j = np.arange(width)[None, :]
    idx = lo[:, None] + np.minimum(j, np.maximum(length[:, None] - 1, 0))
    w = np.where(j < length[:, None],
                 weights[np.minimum(off[:, None] + j, weights.size - 1)], 0.0)
    p = x.double()[..., torch.from_numpy(idx)]  # (..., out, width)
    w = torch.from_numpy(w)
    acc = torch.zeros(p.shape[:-1], dtype=torch.float32)
    for i in range(width):  # zero weights past a band add exactly 0
        acc = (acc.double() + p[..., i] * w[:, i]).float()
    return acc


def _banded_mel(power: torch.Tensor, cfg) -> torch.Tensor:
    """Each filter's band in ascending bin order (logmel_tc_kernel's mel).
    power (..., nbins) starts at the band's first bin."""
    bands = tff.mel_bands(cfg)
    return _banded_sum(power, bands.lo, bands.length, bands.off,
                       bands.weights)


def _banded_dpower(dmel: torch.Tensor, cfg) -> torch.Tensor:
    """Each band bin's filters in ascending order (dframes_tc_kernel's
    dpower): (..., n_mels) -> (..., padded bins)."""
    tb = tff.mel_tbands(cfg)
    return _banded_sum(dmel, tb.lo, tb.length, tb.off, tb.weights)


def _tf32_product(a: torch.Tensor, b: torch.Tensor, passes=3):
    """a @ b as route "tc" runs it: each k8 step's lo hi + hi lo + hi hi
    summed apart and added to the running sums in float32 (``passes=1``:
    hi hi alone, single-pass TF32)."""
    def steps(x, y):  # each k8 step's product apart: (K / 8, M, N)
        return x.reshape(x.shape[0], -1, 8).transpose(0, 1) @ y.reshape(
            -1, 8, y.shape[1])

    ah, bh = _tf32(a), _tf32(b)
    al, bl = _tf32(a - ah), _tf32(b - bh)
    d = steps(ah, bh)
    if passes != 1:
        d = steps(al, bh) + steps(ah, bl) + d
    acc = torch.zeros(a.shape[0], b.shape[1])
    for step in d:
        acc = acc + step
    return acc


def _tc_logmel(wav, cfg, wav_lengths, passes=3):
    """Route "tc"'s log-mel: frames @ the interleaved band in 3xTF32, power
    from each column pair, the banded mel, log floor, mask. Returns (band
    spectra (B T, 2 nbins), mel, masked log-mel, valid (B, T, 1), frame
    counts (B, 1, 1))."""
    frames = tff.fbank_ref.frame_signal(wav, cfg)
    b, t, length = frames.shape
    bm = torch.from_numpy(_interleaved(cfg, tff.padded_bins(cfg)))
    spec = _tf32_product(frames.reshape(-1, length), bm, passes)
    power = spec[:, 0::2] * spec[:, 0::2] + spec[:, 1::2] * spec[:, 1::2]
    if not cfg.use_power:
        power = torch.sqrt(torch.clamp_min(power, 0.0))
    mel = _banded_mel(power, cfg).reshape(b, t, cfg.n_mels)
    n_valid = tff.valid_frames(wav, cfg, wav_lengths)
    valid = (torch.arange(t)[None, :] < n_valid[:, None])[..., None]
    feats = torch.where(valid, torch.log(torch.clamp_min(mel, cfg.log_floor)),
                        0.0)
    denom = torch.clamp_min(n_valid.float(), 1.0)[:, None, None]
    return spec, mel, feats, valid, denom


def _tc_route_emulated(wav, cfg, wav_lengths, norm_var, eps=1e-8,
                       passes=3):
    """Route "tc"'s arithmetic: the log-mel of ``_tc_logmel``, then CMVN
    (the second launch, as the plain version)."""
    _, _, feats, valid, denom = _tc_logmel(wav, cfg, wav_lengths, passes)
    out = torch.where(valid, feats - feats.sum(1, keepdim=True) / denom, 0.0)
    if norm_var:
        out = out * torch.rsqrt((out * out).sum(1, keepdim=True) / denom + eps)
    return out


def _tc_bwd_emulated(wav, cfg, wav_lengths, g, norm_var, eps=1e-8,
                     passes=3):
    """The backward with its frame pass on route "tc": the recompute's band
    spectra and mel (``_tc_logmel``), the CMVN transpose (the plain
    version's), dmel above the log floor, dpower by each bin's filters, A =
    2 [re | im] dpower and A @ the interleaved band transposed in 3xTF32
    (``passes=1``: single-pass TF32), the overlap-add."""
    b, n = wav.shape
    spec, mel, feats, valid, denom = _tc_logmel(wav, cfg, wav_lengths)
    t = mel.shape[1]
    c = torch.where(valid, feats - feats.sum(1, keepdim=True) / denom, 0.0)
    dfeats = tff.cmvn_transpose(c, g, valid, denom, norm_var, eps)
    dmel = torch.where(valid & (mel > cfg.log_floor),
                       dfeats / torch.clamp_min(mel, cfg.log_floor), 0.0)
    dpower = _banded_dpower(dmel.reshape(b * t, -1), cfg)
    a = 2.0 * spec * dpower.repeat_interleave(2, dim=1)
    bt = torch.from_numpy(_interleaved(cfg, tff.padded_bins(cfg)).T.copy())
    dframes = _tf32_product(a, bt, passes).reshape(b, t, -1)
    covered = (t - 1) * cfg.frame_shift + cfg.frame_length
    dwav = torch.nn.functional.fold(
        dframes.transpose(1, 2), output_size=(1, covered),
        kernel_size=(1, cfg.frame_length),
        stride=(1, cfg.frame_shift)).reshape(b, covered)
    return torch.nn.functional.pad(dwav, (0, n - covered))


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


# ---------------------------------------------------------------------------
# the backward's frame pass, route "tc" of csrc/fbank.cu, on the CPU
# ---------------------------------------------------------------------------


def _dt_constants():
    path = os.path.join(os.path.dirname(tff.__file__), "..", "csrc",
                        "fbank.cu")
    with open(path) as f:
        src = f.read()
    return {k: int(v) for k, v in
            re.findall(r"constexpr int (DT_\w+) = (\d+);", src)}


def test_tc_bwd_constants_match_the_kernel():
    """The frame pass's constants as the kernel has them; at L = 400 its 50
    n8 tiles go 7, 7, 6, ..., 6 to the 8 warps, each tile once."""
    assert _dt_constants() == {"DT_TM": tff.DT_TM, "DT_WARPS": tff.DT_WARPS,
                               "DT_NT": tff.DT_NT,
                               "DT_STAGES": tff.DT_STAGES,
                               "DT_APAD": tff.DT_APAD,
                               "DT_BINS": tff.DT_BINS}
    assert tff.DT_NP == 4 and tff.DT_BINS == 256
    split = tff.warp_tiles(400)
    assert [cnt for _, cnt in split] == [7, 7, 6, 6, 6, 6, 6, 6]
    tiles = [n for n0, cnt in split for n in range(n0, n0 + cnt)]
    assert tiles == list(range(400 // 8))


@pytest.mark.parametrize("n_mels,smem", [(80, 218_112), (40, 207_872)])
@pytest.mark.parametrize("shape", [DECODE, TRAIN], ids=["decode", "train"])
def test_fbank_bwd_plan_fits_every_flagship_configuration(n_mels, smem,
                                                          shape):
    """Decode and train shapes, 80 and 40 mels: 32-frame tiles over the
    forward's 256 padded bins; A's hi and lo rows (2 x 32 x 516 floats),
    the mel and dfeats tiles (2 x 32 x M) and 8 rings of 4 steps x 4
    pieces x 32 lanes x 4 floats within the H100's opt-in shared
    memory."""
    cfg = dataclasses.replace(FLAGSHIP, n_mels=n_mels)
    plan = tff.fbank_bwd_plan(cfg, *shape, H100_SMS, H100_SMEM)
    assert plan == tff.FbankBwdPlan(32, 256, smem)
    assert plan.smem == tff.tc_bwd_smem(256, n_mels) <= H100_SMEM
    assert tff.fbank_plan(cfg, *shape, H100_SMS, H100_SMEM).nbins == 256


@pytest.mark.parametrize("change", ["recompute_simt", "magnitude",
                                    "length_456", "smem", "no_frame"])
def test_fbank_bwd_plan_refuses(change):
    """Where the recompute cannot take route "tc" (it writes what the
    frame pass reads), magnitude spectra, a frame of more than 8 x 7 n8
    tiles, too little shared memory, no frame: route "simt"."""
    cfg, b, n, smem = FLAGSHIP, 4, 16_000, H100_SMEM
    if change == "recompute_simt":
        cfg = dataclasses.replace(cfg, frame_shift=164)
    elif change == "magnitude":
        cfg = dataclasses.replace(cfg, use_power=False)
    elif change == "length_456":
        cfg = dataclasses.replace(cfg, frame_length=456)
        assert tff.fbank_plan(cfg, b, n, H100_SMS, smem) is not None
    elif change == "smem":
        smem = tff.tc_bwd_smem(256, 80) - 1
        assert tff.fbank_plan(cfg, b, n, H100_SMS, smem) is not None
    else:
        n = 399
    assert tff.fbank_bwd_plan(cfg, b, n, H100_SMS, smem) is None


def _kernel_view_t(packed, length, nbins):
    """The (2 nbins, L) B operand of the frame pass as its lanes read it:
    at k8 step s, warp w's piece q (from its first piece p0: the pieces of
    the warps before it) holds in lane 4 g + t (b0, b1) of its tile n0 +
    2 q, then of n0 + 2 q + 1, b0 row 8 s + t and b1 row 8 s + t + 4 of
    column 8 n + g; the piece's half past the warp's last tile is zeros."""
    split = tff.warp_tiles(length)
    n_pieces = sum(-(-cnt // 2) for _, cnt in split)
    x = packed.reshape(2 * nbins // 8, n_pieces, 32, 4)
    out = np.full((2 * nbins, length), np.nan, np.float32)
    s = np.arange(2 * nbins // 8)
    p0 = 0
    for n0, cnt in split:
        for q in range(-(-cnt // 2)):
            for lane in range(32):
                g, t = divmod(lane, 4)
                for e, (i, h) in enumerate(((0, 0), (0, 1), (1, 0), (1, 1))):
                    got = x[:, p0 + q, lane, e]
                    if 2 * q + i >= cnt:
                        assert not got.any()
                        continue
                    out[8 * s + t + 4 * h, 8 * (n0 + 2 * q + i) + g] = got
        p0 += -(-cnt // 2)
    return out


def test_pack_bases_t_is_what_the_lanes_read():
    bands = tff.mel_bands(FLAGSHIP)
    m_cos, m_sin, _ = tff.combined_bases(FLAGSHIP)
    packed = tff.pack_bases_t(m_cos, m_sin, bands, 256)
    assert packed.shape == (512 // 8 * 26 * 32 * 4,)  # 26 pieces a step
    np.testing.assert_array_equal(_kernel_view_t(packed, 400, 256),
                                  _interleaved(FLAGSHIP, 256).T)


@pytest.mark.parametrize("n_mels", [80, 40])
def test_bin_filter_table_gives_the_banded_dpower(n_mels):
    """The frame pass's table of each band bin's two filters and weights:
    fmaf(dmel[f1], w1, fmaf(dmel[f0], w0, 0)) equals the bins' ascending
    chain (``_banded_dpower``) bit for bit, zeros on the padding bins."""
    cfg = dataclasses.replace(FLAGSHIP, n_mels=n_mels)
    _, filters, weights = tff.tc_bwd_bases(cfg, torch.device("cpu"))
    assert filters.shape == weights.shape == (2, tff.padded_bins(cfg))
    dmel = torch.from_numpy(np.random.default_rng(n_mels).standard_normal(
        (16, n_mels)).astype(np.float32))
    f0, f1 = filters.long()
    first = (dmel[:, f0].double() * weights[0].double()).float()
    got = (first.double() + dmel[:, f1].double() * weights[1].double()
           ).float()
    torch.testing.assert_close(got, _banded_dpower(dmel, cfg), rtol=0,
                               atol=0)
    assert not got[:, tff.mel_bands(cfg).n_bins:].any()


@pytest.mark.parametrize("n_mels", [80, 40])
def test_band_limited_transposed_product_equals_the_full_one(n_mels):
    """For a dpower made through fb (dmel @ fb.T over all 257 bins), dpower
    is exactly 0 outside the band 1..255, the bins' filter bands rebuild fb
    and give dpower to summation order, and the transposed product over
    the band's 512 interleaved rows equals the full 257-bin one (float64:
    the two differ by the order of their sums only)."""
    cfg = dataclasses.replace(FLAGSHIP, n_mels=n_mels)
    bands, tb = tff.mel_bands(cfg), tff.mel_tbands(cfg)
    m_cos, m_sin, fb = tff.combined_bases(cfg)
    dense = np.zeros((tff.padded_bins(cfg), n_mels), np.float32)
    for j in range(bands.n_bins):
        dense[j, tb.lo[j]:tb.lo[j] + tb.length[j]] = tb.weights[
            tb.off[j]:tb.off[j] + tb.length[j]]
    np.testing.assert_array_equal(dense[:bands.n_bins],
                                  fb[bands.first:bands.first + bands.n_bins])
    assert not tb.length[bands.n_bins:].any() and tb.length.max() == 2
    rng = np.random.default_rng(n_mels)
    frames = 48
    dmel = rng.standard_normal((frames, n_mels)).astype(np.float32)
    re, im = (rng.standard_normal((frames, cfg.n_freqs)) for _ in range(2))
    dpower = dmel.astype(np.float64) @ fb.T.astype(np.float64)  # (48, 257)
    band = slice(bands.first, bands.first + bands.n_bins)
    outside = np.ones(cfg.n_freqs, bool)
    outside[band] = False
    assert not dpower[:, outside].any()
    got = _banded_dpower(torch.from_numpy(dmel), cfg).numpy()
    np.testing.assert_allclose(got[:, :bands.n_bins], dpower[:, band],
                               rtol=1e-6, atol=1e-7)
    assert not got[:, bands.n_bins:].any()
    full = ((2 * re * dpower) @ m_cos.T.astype(np.float64)
            + (2 * im * dpower) @ m_sin.T.astype(np.float64))
    a = np.zeros((frames, 2 * tff.padded_bins(cfg)))
    a[:, 0:2 * bands.n_bins:2] = 2 * re[:, band] * dpower[:, band]
    a[:, 1:2 * bands.n_bins:2] = 2 * im[:, band] * dpower[:, band]
    limited = a @ _interleaved(cfg, tff.padded_bins(cfg)).T.astype(np.float64)
    np.testing.assert_allclose(limited, full, rtol=1e-12,
                               atol=1e-12 * np.abs(full).max())


@pytest.mark.parametrize("norm_var", [True, False], ids=["cmvn", "mean_only"])
@pytest.mark.parametrize("name", list(CASES))
def test_tc_bwd_numerics_match_jax(name, norm_var):
    """The backward with its frame pass emulated as route "tc" runs it
    (the recompute's band spectra and mel, the banded dpower, the
    transposed band in 3xTF32) against the JAX custom-VJP gradient
    (interpret mode), normalised by the largest JAX gradient, at rtol/atol
    1e-4 as the plain version's test (~1e-6 reached); single-pass TF32 in
    the transposed product misses it (by ~2e-4 to ~3e-4) on the cases with
    more than one frame, whose gradients are not all exact zeros."""
    b, n, lens, _ = CASES[name]
    wav = _signal(b, n, seed=1)
    jl, tl = _lengths(lens)
    t = tff.fbank_ref.num_frames(n, CFG)
    w = np.random.default_rng(2).standard_normal(
        (b, t, CFG.n_mels)).astype(np.float32)

    def loss_jax(x):
        feats, _ = jfp.fbank_fused_trainable(x, JCFG, wav_lengths=jl,
                                             norm_var=norm_var)
        return jnp.sum(feats * w)

    want = np.asarray(jax.grad(loss_jax)(jnp.asarray(wav)))
    x, g = torch.from_numpy(wav), torch.from_numpy(w)
    got = _tc_bwd_emulated(x, CFG, tl, g, norm_var).numpy()
    scale = np.abs(want).max()
    if name == "one_frame":  # CMVN over one frame: exact zeros
        assert scale == 0.0 and not got.any()
        return
    np.testing.assert_allclose(got / scale, want / scale, rtol=1e-4,
                               atol=1e-4)
    single = _tc_bwd_emulated(x, CFG, tl, g, norm_var, passes=1).numpy()
    with pytest.raises(AssertionError):
        np.testing.assert_allclose(single / scale, want / scale, rtol=1e-4,
                                   atol=1e-4)
