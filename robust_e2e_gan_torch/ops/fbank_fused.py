"""Fused log-mel frontend: framing -> windowed DFT -> power -> mel -> log ->
masked utterance CMVN in one kernel, and its backward to the waveform.

Counterpart of ``robust_e2e_gan_tpu/ops/fbank_pallas.py``: ``fbank_fused``
(inference; ``csrc/fbank.cu`` forward) and ``fbank_fused_trainable``, an
``autograd.Function`` whose backward is the backward kernel. Both have the
JAX contract: (B, N) float32 waveform -> ((B, T, n_mels) features,
(B, T) mask), zero frames give a (B, 0, n_mels) result, pad frames are
exact zeros, ``n_valid = min(frame_lengths_from_wav_lengths, T)``.

DC removal, pre-emphasis and the window are linear maps on the frame, so
they are folded into the DFT bases in float64 (``combined_bases``), as the
JAX kernel folds them. The plain versions compute the same folded-bases
formulation with PyTorch products; they differ from the split chain of
``ops/fbank.py`` by the folding order only. All products are float32:
TF32 off (PyTorch's default for matmuls).

The forward kernel has two routes. "tc" (``logmel_tc_kernel``) runs the
DFT on the tensor cores in 3xTF32 over the band of bins the filterbank
touches and sums each mel filter over its nonzero bins alone; it runs
wherever ``fbank_plan`` fits, every flagship configuration. "simt"
(``logmel_kernel``, float32 FMAs, a thread a bin) runs past the plan, or
inside ``_force_fbank_route("simt")``. ``FBANK_ROUTE_LAUNCHES`` counts the
forward launches by route.

The backward recomputes the log-mel on the forward's route; its frame
pass has two routes too. "tc" (``dframes_tc_kernel``) takes the band
spectra and mel that the "tc" recompute writes, sums dpower over the few
filters of each bin and runs the transposed DFT over the band on the
tensor cores in 3xTF32; it runs wherever ``fbank_bwd_plan`` fits, every
flagship configuration. "simt" (``dframes_kernel``, float32 FMAs) runs
past the plan, or inside ``_force_fbank_bwd_route("simt")``.
``FBANK_BWD_ROUTE_LAUNCHES`` counts the backward launches by frame-pass
route.
"""

from __future__ import annotations

import contextlib
import functools
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from robust_e2e_gan_torch.config import FrontendConfig
from robust_e2e_gan_torch.ops import fbank as fbank_ref
from robust_e2e_gan_torch.utils.build import launch
from robust_e2e_gan_torch.utils.impl import (
    SMEM_LIMIT,
    check,
    check_no_grad,
    device_limits,
    on_cuda,
)
from robust_e2e_gan_torch.utils.trace import traced

# route "simt": DFT bins (and, in the backward, frame samples) one block
# covers, a thread each (csrc/fbank.cu)
MAX_THREADS = 512
TT, TS = 32, 36  # frames per block and the stride of their transposed tile

# route "tc" (csrc/fbank.cu's TC_* constants): bins a warp owns, warps a
# block, k8 steps of the bases in flight a warp, floats of a warp's bases a
# k8 step, the span's skew every frame shift, the padding of the power
# tile's bin rows; the frame tiles the plan chooses from, the larger first
TC_WARP_BINS = 32
TC_MAX_WARPS = 8
TC_STAGES = 4
TC_STEP = 32 * 2 * (2 * TC_WARP_BINS // 8)
TC_SKEW = 4
TC_PPAD = 8
TC_TILES = (64, 32)

# the backward's frame pass on route "tc" (csrc/fbank.cu's DT_* constants):
# frames a block, warps a block, n8 tiles of the frame's samples a warp at
# most and the 16-byte pieces (two tiles each) they take a lane a k8 step,
# k8 steps of the bases in flight a warp, the padding of A's rows, band
# bins at most; the filters a band bin sums at most (its table holds two)
DT_TM = 32
DT_WARPS = 8
DT_NT = 7
DT_NP = (DT_NT + 1) // 2
DT_STAGES = 4
DT_APAD = 4
DT_BINS = TC_WARP_BINS * TC_MAX_WARPS
DT_FILTERS = 2


def _preprocess_matrix(cfg: FrontendConfig) -> np.ndarray:
    """(L, L) float64: frame' = diag(w) @ P @ A @ frame, DC removal,
    pre-emphasis and window in the order of ops.fbank._preprocess_frames."""
    n = cfg.frame_length
    w = fbank_ref.window_fn(cfg).astype(np.float64)
    a = np.eye(n) - (np.ones((n, n)) / n if cfg.remove_dc else 0.0)
    p = np.eye(n)
    if cfg.preemphasis > 0.0:
        p = p - cfg.preemphasis * np.diag(np.ones(n - 1), k=-1)
        p[0, 0] -= cfg.preemphasis  # x'[0] = x[0] - p * x[0]
    return np.diag(w) @ p @ a


def combined_bases(cfg: FrontendConfig) -> Tuple[np.ndarray, ...]:
    """DC removal, pre-emphasis and window folded into the DFT bases.

    Returns float32 (M_cos (L, n_freqs), M_sin (L, n_freqs), fb (n_freqs,
    n_mels)): frame @ M_cos is the real part of the windowed DFT of the
    preprocessed frame.
    """
    n = cfg.frame_length
    t_pre = _preprocess_matrix(cfg)
    cos_m, sin_m = fbank_ref.dft_matrices(cfg.n_fft)
    m_cos = (t_pre.T @ cos_m[:n].astype(np.float64)).astype(np.float32)
    m_sin = (t_pre.T @ sin_m[:n].astype(np.float64)).astype(np.float32)
    return m_cos, m_sin, fbank_ref.mel_filterbank(cfg).astype(np.float32)


@functools.lru_cache(maxsize=8)
def device_bases(cfg: FrontendConfig, device: torch.device
                 ) -> Tuple[torch.Tensor, ...]:
    """(M_cos, M_sin, fb, M_cos^T, M_sin^T, fb^T) on ``device``, folded and
    moved there once per (configuration, device)."""
    m_cos, m_sin, fb = (torch.from_numpy(x) for x in combined_bases(cfg))
    return tuple(x.contiguous().to(device)
                 for x in (m_cos, m_sin, fb, m_cos.t(), m_sin.t(), fb.t()))


class MelBands(NamedTuple):
    """Each mel filter's nonzero band of ``fb`` (n_freqs, n_mels): bins
    ``first`` ... ``first + n_bins - 1`` hold every nonzero weight; filter
    m's weights ``weights[off[m] : off[m] + length[m]]`` sit on bins
    ``first + lo[m]`` onward (``length[m]`` 0 for an empty filter)."""
    first: int
    n_bins: int
    lo: np.ndarray
    length: np.ndarray
    off: np.ndarray
    weights: np.ndarray


@functools.lru_cache(maxsize=8)
def mel_bands(cfg: FrontendConfig) -> MelBands:
    """The filterbank's bands: summing filter m over ``length[m]`` bins in
    ascending order equals the dense product's ascending chain over every
    bin bit for bit (the bins left out carry a zero weight, and fmaf(p, 0,
    acc) == acc for a finite p)."""
    fb = fbank_ref.mel_filterbank(cfg).astype(np.float32)
    nz = [np.flatnonzero(fb[:, m]) for m in range(fb.shape[1])]
    used = [x for x in nz if x.size]
    first = min((int(x[0]) for x in used), default=0)
    last = max((int(x[-1]) for x in used), default=0)
    lo = np.array([x[0] - first if x.size else 0 for x in nz], np.int32)
    length = np.array([x[-1] - x[0] + 1 if x.size else 0 for x in nz],
                      np.int32)
    off = np.concatenate([[0], np.cumsum(length)[:-1]]).astype(np.int32)
    # one trailing zero, so that the array is never empty
    weights = np.concatenate(
        [fb[first + a:first + a + n, m]
         for m, (a, n) in enumerate(zip(lo, length))] + [np.zeros(1)]
    ).astype(np.float32)
    return MelBands(first, last - first + 1, lo, length, off, weights)


class BinBands(NamedTuple):
    """The filters that touch each bin of the band (``MelBands.first`` on,
    ``nbins`` of them): bin j's weights ``weights[off[j] : off[j] +
    length[j]]`` are those of filters ``lo[j]`` onward (``length[j]`` 0
    for a bin no filter touches, and for the padding past the band)."""
    lo: np.ndarray
    length: np.ndarray
    off: np.ndarray
    weights: np.ndarray


@functools.lru_cache(maxsize=8)
def mel_tbands(cfg: FrontendConfig) -> BinBands:
    """The filterbank's transpose in bands, over the band padded to
    ``padded_bins``: summing bin j's filters in ascending order equals the
    dense ascending chain of ``dmel @ fb.T`` over every filter bit for bit
    (the filters left out carry a zero weight)."""
    bands = mel_bands(cfg)
    fb = fbank_ref.mel_filterbank(cfg).astype(np.float32)
    rows = fb[bands.first:bands.first + bands.n_bins]
    nz = [np.flatnonzero(r) for r in rows]
    nz += [np.zeros(0, np.int64)] * (padded_bins(cfg) - len(nz))
    lo = np.array([x[0] if x.size else 0 for x in nz], np.int32)
    length = np.array([x[-1] - x[0] + 1 if x.size else 0 for x in nz],
                      np.int32)
    off = np.concatenate([[0], np.cumsum(length)[:-1]]).astype(np.int32)
    weights = np.concatenate(
        [rows[j, a:a + n] for j, (a, n) in enumerate(zip(lo, length))
         if n] + [np.zeros(1)]).astype(np.float32)
    return BinBands(lo, length, off, weights)


def _interleaved_band(m_cos: np.ndarray, m_sin: np.ndarray,
                      bands: MelBands, nbins: int) -> np.ndarray:
    """(L, 2 nbins): columns 2j and 2j + 1 are M_cos and M_sin of bin
    ``bands.first + j`` for j < ``bands.n_bins``, zeros past it."""
    lo, n = bands.first, bands.n_bins
    bm = np.zeros((m_cos.shape[0], 2 * nbins), np.float32)
    bm[:, 0:2 * n:2] = m_cos[:, lo:lo + n]
    bm[:, 1:2 * n:2] = m_sin[:, lo:lo + n]
    return bm


def pack_bases(m_cos: np.ndarray, m_sin: np.ndarray, bands: MelBands,
               nbins: int) -> np.ndarray:
    """The "tc" route's B operand in the order its lanes read it.

    Columns 2j and 2j + 1 of the (L, 2 nbins) matrix are M_cos and M_sin of
    bin ``bands.first + j`` for j < ``bands.n_bins``, zeros past it. Warp w
    owns columns 64 w ... 64 w + 63 (8 n8 tiles); at k8 step s, lane 4 g +
    t holds B[8 s + t + 4 h][64 w + 8 nt + g] of its tiles nt (h = 0, 1:
    the fragment's b0 and b1) as four 16-byte pieces q = nt // 2, each
    (nt = 2 q, h 0 / 1, nt = 2 q + 1, h 0 / 1). Returns float32 (L / 8,
    warps, 4, 32, 4), flattened."""
    length = m_cos.shape[0]
    bm = _interleaved_band(m_cos, m_sin, bands, nbins)
    # k = 8 s + 4 h + t, column = 64 w + 8 (2 q + i) + g
    x = bm.reshape(length // 8, 2, 4, nbins // TC_WARP_BINS, 4, 2, 8)
    # (s, h, t, w, q, i, g) -> (s, w, q, g, t, i, h)
    return np.ascontiguousarray(x.transpose(0, 3, 4, 6, 2, 5, 1)).reshape(-1)


def warp_tiles(length: int) -> list:
    """(first n8 tile, tiles) of each warp of the frame pass over a frame's
    L / 8 tiles: the remainder to the first warps (7, 7, 6, ..., 6 at
    L = 400)."""
    base, extra = divmod(length // 8, DT_WARPS)
    return [(w * base + min(w, extra), base + (w < extra))
            for w in range(DT_WARPS)]


def pack_bases_t(m_cos: np.ndarray, m_sin: np.ndarray, bands: MelBands,
                 nbins: int) -> np.ndarray:
    """The backward's B operand, the interleaved band transposed (2 nbins,
    L), in the order the frame pass's lanes read it. At k8 step s, lane
    4 g + t holds (b0, b1) = (B[8 s + t][8 n + g], B[8 s + t + 4][8 n + g])
    of n8 tile n; a 16-byte piece holds those of two tiles, a warp's tiles
    n0, n0 + 1, ... in its pieces (zeros past its last tile), the warps'
    pieces one after another. Returns float32 (2 nbins / 8, pieces, 32,
    4), flattened."""
    length = m_cos.shape[0]
    b = _interleaved_band(m_cos, m_sin, bands, nbins).T
    # k = 8 s + 4 h + t, column = 8 n + g
    x = b.reshape(2 * nbins // 8, 2, 4, length // 8, 8)
    # (s, h, t, n, g) -> (s, n, g, t, h) -> (s, n, lane, (b0, b1))
    x = x.transpose(0, 3, 4, 2, 1).reshape(2 * nbins // 8, length // 8, 32, 2)
    zero = np.zeros_like(x[:, 0])
    pieces = [np.concatenate([x[:, n0 + i], x[:, n0 + i + 1]
                              if i + 1 < cnt else zero], axis=-1)
              for n0, cnt in warp_tiles(length) for i in range(0, cnt, 2)]
    return np.ascontiguousarray(np.stack(pieces, axis=1)).reshape(-1)


class FbankPlan(NamedTuple):
    """Route "tc"'s launch: frames a block, bins computed (the band padded
    to whole warps: blocks of nbins / 32 warps), shared bytes, and whether
    the waveform is copied in 16-byte pieces (else 4-byte ones)."""
    tm: int
    nbins: int
    smem: int
    copy16: bool


def padded_bins(cfg: FrontendConfig) -> int:
    """Bins route "tc" computes: the filterbank's band, padded with zero
    bins to whole warps (1..255 -> 256 at n_fft = 512)."""
    return -(-mel_bands(cfg).n_bins // TC_WARP_BINS) * TC_WARP_BINS


def tc_smem(tm: int, length: int, shift: int, nbins: int, n_mels: int
            ) -> int:
    """Shared bytes of a "tc" block (csrc/fbank.cu::tc_smem_bytes): the
    tf32 hi and lo spans of its tm frames, with a skew every shift (later
    the (nbins, tm + 8) power tile), then the warps' rings of bases (later
    the (tm, n_mels + 1) mel tile)."""
    span = (tm - 1) * shift + length
    words = -(-(span + TC_SKEW * ((span - 1) // shift)) // 4) * 4
    region = max(2 * words, nbins * (tm + TC_PPAD))
    ring = nbins // TC_WARP_BINS * TC_STAGES * TC_STEP
    return 4 * (region + max(ring, tm * (n_mels + 1)))


def fbank_plan(cfg: FrontendConfig, b: int, n: int, n_sm: int,
               smem_optin: int, ptr: int = 0) -> Optional[FbankPlan]:
    """Route "tc"'s plan for b utterances of n samples at ``ptr``, or None
    for route "simt": integer arithmetic.

    It refuses a frame shift or length that is not a multiple of 8 (a k8
    step must not straddle a shift, and the 4-float skew must give rows an
    odd number of 16-byte units apart), a band wider than 8 warps' 256
    bins, and blocks past ``smem_optin``. Of the frame tiles, it takes the
    one with the least ``waves x tm`` (waves of one block an SM over
    ``n_sm`` SMs), the larger on a tie (half the bases' L2 traffic)."""
    t = fbank_ref.num_frames(n, cfg)
    length, shift = cfg.frame_length, cfg.frame_shift
    if min(b, t, n_sm) < 1 or shift % 8 or length % 8:
        return None
    nbins = padded_bins(cfg)
    if nbins > TC_WARP_BINS * TC_MAX_WARPS:
        return None
    best = None
    for tm in TC_TILES:
        smem = tc_smem(tm, length, shift, nbins, cfg.n_mels)
        if smem > smem_optin:
            continue
        cost = -(-b * -(-t // tm) // n_sm) * tm
        if best is None or cost < best[0]:
            best = (cost, FbankPlan(tm, nbins, smem,
                                    n % 4 == 0 and ptr % 16 == 0))
    return None if best is None else best[1]


class FbankBwdPlan(NamedTuple):
    """The frame pass's route "tc": frames a block, the band's padded bins
    (the recompute's, ``fbank_plan``), shared bytes."""
    tm: int
    nbins: int
    smem: int


def tc_bwd_smem(nbins: int, n_mels: int) -> int:
    """Shared bytes of a "tc" frame-pass block (csrc/fbank.cu::
    dt_smem_bytes): A's tf32 hi and lo rows, the mel and dfeats tiles, the
    warps' rings."""
    return 4 * (2 * DT_TM * (2 * nbins + DT_APAD) + 2 * DT_TM * n_mels
                + DT_WARPS * DT_STAGES * DT_NP * 128)


def fbank_bwd_plan(cfg: FrontendConfig, b: int, n: int, n_sm: int,
                   smem_optin: int, ptr: int = 0) -> Optional[FbankBwdPlan]:
    """The frame pass's route "tc" for b utterances of n samples at
    ``ptr``, or None for route "simt": integer arithmetic.

    It needs the recompute on route "tc" (``fbank_plan``), which writes the
    band spectra and the mel the frame pass reads; the power spectrum;
    the frame's L / 8 n8 tiles over 8 warps at 7 a warp at most (L <=
    448); at most two filters on a bin (as triangular filters are); and
    its block within ``smem_optin``."""
    fwd = fbank_plan(cfg, b, n, n_sm, smem_optin, ptr)
    if (fwd is None or not cfg.use_power
            or max(cnt for _, cnt in warp_tiles(cfg.frame_length)) > DT_NT
            or mel_tbands(cfg).length.max() > DT_FILTERS):
        return None
    smem = tc_bwd_smem(fwd.nbins, cfg.n_mels)
    return FbankBwdPlan(DT_TM, fwd.nbins, smem) if smem <= smem_optin else None


def _check_cfg(cfg: FrontendConfig) -> None:
    if cfg.frame_length % 8:  # the JAX kernel's rule, kept so both packages
        raise ValueError("frame_length must be a multiple of 8")  # agree


def _check_backward_cfg(cfg: FrontendConfig) -> None:
    """The configs the backward (kernel and plain version) implements."""
    _check_cfg(cfg)
    if not cfg.use_power:
        raise NotImplementedError(
            "the fused backward implements the power spectrum (the Kaldi "
            "default); use the split chain of ops/fbank.py for magnitude "
            "spectra")


def valid_frames(wav: torch.Tensor, cfg: FrontendConfig,
                 wav_lengths: Optional[torch.Tensor]) -> torch.Tensor:
    """(B,) int32 valid frame counts, at most T."""
    t = fbank_ref.num_frames(wav.shape[-1], cfg)
    if wav_lengths is None:
        return torch.full((wav.shape[0],), t, dtype=torch.int32,
                          device=wav.device)
    n_valid = fbank_ref.frame_lengths_from_wav_lengths(wav_lengths, cfg)
    return torch.clamp_max(n_valid, t).to(torch.int32)


def _mask(n_valid: torch.Tensor, t: int) -> torch.Tensor:
    frames = torch.arange(t, device=n_valid.device)
    return (frames[None, :] < n_valid[:, None]).float()


def _empty(wav: torch.Tensor, cfg: FrontendConfig):
    b = wav.shape[0]
    return (wav.new_zeros((b, 0, cfg.n_mels), dtype=torch.float32),
            wav.new_zeros((b, 0), dtype=torch.float32))


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------


def _spectra(wav, cfg):
    """(re, im, mel) of every frame through the folded bases."""
    m_cos, m_sin, fb = device_bases(cfg, wav.device)[:3]
    frames = fbank_ref.frame_signal(wav.float(), cfg)
    re, im = frames @ m_cos, frames @ m_sin
    power = re * re + im * im
    if not cfg.use_power:
        power = torch.sqrt(torch.clamp_min(power, 0.0))
    return re, im, power @ fb


def _centred_logmel(wav, n_valid, cfg):
    """The masked log-mel less its utterance mean over valid frames, with
    what the backward reuses: (centred, valid (B, T, 1), denom (B, 1, 1),
    (re, im, mel))."""
    re, im, mel = _spectra(wav, cfg)
    valid = _mask(n_valid, mel.shape[1])[..., None] > 0
    feats = torch.where(valid, torch.log(torch.clamp_min(mel, cfg.log_floor)),
                        0.0)
    denom = torch.clamp_min(n_valid.float(), 1.0)[:, None, None]
    mean = feats.sum(dim=1, keepdim=True) / denom
    return torch.where(valid, feats - mean, 0.0), valid, denom, (re, im, mel)


def _forward_plain(wav, n_valid, cfg, norm_var, eps):
    fbank_fused_plain.calls += 1
    out, _, denom, _ = _centred_logmel(wav, n_valid, cfg)
    if norm_var:
        var = (out * out).sum(dim=1, keepdim=True) / denom
        out = out * torch.rsqrt(var + eps)
    return out


def fbank_fused_plain(wav: torch.Tensor, cfg: FrontendConfig,
                      wav_lengths: Optional[torch.Tensor] = None,
                      norm_var: bool = True, eps: float = 1e-8
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The fused frontend in plain PyTorch: same contract as
    ``fbank_fused``."""
    _check_cfg(cfg)
    t = fbank_ref.num_frames(wav.shape[-1], cfg)
    if t == 0:
        return _empty(wav, cfg)
    n_valid = valid_frames(wav, cfg, wav_lengths)
    return _forward_plain(wav, n_valid, cfg, norm_var, eps), _mask(n_valid, t)


fbank_fused_plain.calls = 0


def cmvn_transpose(c, g, valid, denom, norm_var: bool, eps: float):
    """d loss / d (masked log-mel) from the cotangent g of the CMVN'd
    features: the transpose of the two-pass masked CMVN, given the centred
    log-mel c, the (B, T, 1) mask and the (B, 1, 1) frame counts."""
    gm = torch.where(valid, g.to(c.dtype), 0.0)
    if norm_var:
        var = (c * c).sum(dim=1, keepdim=True) / denom
        s = torch.rsqrt(var + eps)
        dvar = (gm * c).sum(dim=1, keepdim=True) * (-0.5) * s * s * s
        dc = gm * s + (2.0 / denom) * c * dvar
    else:
        dc = gm
    return torch.where(valid, dc - dc.sum(dim=1, keepdim=True) / denom, 0.0)


def fbank_fused_bwd_plain(wav: torch.Tensor, n_valid: torch.Tensor,
                          g: torch.Tensor, cfg: FrontendConfig,
                          norm_var: bool = True, eps: float = 1e-8
                          ) -> torch.Tensor:
    """Gradient of the fused frontend's features with respect to the
    waveform for the cotangent ``g`` (B, T, n_mels): the backward kernel's
    chain (CMVN transpose, log floor, mel, power, transposed DFT,
    overlap-add) in plain PyTorch. Samples past the last frame get 0."""
    _check_backward_cfg(cfg)
    fbank_fused_bwd_plain.calls += 1
    b, n = wav.shape
    m_cos, m_sin, fb = device_bases(cfg, wav.device)[:3]
    c, valid, denom, (re, im, mel) = _centred_logmel(wav, n_valid, cfg)
    t = mel.shape[1]
    dfeats = cmvn_transpose(c, g, valid, denom, norm_var, eps)
    dmel = torch.where(mel > cfg.log_floor,
                       dfeats / torch.clamp_min(mel, cfg.log_floor), 0.0)
    dpower = dmel @ fb.t()
    dframes = (2.0 * re * dpower) @ m_cos.t() + (2.0 * im * dpower) @ m_sin.t()
    covered = (t - 1) * cfg.frame_shift + cfg.frame_length
    dwav = F.fold(dframes.transpose(1, 2), output_size=(1, covered),
                  kernel_size=(1, cfg.frame_length),
                  stride=(1, cfg.frame_shift)).reshape(b, covered)
    return F.pad(dwav, (0, n - covered))


fbank_fused_bwd_plain.calls = 0


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------


# forward launches by route: "tc" the tensor-core kernel, "simt" the one it
# replaced, run past the plan or where forced
FBANK_ROUTE_LAUNCHES = {"tc": 0, "simt": 0}
_forced_fbank_route = None


@contextlib.contextmanager
def _force_fbank_route(route: str):
    """Run every forward launch (and the backward's recompute of the
    log-mel) inside the block on one route ("tc" or "simt"): the tests and
    ``chip_smoke.py`` hold both to the plain version and time them. Forcing
    "tc" where its plan does not fit raises."""
    global _forced_fbank_route
    check(route in FBANK_ROUTE_LAUNCHES, f"unknown fbank route {route!r}")
    prev, _forced_fbank_route = _forced_fbank_route, route
    try:
        yield
    finally:
        _forced_fbank_route = prev


# backward launches by the frame pass's route: "tc" the tensor-core kernel,
# "simt" the one it replaced, run past the plan or where forced
FBANK_BWD_ROUTE_LAUNCHES = {"tc": 0, "simt": 0}
_forced_fbank_bwd_route = None


@contextlib.contextmanager
def _force_fbank_bwd_route(route: str):
    """Run every backward's frame pass inside the block on one route ("tc"
    or "simt"): the tests and ``chip_smoke.py`` hold both to the plain
    version and time them. Forcing "tc" where its plan does not fit (or
    with the recompute forced onto "simt") raises."""
    global _forced_fbank_bwd_route
    check(route in FBANK_BWD_ROUTE_LAUNCHES,
          f"unknown fbank backward route {route!r}")
    prev, _forced_fbank_bwd_route = _forced_fbank_bwd_route, route
    try:
        yield
    finally:
        _forced_fbank_bwd_route = prev


@functools.lru_cache(maxsize=None)
def _plan_on(index: int, cfg: FrontendConfig, b: int, n: int, ptr16: int):
    """The "tc" plan of these shapes on card ``index``, for a waveform at
    ``ptr16`` bytes past a 16-byte boundary."""
    return fbank_plan(cfg, b, n, *device_limits(index), ptr=ptr16)


def _route_plan(wav: torch.Tensor, cfg: FrontendConfig):
    """The "tc" plan of wav on its card, or None for route "simt": past the
    plan, or where "simt" is forced."""
    if _forced_fbank_route == "simt":
        return None
    b, n = wav.shape
    plan = _plan_on(wav.device.index or 0, cfg, b, n, wav.data_ptr() % 16)
    check(plan is not None or _forced_fbank_route is None,
          f"the tc route does not fit B={b} N={n} frame_length="
          f"{cfg.frame_length} frame_shift={cfg.frame_shift} "
          f"n_fft={cfg.n_fft} n_mels={cfg.n_mels}")
    return plan


@functools.lru_cache(maxsize=None)
def _bwd_plan_on(index: int, cfg: FrontendConfig, b: int, n: int, ptr16: int):
    """The frame pass's "tc" plan of these shapes on card ``index``."""
    return fbank_bwd_plan(cfg, b, n, *device_limits(index), ptr=ptr16)


def _bwd_route_plan(wav: torch.Tensor, cfg: FrontendConfig, plan):
    """The frame pass's "tc" plan, or None for route "simt": past the plan,
    with the recompute on "simt" (``plan`` None), or where "simt" is
    forced."""
    if _forced_fbank_bwd_route == "simt":
        return None
    b, n = wav.shape
    bplan = None if plan is None else _bwd_plan_on(
        wav.device.index or 0, cfg, b, n, wav.data_ptr() % 16)
    check(bplan is not None or _forced_fbank_bwd_route is None,
          f"the backward's tc route does not fit B={b} N={n} frame_length="
          f"{cfg.frame_length} frame_shift={cfg.frame_shift} "
          f"n_fft={cfg.n_fft} n_mels={cfg.n_mels}"
          + ("" if plan else " (its log-mel recompute is on route simt)"))
    return bplan


@functools.lru_cache(maxsize=8)
def tc_bases(cfg: FrontendConfig, device: torch.device
             ) -> Tuple[torch.Tensor, ...]:
    """Route "tc"'s packed bases, bands ((3, n_mels) int32: each filter's
    lo, length and off) and weights on ``device``, built once per
    (configuration, card)."""
    m_cos, m_sin, _ = combined_bases(cfg)
    bands = mel_bands(cfg)
    arrays = (pack_bases(m_cos, m_sin, bands, padded_bins(cfg)),
              np.stack([bands.lo, bands.length, bands.off]), bands.weights)
    return tuple(torch.from_numpy(x).to(device) for x in arrays)


@functools.lru_cache(maxsize=8)
def tc_bwd_bases(cfg: FrontendConfig, device: torch.device
                 ) -> Tuple[torch.Tensor, ...]:
    """The frame pass's packed transposed bases and each band bin's (at
    most two) filters ((2, nbins) int32, ascending; the first again where
    a bin has one or none) and their weights ((2, nbins) float32; zero
    where it has fewer) on ``device``, built once per (configuration,
    card)."""
    m_cos, m_sin, _ = combined_bases(cfg)
    tb = mel_tbands(cfg)
    second = tb.length > 1
    filters = np.stack([tb.lo, tb.lo + second]).astype(np.int32)
    weights = np.zeros((2, tb.lo.size), np.float32)
    weights[0, tb.length > 0] = tb.weights[tb.off[tb.length > 0]]
    weights[1, second] = tb.weights[tb.off[second] + 1]
    arrays = (pack_bases_t(m_cos, m_sin, mel_bands(cfg), padded_bins(cfg)),
              filters, weights)
    return tuple(torch.from_numpy(x).to(device) for x in arrays)


def _logmel_args(wav, cfg, plan) -> list:
    """(pointers, route arguments) of csrc/fbank.cu's log-mel launch: the
    pointers M_cos, M_sin, fb, and the packed bases, bands and weights
    (null on route "simt"); the arguments tm (0 on "simt"), nbins, copy16
    and shared bytes."""
    m_cos, m_sin, fb = device_bases(cfg, wav.device)[:3]
    if plan is None:
        return [m_cos.data_ptr(), m_sin.data_ptr(), fb.data_ptr(), None,
                None, None], [0, 0, 0, 0]
    packed, bands, weights = tc_bases(cfg, wav.device)
    return ([m_cos.data_ptr(), m_sin.data_ptr(), fb.data_ptr(),
             packed.data_ptr(), bands.data_ptr(), weights.data_ptr()],
            [plan.tm, plan.nbins, int(plan.copy16), plan.smem])


def _check_kernel_inputs(wav, cfg, backward: bool, plan, bplan=None):
    """The kernels' limits: route "simt"'s thread per DFT bin in one block
    and its shared memory (route "tc" has ``fbank_plan``'s), and the simt
    frame pass's thread per bin and per frame sample (route "tc" has
    ``fbank_bwd_plan``'s)."""
    check(wav.dtype == torch.float32 and wav.dim() == 2,
          f"wav must be (B, N) float32, got {tuple(wav.shape)} {wav.dtype}")
    check(cfg.n_mels <= 1024, f"n_mels={cfg.n_mels} > 1024")
    if backward and bplan is None:
        check(max(cfg.n_freqs, cfg.frame_length) <= MAX_THREADS,
              f"n_fft // 2 + 1 = {cfg.n_freqs} and frame_length = "
              f"{cfg.frame_length} must be <= {MAX_THREADS} (one thread "
              "each in a block)")
        smem = 4 * (max(cfg.frame_length, 2 * cfg.n_freqs) * TS
                    + TT * cfg.n_freqs + cfg.n_mels * TS)
        check(smem <= SMEM_LIMIT, f"a backward block needs {smem} bytes of "
              f"shared memory, more than {SMEM_LIMIT}")
    if plan is None:
        check(cfg.n_freqs <= MAX_THREADS,
              f"n_fft // 2 + 1 = {cfg.n_freqs} must be <= {MAX_THREADS} "
              "(one thread each in a block)")
        smem = 4 * max(cfg.frame_length * TS, TT * cfg.n_freqs)
        check(smem <= SMEM_LIMIT, f"a block needs {smem} bytes of shared "
              f"memory, more than {SMEM_LIMIT}")


def _forward_kernel(wav, n_valid, cfg, norm_var, eps):
    wav = wav.contiguous()
    plan = _route_plan(wav, cfg)
    _check_kernel_inputs(wav, cfg, False, plan)
    b, n = wav.shape
    t = fbank_ref.num_frames(n, cfg)
    bases, route = _logmel_args(wav, cfg, plan)
    n_valid = n_valid.to(torch.int32).contiguous()
    out = torch.empty((b, t, cfg.n_mels), dtype=torch.float32,
                      device=wav.device)
    launch("fbank_fwd", wav.data_ptr(), n_valid.data_ptr(), *bases,
           out.data_ptr(), b, n, t, cfg.frame_length, cfg.frame_shift,
           cfg.n_freqs, cfg.n_mels, *route, cfg.log_floor,
           int(cfg.use_power), int(norm_var), eps,
           torch.cuda.current_stream(wav.device).cuda_stream)
    fbank_fused.launches += 1
    FBANK_ROUTE_LAUNCHES["simt" if plan is None else "tc"] += 1
    return out


def _forward(wav, n_valid, cfg, norm_var, eps):
    if on_cuda(wav, n_valid):
        return _forward_kernel(wav, n_valid, cfg, norm_var, eps)
    return _forward_plain(wav, n_valid, cfg, norm_var, eps)


@traced("rg.op.fbank_fused")
def fbank_fused(wav: torch.Tensor, cfg: FrontendConfig,
                wav_lengths: Optional[torch.Tensor] = None,
                norm_var: bool = True, eps: float = 1e-8
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B, N) waveform -> ((B, T, n_mels) CMVN'd log-mel, (B, T) mask).

    CPU tensors run the plain version; CUDA tensors launch the forward
    kernel of ``csrc/fbank.cu`` or raise. Inference only: it raises under
    autograd (``fbank_fused_trainable`` is the differentiable form).
    """
    check_no_grad("fbank_fused", wav)
    _check_cfg(cfg)
    t = fbank_ref.num_frames(wav.shape[-1], cfg)
    if t == 0:
        return _empty(wav, cfg)
    n_valid = valid_frames(wav, cfg, wav_lengths)
    return _forward(wav, n_valid, cfg, norm_var, eps), _mask(n_valid, t)


fbank_fused.launches = 0


@traced("rg.op.fbank_fused_bwd")
def fbank_fused_bwd(wav: torch.Tensor, n_valid: torch.Tensor,
                    g: torch.Tensor, cfg: FrontendConfig,
                    norm_var: bool = True, eps: float = 1e-8) -> torch.Tensor:
    """Kernel wrapper of the backward, same contract as
    ``fbank_fused_bwd_plain``: CPU tensors run the plain version, CUDA
    tensors launch the backward kernels of ``csrc/fbank.cu`` or raise."""
    _check_backward_cfg(cfg)
    if not on_cuda(wav, n_valid, g):
        return fbank_fused_bwd_plain(wav, n_valid, g, cfg, norm_var, eps)
    wav = wav.contiguous()
    plan = _route_plan(wav, cfg)
    bplan = _bwd_route_plan(wav, cfg, plan)
    _check_kernel_inputs(wav, cfg, True, plan, bplan)
    b, n = wav.shape
    t = fbank_ref.num_frames(n, cfg)
    check(g.shape == (b, t, cfg.n_mels), f"g shape {tuple(g.shape)}")
    bases, route = _logmel_args(wav, cfg, plan)
    transposed = device_bases(cfg, wav.device)[3:]
    n_valid = n_valid.to(torch.int32).contiguous()
    g = g.float().contiguous()
    feats = torch.empty_like(g)
    dfeats = torch.empty_like(g)
    dframes = torch.empty((b, t, cfg.frame_length), dtype=torch.float32,
                          device=wav.device)
    dwav = torch.empty_like(wav)
    if bplan is None:
        frame_pass, res, melr = [None] * 3, None, None
    else:  # the recompute's band spectra and mel, for the frame pass
        frame_pass = [x.data_ptr() for x in tc_bwd_bases(cfg, wav.device)]
        res = torch.empty((b, t, 2 * bplan.nbins), dtype=torch.float32,
                          device=wav.device)
        melr = torch.empty_like(g)
    launch("fbank_bwd", wav.data_ptr(), n_valid.data_ptr(), *bases,
           *(x.data_ptr() for x in transposed), *frame_pass, g.data_ptr(),
           feats.data_ptr(), dfeats.data_ptr(),
           None if res is None else res.data_ptr(),
           None if melr is None else melr.data_ptr(), dframes.data_ptr(),
           dwav.data_ptr(), b, n, t, cfg.frame_length, cfg.frame_shift,
           cfg.n_freqs, cfg.n_mels, *route, 0 if bplan is None else bplan.smem,
           cfg.log_floor, int(norm_var), eps,
           torch.cuda.current_stream(wav.device).cuda_stream)
    fbank_fused_bwd.launches += 1
    FBANK_BWD_ROUTE_LAUNCHES["simt" if bplan is None else "tc"] += 1
    return dwav


fbank_fused_bwd.launches = 0


class _FbankFusedFn(torch.autograd.Function):
    """Forward kernel, backward kernel (plain versions on CPU tensors)."""

    @staticmethod
    def forward(ctx, wav, n_valid, cfg, norm_var, eps):
        ctx.save_for_backward(wav, n_valid)
        ctx.args = (cfg, norm_var, eps)
        return _forward(wav, n_valid, cfg, norm_var, eps)

    @staticmethod
    def backward(ctx, g):
        wav, n_valid = ctx.saved_tensors
        dwav = fbank_fused_bwd(wav, n_valid, g, *ctx.args)
        return dwav.to(wav.dtype), None, None, None, None


def fbank_fused_trainable(wav: torch.Tensor, cfg: FrontendConfig,
                          wav_lengths: Optional[torch.Tensor] = None,
                          norm_var: bool = True, eps: float = 1e-8
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``fbank_fused``, differentiable with respect to the waveform through
    the backward kernel. Same outputs as ``fbank_fused``."""
    _check_backward_cfg(cfg)
    t = fbank_ref.num_frames(wav.shape[-1], cfg)
    if t == 0:
        return _empty(wav, cfg)
    n_valid = valid_frames(wav, cfg, wav_lengths)
    feats = _FbankFusedFn.apply(wav, n_valid, cfg, norm_var, eps)
    return feats, _mask(n_valid, t)
