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
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

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
    on_cuda,
)

# DFT bins (and, in the backward, frame samples) one block covers, a
# thread each (csrc/fbank.cu)
MAX_THREADS = 512
TT, TS = 32, 36  # frames per block and the stride of their transposed tile


def combined_bases(cfg: FrontendConfig) -> Tuple[np.ndarray, ...]:
    """DC removal, pre-emphasis and window folded into the DFT bases.

    Returns float32 (M_cos (L, n_freqs), M_sin (L, n_freqs), fb (n_freqs,
    n_mels)): frame @ M_cos is the real part of the windowed DFT of the
    preprocessed frame.
    """
    n = cfg.frame_length
    w = fbank_ref.window_fn(cfg).astype(np.float64)
    # frame' = diag(w) @ P @ A @ frame: DC, pre-emphasis, window, in the
    # order of ops.fbank._preprocess_frames
    a = np.eye(n) - (np.ones((n, n)) / n if cfg.remove_dc else 0.0)
    p = np.eye(n)
    if cfg.preemphasis > 0.0:
        p = p - cfg.preemphasis * np.diag(np.ones(n - 1), k=-1)
        p[0, 0] -= cfg.preemphasis  # x'[0] = x[0] - p * x[0]
    t_pre = np.diag(w) @ p @ a
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
    gm = torch.where(valid, g.float(), 0.0)
    if norm_var:
        var = (c * c).sum(dim=1, keepdim=True) / denom
        s = torch.rsqrt(var + eps)
        dvar = (gm * c).sum(dim=1, keepdim=True) * (-0.5) * s * s * s
        dc = gm * s + (2.0 / denom) * c * dvar
    else:
        dc = gm
    dfeats = torch.where(valid, dc - dc.sum(dim=1, keepdim=True) / denom, 0.0)
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


def _check_kernel_inputs(wav, cfg, backward: bool):
    """The kernels' limits: a thread per DFT bin (and, in the backward, per
    frame sample) in one block, and the blocks' shared memory."""
    check(wav.dtype == torch.float32 and wav.dim() == 2,
          f"wav must be (B, N) float32, got {tuple(wav.shape)} {wav.dtype}")
    per_thread = (max(cfg.n_freqs, cfg.frame_length) if backward
                  else cfg.n_freqs)
    check(per_thread <= MAX_THREADS,
          f"n_fft // 2 + 1 = {cfg.n_freqs}"
          f"{f' and frame_length = {cfg.frame_length}' if backward else ''} "
          f"must be <= {MAX_THREADS} (one thread each in a block)")
    if backward:
        smem = 4 * (max(cfg.frame_length, 2 * cfg.n_freqs) * TS
                    + TT * cfg.n_freqs + cfg.n_mels * TS)
    else:
        smem = 4 * max(cfg.frame_length * TS, TT * cfg.n_freqs)
    check(smem <= SMEM_LIMIT, f"a block needs {smem} bytes of shared memory, "
          f"more than {SMEM_LIMIT}")
    check(cfg.n_mels <= 1024, f"n_mels={cfg.n_mels} > 1024")


def _forward_kernel(wav, n_valid, cfg, norm_var, eps):
    _check_kernel_inputs(wav, cfg, backward=False)
    b, n = wav.shape
    t = fbank_ref.num_frames(n, cfg)
    m_cos, m_sin, fb = device_bases(cfg, wav.device)[:3]
    wav = wav.contiguous()
    n_valid = n_valid.to(torch.int32).contiguous()
    out = torch.empty((b, t, cfg.n_mels), dtype=torch.float32,
                      device=wav.device)
    launch("fbank_fwd", wav.data_ptr(), n_valid.data_ptr(), m_cos.data_ptr(),
           m_sin.data_ptr(), fb.data_ptr(), out.data_ptr(), b, n, t,
           cfg.frame_length, cfg.frame_shift, cfg.n_freqs, cfg.n_mels,
           cfg.log_floor, int(cfg.use_power), int(norm_var), eps,
           torch.cuda.current_stream(wav.device).cuda_stream)
    fbank_fused.launches += 1
    return out


def _forward(wav, n_valid, cfg, norm_var, eps):
    if on_cuda(wav, n_valid):
        return _forward_kernel(wav, n_valid, cfg, norm_var, eps)
    return _forward_plain(wav, n_valid, cfg, norm_var, eps)


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


def fbank_fused_bwd(wav: torch.Tensor, n_valid: torch.Tensor,
                    g: torch.Tensor, cfg: FrontendConfig,
                    norm_var: bool = True, eps: float = 1e-8) -> torch.Tensor:
    """Kernel wrapper of the backward, same contract as
    ``fbank_fused_bwd_plain``: CPU tensors run the plain version, CUDA
    tensors launch the backward kernels of ``csrc/fbank.cu`` or raise."""
    _check_backward_cfg(cfg)
    if not on_cuda(wav, n_valid, g):
        return fbank_fused_bwd_plain(wav, n_valid, g, cfg, norm_var, eps)
    _check_kernel_inputs(wav, cfg, backward=True)
    b, n = wav.shape
    t = fbank_ref.num_frames(n, cfg)
    check(g.shape == (b, t, cfg.n_mels), f"g shape {tuple(g.shape)}")
    bases = device_bases(cfg, wav.device)
    wav = wav.contiguous()
    n_valid = n_valid.to(torch.int32).contiguous()
    g = g.float().contiguous()
    feats = torch.empty_like(g)
    dfeats = torch.empty_like(g)
    dframes = torch.empty((b, t, cfg.frame_length), dtype=torch.float32,
                          device=wav.device)
    dwav = torch.empty_like(wav)
    launch("fbank_bwd", wav.data_ptr(), n_valid.data_ptr(),
           *(x.data_ptr() for x in bases), g.data_ptr(), feats.data_ptr(),
           dfeats.data_ptr(), dframes.data_ptr(), dwav.data_ptr(), b, n, t,
           cfg.frame_length, cfg.frame_shift, cfg.n_freqs, cfg.n_mels,
           cfg.log_floor, int(norm_var), eps,
           torch.cuda.current_stream(wav.device).cuda_stream)
    fbank_fused_bwd.launches += 1
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
