"""Feature frontend: framing -> STFT power -> log-mel -> CMVN.

Port of ``robust_e2e_gan_tpu/ops/fbank.py`` with the same Kaldi semantics
(snip-edges framing, dither 0, per-frame DC removal, in-frame
pre-emphasis, povey window, power spectrum, natural log with the
FLT_EPSILON floor). The DFT is two real matrix products against cos/sin
bases, as in the JAX package.

Everything stays float32. The JAX package pins these products to HIGHEST
precision; on the card that is float32 matmul with TF32 off, which is
PyTorch's default (``torch.backends.cuda.matmul.allow_tf32 = False``).
Callers that turn TF32 on lose about three decimal digits here.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import numpy as np
import torch

from robust_e2e_gan_torch.config import FrontendConfig


def num_frames(num_samples: int, cfg: FrontendConfig) -> int:
    """Kaldi snip-edges frame count: 1 + floor((N - flen) / fshift)."""
    if num_samples < cfg.frame_length:
        return 0
    return 1 + (num_samples - cfg.frame_length) // cfg.frame_shift


def window_fn(cfg: FrontendConfig) -> np.ndarray:
    """Analysis window; povey = hann ** 0.85 (Kaldi's fbank default)."""
    n = cfg.frame_length
    x = np.arange(n, dtype=np.float64)
    hann = 0.5 - 0.5 * np.cos(2.0 * np.pi * x / (n - 1))
    if cfg.window == "povey":
        w = hann ** 0.85
    elif cfg.window == "hann":
        w = hann
    elif cfg.window == "hamming":
        w = 0.54 - 0.46 * np.cos(2.0 * np.pi * x / (n - 1))
    else:
        raise ValueError(f"unknown window {cfg.window!r}")
    return w.astype(np.float32)


def dft_matrices(n_fft: int) -> Tuple[np.ndarray, np.ndarray]:
    """(n_fft, n_fft//2+1) real-DFT bases: cos and sin of -2 pi k j / n.
    The caller's own copies: a CPU tensor made from them by
    ``torch.from_numpy`` aliases them, and a write into the cached arrays
    would change every later call."""
    return tuple(x.copy() for x in _dft_matrices_np(n_fft))


@functools.lru_cache(maxsize=8)
def _dft_matrices_np(n_fft: int) -> Tuple[np.ndarray, np.ndarray]:
    k = np.arange(n_fft, dtype=np.float64)[:, None]
    f = np.arange(n_fft // 2 + 1, dtype=np.float64)[None, :]
    ang = -2.0 * np.pi * k * f / n_fft
    return np.cos(ang).astype(np.float32), np.sin(ang).astype(np.float32)


def _hz_to_mel(hz):
    return 1127.0 * np.log(1.0 + np.asarray(hz, dtype=np.float64) / 700.0)


@functools.lru_cache(maxsize=8)
def _mel_filterbank_np(n_mels, n_fft, sample_rate, f_min, f_max):
    n_freqs = n_fft // 2 + 1
    fft_mel = _hz_to_mel(np.arange(n_freqs, dtype=np.float64)
                         * sample_rate / n_fft)
    low, high = _hz_to_mel(f_min), _hz_to_mel(f_max)
    centers = np.linspace(low, high, n_mels + 2)
    left, mid, right = centers[:-2], centers[1:-1], centers[2:]
    up = (fft_mel[:, None] - left[None, :]) / (mid - left)[None, :]
    down = (right[None, :] - fft_mel[:, None]) / (right - mid)[None, :]
    return np.maximum(0.0, np.minimum(up, down)).astype(np.float32)


def mel_filterbank(cfg: FrontendConfig) -> np.ndarray:
    """Kaldi-style triangular mel filterbank, (n_freqs, n_mels): the
    caller's own copy, as ``dft_matrices``'."""
    f_max = cfg.f_max if cfg.f_max is not None else cfg.sample_rate / 2.0
    return _mel_filterbank_np(cfg.n_mels, cfg.n_fft, cfg.sample_rate,
                              cfg.f_min, float(f_max)).copy()


def frame_signal(wav: torch.Tensor, cfg: FrontendConfig) -> torch.Tensor:
    """(..., N) waveform -> (..., T, frame_length) frames (snip-edges)."""
    t = num_frames(wav.shape[-1], cfg)
    if t == 0:
        return wav.new_zeros(wav.shape[:-1] + (0, cfg.frame_length))
    return wav.unfold(-1, cfg.frame_length, cfg.frame_shift)


def _preprocess_frames(frames: torch.Tensor, cfg: FrontendConfig):
    """Per-frame DC removal, in-frame pre-emphasis, window (Kaldi order)."""
    if cfg.remove_dc:
        frames = frames - frames.mean(dim=-1, keepdim=True)
    if cfg.preemphasis > 0.0:
        prev = torch.cat([frames[..., :1], frames[..., :-1]], dim=-1)
        frames = frames - cfg.preemphasis * prev
    return frames * torch.from_numpy(window_fn(cfg)).to(frames.device)


def stft_power(wav: torch.Tensor, cfg: FrontendConfig) -> torch.Tensor:
    """(..., N) float32 waveform -> (..., T, n_freqs) power spectrum.

    The zero-padded tail of each frame contributes nothing, so the bases
    are cut to their first frame_length rows.
    """
    frames = _preprocess_frames(frame_signal(wav.float(), cfg), cfg)
    cos_m, sin_m = dft_matrices(cfg.n_fft)
    dev = frames.device
    re = frames @ torch.from_numpy(cos_m[: cfg.frame_length]).to(dev)
    im = frames @ torch.from_numpy(sin_m[: cfg.frame_length]).to(dev)
    power = re * re + im * im
    if not cfg.use_power:
        power = torch.sqrt(torch.clamp_min(power, 0.0))
    return power


def log_mel(power: torch.Tensor, cfg: FrontendConfig) -> torch.Tensor:
    """(..., T, n_freqs) power -> (..., T, n_mels) natural-log mel energies."""
    fb = torch.from_numpy(mel_filterbank(cfg)).to(power.device)
    return torch.log(torch.clamp_min(power @ fb, cfg.log_floor))


def utterance_cmvn(
    feats: torch.Tensor,
    frame_mask: Optional[torch.Tensor] = None,
    norm_var: bool = True,
    eps: float = 1e-8,
) -> torch.Tensor:
    """Per-utterance CMVN over valid frames of (B, T, D) features; pad
    frames are left out of the statistics and come out as exact zeros."""
    if frame_mask is None:
        mean = feats.mean(dim=-2, keepdim=True)
        var = torch.square(feats - mean).mean(dim=-2, keepdim=True)
        out = feats - mean
        return out * torch.rsqrt(var + eps) if norm_var else out
    m = frame_mask[..., None].to(feats.dtype)
    denom = torch.clamp_min(m.sum(dim=-2, keepdim=True), 1.0)
    mean = (feats * m).sum(dim=-2, keepdim=True) / denom
    var = (torch.square(feats - mean) * m).sum(dim=-2, keepdim=True) / denom
    out = feats - mean
    if norm_var:
        out = out * torch.rsqrt(var + eps)
    return out * m


def apply_cmvn(feats: torch.Tensor, mean: torch.Tensor,
               inv_std: torch.Tensor) -> torch.Tensor:
    """Apply precomputed (global) CMVN stats, Kaldi apply-cmvn style."""
    return (feats - mean) * inv_std


def frame_lengths_from_wav_lengths(wav_lengths: torch.Tensor,
                                   cfg: FrontendConfig) -> torch.Tensor:
    """Valid frame count of each waveform length."""
    return torch.clamp_min(
        torch.div(wav_lengths - cfg.frame_length, cfg.frame_shift,
                  rounding_mode="floor") + 1,
        0,
    )
