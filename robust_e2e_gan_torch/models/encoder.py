"""ASR encoder: VGG conv frontend + projected BLSTM stack.

Port of ``robust_e2e_gan_tpu/models/encoder.py``. The convolutions run in
NCHW with ``F.conv2d`` (XLA convolutions in the JAX package, not Pallas);
the SAME 2x2 max pools are ``ceil_mode`` pools, so subsampled lengths are
ceil(ceil(T/2)/2). The flattened output keeps the JAX layout: (T', D' * C)
with the channel fastest.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from robust_e2e_gan_torch.config import EncoderConfig
from robust_e2e_gan_torch.models.layers import Conv2d
from robust_e2e_gan_torch.models.rnn import BLSTMP
from robust_e2e_gan_torch.utils.trace import span


def subsampled_lengths(lengths: torch.Tensor) -> torch.Tensor:
    """Length transform of the two ceil-mode 2x2 max pools."""
    return (torch.div(lengths + 1, 2, rounding_mode="floor") + 1).div(
        2, rounding_mode="floor")


def subsampled_frames(t: int) -> int:
    return ((t + 1) // 2 + 1) // 2


class VGG2L(nn.Module):
    """Two VGG blocks over (B, T, D) as a one-channel image ->
    (B, T', D' * channels[-1])."""

    def __init__(self, channels: Tuple[int, int], dtype: torch.dtype):
        super().__init__()
        self.dtype = dtype
        self.channels = tuple(channels)
        c_in = 1
        for i, ch in enumerate(self.channels):
            self.add_module(f"conv{i}_1", Conv2d(c_in, ch, dtype))
            self.add_module(f"conv{i}_2", Conv2d(ch, ch, dtype))
            c_in = ch

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = x[:, None].to(self.dtype)  # (B, 1, T, D)
        for i in range(len(self.channels)):
            h = F.relu(getattr(self, f"conv{i}_1")(h))
            h = F.relu(getattr(self, f"conv{i}_2")(h))
            h = F.max_pool2d(h, 2, 2, ceil_mode=True)
        b, c, t, d = h.shape
        return h.permute(0, 2, 3, 1).reshape(b, t, d * c)


class Encoder(nn.Module):
    """VGG2L -> BLSTMP; returns (hs, hmask, hlens)."""

    def __init__(self, cfg: EncoderConfig, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.vgg = VGG2L(cfg.vgg_channels, dtype)
        d_vgg = subsampled_frames(cfg.input_dim) * cfg.vgg_channels[-1]
        self.blstmp = BLSTMP(d_vgg, cfg.num_layers, cfg.hidden_dim,
                             cfg.proj_dim, dtype, cfg.lstm_impl,
                             cfg.dropout_rate, cfg.gate_storage)

    def forward(self, feats: torch.Tensor,
                feat_lengths: Optional[torch.Tensor] = None,
                deterministic: bool = True,
                gen: Optional[torch.Generator] = None):
        b = feats.shape[0]
        with span("rg.encode.vgg"):
            h = self.vgg(feats)
            tt = h.shape[1]
            if feat_lengths is None:
                hlens = torch.full((b,), tt, dtype=torch.int32,
                                   device=h.device)
            else:
                hlens = subsampled_lengths(feat_lengths.to(torch.int32))
            hmask = (torch.arange(tt, device=h.device)[None, :]
                     < hlens[:, None]).to(h.dtype)
            h = h * hmask[..., None]
        with span("rg.encode.blstmp"):
            return self.blstmp(h, hmask, deterministic, gen), hmask, hlens
