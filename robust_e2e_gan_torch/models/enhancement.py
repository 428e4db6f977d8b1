"""Mask-estimating BLSTM enhancement generator.

Port of ``EnhanceNet`` in ``robust_e2e_gan_tpu/models/enhancement.py``: a
BLSTM stack over the compressed noisy power spectrum estimates a sigmoid
T-F mask, which multiplies the linear-domain spectrum. The discriminator
is training-only and is not ported yet.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from robust_e2e_gan_torch.config import EnhancerConfig
from robust_e2e_gan_torch.models.layers import Dense
from robust_e2e_gan_torch.models.rnn import BLSTM


class EnhanceNet(nn.Module):
    """(B, T, F) power -> (enhanced power, T-F mask), both float32."""

    def __init__(self, cfg: EnhancerConfig,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.cfg = cfg
        d = cfg.input_dim
        for i in range(cfg.num_layers):
            self.add_module(
                f"blstm{i}", BLSTM(d, cfg.hidden_dim, dtype, cfg.lstm_impl)
            )
            d = 2 * cfg.hidden_dim
        self.mask_out = Dense(d, cfg.input_dim, dtype=dtype)

    def forward(self, noisy_power: torch.Tensor,
                frame_mask: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        cfg = self.cfg
        if cfg.compression == "log1p":
            x = torch.log1p(noisy_power)
        elif cfg.compression == "log":
            x = torch.log(torch.clamp_min(noisy_power, 1e-7))
        else:
            x = noisy_power
        h = x
        for i in range(cfg.num_layers):
            h = getattr(self, f"blstm{i}")(h, frame_mask)
        tf_mask = torch.sigmoid(self.mask_out(h))
        if cfg.mask_floor > 0.0:
            tf_mask = cfg.mask_floor + (1.0 - cfg.mask_floor) * tf_mask
        enhanced = tf_mask * noisy_power
        if frame_mask is not None:
            fm = frame_mask[..., None].to(enhanced.dtype)
            enhanced = enhanced * fm
            tf_mask = tf_mask * fm
        return enhanced, tf_mask
