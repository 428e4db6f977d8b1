"""Speech-enhancement GAN: mask-estimating generator, conv discriminator,
and the adversarial and reconstruction losses.

Port of ``robust_e2e_gan_tpu/models/enhancement.py``: a BLSTM stack over
the compressed noisy power spectrum estimates a sigmoid T-F mask, which
multiplies the linear-domain spectrum (``EnhanceNet``); strided SAME convs
with leaky ReLU and valid-frame mean pooling score a log-mel map
(``Discriminator``); ``adversarial_losses`` (lsgan, bce) and
``enhancement_loss`` (l2, l1 on log1p spectra).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from robust_e2e_gan_torch.config import DiscriminatorConfig, EnhancerConfig
from robust_e2e_gan_torch.models.layers import Conv2d, Dense
from robust_e2e_gan_torch.models.rnn import BLSTM
from robust_e2e_gan_torch.parallel.sharding import mean_denominator


class EnhanceNet(nn.Module):
    """(B, T, F) power -> (enhanced power, T-F mask), both float32."""

    def __init__(self, cfg: EnhancerConfig,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.cfg = cfg
        d = cfg.input_dim
        for i in range(cfg.num_layers):
            self.add_module(
                f"blstm{i}", BLSTM(d, cfg.hidden_dim, dtype, cfg.lstm_impl,
                                   cfg.gate_storage)
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


class Discriminator(nn.Module):
    """Conv discriminator over (B, T, D) feature maps -> (B,) scores.

    Pad frames are zeroed before the convs; after them, the frames past
    each utterance's subsampled length are left out of the mean pooling,
    so the score does not depend on the padding.
    """

    def __init__(self, cfg: DiscriminatorConfig,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.cfg = cfg
        self.dtype = dtype
        c_in, d = 1, cfg.input_dim
        for i, ch in enumerate(cfg.channels):
            self.add_module(f"conv{i}", Conv2d(c_in, ch, dtype, cfg.kernel,
                                               stride=2))
            c_in, d = ch, (d + 1) // 2
        self.out = Dense(d * c_in, 1, dtype=dtype)

    def forward(self, feats: torch.Tensor,
                frame_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        if frame_mask is not None:
            feats = feats * frame_mask[..., None].to(feats.dtype)
        h = feats[:, None].to(self.dtype)  # (B, 1, T, D)
        for i in range(len(self.cfg.channels)):
            h = getattr(self, f"conv{i}")(h)
            # jax.nn.leaky_relu: slope 1 at exactly 0 (pad frames, where
            # every input of a position is zero), unlike F.leaky_relu
            h = torch.where(h >= 0, h, 0.2 * h)
        b, c, tt, dd = h.shape
        h = h.permute(0, 2, 3, 1).reshape(b, tt, dd * c)  # JAX (T', D'*C)
        if frame_mask is not None:
            sub_len = frame_mask.sum(dim=1).to(torch.int32)
            for _ in self.cfg.channels:
                sub_len = torch.div(sub_len + 1, 2, rounding_mode="floor")
            m = (torch.arange(tt, device=h.device)[None, :]
                 < sub_len[:, None]).to(h.dtype)
            h = h * m[..., None]
            pooled = h.sum(dim=1) / torch.clamp_min(m.sum(dim=1, keepdim=True),
                                                    1.0)
        else:
            pooled = h.mean(dim=1)
        return self.out(pooled)[..., 0]


def adversarial_losses(d_real: torch.Tensor, d_fake: torch.Tensor,
                       loss_type: str = "lsgan"
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(loss_D, loss_G_adv). lsgan: D (D(x)-1)^2 + D(G)^2, G (D(G)-1)^2,
    both halved; bce: sigmoid cross entropy."""
    if loss_type == "lsgan":
        loss_d = 0.5 * (torch.mean((d_real - 1.0) ** 2)
                        + torch.mean(d_fake ** 2))
        loss_g = 0.5 * torch.mean((d_fake - 1.0) ** 2)
    elif loss_type == "bce":
        loss_d = torch.mean(F.softplus(-d_real)) + torch.mean(F.softplus(d_fake))
        loss_g = torch.mean(F.softplus(-d_fake))
    else:
        raise ValueError(f"unknown gan loss {loss_type!r}")
    return loss_d, loss_g


def enhancement_loss(enhanced: torch.Tensor, clean: torch.Tensor,
                     frame_mask: Optional[torch.Tensor] = None,
                     kind: str = "l2", compress: bool = True) -> torch.Tensor:
    """Reconstruction term L_enh(enhanced, clean), on log1p-compressed
    spectra by default, averaged over valid frames and bins (under a data
    mesh, the valid frames of the global batch)."""
    if compress:
        enhanced = torch.log1p(torch.clamp_min(enhanced, 0.0))
        clean = torch.log1p(torch.clamp_min(clean, 0.0))
    diff = enhanced - clean
    per = torch.abs(diff) if kind == "l1" else torch.square(diff)
    if frame_mask is None:
        return per.mean()
    m = frame_mask[..., None].to(per.dtype)
    return (per * m).sum() / mean_denominator(m.sum() * per.shape[-1])
