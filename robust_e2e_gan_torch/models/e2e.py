"""Hybrid CTC/attention E2E model.

Port of ``robust_e2e_gan_tpu/models/e2e.py``: ``add_sos_eos``,
``CTCHead``, and ``E2E`` with its loss (``forward``: mtlalpha * CTC +
(1 - mtlalpha) * attention cross entropy) and decode-time methods. Label
padding is ``ignore_id``; <sos> and <eos> share one id.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch import nn

from robust_e2e_gan_torch.config import E2EConfig
from robust_e2e_gan_torch.models.decoder import Decoder, decoder_cross_entropy
from robust_e2e_gan_torch.models.encoder import Encoder
from robust_e2e_gan_torch.models.layers import Dense
from robust_e2e_gan_torch.ops.ctc import ctc_loss


def add_sos_eos(ys_pad: torch.Tensor, sos: int, eos: int,
                ignore_id: int = -1
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(B, S) padded labels -> (ys_in (B, S+1), ys_out (B, S+1), lengths):
    ys_in = [sos, y1..yS, 0...], ys_out = [y1..yS, eos, ignore...]."""
    b, s = ys_pad.shape
    lengths = (ys_pad != ignore_id).sum(dim=1)
    ys_in = torch.cat([torch.full((b, 1), sos, dtype=ys_pad.dtype,
                                  device=ys_pad.device),
                       torch.where(ys_pad == ignore_id, 0, ys_pad)], dim=1)
    pos = torch.arange(s + 1, device=ys_pad.device)[None, :]
    padded = torch.cat([ys_pad, torch.full((b, 1), ignore_id,
                                           dtype=ys_pad.dtype,
                                           device=ys_pad.device)], dim=1)
    ys_out = torch.where(pos == lengths[:, None], eos, padded)
    ys_out = torch.where(pos > lengths[:, None], ignore_id, ys_out)
    return ys_in, ys_out, lengths


class CTCHead(nn.Module):
    """Linear projection encoder -> vocab."""

    def __init__(self, enc_dim: int, vocab: int, dtype: torch.dtype):
        super().__init__()
        self.ctc_lo = Dense(enc_dim, vocab, dtype=dtype)

    def forward(self, hs: torch.Tensor) -> torch.Tensor:
        return self.ctc_lo(hs)


class E2E(nn.Module):
    """Encoder, CTC head and attention decoder."""

    def __init__(self, cfg: E2EConfig, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.cfg = cfg
        enc_dim = cfg.encoder.proj_dim
        self.encoder = Encoder(cfg.encoder, dtype)
        self.ctc = CTCHead(enc_dim, cfg.decoder.vocab_size, dtype)
        self.decoder = Decoder(cfg.decoder, cfg.attention, enc_dim, dtype)

    def forward(self, feats: torch.Tensor, feat_lengths: torch.Tensor,
                ys_pad: torch.Tensor, deterministic: bool = True,
                rngs: Optional[Dict[str, torch.Generator]] = None
                ) -> Dict[str, torch.Tensor]:
        """-> {"loss", "loss_ctc", "loss_att", "acc"}. ``rngs`` holds the
        "dropout" and "sampling" generators of a training forward."""
        cfg = self.cfg
        rngs = rngs or {}
        hs, hmask, hlens = self.encoder(feats, feat_lengths, deterministic,
                                        rngs.get("dropout"))
        label_lengths = (ys_pad != cfg.ignore_id).sum(dim=1)
        loss_ctc = ctc_loss(
            self.ctc(hs), hlens, torch.where(ys_pad == cfg.ignore_id, 0, ys_pad),
            label_lengths, blank_id=cfg.blank_id, reduction="mean",
            impl=cfg.ctc_impl)
        ys_in, ys_out, _ = add_sos_eos(ys_pad, cfg.sos_id, cfg.eos_id,
                                       cfg.ignore_id)
        logits, _ = self.decoder(hs, hmask, ys_in, deterministic,
                                 rngs.get("sampling"))
        loss_att, acc = decoder_cross_entropy(
            logits, ys_out, cfg.ignore_id, cfg.decoder.label_smoothing)
        loss = cfg.mtlalpha * loss_ctc + (1.0 - cfg.mtlalpha) * loss_att
        return {"loss": loss, "loss_ctc": loss_ctc, "loss_att": loss_att,
                "acc": acc}

    def encode(self, feats, feat_lengths):
        return self.encoder(feats, feat_lengths)

    def ctc_logits(self, hs):
        return self.ctc(hs)

    def decoder_project_encoder(self, hs):
        return self.decoder.project_encoder(hs)

    def decoder_step(self, carry, tokens, enc, enc_proj, enc_mask):
        return self.decoder.step(carry, tokens, enc, enc_proj, enc_mask)

    def decoder_initial_carry(self, batch: int, enc_mask):
        return self.decoder.initial_carry(batch, enc_mask)
