"""Hybrid CTC/attention E2E model: the decode entry points.

Port of ``CTCHead`` and the decode-time methods of ``E2E`` in
``robust_e2e_gan_tpu/models/e2e.py``. The losses are training and are not
ported yet.
"""

from __future__ import annotations

import torch
from torch import nn

from robust_e2e_gan_torch.config import E2EConfig
from robust_e2e_gan_torch.models.decoder import Decoder
from robust_e2e_gan_torch.models.encoder import Encoder
from robust_e2e_gan_torch.models.layers import Dense


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
