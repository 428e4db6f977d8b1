"""Attention decoder: the decode-time step API.

Port of the serving half of ``robust_e2e_gan_tpu/models/decoder.py``:
``DecoderStep``'s beam and non-beam steps, and ``Decoder``'s
``initial_carry``, ``project_encoder`` and ``step``. The teacher-forced
scan, scheduled sampling and the fused full-step kernel are not ported
yet. flax's ``DenseIO`` readout is a ``Dense`` here (same parameters and
rounding points). The carry is (h (L, N, H) f32, c (L, N, H) f32, att (N, T),
prev_pred (N,) int32), as in the JAX package.
"""

from __future__ import annotations

import torch
from torch import nn

from robust_e2e_gan_torch.config import AttentionConfig, DecoderConfig
from robust_e2e_gan_torch.models.attention import (
    AttLoc,
    EncoderProjection,
    initial_alignment,
)
from robust_e2e_gan_torch.models.layers import Dense, Embed
from robust_e2e_gan_torch.models.rnn import LSTMCell


class DecoderStep(nn.Module):
    """One decode step on raw token ids: embedding, attention with
    s_{t-1}, LSTM update, output logits."""

    def __init__(self, dcfg: DecoderConfig, acfg: AttentionConfig,
                 enc_dim: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.num_layers = dcfg.num_layers
        h = dcfg.hidden_dim
        self.embed = Embed(dcfg.vocab_size, dcfg.embed_dim, dtype)
        d = dcfg.embed_dim + enc_dim
        for i in range(dcfg.num_layers):
            self.add_module(f"lstm{i}", LSTMCell(d, h, dtype))
            d = h
        self.output = Dense(h + enc_dim, dcfg.vocab_size, dtype=dtype)
        self.att = AttLoc(acfg, h, dtype)

    def forward(self, carry, tok, enc, enc_proj, enc_mask):
        h_prev, c_prev, att_prev, _ = carry
        emb = self.embed(torch.clamp_min(tok, 0))
        n, b = tok.shape[0], enc.shape[0]
        if n != b:
            # beam search: N = B*K hypothesis lanes share the B encoder rows
            k = n // b
            ctx, att = self.att(enc, enc_proj, enc_mask,
                                h_prev[-1].reshape(b, k, -1),
                                att_prev.reshape(b, k, -1))
            ctx, att = ctx.reshape(n, -1), att.reshape(n, -1)
        else:
            ctx, att = self.att(enc, enc_proj, enc_mask, h_prev[-1], att_prev)
        inp = torch.cat([emb, ctx], dim=-1)
        hs, cs = [], []
        for i in range(self.num_layers):
            (h_new, c_new), inp = getattr(self, f"lstm{i}")(
                (h_prev[i], c_prev[i]), inp)
            hs.append(h_new)
            cs.append(c_new)
        # (f32 state, compute-dtype context) -> f32, as JAX promotes
        logits = self.output(torch.cat([inp, ctx.to(inp.dtype)], dim=-1))
        new_pred = torch.argmax(logits, dim=-1).to(torch.int32)
        return (torch.stack(hs), torch.stack(cs), att, new_pred), (logits, att)


class Decoder(nn.Module):
    """The decode-time API of the attention decoder."""

    def __init__(self, dcfg: DecoderConfig, acfg: AttentionConfig,
                 enc_dim: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dcfg = dcfg
        self.enc_projection = EncoderProjection(acfg, enc_dim, dtype)
        self.step_mod = DecoderStep(dcfg, acfg, enc_dim, dtype)

    def initial_carry(self, batch: int, enc_mask: torch.Tensor):
        h0 = torch.zeros((self.dcfg.num_layers, batch, self.dcfg.hidden_dim),
                         device=enc_mask.device)
        prev_pred = torch.full((batch,), -1, dtype=torch.int32,
                               device=enc_mask.device)
        return (h0, h0, initial_alignment(enc_mask), prev_pred)

    def project_encoder(self, enc: torch.Tensor) -> torch.Tensor:
        return self.enc_projection(enc)

    def step(self, carry, tokens, enc, enc_proj, enc_mask):
        """One decode step on raw token ids (beam-search entry point)."""
        return self.step_mod(carry, tokens, enc, enc_proj, enc_mask)
