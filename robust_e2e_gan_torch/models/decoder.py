"""Attention decoder: teacher-forced training loop, decode-time step API
and the cross-entropy loss.

Port of ``robust_e2e_gan_tpu/models/decoder.py``: ``DecoderStep``'s beam
and non-beam steps; ``Decoder``'s teacher-forced loop over ``ys_in`` (the
JAX ``nn.scan``, here a Python loop over the same step), with scheduled
sampling, ``initial_carry``, ``project_encoder`` and ``step``; and
``decoder_cross_entropy``. With ``DecoderConfig.step_impl="fused"`` the
beam step hands the attention a step pack and runs attention, embedding,
cell and readout in one kernel (``ops/att_dec.py``). flax's ``DenseIO``
readout is a ``Dense`` here (same parameters and rounding points). The
carry is (h (L, N, H) f32, c (L, N, H) f32, att (N, T),
prev_pred (N,) int32), as in the JAX package. ``DecoderConfig.dropout_rate``
is read nowhere in the JAX decoder, so none is applied here either.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from robust_e2e_gan_torch.config import AttentionConfig, DecoderConfig
from robust_e2e_gan_torch.models.attention import (
    EncoderProjection,
    initial_alignment,
    make_attention,
)
from robust_e2e_gan_torch.models.layers import Dense, Embed
from robust_e2e_gan_torch.models.rnn import LSTMCell
from robust_e2e_gan_torch.parallel.sharding import mean_denominator, rows_rand
from robust_e2e_gan_torch.utils.impl import kernel_enabled


class DecoderStep(nn.Module):
    """One decode step on raw token ids: embedding, attention with
    s_{t-1}, LSTM update, output logits."""

    def __init__(self, dcfg: DecoderConfig, acfg: AttentionConfig,
                 enc_dim: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.num_layers = dcfg.num_layers
        self.dtype = dtype
        kernel_enabled(dcfg.step_impl)  # unknown values raise
        # the JAX gate (models/decoder.py:160-178): "fused" alone selects
        # the fused step, and only for its structure; the attention takes
        # it only with a kernel score_impl
        self.fused_step = (dcfg.step_impl == "fused" and dcfg.num_layers == 1
                           and acfg.variant == "location")
        h = dcfg.hidden_dim
        self.embed = Embed(dcfg.vocab_size, dcfg.embed_dim, dtype)
        d = dcfg.embed_dim + enc_dim
        for i in range(dcfg.num_layers):
            self.add_module(f"lstm{i}", LSTMCell(d, h, dtype))
            d = h
        self.output = Dense(h + enc_dim, dcfg.vocab_size, dtype=dtype)
        self.att = make_attention(acfg, h, dtype)

    def forward(self, carry, tok, enc, enc_proj, enc_mask):
        h_prev, c_prev, att_prev, _ = carry
        emb = self.embed(torch.clamp_min(tok, 0))
        n, b = tok.shape[0], enc.shape[0]
        if n != b:
            # beam search: N = B*K hypothesis lanes share the B encoder rows
            k = n // b
            step_pack = None
            if self.fused_step:
                step_pack = {
                    "tok": torch.clamp_min(tok, 0).reshape(b, k),
                    "emb_table": self.embed.embedding,
                    "cell_wx": self.lstm0.wx, "cell_wh": self.lstm0.wh,
                    "cell_bias": self.lstm0.bias,
                    "out_w": self.output.kernel, "out_b": self.output.bias,
                    "z_prev": h_prev[-1].reshape(b, k, -1),
                    "c_prev": c_prev[-1].reshape(b, k, -1),
                }
            res = self.att(enc, enc_proj, enc_mask,
                           h_prev[-1].reshape(b, k, -1),
                           att_prev.reshape(b, k, -1), step_pack=step_pack)
            if len(res) == 4:
                logits, att, z_new, c_new = res
                # the readout's rounding point in the compute dtype, as JAX
                logits = logits.reshape(n, -1).to(self.dtype)
                att = att.reshape(n, -1).to(att_prev.dtype)
                new_pred = torch.argmax(logits, dim=-1).to(torch.int32)
                return ((z_new.reshape(1, n, -1), c_new.reshape(1, n, -1),
                         att, new_pred), (logits, att))
            ctx, att = res
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

    def forward(self, enc: torch.Tensor, enc_mask: torch.Tensor,
                ys_in: torch.Tensor, deterministic: bool = True,
                gen: Optional[torch.Generator] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Teacher forcing over (B, S) inputs -> (logits (B, S, V),
        attentions (B, S, T)).

        Scheduled sampling (training only): each step feeds back the
        previous step's argmax instead of the gold token with probability
        ``sampling_probability``, a Bernoulli draw per row from ``gen``;
        never at step 0, where the previous prediction is the -1 sentinel.
        """
        b, s = ys_in.shape
        p = 0.0 if deterministic else self.dcfg.sampling_probability
        enc_proj = self.enc_projection(enc)
        carry = self.initial_carry(b, enc_mask)
        logits, atts = [], []
        for i in range(s):
            tok = ys_in[:, i].to(torch.int32)
            if p > 0.0:
                draw = rows_rand((b,), gen, tok.device) < p
                prev = carry[3]
                tok = torch.where(draw & (prev >= 0), prev, tok)
            carry, (lg, att) = self.step_mod(carry, tok, enc, enc_proj,
                                             enc_mask)
            logits.append(lg)
            atts.append(att)
        return torch.stack(logits, dim=1), torch.stack(atts, dim=1)

    def project_encoder(self, enc: torch.Tensor) -> torch.Tensor:
        return self.enc_projection(enc)

    def step(self, carry, tokens, enc, enc_proj, enc_mask):
        """One decode step on raw token ids (beam-search entry point)."""
        return self.step_mod(carry, tokens, enc, enc_proj, enc_mask)


def decoder_cross_entropy(logits: torch.Tensor, ys_out: torch.Tensor,
                          ignore_id: int = -1, label_smoothing: float = 0.0
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Masked cross entropy with label smoothing, normalised per valid
    token -> (loss, accuracy). Under a data mesh the valid tokens are
    counted over the global batch (``parallel/sharding.py``)."""
    valid = (ys_out != ignore_id).float()
    targets = torch.clamp_min(ys_out, 0).long()
    lp = torch.log_softmax(logits.float(), dim=-1)
    nll = -torch.gather(lp, -1, targets[..., None])[..., 0]
    if label_smoothing > 0.0:
        smooth = -lp.mean(dim=-1)
        nll = (1.0 - label_smoothing) * nll + label_smoothing * smooth
    denom = mean_denominator(valid.sum())
    loss = (nll * valid).sum() / denom
    pred = torch.argmax(logits, dim=-1)
    acc = ((pred == targets).float() * valid).sum() / denom
    return loss, acc
