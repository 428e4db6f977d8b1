"""The attention variants and the encoder-side projection.

Port of ``robust_e2e_gan_tpu/models/attention.py``: AttLoc, AttAdd and
AttDot (each in beam and non-beam mode), ``ATTENTION_VARIANTS`` and
``make_attention``, ``initial_alignment`` and ``EncoderProjection``. The
location conv stays ``F.conv1d`` outside the kernel, as it stays an XLA
conv in the JAX package. Beam mode with the kernel impl runs the score,
softmax and context through ``ops/att.py``; non-beam mode (training,
streaming) always runs the plain form. Given a step pack in beam mode, the
kernel impl runs the whole decoder step through ``ops/att_dec.py`` instead
and returns its 4-tuple, as the JAX AttLoc does
(``models/attention.py:127-162``). AttAdd and AttDot are plain PyTorch:
no kernel covers them in either package (the attention kernel and the
fused step are location-only), so a decoder with either takes the
unfused step.
"""

from __future__ import annotations

from typing import Tuple

import torch
from torch import nn

from robust_e2e_gan_torch.config import AttentionConfig
from robust_e2e_gan_torch.models.layers import Conv1d, Dense
from robust_e2e_gan_torch.ops.att import (
    att_loc_step,
    att_loc_step_plain,
    finish,
)
from robust_e2e_gan_torch.ops.att_dec import att_dec_step
from robust_e2e_gan_torch.utils.impl import kernel_enabled


class AttLoc(nn.Module):
    """One attention step.

    enc (B, T, E), enc_proj (B, T, A), mask (B, T), dec_z (B, D) and
    att_prev (B, T) -> (ctx (B, E), att (B, T)); in beam mode dec_z is
    (B, K, D) and att_prev (B, K, T), and the K hypotheses of an utterance
    share its enc and enc_proj rows.
    """

    def __init__(self, cfg: AttentionConfig, dec_dim: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.cfg = cfg
        self.dtype = dtype
        self.use_kernel = kernel_enabled(cfg.score_impl)
        self.loc_conv = Conv1d(cfg.conv_channels, cfg.conv_kernel, dtype)
        self.mlp_loc = Dense(cfg.conv_channels, cfg.dim, bias=False,
                             dtype=dtype)
        self.mlp_dec = Dense(dec_dim, cfg.dim, bias=False, dtype=dtype)
        self.gvec = Dense(cfg.dim, 1, bias=False, dtype=dtype)

    def forward(self, enc, enc_proj, mask, dec_z, att_prev, step_pack=None
                ) -> Tuple[torch.Tensor, ...]:
        """``step_pack`` (beam mode, kernel impl only): the decoder-step
        tensors (tok, emb_table, cell_wx, cell_wh, cell_bias, out_w, out_b,
        z_prev, c_prev); then the whole step runs in one kernel and the
        result is (logits, att, z_new, c_new), all float32."""
        beam = dec_z.dim() == 3
        if not beam:  # one hypothesis per utterance: K = 1
            dec_z, att_prev = dec_z[:, None], att_prev[:, None]
        b, k, t = att_prev.shape
        dt = self.dtype
        # conv over the previous alignments: (B*K, 1, T) -> (B, K, T, C)
        feat = self.loc_conv(att_prev.reshape(b * k, 1, t))
        feat = feat.transpose(1, 2).reshape(b, k, t, -1)
        dec = self.mlp_dec(dec_z)
        args = (feat, enc_proj.to(dt), enc.to(dt), dec,
                self.mlp_loc.kernel.to(dt), self.gvec.kernel[:, 0].to(dt),
                mask, self.cfg.sharpening)
        if step_pack is not None and beam and self.use_kernel:
            sp = step_pack
            return att_dec_step(
                *args, sp["tok"], sp["emb_table"].to(dt),
                sp["cell_wx"].to(dt), sp["cell_wh"].to(dt), sp["cell_bias"],
                sp["out_w"].to(dt), sp["out_b"], sp["z_prev"], sp["c_prev"])
        step = (att_loc_step if beam and self.use_kernel
                else att_loc_step_plain)
        ctx, att = step(*args)
        ctx, att = ctx.to(enc.dtype), att.to(att_prev.dtype)
        return (ctx, att) if beam else (ctx[:, 0], att[:, 0])


class _ContentAttention(nn.Module):
    """The step the reference's AttAdd and AttDot share: scores from the
    encoder projection and the projected decoder state alone, then the
    masked softmax and the context. ``att_prev`` is taken and ignored, so
    that every variant has one step signature; the alignment comes back in
    its dtype."""

    def __init__(self, cfg: AttentionConfig, dec_dim: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.cfg = cfg
        self.dtype = dtype
        self.mlp_dec = Dense(dec_dim, cfg.dim, bias=False, dtype=dtype)

    def scores(self, enc_proj, dec) -> torch.Tensor:
        """enc_proj (B, T, A), dec (B, K, A) -> float32 scores (B, K, T)."""
        raise NotImplementedError

    def forward(self, enc, enc_proj, mask, dec_z, att_prev, step_pack=None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        del step_pack  # the fused step is location-only
        beam = dec_z.dim() == 3
        if not beam:  # one hypothesis per utterance: K = 1
            dec_z = dec_z[:, None]
        e = self.scores(enc_proj, self.mlp_dec(dec_z))
        ctx, att = finish(e, mask[:, None, :], enc, self.cfg.sharpening)
        # the context from the float32 alignment; the alignment returned in
        # the carry's dtype
        ctx, att = ctx.to(enc.dtype), att.to(att_prev.dtype)
        return (ctx, att) if beam else (ctx[:, 0], att[:, 0])


class AttAdd(_ContentAttention):
    """Additive (Bahdanau) attention: AttLoc without the location conv."""

    def __init__(self, cfg: AttentionConfig, dec_dim: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__(cfg, dec_dim, dtype)
        self.gvec = Dense(cfg.dim, 1, bias=False, dtype=dtype)

    def scores(self, enc_proj, dec):
        # g . tanh(pre), the tanh in the compute dtype (``_gvec_score``)
        pre = enc_proj[:, None] + dec[:, :, None, :]
        g = self.gvec.kernel[:, 0].to(self.dtype)
        return (torch.tanh(pre).float() * g.float()).sum(dim=-1)


class AttDot(_ContentAttention):
    """Dot-product attention: tanh(enc_proj) . tanh(W dec_z), summed in
    float32."""

    def scores(self, enc_proj, dec):
        return torch.einsum("bta,bka->bkt", torch.tanh(enc_proj).float(),
                            torch.tanh(dec).float())


ATTENTION_VARIANTS = {"location": AttLoc, "add": AttAdd, "dot": AttDot}


def make_attention(cfg: AttentionConfig, dec_dim: int,
                   dtype: torch.dtype = torch.float32) -> nn.Module:
    """The attention of ``cfg.variant`` (the reference's atype option)."""
    try:
        cls = ATTENTION_VARIANTS[cfg.variant]
    except KeyError:
        raise ValueError(
            f"unknown attention variant {cfg.variant!r}; "
            f"options: {sorted(ATTENTION_VARIANTS)}") from None
    return cls(cfg, dec_dim, dtype)


def initial_alignment(mask: torch.Tensor) -> torch.Tensor:
    """Masked-uniform alignment over valid frames (ESPnet step 0)."""
    return mask / torch.clamp_min(mask.sum(dim=-1, keepdim=True), 1.0)


class EncoderProjection(nn.Module):
    """The per-utterance encoder-side projection, hoisted out of the
    decode loop."""

    def __init__(self, cfg: AttentionConfig, enc_dim: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.mlp_enc = Dense(enc_dim, cfg.dim, bias=cfg.enc_proj_bias,
                             dtype=dtype)

    def forward(self, enc: torch.Tensor) -> torch.Tensor:
        return self.mlp_enc(enc)

