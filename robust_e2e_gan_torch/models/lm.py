"""Character RNNLM for shallow fusion in the beam search.

Port of ``robust_e2e_gan_tpu/models/lm.py``: ``LMStep`` (embedding, L
stacked LSTM cells, vocabulary readout on raw token ids), ``RNNLM`` (the
teacher-forced pass over (B, S) ids, ``initial_carry`` and the beam-search
``step``) and ``lm_loss``. Training and decoding share one ``LMStep``, so
the state-dict keys are the flax paths (``step_mod.embed.embedding``,
``step_mod.lstm{i}.wx/wh/bias``, ``step_mod.output.kernel/bias``) and
``convert.from_flax`` copies a JAX LM over as it is.

The teacher-forced pass always runs the plain cells, as the JAX package
always uses XLA there. ``step`` takes the kernel wrapper
(``ops/lm_step.py``) when ``LMConfig.step_impl`` selects it; the wrapper is
inference-only.
"""

from __future__ import annotations

from typing import Tuple

import torch
from torch import nn

from robust_e2e_gan_torch.config import LMConfig
from robust_e2e_gan_torch.models.layers import Dense, Embed
from robust_e2e_gan_torch.models.rnn import LSTMCell
from robust_e2e_gan_torch.ops.lm_step import lm_step
from robust_e2e_gan_torch.utils.impl import kernel_enabled

Carry = Tuple[torch.Tensor, torch.Tensor]


class LMStep(nn.Module):
    """One LM step on raw token ids: embed, stacked LSTM cells, logits."""

    def __init__(self, cfg: LMConfig, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.cfg = cfg
        self.dtype = dtype
        self.embed = Embed(cfg.vocab_size, cfg.embed_dim, dtype)
        d = cfg.embed_dim
        for i in range(cfg.num_layers):
            self.add_module(f"lstm{i}", LSTMCell(d, cfg.hidden_dim, dtype))
            d = cfg.hidden_dim
        self.output = Dense(cfg.hidden_dim, cfg.vocab_size, dtype=dtype)

    def cells(self):
        return [getattr(self, f"lstm{i}") for i in range(self.cfg.num_layers)]

    def forward(self, carry: Carry, tok: torch.Tensor,
                fused_ok: bool = False) -> Tuple[Carry, torch.Tensor]:
        h_prev, c_prev = carry
        tok = torch.clamp_min(tok, 0)
        if fused_ok and kernel_enabled(self.cfg.step_impl):
            cells = self.cells()
            h_new, c_new, logits = lm_step(
                tok, self.embed.embedding, [m.wx for m in cells],
                [m.wh for m in cells], [m.bias for m in cells],
                self.output.kernel, self.output.bias, h_prev, c_prev,
                self.dtype)
            return (h_new, c_new), logits.to(self.dtype)
        inp = self.embed(tok)
        hs, cs = [], []
        for li, cell in enumerate(self.cells()):
            (h_new, c_new), inp = cell((h_prev[li], c_prev[li]), inp)
            hs.append(h_new)
            cs.append(c_new)
        return (torch.stack(hs), torch.stack(cs)), self.output(inp)


class RNNLM(nn.Module):
    """Next-token LSTM LM: teacher-forced pass for training, per-step API
    for decoding."""

    def __init__(self, cfg: LMConfig, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.cfg = cfg
        self.dtype = dtype
        self.step_mod = LMStep(cfg, dtype)

    def initial_carry(self, batch: int) -> Carry:
        dev = self.step_mod.output.kernel.device
        h0 = torch.zeros((self.cfg.num_layers, batch, self.cfg.hidden_dim),
                         device=dev)
        return (h0, h0)

    def forward(self, ys_in: torch.Tensor) -> torch.Tensor:
        """Teacher-forced pass over (B, S) token ids -> (B, S, V) logits."""
        carry = self.initial_carry(ys_in.shape[0])
        logits = []
        for i in range(ys_in.shape[1]):
            carry, lg = self.step_mod(carry, ys_in[:, i])
            logits.append(lg)
        return torch.stack(logits, dim=1)

    def step(self, carry: Carry, tokens: torch.Tensor
             ) -> Tuple[Carry, torch.Tensor]:
        """Single LM step on raw token ids (beam-search entry point): the
        kernel when ``step_impl`` selects it, else the plain cells."""
        return self.step_mod(carry, tokens, fused_ok=True)


def lm_loss(logits: torch.Tensor, ys_out: torch.Tensor, ignore_id: int = -1
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Masked next-token NLL; returns (loss per token, perplexity)."""
    valid = (ys_out != ignore_id).float()
    targets = torch.clamp_min(ys_out, 0).long()
    lp = torch.log_softmax(logits.float(), dim=-1)
    nll = -torch.gather(lp, -1, targets[..., None])[..., 0]
    loss = (nll * valid).sum() / torch.clamp_min(valid.sum(), 1.0)
    return loss, torch.exp(loss)
