"""Recurrent cores: BLSTM, BLSTMP and the decoder's LSTM cell.

Port of ``robust_e2e_gan_tpu/models/rnn.py``: gate order i, f, g, o; the
forget-gate bias is a parameter like the others; length-mask semantics
(pad frames leave the state unchanged and output exact zeros). The BLSTM
frame loop runs through ``ops/blstm.py``: the CUDA kernel, or its plain
version.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from robust_e2e_gan_torch.models.layers import Dense, mm_f32, param
from robust_e2e_gan_torch.ops.blstm import (
    blstm_recurrence,
    blstm_recurrence_plain,
)
from robust_e2e_gan_torch.utils.impl import kernel_enabled


def lengths_from_mask(mask: Optional[torch.Tensor], b: int, t: int,
                      device) -> torch.Tensor:
    """Valid-frame counts of a (B, T) length mask (all T when None)."""
    if mask is None:
        return torch.full((b,), t, dtype=torch.int32, device=device)
    return (mask > 0).sum(dim=1).to(torch.int32)


def input_projection(x: torch.Tensor, wx: torch.Tensor, bias: torch.Tensor,
                     dtype: torch.dtype) -> torch.Tensor:
    """(B, T, D) -> gate inputs ``x @ wx[z] + bias[z]``, (B, T, 2, 4H) f32.

    One product for both directions, on operands rounded to the compute
    dtype with a float32 result (the JAX einsum's
    ``preferred_element_type=float32``).
    """
    b, t, d = x.shape
    four_h = wx.shape[-1]
    w = wx.to(dtype).permute(1, 0, 2).reshape(d, 2 * four_h)
    gx = mm_f32(x.reshape(b * t, d).to(dtype), w) + bias.float().reshape(-1)
    return gx.view(b, t, 2, four_h)


class BLSTM(nn.Module):
    """Bidirectional masked LSTM, (B, T, D) -> (B, T, 2H) in the compute
    dtype. Parameters as flax: wx (2, D, 4H), wh (2, H, 4H), bias (2, 4H).

    ``impl``: "scan" runs the plain frame loop; "auto" (or the JAX kernel
    names "tiled"/"fused") runs the kernel wrapper.
    """

    def __init__(self, d_in: int, hidden: int, dtype: torch.dtype,
                 impl: str = "scan"):
        super().__init__()
        self.dtype = dtype
        self.use_kernel = kernel_enabled(impl)
        self.wx = param(2, d_in, 4 * hidden)
        self.wh = param(2, hidden, 4 * hidden)
        self.bias = param(2, 4 * hidden)

    def forward(self, x: torch.Tensor,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        b, t, _ = x.shape
        lengths = lengths_from_mask(mask, b, t, x.device)
        gx = input_projection(x, self.wx, self.bias, self.dtype)
        wh = self.wh.to(self.dtype).contiguous()
        if self.use_kernel:
            return blstm_recurrence(gx, wh, lengths)
        return blstm_recurrence_plain(gx, wh, lengths)


class BLSTMP(nn.Module):
    """BLSTM layers, each followed by a projection + tanh (ESPnet BLSTMP)."""

    def __init__(self, d_in: int, num_layers: int, hidden: int, proj: int,
                 dtype: torch.dtype, impl: str = "scan"):
        super().__init__()
        self.num_layers = num_layers
        d = d_in
        for i in range(num_layers):
            self.add_module(f"blstm{i}", BLSTM(d, hidden, dtype, impl))
            self.add_module(f"proj{i}", Dense(2 * hidden, proj, dtype=dtype))
            d = proj

    def forward(self, x: torch.Tensor,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        h = x
        for i in range(self.num_layers):
            h = getattr(self, f"blstm{i}")(h, mask)
            h = torch.tanh(getattr(self, f"proj{i}")(h))
            if mask is not None:
                h = h * mask[..., None].to(h.dtype)
        return h


class LSTMCell(nn.Module):
    """One LSTM step for the decoder: wx (D, 4H), wh (H, 4H), bias (4H,).

    Rounding points as the JAX cell: ``x @ wx`` on compute-dtype operands
    with a float32 result; ``h @ wh`` promotes the compute-dtype weights to
    float32 against the float32 state.
    """

    def __init__(self, d_in: int, hidden: int, dtype: torch.dtype):
        super().__init__()
        self.dtype = dtype
        self.wx = param(d_in, 4 * hidden)
        self.wh = param(hidden, 4 * hidden)
        self.bias = param(4 * hidden)

    def forward(self, carry: Tuple[torch.Tensor, torch.Tensor],
                x: torch.Tensor):
        h_prev, c_prev = carry
        dt = self.dtype
        gates = (mm_f32(x.to(dt), self.wx.to(dt))
                 + h_prev @ self.wh.to(dt).float()) + self.bias
        gi, gf, gg, go = gates.chunk(4, dim=-1)
        c_new = torch.sigmoid(gf) * c_prev + torch.sigmoid(gi) * torch.tanh(gg)
        h_new = torch.sigmoid(go) * torch.tanh(c_new)
        return (h_new, c_new), h_new
