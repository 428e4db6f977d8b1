"""Recurrent cores: BLSTM, BLSTMP and the decoder's LSTM cell.

Port of ``robust_e2e_gan_tpu/models/rnn.py``: gate order i, f, g, o; the
forget-gate bias is a parameter like the others; length-mask semantics
(pad frames leave the state unchanged and output exact zeros). The BLSTM
frame loop runs through ``ops/blstm.py`` (inference) or
``ops/blstm_train.py`` (training): the CUDA kernels, or their plain
versions. ``gate_storage`` is the JAX field: "compute" rounds the plain
frame loop's hoisted gate projections to the compute dtype.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from robust_e2e_gan_torch.models.layers import Dense, mm_f32, param
from robust_e2e_gan_torch.ops.blstm import (
    blstm_infer,
    blstm_recurrence,
    blstm_recurrence_plain,
    infer_kernel_for,
)
from robust_e2e_gan_torch.ops.blstm_train import (
    blstm_train,
    blstm_train_gx,
    train_kernel_for,
)
from robust_e2e_gan_torch.parallel.sharding import rows_rand
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

    ``impl``: "scan" runs the plain frame loop (differentiable by
    autograd, the JAX scan); "auto" (or the JAX kernel names
    "tiled"/"fused") runs a kernel wrapper, chosen per layer by the JAX
    package's rules: ``blstm_train`` or ``blstm_train_gx`` when autograd
    records (``ops/blstm_train.py::train_kernel_for``), and when it does
    not the inference ``blstm_infer`` (W_x-resident) or
    ``blstm_recurrence`` (gate stream) (``ops/blstm.py::infer_kernel_for``).
    The kernel paths round ``h`` to the compute dtype for the recurrent
    product, as the JAX kernels do; "scan" keeps it float32, as the JAX
    scan does.

    ``gate_storage`` "compute" rounds the hoisted gate projections of the
    "scan" path to the compute dtype (JAX ``rnn.py:243-248``); the kernel
    paths ignore it, as the JAX kernels do.
    """

    def __init__(self, d_in: int, hidden: int, dtype: torch.dtype,
                 impl: str = "scan", gate_storage: str = "f32"):
        super().__init__()
        if gate_storage not in ("f32", "compute"):
            raise ValueError(f"unknown gate_storage {gate_storage!r}")
        self.dtype = dtype
        self.use_kernel = kernel_enabled(impl)
        self.gate_storage = gate_storage
        self.wx = param(2, d_in, 4 * hidden)
        self.wh = param(2, hidden, 4 * hidden)
        self.bias = param(2, 4 * hidden)

    def forward(self, x: torch.Tensor,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        b, t, d = x.shape
        h = self.wh.shape[1]
        lengths = lengths_from_mask(mask, b, t, x.device)
        wh = self.wh.to(self.dtype).contiguous()
        recording = torch.is_grad_enabled() and (
            x.requires_grad or any(p.requires_grad for p in self.parameters()))
        if self.use_kernel and recording:
            if train_kernel_for(b, t, d, h, self.dtype) == "fused":
                return blstm_train(x, lengths, self.wx.to(self.dtype), wh,
                                   self.bias)
            gx = input_projection(x, self.wx, self.bias, self.dtype)
            return blstm_train_gx(gx, wh, lengths)
        if self.use_kernel:
            if infer_kernel_for(b, t, d, h, self.dtype) == "fused":
                return blstm_infer(x, lengths, self.wx.to(self.dtype), wh,
                                   self.bias)
            gx = input_projection(x, self.wx, self.bias, self.dtype)
            return blstm_recurrence(gx, wh, lengths)
        gx = input_projection(x, self.wx, self.bias, self.dtype)
        if self.gate_storage == "compute" and self.dtype != torch.float32:
            gx = gx.to(self.dtype).float()
        return blstm_recurrence_plain(gx, wh, lengths)


def dropout(x: torch.Tensor, rate: float,
            gen: Optional[torch.Generator]) -> torch.Tensor:
    """flax ``Dropout``: keep with probability 1 - rate, scaled by
    1 / (1 - rate); the draws come from ``gen`` (under a data mesh, the
    rank's rows of the global batch's draw)."""
    keep = 1.0 - rate
    draw = rows_rand(x.shape, gen, x.device) < keep
    return torch.where(draw, x / keep, torch.zeros((), dtype=x.dtype,
                                                   device=x.device))


class BLSTMP(nn.Module):
    """BLSTM layers, each followed by a projection + tanh (ESPnet BLSTMP),
    and dropout after each projection in training."""

    def __init__(self, d_in: int, num_layers: int, hidden: int, proj: int,
                 dtype: torch.dtype, impl: str = "scan",
                 dropout_rate: float = 0.0, gate_storage: str = "f32"):
        super().__init__()
        self.num_layers = num_layers
        self.dropout_rate = dropout_rate
        d = d_in
        for i in range(num_layers):
            self.add_module(f"blstm{i}",
                            BLSTM(d, hidden, dtype, impl, gate_storage))
            self.add_module(f"proj{i}", Dense(2 * hidden, proj, dtype=dtype))
            d = proj

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None,
                deterministic: bool = True,
                gen: Optional[torch.Generator] = None) -> torch.Tensor:
        h = x
        for i in range(self.num_layers):
            h = getattr(self, f"blstm{i}")(h, mask)
            h = torch.tanh(getattr(self, f"proj{i}")(h))
            if self.dropout_rate > 0.0 and not deterministic:
                h = dropout(h, self.dropout_rate, gen)
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
