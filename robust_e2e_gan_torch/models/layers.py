"""Parameter-holding layers with the flax names and rounding points.

flax's ``Dense``, ``Conv`` and ``Embed`` with ``dtype=bfloat16`` cast the
input and the float32 master weights to bfloat16, multiply with a
bfloat16 result, then add the bias in bfloat16. These layers do the same,
so the port rounds where the JAX package rounds. Parameters are float32
and keep the flax names (``kernel``, ``bias``, ``embedding``); conv
kernels are stored in the layout ``F.conv*d`` takes (see ``convert.py``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


def param(*shape: int) -> nn.Parameter:
    return nn.Parameter(torch.zeros(shape), requires_grad=False)


def mm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """2-D product of compute-dtype operands with a float32 result, as a
    JAX matmul with ``preferred_element_type=float32``. On CUDA a bfloat16
    product runs on the tensor cores with float32 accumulation; elsewhere
    the operands are widened to float32, which gives the same products."""
    if a.is_cuda and a.dtype == torch.bfloat16:
        return torch.mm(a, b, out_dtype=torch.float32)
    return a.float() @ b.float()


class Dense(nn.Module):
    """``x @ kernel + bias`` in the compute dtype; kernel (in, out)."""

    def __init__(self, d_in: int, d_out: int, bias: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.kernel = param(d_in, d_out)
        self.bias = param(d_out) if bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = x.to(self.dtype) @ self.kernel.to(self.dtype)
        if self.bias is not None:
            y = y + self.bias.to(self.dtype)
        return y


class Conv2d(nn.Module):
    """3x3 SAME conv over NCHW; kernel (out, in, 3, 3)."""

    def __init__(self, c_in: int, c_out: int, dtype: torch.dtype):
        super().__init__()
        self.dtype = dtype
        self.kernel = param(c_out, c_in, 3, 3)
        self.bias = param(c_out)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.conv2d(x.to(self.dtype), self.kernel.to(self.dtype), padding=1)
        return y + self.bias.to(self.dtype)[:, None, None]


class Conv1d(nn.Module):
    """Bias-free SAME conv over (N, 1, T); kernel (C, 1, K)."""

    def __init__(self, channels: int, width: int, dtype: torch.dtype):
        super().__init__()
        self.dtype = dtype
        self.kernel = param(channels, 1, width)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.conv1d(x.to(self.dtype), self.kernel.to(self.dtype),
                        padding="same")


class Embed(nn.Module):
    """Token embedding; table (V, E) cast to the compute dtype."""

    def __init__(self, vocab: int, dim: int, dtype: torch.dtype):
        super().__init__()
        self.dtype = dtype
        self.embedding = param(vocab, dim)

    def forward(self, tok: torch.Tensor) -> torch.Tensor:
        return F.embedding(tok.long(), self.embedding.to(self.dtype))
