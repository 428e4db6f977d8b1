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
    """A trainable float32 master weight (zeros until loaded)."""
    return nn.Parameter(torch.zeros(shape))


class _MmF32(torch.autograd.Function):
    """bfloat16 product with a float32 result on CUDA, differentiable: the
    gradients are the float32 products the widened form's autograd gives,
    rounded back to the operands' dtype."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return torch.mm(a, b, out_dtype=torch.float32)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        ga = (g @ b.float().t()).to(a.dtype) if ctx.needs_input_grad[0] else None
        gb = (a.float().t() @ g).to(b.dtype) if ctx.needs_input_grad[1] else None
        return ga, gb


def mm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """2-D product of compute-dtype operands with a float32 result, as a
    JAX matmul with ``preferred_element_type=float32``. On CUDA a bfloat16
    product runs on the tensor cores with float32 accumulation; elsewhere
    the operands are widened to float32, which gives the same products."""
    if a.is_cuda and a.dtype == torch.bfloat16:
        if torch.is_grad_enabled() and (a.requires_grad or b.requires_grad):
            return _MmF32.apply(a, b)
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


def _same_pad(n: int, k: int, s: int):
    """XLA's SAME padding (low, high) of one spatial dimension."""
    total = max((-(-n // s) - 1) * s + k - n, 0)
    return total // 2, total - total // 2


class Conv2d(nn.Module):
    """SAME conv over NCHW (3x3, stride 1 unless given); kernel
    (out, in, kh, kw)."""

    def __init__(self, c_in: int, c_out: int, dtype: torch.dtype,
                 kernel=(3, 3), stride: int = 1):
        super().__init__()
        self.dtype = dtype
        self.stride = stride
        self.kernel = param(c_out, c_in, *kernel)
        self.bias = param(c_out)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        kh, kw = self.kernel.shape[2:]
        (t0, t1), (f0, f1) = (_same_pad(x.shape[2], kh, self.stride),
                              _same_pad(x.shape[3], kw, self.stride))
        x, pad = x.to(self.dtype), (t0, f0)
        if (t0, f0) != (t1, f1):  # uneven: pad the high side by hand
            x, pad = F.pad(x, (f0, f1, t0, t1)), 0
        y = F.conv2d(x, self.kernel.to(self.dtype), stride=self.stride,
                     padding=pad)
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
