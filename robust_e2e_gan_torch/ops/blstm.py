"""Masked bidirectional LSTM for inference: the kernels' wrappers, their
plain PyTorch versions, and the rule that picks one per layer.

Counterparts of ``robust_e2e_gan_tpu/ops/blstm_pallas.py::blstm_infer``
in its two variants:

* ``blstm_infer(x, lengths, wx, wh, bias)``, the W_x-resident variant
  (``_fused_kernel``): raw input frames in, hidden states out, in one
  launch of ``csrc/blstm_infer.cu``; the input projection is computed in
  the kernel a chunk of frames at a time, so no gate tensor goes through
  device memory.
* ``blstm_recurrence(gx, wh, lengths)``, the gate-stream variant
  (``_gx_kernel``): the input projection of both directions is one matrix
  product over the whole sequence (``models/rnn.py::input_projection``)
  and the serial frame loop is ``csrc/blstm.cu``.

``infer_kernel_for`` is the JAX package's choice between the two. Masks
are length masks: frames at or past a row's length leave the state
unchanged and come out as exact zeros. Both kernels round ``h`` to the
compute dtype for the recurrent product, as the JAX kernels do; the plain
frame loop takes ``round_h`` for that, and the JAX scan's arithmetic
(``h`` promoted to float32) without it.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from robust_e2e_gan_torch.utils.build import launch
from robust_e2e_gan_torch.utils.impl import check, check_no_grad, on_cuda

MAX_HIDDEN = 1024  # one thread per hidden unit in a block

# --------------------------------------------------------------------------
# which inference kernel a layer takes: the JAX package's rule
# (blstm_pallas.py::infer_fits, and the variant selection of blstm_infer),
# written out as plain arithmetic
# --------------------------------------------------------------------------

_INFER_VMEM_BUDGET = 64 * 1024 * 1024


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


def infer_fits(b: int, h: int, itemsize: int = 2) -> bool:
    """True where the JAX package runs the layer in ``blstm_infer`` at all
    (else it keeps its scan)."""
    bp, hp = _round_up(b, 8), _round_up(h, 128)
    need = (2 * hp * 4 * hp * itemsize + 2 * (2 * bp * hp * 4)
            + 2 * 2 * bp * 4 * hp * 4 + 2 * 2 * bp * hp * 4
            + 2 * (2 * bp * min(hp, 128) * 4))
    return need <= _INFER_VMEM_BUDGET


def fused_infer_fits(b: int, d: int, h: int, itemsize: int = 2) -> bool:
    """True where ``blstm_infer`` takes its W_x-resident variant: some
    chunk of (2, 4, 8, 1) frames fits the working set beside W_x, W_h and
    the carries."""
    bp, dp, hp = _round_up(b, 8), _round_up(d, 128), _round_up(h, 128)
    fixed = (2 * dp * 4 * hp * itemsize + 2 * hp * 4 * hp * itemsize
             + 2 * (2 * bp * hp * 4) + 2 * (2 * bp * 128 * 4))
    return any(fixed + 2 * 2 * f * bp * dp * itemsize + 2 * f * bp * 4 * hp * 4
               + 2 * 2 * f * bp * hp * itemsize <= _INFER_VMEM_BUDGET
               for f in (2, 4, 8, 1))


def infer_kernel_for(b: int, t: int, d: int, h: int,
                     dtype: torch.dtype) -> str:
    """"fused" (``blstm_infer``) where the JAX package runs its
    W_x-resident kernel, else "gx" (``blstm_recurrence``): also where the
    reference keeps its scan, since the port's gate-stream kernel takes any
    H up to ``MAX_HIDDEN``."""
    del t  # time never limits the TPU kernel's VMEM
    itemsize = torch.finfo(dtype).bits // 8
    if infer_fits(b, h, itemsize) and fused_infer_fits(b, d, h, itemsize):
        return "fused"
    return "gx"


# --------------------------------------------------------------------------
# plain versions
# --------------------------------------------------------------------------


def _frame_loop(gx: torch.Tensor, wh: torch.Tensor, lengths: torch.Tensor,
                round_h: bool) -> torch.Tensor:
    b, t = gx.shape[:2]
    h_dim = wh.shape[1]
    mask = (torch.arange(t, device=gx.device)[None, :]
            < lengths[:, None]).float()
    gxs = torch.stack([gx[:, :, 0], gx[:, :, 1].flip(1)])  # (2, B, T, 4H)
    ms = torch.stack([mask, mask.flip(1)])  # (2, B, T)
    whf = wh.float()
    h = gx.new_zeros((2, b, h_dim))
    c = gx.new_zeros((2, b, h_dim))
    ys = []
    for i in range(t):
        h_in = h.to(wh.dtype).float() if round_h else h
        gates = gxs[:, :, i] + torch.bmm(h_in, whf)
        gi, gf, gg, go = gates.chunk(4, dim=-1)
        c_new = torch.sigmoid(gf) * c + torch.sigmoid(gi) * torch.tanh(gg)
        h_new = torch.sigmoid(go) * torch.tanh(c_new)
        m = ms[:, :, i, None]
        c = m * c_new + (1.0 - m) * c
        h = m * h_new + (1.0 - m) * h
        ys.append(h * m)
    ys = torch.stack(ys, dim=2)  # (2, B, T, H)
    return torch.cat([ys[0], ys[1].flip(1)], dim=-1).to(wh.dtype)


def blstm_recurrence_plain(gx: torch.Tensor, wh: torch.Tensor,
                           lengths: torch.Tensor,
                           round_h: bool = False) -> torch.Tensor:
    """The masked frame loop of ``models/rnn.py::BLSTM``.

    gx (B, T, 2, 4H) f32, wh (2, H, 4H) in the compute dtype, lengths (B,)
    -> (B, T, 2H) in wh's dtype. The backward direction runs over the
    flipped sequence, where the pad frames come first and leave the zero
    state alone. ``round_h`` rounds ``h`` to wh's dtype for the recurrent
    product, as the JAX kernels do (``blstm_pallas.py:245-248``); without
    it ``h`` stays float32, as in the JAX scan.
    """
    blstm_recurrence_plain.calls += 1
    return _frame_loop(gx, wh, lengths, round_h)


blstm_recurrence_plain.calls = 0


def blstm_infer_plain(x: torch.Tensor, lengths: torch.Tensor,
                      wx: torch.Tensor, wh: torch.Tensor,
                      bias: torch.Tensor) -> torch.Tensor:
    """The W_x-resident kernel's function, with its rounding points
    (``blstm_pallas.py:147-187``).

    x (B, T, D) of any float dtype, lengths (B,), wx (2, D, 4H) and wh
    (2, H, 4H) in the compute dtype, bias (2, 4H) f32 -> (B, T, 2H) in the
    compute dtype. x is cast to the compute dtype; ``x @ wx[z]`` has a
    float32 result to which the bias is added; the recurrent product takes
    ``h`` rounded to the compute dtype; gates i, f, g, o in float32.
    """
    blstm_infer_plain.calls += 1
    b, t, d = x.shape
    four_h = wx.shape[-1]
    w = wx.permute(1, 0, 2).reshape(d, 2 * four_h).float()
    xc = x.reshape(b * t, d).to(wx.dtype).float()
    gx = (xc @ w + bias.float().reshape(-1)).view(b, t, 2, four_h)
    return _frame_loop(gx, wh, lengths, round_h=True)


blstm_infer_plain.calls = 0


# --------------------------------------------------------------------------
# kernel wrappers
# --------------------------------------------------------------------------


def _rows_per_block(b: int, device: torch.device) -> int:
    """Batch rows per block: 2 (fastest on an H100 at H=256), or 4 when
    2 would need more blocks than the card has SMs."""
    n_sm = torch.cuda.get_device_properties(device).multi_processor_count
    return 2 if 2 * -(-b // 2) <= n_sm else 4


def blstm_recurrence(gx: torch.Tensor, wh: torch.Tensor,
                     lengths: torch.Tensor) -> torch.Tensor:
    """Kernel wrapper, the contract of ``blstm_recurrence_plain`` with
    ``round_h=True``.

    CPU tensors run the plain version; CUDA tensors launch
    ``csrc/blstm.cu`` or raise.
    """
    check_no_grad("blstm_recurrence", gx, wh)
    if not on_cuda(gx, wh, lengths):
        return blstm_recurrence_plain(gx, wh, lengths, round_h=True)
    b, t, two, four_h = gx.shape
    h_dim = four_h // 4
    check(two == 2 and four_h == 4 * h_dim, f"gx shape {tuple(gx.shape)}")
    check(gx.dtype == torch.float32 and gx.is_contiguous(),
          "gx must be contiguous float32")
    check(wh.shape == (2, h_dim, four_h) and wh.is_contiguous(),
          f"wh shape {tuple(wh.shape)} for H={h_dim}")
    check(wh.dtype in (torch.float32, torch.bfloat16), f"wh dtype {wh.dtype}")
    check(1 <= h_dim <= MAX_HIDDEN, f"H={h_dim} outside [1, {MAX_HIDDEN}]")
    check(lengths.shape == (b,), f"lengths shape {tuple(lengths.shape)}")
    lengths = lengths.to(torch.int32).contiguous()
    out = torch.empty((b, t, 2 * h_dim), dtype=wh.dtype, device=gx.device)
    launch(
        "blstm_recurrence", gx.data_ptr(), wh.data_ptr(), lengths.data_ptr(),
        out.data_ptr(), b, t, h_dim, _rows_per_block(b, gx.device),
        int(wh.dtype == torch.bfloat16),
        torch.cuda.current_stream(gx.device).cuda_stream,
    )
    blstm_recurrence.launches += 1
    return out


blstm_recurrence.launches = 0


def blstm_infer(x: torch.Tensor, lengths: torch.Tensor, wx: torch.Tensor,
                wh: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """Kernel wrapper, same contract as ``blstm_infer_plain``.

    CPU tensors run the plain version; CUDA tensors launch
    ``csrc/blstm_infer.cu`` or raise. In bfloat16 with H a multiple of 16
    the kernel projects on the tensor cores, reading W_x in 16-row tiles,
    so its rows are zero-padded to a multiple of 16 here.
    """
    check_no_grad("blstm_infer", x, wx, wh, bias)
    if not on_cuda(x, lengths, wx, wh, bias):
        return blstm_infer_plain(x, lengths, wx, wh, bias)
    b, t, d = x.shape
    h_dim = wh.shape[1]
    four_h = 4 * h_dim
    check(tuple(wx.shape) == (2, d, four_h), f"wx shape {tuple(wx.shape)}")
    check(tuple(wh.shape) == (2, h_dim, four_h), f"wh shape {tuple(wh.shape)}")
    check(wx.dtype == wh.dtype and wh.dtype in (torch.float32, torch.bfloat16),
          f"wx {wx.dtype} and wh {wh.dtype}: one of float32, bfloat16")
    check(tuple(bias.shape) == (2, four_h) and bias.dtype == torch.float32,
          f"bias must be (2, 4H) float32, got {tuple(bias.shape)}")
    check(1 <= h_dim <= MAX_HIDDEN, f"H={h_dim} outside [1, {MAX_HIDDEN}]")
    check(d >= 1 and t >= 1 and b >= 1, f"x shape {tuple(x.shape)}")
    check(tuple(lengths.shape) == (b,), f"lengths shape {tuple(lengths.shape)}")
    bf16 = wx.dtype == torch.bfloat16
    mma = bf16 and h_dim % 16 == 0
    dw = _round_up(d, 16) if mma else d
    if dw != d:
        wx = F.pad(wx, (0, 0, 0, dw - d))
    elif not wx.is_contiguous() or wx.data_ptr() % 32:  # WMMA's alignment
        wx = wx.clone(memory_format=torch.contiguous_format)
    wh, bias = wh.contiguous(), bias.contiguous()
    xc = x.to(wx.dtype).contiguous()
    lengths = lengths.to(torch.int32).contiguous()
    out = torch.empty((b, t, 2 * h_dim), dtype=wx.dtype, device=x.device)
    launch(
        "blstm_infer", xc.data_ptr(), wx.data_ptr(), wh.data_ptr(),
        bias.data_ptr(), lengths.data_ptr(), out.data_ptr(),
        b, t, d, dw, h_dim, _rows_per_block(b, x.device), int(bf16),
        int(mma), torch.cuda.current_stream(x.device).cuda_stream,
    )
    blstm_infer.launches += 1
    return out


blstm_infer.launches = 0
