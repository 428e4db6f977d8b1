"""Masked bidirectional LSTM recurrence for inference: the kernel's wrapper
and its plain PyTorch version.

Counterpart of ``robust_e2e_gan_tpu/ops/blstm_pallas.py::blstm_infer`` in
its gate-stream form: the input projection of both directions is one
matrix product over the whole sequence (``models/rnn.py::input_projection``)
and the serial frame loop is ``csrc/blstm.cu``. Masks are length masks:
frames at or past a row's length leave the state unchanged and come out as
exact zeros.
"""

from __future__ import annotations

import torch

from robust_e2e_gan_torch.utils.build import launch
from robust_e2e_gan_torch.utils.impl import check, check_no_grad, on_cuda

MAX_HIDDEN = 1024  # one thread per hidden unit in a block


def blstm_recurrence_plain(gx: torch.Tensor, wh: torch.Tensor,
                           lengths: torch.Tensor) -> torch.Tensor:
    """The masked frame loop of ``models/rnn.py::BLSTM`` (JAX scan form).

    gx (B, T, 2, 4H) f32, wh (2, H, 4H) in the compute dtype, lengths (B,)
    -> (B, T, 2H) in wh's dtype. The backward direction runs over the
    flipped sequence, where the pad frames come first and leave the zero
    state alone.
    """
    blstm_recurrence_plain.calls += 1
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
        gates = gxs[:, :, i] + torch.bmm(h, whf)
        gi, gf, gg, go = gates.chunk(4, dim=-1)
        c_new = torch.sigmoid(gf) * c + torch.sigmoid(gi) * torch.tanh(gg)
        h_new = torch.sigmoid(go) * torch.tanh(c_new)
        m = ms[:, :, i, None]
        c = m * c_new + (1.0 - m) * c
        h = m * h_new + (1.0 - m) * h
        ys.append(h * m)
    ys = torch.stack(ys, dim=2)  # (2, B, T, H)
    return torch.cat([ys[0], ys[1].flip(1)], dim=-1).to(wh.dtype)


blstm_recurrence_plain.calls = 0


def _rows_per_block(b: int, device: torch.device) -> int:
    """Batch rows per block: 2 (fastest on an H100 at H=256), or 4 when
    2 would need more blocks than the card has SMs."""
    n_sm = torch.cuda.get_device_properties(device).multi_processor_count
    return 2 if 2 * -(-b // 2) <= n_sm else 4


def blstm_recurrence(gx: torch.Tensor, wh: torch.Tensor,
                     lengths: torch.Tensor) -> torch.Tensor:
    """Kernel wrapper, same contract as ``blstm_recurrence_plain``.

    CPU tensors run the plain version; CUDA tensors launch
    ``csrc/blstm.cu`` or raise.
    """
    check_no_grad("blstm_recurrence", gx, wh)
    if not on_cuda(gx, wh, lengths):
        return blstm_recurrence_plain(gx, wh, lengths)
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
