"""Differentiable masked bidirectional LSTM for training: the kernels'
autograd wrappers and their plain PyTorch versions.

Counterparts of ``robust_e2e_gan_tpu/ops/blstm_train_pallas.py``:

* ``blstm_train(x, lengths, wx, wh, bias)`` (TPU ``blstm_train``, the
  W_x-resident variant): the input projection ``x @ W_x + bias``, its
  gradients ``dx``, ``dW_x``, ``dbias`` and ``dW_h`` are products of
  ``csrc/gemm.cu``; the frame loops are ``csrc/blstm_train.cu``. Nothing
  goes through ``torch.matmul``.
* ``blstm_train_gx(gx, wh, lengths)`` (TPU ``blstm_train_gx``): the input
  projection stays outside, a differentiable product
  (``models/rnn.py::input_projection``), as the JAX gate-stream variant
  leaves it to an XLA einsum; the kernels own the frame loops and
  ``dW_h``.

The forward streams out the only residuals the backward needs, per
direction in frame order with one zero row (``y_ext`` (2, B, T+1, H) in
the compute dtype, ``c_ext`` (2, B, T+1, H) float32): the forward
direction keeps frame t at row t+1 and a zero row 0, the backward
direction frame t at row t and a zero row T. Every mask here is a length
mask, so a valid frame's incoming carries are the stored masked row on the
side it came from (the interval-mask argument of the reference). The
backward recomputes the gates as ``gx + h_prev @ W_h`` and walks the
frames in descending processing order.

Rounding points are the JAX kernel's: the recurrent product takes h
rounded to the compute dtype, ``dy`` is rounded to the compute dtype,
``dgates`` is rounded to it for every product, and ``dW_x``/``dW_h``
come back in the compute dtype; ``dbias`` and ``dgx`` stay float32.
"""

from __future__ import annotations

import torch

from robust_e2e_gan_torch.utils.build import launch
from robust_e2e_gan_torch.utils.impl import check, on_cuda

MAX_HIDDEN = 1024  # one thread per hidden unit in a block

# --------------------------------------------------------------------------
# which training kernel a layer takes: the JAX package's per-layer rule
# (blstm_train_pallas.py::_pick_chunk, fused_train_fits, gx_train_fits),
# written out as plain arithmetic so each layer runs the counterpart of the
# kernel the JAX package runs there
# --------------------------------------------------------------------------

_TRAIN_VMEM_BUDGET = 80 * 1024 * 1024
_GX_CHUNK = 2


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


def fused_train_fits(b: int, t: int, d: int, h: int, itemsize: int = 2
                     ) -> bool:
    """True where the JAX package trains the layer in ``blstm_train``."""
    del t  # time never limits the TPU kernel's VMEM
    bp, dp, hp = _round_up(b, 8), _round_up(d, 128), _round_up(h, 128)
    fixed = (2 * dp * 4 * hp * itemsize + 2 * hp * 4 * hp * itemsize
             + 2 * dp * 4 * hp * 4 + 2 * hp * 4 * hp * 4 + 2 * bp * 4 * hp * 4
             + 4 * (2 * bp * hp * 4) + 2 * (2 * bp * 128 * 4))
    for f in (4, 2, 8, 1):
        bufs = (2 * 2 * f * bp * dp * itemsize + 2 * 2 * f * bp * hp * itemsize
                + 2 * 2 * (f + 1) * bp * hp * 4
                + 2 * 2 * f * bp * hp * itemsize + 2 * f * bp * 4 * hp * 4
                + 2 * f * bp * 4 * hp * 4 + 2 * 2 * f * bp * dp * 4)
        if fixed + bufs <= _TRAIN_VMEM_BUDGET:
            return True
    return False


def gx_train_fits(b: int, h: int, itemsize: int = 2) -> bool:
    """True where the JAX package trains the layer in ``blstm_train_gx``
    (when ``fused_train_fits`` is False)."""
    bp, hp, f = _round_up(b, 8), _round_up(h, 128), _GX_CHUNK
    need = (2 * hp * 4 * hp * itemsize + 2 * hp * 4 * hp * 4
            + 2 * (2 * bp * hp * 4) + 2 * (2 * bp * min(hp, 128) * 4)
            + 2 * 2 * f * bp * 4 * hp * 4 + 2 * 2 * f * bp * hp * itemsize
            + 2 * 2 * (f + 1) * bp * hp * 4 + 2 * 2 * f * bp * hp * itemsize
            + 2 * f * bp * 4 * hp * 4 + 2 * 2 * f * bp * 4 * hp * 4)
    return need <= _TRAIN_VMEM_BUDGET


# --------------------------------------------------------------------------
# plain versions
# --------------------------------------------------------------------------


def _stream_order(a: torch.Tensor):
    """(B, T, 2, ...) frame-order per-direction tensor -> (2, B, T, ...)
    in stream order: the backward direction over the flipped sequence,
    where its pad frames come first."""
    return torch.stack([a[:, :, 0], a[:, :, 1].flip(1)])


def _masks(lengths: torch.Tensor, t: int, device) -> torch.Tensor:
    """(2, B, T) stream-order float masks."""
    m = (torch.arange(t, device=device)[None, :] < lengths[:, None]).float()
    return torch.stack([m, m.flip(1)])


def recurrence_fwd_plain(gx: torch.Tensor, wh: torch.Tensor,
                         lengths: torch.Tensor):
    """The forward frame loop with residuals: gx (B, T, 2, 4H) f32, wh
    (2, H, 4H) in the compute dtype -> (y (B, T, 2H), y_ext, c_ext)."""
    b, t = gx.shape[:2]
    h_dim = wh.shape[1]
    cd = wh.dtype
    gxs = _stream_order(gx)
    ms = _masks(lengths, t, gx.device)
    whf = wh.float()
    h = gx.new_zeros((2, b, h_dim))
    c = gx.new_zeros((2, b, h_dim))
    ys, cs = [], []
    for i in range(t):
        gates = gxs[:, :, i] + torch.bmm(h.to(cd).float(), whf)
        gi, gf, gg, go = gates.chunk(4, dim=-1)
        c_new = torch.sigmoid(gf) * c + torch.sigmoid(gi) * torch.tanh(gg)
        h_new = torch.sigmoid(go) * torch.tanh(c_new)
        m = ms[:, :, i, None]
        c = m * c_new + (1.0 - m) * c
        h = m * h_new + (1.0 - m) * h
        ys.append(h * m)
        cs.append(c * m)
    ys = torch.stack(ys, dim=2)  # (2, B, T, H) stream order
    cs = torch.stack(cs, dim=2)
    zero = gx.new_zeros((b, 1, h_dim))
    y_ext = torch.stack([torch.cat([zero, ys[0]], 1),
                         torch.cat([ys[1].flip(1), zero], 1)]).to(cd)
    c_ext = torch.stack([torch.cat([zero, cs[0]], 1),
                         torch.cat([cs[1].flip(1), zero], 1)])
    y = torch.cat([ys[0], ys[1].flip(1)], dim=-1).to(cd)
    return y, y_ext, c_ext


def recurrence_bwd_plain(gx, wh, lengths, y_ext, c_ext, dy) -> torch.Tensor:
    """The adjoint frame loop (``blstm_train_pallas.py:310-344``):
    -> dgates (B, T, 2, 4H) float32, zero at pad frames."""
    b, t = gx.shape[:2]
    h_dim = wh.shape[1]
    cd = wh.dtype
    gxs = _stream_order(gx)
    ms = _masks(lengths, t, gx.device)
    dyc = dy.to(cd).float()
    dys = torch.stack([dyc[..., :h_dim], dyc[..., h_dim:].flip(1)])
    # stream-order incoming h and c, and the outgoing c, of every frame
    h_prev = torch.stack([y_ext[0, :, :t], y_ext[1, :, 1:].flip(1)]).float()
    c_prev = torch.stack([c_ext[0, :, :t], c_ext[1, :, 1:].flip(1)])
    c_out = torch.stack([c_ext[0, :, 1:], c_ext[1, :, :t].flip(1)])
    whf = wh.float()
    dh = gx.new_zeros((2, b, h_dim))
    dc = gx.new_zeros((2, b, h_dim))
    dgs = [None] * t
    for i in range(t - 1, -1, -1):
        gates = gxs[:, :, i] + torch.bmm(h_prev[:, :, i], whf)
        gi, gf, gg, go = gates.chunk(4, dim=-1)
        gi, gf, go = torch.sigmoid(gi), torch.sigmoid(gf), torch.sigmoid(go)
        gg = torch.tanh(gg)
        tanh_c = torch.tanh(c_out[:, :, i])
        m = ms[:, :, i, None]
        dh_out = dys[:, :, i] * m + dh
        dh_new = m * dh_out
        dc_new = m * dc + dh_new * go * (1.0 - tanh_c * tanh_c)
        dgates = torch.cat([dc_new * gg * (gi * (1.0 - gi)),
                            dc_new * c_prev[:, :, i] * (gf * (1.0 - gf)),
                            dc_new * gi * (1.0 - gg * gg),
                            dh_new * tanh_c * (go * (1.0 - go))], dim=-1)
        dgs[i] = dgates
        rec = torch.bmm(dgates.to(cd).float(), whf.transpose(1, 2))
        dh = (1.0 - m) * dh_out + rec
        dc = (1.0 - m) * dc + gf * dc_new
    dgs = torch.stack(dgs, dim=2)  # (2, B, T, 4H)
    return torch.stack([dgs[0], dgs[1].flip(1)], dim=2)


def _dwh_plain(y_ext: torch.Tensor, dgates: torch.Tensor, t: int):
    """dW_h (2, H, 4H) f32 = sum over frames of h_prev^T dgates."""
    cd = y_ext.dtype
    h_prev = torch.stack([y_ext[0, :, :t], y_ext[1, :, 1:]]).float()
    dg = dgates.to(cd).float()
    return torch.einsum("zbth,btzg->zhg", h_prev, dg)


# --------------------------------------------------------------------------
# kernel launches
# --------------------------------------------------------------------------


def _rows_per_block(b: int, device: torch.device) -> int:
    """Batch rows per block: 2, or 4 when 2 would need more blocks than
    the card has SMs (the rule of ``ops/blstm.py``)."""
    n_sm = torch.cuda.get_device_properties(device).multi_processor_count
    return 2 if 2 * -(-b // 2) <= n_sm else 4


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _is_bf16(t: torch.Tensor) -> int:
    return int(t.dtype == torch.bfloat16)


def gemm(a, b, c, bias=None, *, batch, m, n, k, a_strides, b_strides,
         c_strides, ki=None, bias_stride=0, round_bf16=False,
         accumulate=False) -> None:
    """``csrc/gemm.cu``: C[z] (+)= A[z] @ B[z] (+ bias[z]) in float32.

    Strides are in elements. ``a_strides`` = (batch, m, k_outer, k_inner),
    ``b_strides`` = (batch, k_outer, k_inner, n), ``c_strides`` = (batch,
    m, n); the reduction index k splits as (k // ki, k % ki), so a sum
    over (row, frame) pairs of a padded layout is one product.
    ``round_bf16`` rounds both operands to bfloat16 as they are loaded.
    """
    ki = k if ki is None else ki
    launch("gemm", a.data_ptr(), b.data_ptr(), c.data_ptr(),
           0 if bias is None else bias.data_ptr(), batch, m, n, k, ki,
           *a_strides, *b_strides, *c_strides, bias_stride,
           _is_bf16(a), _is_bf16(b), int(round_bf16), int(accumulate),
           _stream(c))


def colsum(x: torch.Tensor, out: torch.Tensor, m: int, n: int) -> None:
    """``csrc/gemm.cu``: out (N,) = column sums of the (M, N) float32 x."""
    launch("colsum", x.data_ptr(), out.data_ptr(), m, n, _stream(x))


def _recurrence_fwd_kernel(gx, wh, lengths):
    b, t = gx.shape[:2]
    h = wh.shape[1]
    out = torch.empty((b, t, 2 * h), dtype=wh.dtype, device=gx.device)
    y_ext = torch.empty((2, b, t + 1, h), dtype=wh.dtype, device=gx.device)
    c_ext = torch.empty((2, b, t + 1, h), device=gx.device)
    launch("blstm_train_fwd", gx.data_ptr(), wh.data_ptr(),
           lengths.data_ptr(), out.data_ptr(), y_ext.data_ptr(),
           c_ext.data_ptr(), b, t, h, _rows_per_block(b, gx.device),
           _is_bf16(wh), _stream(gx))
    return out, y_ext, c_ext


def _recurrence_bwd_kernel(gx, wh, lengths, y_ext, c_ext, dy):
    b, t = gx.shape[:2]
    h = wh.shape[1]
    wh_t = wh.transpose(1, 2).contiguous()  # (2, 4H, H): coalesced dh
    dy = dy.to(wh.dtype).contiguous()
    dgates = torch.empty((b, t, 2, 4 * h), device=gx.device)
    launch("blstm_train_bwd", gx.data_ptr(), wh.data_ptr(), wh_t.data_ptr(),
           lengths.data_ptr(), y_ext.data_ptr(), c_ext.data_ptr(),
           dy.data_ptr(), dgates.data_ptr(), b, t, h,
           _rows_per_block(b, gx.device), _is_bf16(wh), _stream(gx))
    return dgates


def _projection_kernel(xc, wx, bias):
    """gx (B, T, 2, 4H) f32 with gx[:, :, z] = x @ wx[z] + bias[z]."""
    b, t, d = xc.shape
    four_h = wx.shape[-1]
    gx = torch.empty((b, t, 2, four_h), device=xc.device)
    for z in (0, 1):
        gemm(xc, wx[z], gx[:, :, z], bias[z], batch=1, m=b * t, n=four_h,
             k=d, a_strides=(0, d, 0, 1), b_strides=(0, 0, four_h, 1),
             c_strides=(0, 2 * four_h, 1))
    return gx


def _dwh_kernel(y_ext, dgates, b, t, h):
    """dW_h[z] = sum over (row, frame) of y_ext[z, row, frame + 1 - z]^T
    dgates[row, frame, z] (a zero row sits on the other side)."""
    dwh = torch.empty((2, h, 4 * h), device=dgates.device)
    for z in (0, 1):
        # h_prev rows: forward 0..T-1, backward 1..T
        gemm(y_ext[z, :, z:], dgates[:, :, z], dwh[z], batch=1, m=h, n=4 * h,
             k=b * t, ki=t, a_strides=(0, 1, (t + 1) * h, h),
             b_strides=(0, t * 8 * h, 8 * h, 1), c_strides=(0, 4 * h, 1),
             round_bf16=y_ext.dtype == torch.bfloat16)
    return dwh


def _check_recurrence(gx, wh, lengths):
    b, t, two, four_h = gx.shape
    h = four_h // 4
    check(two == 2 and four_h == 4 * h, f"gx shape {tuple(gx.shape)}")
    check(gx.dtype == torch.float32, f"gx dtype {gx.dtype}")
    check(tuple(wh.shape) == (2, h, four_h), f"wh shape {tuple(wh.shape)}")
    check(wh.dtype in (torch.float32, torch.bfloat16), f"wh dtype {wh.dtype}")
    check(1 <= h <= MAX_HIDDEN, f"H={h} outside [1, {MAX_HIDDEN}]")
    check(tuple(lengths.shape) == (b,), f"lengths shape {tuple(lengths.shape)}")


# --------------------------------------------------------------------------
# autograd functions
# --------------------------------------------------------------------------


class _BLSTMTrain(torch.autograd.Function):
    """x (B, T, D), lengths, wx (2, D, 4H), wh (2, H, 4H) in the compute
    dtype, bias (2, 4H) f32 -> (B, T, 2H) in the compute dtype."""

    @staticmethod
    def forward(ctx, x, lengths, wx, wh, bias, kernel: bool):
        xc = x.to(wx.dtype).contiguous()
        lengths = lengths.to(torch.int32).contiguous()
        if kernel:
            gx = _projection_kernel(xc, wx, bias)
            y, y_ext, c_ext = _recurrence_fwd_kernel(gx, wh, lengths)
        else:
            gx = torch.einsum("btd,zdg->btzg", xc.float(), wx.float()) + bias
            y, y_ext, c_ext = recurrence_fwd_plain(gx, wh, lengths)
        ctx.kernel = kernel
        ctx.x_dtype = x.dtype
        ctx.save_for_backward(xc, lengths, wx, wh, bias, y_ext, c_ext)
        return y

    @staticmethod
    def backward(ctx, dy):
        xc, lengths, wx, wh, bias, y_ext, c_ext = ctx.saved_tensors
        b, t, d = xc.shape
        h = wh.shape[1]
        cd = wx.dtype
        if ctx.kernel:
            blstm_train.launches += 1
            gx = _projection_kernel(xc, wx, bias)  # recomputed, not stored
            dg = _recurrence_bwd_kernel(gx, wh, lengths, y_ext, c_ext, dy)
            rnd = cd == torch.bfloat16
            dx = torch.empty((b, t, d), device=xc.device)
            for z in (0, 1):  # dx = sum_z dgates[z] @ wx[z]^T
                gemm(dg[:, :, z], wx[z], dx, batch=1, m=b * t, n=d, k=4 * h,
                     a_strides=(0, 8 * h, 0, 1), b_strides=(0, 0, 1, 4 * h),
                     c_strides=(0, d, 1), round_bf16=rnd, accumulate=z == 1)
            dwx = torch.empty((2, d, 4 * h), device=xc.device)
            for z in (0, 1):  # dwx[z] = x^T @ dgates[z]
                gemm(xc, dg[:, :, z], dwx[z], batch=1, m=d, n=4 * h,
                     k=b * t, a_strides=(0, 1, 0, d),
                     b_strides=(0, 0, 8 * h, 1), c_strides=(0, 4 * h, 1),
                     round_bf16=rnd)
            dwh = _dwh_kernel(y_ext, dg, b, t, h)
            dbias = torch.empty((2 * 4 * h,), device=xc.device)
            colsum(dg, dbias, b * t, 8 * h)
            dbias = dbias.view(2, 4 * h)
        else:
            gx = torch.einsum("btd,zdg->btzg", xc.float(), wx.float()) + bias
            dg = recurrence_bwd_plain(gx, wh, lengths, y_ext, c_ext, dy)
            dgc = dg.to(cd).float()
            dx = torch.einsum("btzg,zdg->btd", dgc, wx.float())
            dwx = torch.einsum("btd,btzg->zdg", xc.float(), dgc)
            dwh = _dwh_plain(y_ext, dg, t)
            dbias = dg.sum(dim=(0, 1))
        return (dx.to(ctx.x_dtype), None, dwx.to(cd), dwh.to(cd), dbias,
                None)


class _BLSTMTrainGx(torch.autograd.Function):
    """gx (B, T, 2, 4H) f32 (projection incl. bias), wh (2, H, 4H) in the
    compute dtype, lengths -> (B, T, 2H) in the compute dtype."""

    @staticmethod
    def forward(ctx, gx, wh, lengths, kernel: bool):
        gx = gx.contiguous()
        lengths = lengths.to(torch.int32).contiguous()
        if kernel:
            y, y_ext, c_ext = _recurrence_fwd_kernel(gx, wh, lengths)
        else:
            y, y_ext, c_ext = recurrence_fwd_plain(gx, wh, lengths)
        ctx.kernel = kernel
        ctx.save_for_backward(gx, wh, lengths, y_ext, c_ext)
        return y

    @staticmethod
    def backward(ctx, dy):
        gx, wh, lengths, y_ext, c_ext = ctx.saved_tensors
        b, t = gx.shape[:2]
        h = wh.shape[1]
        if ctx.kernel:
            blstm_train_gx.launches += 1
            dg = _recurrence_bwd_kernel(gx, wh, lengths, y_ext, c_ext, dy)
            dwh = _dwh_kernel(y_ext, dg, b, t, h)
        else:
            dg = recurrence_bwd_plain(gx, wh, lengths, y_ext, c_ext, dy)
            dwh = _dwh_plain(y_ext, dg, t)
        return dg, dwh.to(wh.dtype), None, None


# --------------------------------------------------------------------------
# public entry points
# --------------------------------------------------------------------------


def blstm_train_plain(x, lengths, wx, wh, bias) -> torch.Tensor:
    """Plain version of ``blstm_train`` on any device."""
    blstm_train_plain.calls += 1
    return _BLSTMTrain.apply(x, lengths, wx, wh, bias, False)


blstm_train_plain.calls = 0


def blstm_train(x: torch.Tensor, lengths: torch.Tensor, wx: torch.Tensor,
                wh: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """Differentiable BLSTM layer, the contract of
    ``blstm_train_pallas.py::blstm_train``: x (B, T, D), lengths (B,),
    wx (2, D, 4H) and wh (2, H, 4H) in the compute dtype, bias (2, 4H)
    float32 -> (B, T, 2H) in the compute dtype, pad frames zero.

    CPU tensors run the plain version; CUDA tensors launch
    ``csrc/gemm.cu`` and ``csrc/blstm_train.cu`` or raise.
    """
    if not on_cuda(x, lengths, wx, wh, bias):
        return blstm_train_plain(x, lengths, wx, wh, bias)
    b, t, d = x.shape
    h = wh.shape[1]
    check(tuple(wx.shape) == (2, d, 4 * h), f"wx shape {tuple(wx.shape)}")
    check(tuple(wh.shape) == (2, h, 4 * h), f"wh shape {tuple(wh.shape)}")
    check(wx.dtype == wh.dtype and wh.dtype in (torch.float32, torch.bfloat16),
          f"wx {wx.dtype} and wh {wh.dtype}: one of float32, bfloat16")
    check(tuple(bias.shape) == (2, 4 * h) and bias.dtype == torch.float32,
          f"bias must be (2, 4H) float32, got {tuple(bias.shape)}")
    check(1 <= h <= MAX_HIDDEN, f"H={h} outside [1, {MAX_HIDDEN}]")
    check(tuple(lengths.shape) == (b,), f"lengths shape {tuple(lengths.shape)}")
    blstm_train.launches += 1
    return _BLSTMTrain.apply(x, lengths, wx.contiguous(), wh.contiguous(),
                             bias.contiguous(), True)


blstm_train.launches = 0


def blstm_train_gx_plain(gx, wh, lengths) -> torch.Tensor:
    """Plain version of ``blstm_train_gx`` on any device."""
    blstm_train_gx_plain.calls += 1
    return _BLSTMTrainGx.apply(gx, wh, lengths, False)


blstm_train_gx_plain.calls = 0


def blstm_train_gx(gx: torch.Tensor, wh: torch.Tensor,
                   lengths: torch.Tensor) -> torch.Tensor:
    """Differentiable frame loops of the gate-stream variant
    (``blstm_train_pallas.py::blstm_train_gx``): gx (B, T, 2, 4H) float32
    projections including the bias, wh (2, H, 4H) in the compute dtype,
    lengths (B,) -> (B, T, 2H) in the compute dtype.

    CPU tensors run the plain version; CUDA tensors launch
    ``csrc/blstm_train.cu`` or raise (H above ``MAX_HIDDEN`` included).
    """
    if not on_cuda(gx, wh, lengths):
        return blstm_train_gx_plain(gx, wh, lengths)
    _check_recurrence(gx, wh, lengths)
    blstm_train_gx.launches += 1
    return _BLSTMTrainGx.apply(gx, wh.contiguous(), lengths, True)


blstm_train_gx.launches = 0


def train_kernel_for(b: int, t: int, d: int, h: int,
                     dtype: torch.dtype) -> str:
    """"fused" (``blstm_train``) where the JAX package's rule takes its
    W_x-resident kernel, else "gx" (``blstm_train_gx``): also where the
    reference falls back to its scan, since the port's gx kernel takes any
    H up to ``MAX_HIDDEN``."""
    itemsize = torch.finfo(dtype).bits // 8
    return "fused" if fused_train_fits(b, t, d, h, itemsize) else "gx"

