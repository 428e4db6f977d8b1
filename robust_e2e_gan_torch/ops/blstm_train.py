"""Differentiable masked bidirectional LSTM for training: the kernels'
autograd wrappers and their plain PyTorch versions.

Counterparts of ``robust_e2e_gan_tpu/ops/blstm_train_pallas.py``:

* ``blstm_train(x, lengths, wx, wh, bias)`` (TPU ``blstm_train``, the
  W_x-resident variant): the input projection ``x @ W_x + bias``, its
  gradients ``dx``, ``dW_x``, ``dbias`` and ``dW_h`` are products of
  ``csrc/gemm.cu`` (``gemm``: tensor-core tiles, split-K where
  ``gemm_plan`` finds too few tiles for the SMs, one launch a product for
  both directions; ``colsum`` for ``dbias``); the frame loops are
  ``csrc/blstm_train_resident.cu`` where ``resident_plan`` fits, else
  ``csrc/blstm_train.cu``. Nothing goes through ``torch.matmul``.
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

import contextlib
from typing import NamedTuple, Optional, Tuple

import torch

from robust_e2e_gan_torch.utils.build import launch
from robust_e2e_gan_torch.utils.impl import check, device_limits, on_cuda
from robust_e2e_gan_torch.utils.trace import traced

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
# which frame loops a layer takes: the resident loops of
# csrc/blstm_train_resident.cu where their plan fits, else those of
# csrc/blstm_train.cu; a rule computed before the launch
# --------------------------------------------------------------------------


RESIDENT_THREADS = 512  # a resident block's threads (NT of the source)


def resident_smem(b: int, h: int, n_u: int, itemsize: int) -> int:
    """Bytes of dynamic shared memory of one resident block: the rounded
    dgates, two buffers of gate pre-activations and two of c and dy
    (B x 4n_u float32 each), the summed dh and the carried c or dc
    (B x n_u float32 each), the lengths and the step count (B + 1 int32),
    two B x H stages of h_{t-1} and the block's W_h slice (H x 4n_u), both
    in the compute dtype (the forward's one float32 stage takes the same
    bytes). ``smem_bytes`` of the kernel source computes the same."""
    c = 4 * n_u
    return (4 * (5 * b * c + 2 * b * n_u + b + 1)
            + (2 * b * h + c * h) * itemsize)


def resident_plan(b: int, h: int, itemsize: int, n_sm: int,
                  smem_per_block: int):
    """(n_u, P, smem) of the resident frame loops, or None where they do
    not fit: each direction's P = ceil(H / n_u) blocks own n_u hidden units
    each, the 2P blocks of both directions fit one per SM (the smallest
    such n_u, which also keeps the W_h slice smallest), a block's 4 n_u
    gate columns are at most its 512 threads, and its ``resident_smem``
    fits ``smem_per_block``."""
    if n_sm < 2:
        return None
    n_u = -(-h // (n_sm // 2))
    p = -(-h // n_u)
    smem = resident_smem(b, h, n_u, itemsize)
    fits = 4 * n_u <= RESIDENT_THREADS and smem <= smem_per_block
    return (n_u, p, smem) if fits else None


# frame-loop launches (forward and backward each) by route
ROUTE_LAUNCHES = {"resident": 0, "loop": 0}
_forced_route = None


@contextlib.contextmanager
def _force_route(route: str):
    """Run the frame loops of every layer on one route ("resident" or
    "loop") inside the block: the tests and ``chip_smoke.py`` hold both
    routes to the plain version. Forcing "resident" where the plan does not
    fit raises at the launch."""
    global _forced_route
    check(route in ("resident", "loop"), f"unknown route {route!r}")
    prev, _forced_route = _forced_route, route
    try:
        yield
    finally:
        _forced_route = prev


def _resident(b: int, h: int, wh: torch.Tensor):
    """The resident plan of this layer on wh's card, or None for the loops
    of ``csrc/blstm_train.cu``."""
    if _forced_route == "loop":
        return None
    plan = resident_plan(b, h, wh.element_size(),
                         *device_limits(wh.device.index))
    check(plan is not None or _forced_route is None,
          f"the resident frame loops do not fit B={b} H={h} {wh.dtype}")
    return plan


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


# --------------------------------------------------------------------------
# the products: csrc/gemm.cu's tensor-core kernel, its plan and copy widths,
# and its plain version
# --------------------------------------------------------------------------

GEMM_TILE = (128, 128, 32)  # output rows, columns and k a chunk (BM, BN, BK)
# by compute itemsize (2: bfloat16; 4: float32 as 3xTF32): chunks in flight
# and the bytes of one operand's stage, the larger of its [mn][k] and
# [k][mn] layouts (in tf32 a hi and a lo tile); Cfg of csrc/gemm.cu
GEMM_STAGES = {2: 4, 4: 2}
GEMM_TILE_BYTES = {2: 128 * 40 * 2, 4: 2 * 128 * 36 * 4}
# blocks a multiprocessor runs at once (the kernel's launch bounds: two in
# bfloat16, one in tf32)
GEMM_BLOCKS_PER_SM = {2: 2, 4: 1}
GEMM_MIN_SLICE = 8  # chunks a k slice at least


class GemmPlan(NamedTuple):
    tile: Tuple[int, int, int]  # (BM, BN, BK)
    splits: int  # k slices
    slice_chunks: int  # chunks of BK a slice
    workspace: int  # bytes of float32 partial tiles (0 without split-K)
    smem: int  # dynamic shared memory of a block


def gemm_plan(m: int, n: int, k: int, itemsize: int, n_sm: int,
              smem_per_block: int, batch: int = 1) -> Optional[GemmPlan]:
    """The launch plan of ``csrc/gemm.cu``'s tensor-core kernel for
    ``batch`` products of (m, k) x (k, n) in the compute type of
    ``itemsize`` bytes, or None where it does not fit the card.

    Integer arithmetic. One block an output tile of 128 x 128. Where the
    tiles of all batches fill at most half of the blocks the card runs at
    once (``n_sm`` x ``GEMM_BLOCKS_PER_SM``), K is split into S slices of
    whole 32-k chunks, S the most that keep every block in that one wave
    (so tiles x S >= n_sm wherever K allows), at least
    ``GEMM_MIN_SLICE`` chunks a slice and none empty; the slices' float32
    partial tiles take ``tiles x S x 128 x 128 x 4`` bytes of workspace.
    The ring of ``GEMM_STAGES`` stages must fit ``smem_per_block``.
    """
    if itemsize not in GEMM_STAGES or min(m, n, k) < 0 or batch < 1:
        return None
    bm, bn, bk = GEMM_TILE
    smem = GEMM_STAGES[itemsize] * 2 * GEMM_TILE_BYTES[itemsize]
    if smem > smem_per_block:
        return None
    tiles = batch * -(-m // bm) * -(-n // bn)
    chunks = -(-k // bk)
    slots = n_sm * GEMM_BLOCKS_PER_SM[itemsize]
    splits = 1
    if 0 < tiles <= slots // 2:
        splits = max(1, min(slots // tiles, chunks // GEMM_MIN_SLICE))
    per = max(1, -(-chunks // splits))
    splits = max(1, -(-chunks // per))
    workspace = tiles * splits * bm * bn * 4 if splits > 1 else 0
    return GemmPlan((bm, bn, bk), splits, per, workspace, smem)


# copy modes of csrc/gemm.cu (enum Mode) by (itemsize, elements a copy)
_COPY_MODES = {(4, 4): 0, (4, 1): 1, (2, 8): 2, (2, 2): 3, (2, 1): 4}


def copy_mode(ptr: int, itemsize: int, mn: int, k: int, ki: int,
              s_batch: int, s_mn: int, s_k1: int, s_k0: int):
    """(k-contiguous staging, copy mode) of one operand of ``gemm``: its
    tiles are staged with their rows along k where k has stride 1 (or
    neither k nor m/n has), else along m (A) or n (B). A copy takes 16
    bytes, or 4, or one element: the widest whose pieces start on a
    multiple of their size (the base pointer and every stride but the
    contiguous one's a multiple of the piece) and never cross the edge of
    the contiguous axis or of a k // ki segment. ``csrc/gemm.cu``'s
    ``mode_fits`` checks the same before the launch."""
    kcol = s_k0 == 1 or s_mn != 1
    if kcol:
        contiguous, rest = s_k0 == 1, (s_batch, s_mn, s_k1, ki, k)
    else:
        contiguous, rest = True, (s_batch, s_k1, s_k0, mn)
    for vec in (16 // itemsize, 4 // itemsize):
        if (vec > 1 and contiguous and ptr % (vec * itemsize) == 0
                and all(x % vec == 0 for x in rest)):
            return kcol, _COPY_MODES[itemsize, vec]
    return kcol, _COPY_MODES[itemsize, 1]


def _operand_view(x: torch.Tensor, batch: int, rows: int, k: int, ki: int,
                  s_batch: int, s_rows: int, s_k1: int, s_k0: int):
    """x read as (batch, rows, k) through element strides, k split as
    (k // ki, k % ki)."""
    q, r = divmod(k, ki)
    base = x.storage_offset()
    parts = []
    if q:
        parts.append(torch.as_strided(x, (batch, rows, q, ki),
                                      (s_batch, s_rows, s_k1, s_k0), base)
                     .reshape(batch, rows, q * ki))
    if r:
        parts.append(torch.as_strided(x, (batch, rows, r),
                                      (s_batch, s_rows, s_k0),
                                      base + q * s_k1))
    if not parts:
        return x.new_zeros((batch, rows, 0))
    return torch.cat(parts, -1) if len(parts) > 1 else parts[0]


@contextlib.contextmanager
def _full_f32():
    """float32 products in float32, not TF32, inside the block."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def gemm_plain(a, b, c, bias=None, *, batch, m, n, k, a_strides, b_strides,
               c_strides, ki=None, bias_stride=0, round_bf16=False,
               accumulate=False) -> None:
    """Plain version of ``gemm`` on any device: the strided views, the
    bfloat16 rounding, one float32 product (TF32 off), then the bias and
    the write or the add into c."""
    gemm_plain.calls += 1
    ki = k if ki is None else ki
    sa_b, sa_m, sa_k1, sa_k0 = a_strides
    sb_b, sb_k1, sb_k0, sb_n = b_strides
    av = _operand_view(a, batch, m, k, ki, sa_b, sa_m, sa_k1, sa_k0).float()
    bv = _operand_view(b, batch, n, k, ki, sb_b, sb_n, sb_k1,
                       sb_k0).float().transpose(1, 2)
    if round_bf16:
        av, bv = av.bfloat16().float(), bv.bfloat16().float()
    with _full_f32():
        out = torch.matmul(av, bv)
    if bias is not None:
        out = out + torch.as_strided(bias, (batch, 1, n), (bias_stride, 0, 1),
                                     bias.storage_offset())
    cv = torch.as_strided(c, (batch, m, n), c_strides, c.storage_offset())
    if accumulate:
        cv.add_(out)
    else:
        cv.copy_(out)


gemm_plain.calls = 0

# launches of the products by route: "tc" the tensor-core kernel, "simt"
# the SIMT kernel it replaced, run only where forced
GEMM_ROUTE_LAUNCHES = {"tc": 0, "simt": 0}
_forced_gemm_route = None


@contextlib.contextmanager
def _force_gemm_route(route: str):
    """Run every product on one route ("tc" or "simt") inside the block:
    the tests and ``chip_smoke.py`` time and hold the SIMT kernel against
    the tensor-core one. Forcing "tc" where its plan does not fit raises."""
    global _forced_gemm_route
    check(route in GEMM_ROUTE_LAUNCHES, f"unknown gemm route {route!r}")
    prev, _forced_gemm_route = _forced_gemm_route, route
    try:
        yield
    finally:
        _forced_gemm_route = prev


# split-K tickets by (card, stream): one int32 a tile, zero between
# launches (the last block of a tile resets its ticket)
_TICKETS = {}


def _tickets(dev: torch.device, stream: int, n: int) -> torch.Tensor:
    key = (dev.index, stream)
    t = _TICKETS.get(key)
    if t is None or t.numel() < n:
        t = torch.zeros(max(n, 1024), dtype=torch.int32, device=dev)
        _TICKETS[key] = t
    return t


@traced("rg.op.gemm")
def gemm(a, b, c, bias=None, *, batch, m, n, k, a_strides, b_strides,
         c_strides, ki=None, bias_stride=0, round_bf16=False,
         accumulate=False) -> None:
    """``csrc/gemm.cu``: C[z] (+)= A[z] @ B[z] (+ bias[z]) in float32.

    Strides are in elements. ``a_strides`` = (batch, m, k_outer, k_inner),
    ``b_strides`` = (batch, k_outer, k_inner, n), ``c_strides`` = (batch,
    m, n); the reduction index k splits as (k // ki, k % ki), so a sum
    over (row, frame) pairs of a padded layout is one product.
    ``round_bf16`` rounds both operands to bfloat16 as they are loaded.
    The compute type is bfloat16 (tensor cores, ``mma.sync`` m16n8k16)
    where ``round_bf16`` is set or both operands are bfloat16, else float32
    as 3xTF32. CPU tensors run ``gemm_plain``; CUDA tensors launch the
    tensor-core kernel with ``gemm_plan``'s split of K, or raise.
    """
    if not on_cuda(a, b, c):
        gemm_plain(a, b, c, bias, batch=batch, m=m, n=n, k=k,
                   a_strides=a_strides, b_strides=b_strides,
                   c_strides=c_strides, ki=ki, bias_stride=bias_stride,
                   round_bf16=round_bf16, accumulate=accumulate)
        return
    ki = k if ki is None else ki
    check(c.dtype == torch.float32, f"gemm writes float32, not {c.dtype}")
    check(bias is None or bias.dtype == torch.float32,
          "gemm's bias must be float32")
    for x in (a, b):
        check(x.dtype in (torch.float32, torch.bfloat16),
              f"gemm operand dtype {x.dtype}")
    bias_ptr = 0 if bias is None else bias.data_ptr()
    if _forced_gemm_route == "simt":
        GEMM_ROUTE_LAUNCHES["simt"] += 1
        launch("gemm_simt", a.data_ptr(), b.data_ptr(), c.data_ptr(),
               bias_ptr, batch, m, n, k, ki, *a_strides, *b_strides,
               *c_strides, bias_stride, _is_bf16(a), _is_bf16(b),
               int(round_bf16), int(accumulate), _stream(c))
        return
    tf32 = not (round_bf16 or (_is_bf16(a) and _is_bf16(b)))
    plan = gemm_plan(m, n, k, 4 if tf32 else 2,
                     *device_limits(c.device.index), batch=batch)
    check(plan is not None, f"gemm's plan does not fit batch={batch} M={m} "
          f"N={n} K={k} on this card")
    sa_b, sa_m, sa_k1, sa_k0 = a_strides
    sb_b, sb_k1, sb_k0, sb_n = b_strides
    a_kcol, mode_a = copy_mode(a.data_ptr(), a.element_size(), m, k, ki,
                               sa_b, sa_m, sa_k1, sa_k0)
    b_kcol, mode_b = copy_mode(b.data_ptr(), b.element_size(), n, k, ki,
                               sb_b, sb_n, sb_k1, sb_k0)
    ws = tickets = None
    if plan.splits > 1:
        bm, bn, _ = plan.tile
        ws = torch.empty(plan.workspace // 4, device=c.device)
        tickets = _tickets(c.device, _stream(c),
                           batch * -(-m // bm) * -(-n // bn))
    gemm.launches += 1
    GEMM_ROUTE_LAUNCHES["tc"] += 1
    launch("gemm", a.data_ptr(), b.data_ptr(), c.data_ptr(), bias_ptr,
           0 if ws is None else ws.data_ptr(),
           0 if tickets is None else tickets.data_ptr(), batch, m, n, k, ki,
           *a_strides, *b_strides, *c_strides, bias_stride, mode_a,
           int(a_kcol), mode_b, int(b_kcol), int(tf32), int(accumulate),
           plan.splits, plan.slice_chunks, plan.smem, _stream(c))


gemm.launches = 0


def colsum(x: torch.Tensor, out: torch.Tensor, m: int, n: int) -> None:
    """``csrc/gemm.cu``: out (N,) = column sums of the (M, N) float32 x."""
    launch("colsum", x.data_ptr(), out.data_ptr(), m, n, _stream(x))


def _barrier_count(device) -> torch.Tensor:
    """The resident loops' two barrier counters (one per direction, 128
    bytes apart), zeroed."""
    return torch.zeros(64, dtype=torch.int32, device=device)


def _recurrence_fwd_kernel(gx, wh, lengths):
    b, t = gx.shape[:2]
    h = wh.shape[1]
    out = torch.empty((b, t, 2 * h), dtype=wh.dtype, device=gx.device)
    y_ext = torch.empty((2, b, t + 1, h), dtype=wh.dtype, device=gx.device)
    c_ext = torch.empty((2, b, t + 1, h), device=gx.device)
    plan = _resident(b, h, wh)
    if plan is None:
        ROUTE_LAUNCHES["loop"] += 1
        launch("blstm_train_fwd", gx.data_ptr(), wh.data_ptr(),
               lengths.data_ptr(), out.data_ptr(), y_ext.data_ptr(),
               c_ext.data_ptr(), b, t, h, _rows_per_block(b, gx.device),
               _is_bf16(wh), _stream(gx))
    else:
        ROUTE_LAUNCHES["resident"] += 1
        count = _barrier_count(gx.device)
        launch("blstm_train_resident_fwd", gx.data_ptr(), wh.data_ptr(),
               lengths.data_ptr(), out.data_ptr(), y_ext.data_ptr(),
               c_ext.data_ptr(), count.data_ptr(), b, t, h, plan[0],
               _is_bf16(wh), _stream(gx))
    return out, y_ext, c_ext


def _recurrence_bwd_kernel(gx, wh, lengths, y_ext, c_ext, dy):
    b, t = gx.shape[:2]
    h = wh.shape[1]
    dy = dy.to(wh.dtype).contiguous()
    dgates = torch.empty((b, t, 2, 4 * h), device=gx.device)
    plan = _resident(b, h, wh)
    if plan is None:
        ROUTE_LAUNCHES["loop"] += 1
        wh_t = wh.transpose(1, 2).contiguous()  # (2, 4H, H): coalesced dh
        launch("blstm_train_bwd", gx.data_ptr(), wh.data_ptr(),
               wh_t.data_ptr(), lengths.data_ptr(), y_ext.data_ptr(),
               c_ext.data_ptr(), dy.data_ptr(), dgates.data_ptr(), b, t, h,
               _rows_per_block(b, gx.device), _is_bf16(wh), _stream(gx))
    else:
        ROUTE_LAUNCHES["resident"] += 1
        n_u, p, _ = plan
        # each block's partial dh_{t-1}, per direction and step parity
        part = torch.empty((2, 2, p, b, h), device=gx.device)
        count = _barrier_count(gx.device)
        launch("blstm_train_resident_bwd", gx.data_ptr(), wh.data_ptr(),
               lengths.data_ptr(), y_ext.data_ptr(), c_ext.data_ptr(),
               dy.data_ptr(), dgates.data_ptr(), part.data_ptr(),
               count.data_ptr(), b, t, h, n_u, _is_bf16(wh), _stream(gx))
    return dgates


def _projection_kernel(xc, wx, bias, product=None):
    """gx (B, T, 2, 4H) f32 with gx[:, :, z] = x @ wx[z] + bias[z]: one
    product for both directions (z the batch index). ``product`` is
    ``gemm`` unless given (its plain version, to time or test the same
    product); so for the three below."""
    b, t, d = xc.shape
    four_h = wx.shape[-1]
    gx = torch.empty((b, t, 2, four_h), device=xc.device)
    (product or gemm)(
        xc, wx, gx, bias, batch=2, m=b * t, n=four_h, k=d,
        a_strides=(0, d, 0, 1), b_strides=(d * four_h, 0, four_h, 1),
        c_strides=(four_h, 2 * four_h, 1), bias_stride=four_h)
    return gx


def _dx_kernel(dg, wx, rnd, product=None):
    """dx (B, T, D) f32 = sum over z of dgates[:, :, z] @ wx[z]^T: one
    product over both directions' gates, K = 8H split as (z, gate) by
    KI = 4H."""
    b, t, _, four_h = dg.shape
    d = wx.shape[1]
    dx = torch.empty((b, t, d), device=dg.device)
    (product or gemm)(
        dg, wx, dx, batch=1, m=b * t, n=d, k=2 * four_h, ki=four_h,
        a_strides=(0, 2 * four_h, four_h, 1),
        b_strides=(0, d * four_h, 1, four_h), c_strides=(0, d, 1),
        round_bf16=rnd)
    return dx


def _dwx_kernel(xc, dg, rnd, product=None):
    """dW_x (2, D, 4H) f32, dW_x[z] = x^T @ dgates[:, :, z]: one product
    for both directions."""
    b, t, d = xc.shape
    four_h = dg.shape[-1]
    dwx = torch.empty((2, d, four_h), device=xc.device)
    (product or gemm)(
        xc, dg, dwx, batch=2, m=d, n=four_h, k=b * t,
        a_strides=(0, 1, 0, d), b_strides=(four_h, 0, 2 * four_h, 1),
        c_strides=(d * four_h, four_h, 1), round_bf16=rnd)
    return dwx


def _dwh_kernel(y_ext, dgates, b, t, h, product=None):
    """dW_h[z] = sum over (row, frame) of y_ext[z, row, frame + z]^T
    dgates[row, frame, z] (a zero row sits on the other side): one product
    for both directions, z the batch index, k = (row, frame) split by
    KI = T over the padded rows of T + 1."""
    dwh = torch.empty((2, h, 4 * h), device=dgates.device)
    # h_prev rows: forward 0..T-1, backward 1..T (batch stride + H)
    (product or gemm)(
        y_ext, dgates, dwh, batch=2, m=h, n=4 * h, k=b * t, ki=t,
        a_strides=(b * (t + 1) * h + h, 1, (t + 1) * h, h),
        b_strides=(4 * h, t * 8 * h, 8 * h, 1),
        c_strides=(h * 4 * h, 4 * h, 1),
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
            dx = _dx_kernel(dg, wx, rnd)
            dwx = _dwx_kernel(xc, dg, rnd)
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


@traced("rg.op.blstm_train")
def blstm_train(x: torch.Tensor, lengths: torch.Tensor, wx: torch.Tensor,
                wh: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """Differentiable BLSTM layer, the contract of
    ``blstm_train_pallas.py::blstm_train``: x (B, T, D), lengths (B,),
    wx (2, D, 4H) and wh (2, H, 4H) in the compute dtype, bias (2, 4H)
    float32 -> (B, T, 2H) in the compute dtype, pad frames zero.

    CPU tensors run the plain version; CUDA tensors launch
    ``csrc/gemm.cu`` and the frame loops (``resident_plan``) or raise.
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


@traced("rg.op.blstm_train_gx")
def blstm_train_gx(gx: torch.Tensor, wh: torch.Tensor,
                   lengths: torch.Tensor) -> torch.Tensor:
    """Differentiable frame loops of the gate-stream variant
    (``blstm_train_pallas.py::blstm_train_gx``): gx (B, T, 2, 4H) float32
    projections including the bias, wh (2, H, 4H) in the compute dtype,
    lengths (B,) -> (B, T, 2H) in the compute dtype.

    CPU tensors run the plain version; CUDA tensors launch
    the frame loops (``resident_plan``) or raise (H above ``MAX_HIDDEN``
    included).
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

