"""Masked bidirectional LSTM for inference: the kernels' wrappers, their
plain PyTorch versions, and the rule that picks one per layer.

Counterparts of ``robust_e2e_gan_tpu/ops/blstm_pallas.py::blstm_infer``
in its two variants:

* ``blstm_infer(x, lengths, wx, wh, bias)``, the W_x-resident variant
  (``_fused_kernel``): raw input frames in, hidden states out, in one
  launch; the input projection is computed in the kernel a chunk of
  frames at a time, so no gate tensor goes through device memory. Two
  kernels compute it, chosen by ``cluster_plan`` before the launch: the
  "cluster" route (``csrc/blstm_infer_cluster.cu``: W_h split over a
  thread-block cluster, h exchanged through distributed shared memory)
  where the plan fits, else the "row-tiled" route
  (``csrc/blstm_infer.cu``).
* ``blstm_recurrence(gx, wh, lengths)``, the gate-stream variant
  (``_gx_kernel``): the input projection of both directions is one matrix
  product over the whole sequence (``models/rnn.py::input_projection``)
  and the serial frame loop is a kernel chosen by ``gx_plan`` before the
  launch: the "grid" route (``csrc/blstm_gx_grid.cu``: W_h split by gate
  columns over a co-resident grid, the recurrent product on the tensor
  cores, h exchanged through L2 at one barrier a frame) where the plan
  fits, else the "row_tiled" route (``csrc/blstm.cu``).

``infer_kernel_for`` is the JAX package's choice between the two. Masks
are length masks: frames at or past a row's length leave the state
unchanged and come out as exact zeros. Both kernels round ``h`` to the
compute dtype for the recurrent product, as the JAX kernels do; the plain
frame loop takes ``round_h`` for that, and the JAX scan's arithmetic
(``h`` promoted to float32) without it.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
from typing import Callable, NamedTuple, Optional

import torch
import torch.nn.functional as F

from robust_e2e_gan_torch.utils.build import launch
from robust_e2e_gan_torch.utils.impl import (
    aligned16,
    check,
    check_no_grad,
    device_limits,
    grid_barrier,
    on_cuda,
)

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
# which kernel runs blstm_infer: the cluster route of
# csrc/blstm_infer_cluster.cu where its plan fits, else the row-tiled
# csrc/blstm_infer.cu; a rule computed before the launch
# --------------------------------------------------------------------------

CLUSTER_SIZES = (1, 2, 4, 8, 16)  # blocks a cluster (past 8 non-portable)
CLUSTER_PAIRS = 128  # (row, frame) pairs of a chunk: R * F
CLUSTER_PAIRS_WIDE = 64  # the same where part of W_h is in shared memory
CLUSTER_SLICE = 64  # input columns per projection slice (DS)
CLUSTER_UNITS = 32  # hidden units a block at most: 8 warps of 4
CLUSTER_KREG = 256  # rows of W_h a warp holds in registers (16 KMAX)
CLUSTER_WIDE_H = 512  # the one H past them: 16 blocks of 32 units
_PAD = 8  # bf16 elements of padding of a row of an h slice


def cluster_smem(h: int, c: int, r: int, dw: int, resident: bool) -> int:
    """Bytes of dynamic shared memory of one cluster block, n_u = H / C,
    P = 128 (row, frame) pairs a chunk, 64 where H > 256: two x stages (P
    pairs of DS), W_x's columns resident (ceil(DW / DS) slices of 4 n_u
    rows of DS) or two staged slices of them, where H > 256 W_h's rows past
    the 256 the registers hold (4 n_u columns of H - 256), two h buffers (C
    slices of R rows of n_u + 8), all bfloat16; the chunk's gx (P pairs by
    4 n_u columns, float32); R int32 lengths, seven 8-byte mbarriers and
    1 KB to align the base. ``smem_bytes`` of the kernel source computes
    the same."""
    n_u = h // c
    n = 4 * n_u
    wide = h > CLUSTER_KREG
    pairs = CLUSTER_PAIRS_WIDE if wide else CLUSTER_PAIRS
    slices = -(-dw // CLUSTER_SLICE) if resident else 2
    elems = (2 * pairs * CLUSTER_SLICE + slices * n * CLUSTER_SLICE
             + (n * (h - CLUSTER_KREG) if wide else 0)
             + 2 * c * r * (n_u + _PAD))
    return 1024 + 2 * elems + 4 * pairs * n + 4 * r + 56


def cluster_plan(b: int, d: int, h: int, itemsize: int, n_sm: int,
                 smem_optin: int, max_clusters: int | None = None):
    """(C, R, F, W_x resident, shared-memory bytes) of the cluster route,
    or None where it does not fit: bfloat16 only; C, the fewest blocks a
    cluster (of 1, 2, 4, 8, 16) that leaves each at most 32 hidden units, a
    multiple of 8 (16-byte pieces of h); past the 256 rows of W_h the
    registers hold, only H = 512 (16 blocks of 32 units, the kernel's one
    instantiation there); R = 16 rows a group, or 32 where the 2 ceil(B /
    16) clusters of 16-row groups would not all run at once
    (``max_clusters`` of C blocks fit the card, n_sm // C where not given:
    the card's cluster placement can fit fewer, 15 of 8 and 7 of 16 on an
    H100); F = P / R frames a chunk (P = 128 pairs, 64 at H = 512); W_x's
    columns resident where they fit beside the rest, else streamed; the
    block's bytes within ``smem_optin``."""
    if itemsize != 2 or h % 16:
        return None
    c = next((c for c in CLUSTER_SIZES
              if h % (8 * c) == 0 and h // c <= CLUSTER_UNITS), None)
    if c is None or (h > CLUSTER_KREG and h != CLUSTER_WIDE_H):
        return None
    fit = n_sm // c if max_clusters is None else max_clusters
    r = 16 if 2 * -(-b // 16) <= fit else 32
    pairs = CLUSTER_PAIRS_WIDE if h > CLUSTER_KREG else CLUSTER_PAIRS
    dw = _round_up(d, 16)
    for resident in (True, False):
        smem = cluster_smem(h, c, r, dw, resident)
        if smem <= smem_optin:
            return c, r, pairs // r, resident, smem
    return None


# blstm_infer launches by route
INFER_ROUTE_LAUNCHES = {"cluster": 0, "row_tiled": 0}
_forced_infer_route = None


@contextlib.contextmanager
def _force_infer_route(route: str):
    """Run every ``blstm_infer`` launch inside the block on one route
    ("cluster" or "row_tiled"): the tests and ``chip_smoke.py`` hold both
    to the plain version. Forcing "cluster" where the plan does not fit
    raises."""
    global _forced_infer_route
    check(route in INFER_ROUTE_LAUNCHES, f"unknown route {route!r}")
    prev, _forced_infer_route = _forced_infer_route, route
    try:
        yield
    finally:
        _forced_infer_route = prev


@functools.lru_cache(maxsize=None)
def _clusters_at_once(index: int, c: int, smem: int) -> int:
    """Clusters of c blocks of ``smem`` bytes of shared memory (one block
    an SM) that card ``index`` runs at once, as the CUDA runtime places
    them."""
    n = ctypes.c_int(0)
    with torch.cuda.device(index):
        launch("blstm_infer_cluster_fit", c, smem, ctypes.addressof(n))
    return n.value


def infer_route(b: int, d: int, h: int, itemsize: int, n_sm: int,
                smem_optin: int, clusters_at_once: Callable[[int, int], int]):
    """The cluster plan ``blstm_infer`` launches a layer with on a card of
    ``n_sm`` SMs and ``smem_optin`` bytes, or None for the row-tiled
    kernel: ``cluster_plan``, asked again at the ``clusters_at_once(C,
    smem)`` clusters of its C blocks with its shared memory that the card
    runs at once."""
    plan = cluster_plan(b, d, h, itemsize, n_sm, smem_optin)
    if plan is None:
        return None
    return cluster_plan(b, d, h, itemsize, n_sm, smem_optin,
                        max_clusters=clusters_at_once(plan[0], plan[4]))


def card_infer_route(b: int, d: int, h: int, dtype: torch.dtype,
                     index: int):
    """``infer_route`` of a layer on card ``index``."""
    return infer_route(b, d, h, torch.finfo(dtype).bits // 8,
                       *device_limits(index),
                       functools.partial(_clusters_at_once, index))


def _cluster(b: int, d: int, h: int, wh: torch.Tensor):
    """The cluster plan of this layer on wh's card, or None for the
    row-tiled kernel."""
    if _forced_infer_route == "row_tiled":
        return None
    plan = card_infer_route(b, d, h, wh.dtype, wh.device.index)
    check(plan is not None or _forced_infer_route is None,
          f"the cluster route does not fit B={b} D={d} H={h} {wh.dtype}")
    return plan


@functools.lru_cache(maxsize=None)
def _cluster_columns(h: int, c: int, device: torch.device) -> torch.Tensor:
    """The gate columns of (2, ., 4H) weights in the cluster kernel's
    order: block j's 4 n_u columns, 16 per group of 4 units u, ordered
    (i f) of each u, then (g o) of each u. Made once per shape and device:
    a copy from the host would wait for the stream."""
    n_u = h // c
    col = torch.arange(4 * n_u)
    grp, w = col // 16, col % 16
    unit = grp * 4 + (w % 8) // 2
    gate = (w // 8) * 2 + w % 2
    return torch.cat([gate * h + j * n_u + unit for j in range(c)]).to(device)


def _reversed_rows(xc: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """x_rev[b, s] = xc[b, len_b - 1 - s] for s < len_b (and frame 0 past
    it, which no output reads): the backward direction's input in its own
    order, so that the cluster kernel reads the same frame of every row of
    a group as one box. One row gather over (B T, DW), moving the rows as
    8-byte words (DW is a multiple of 16)."""
    b, t, dw = xc.shape
    src = (lengths.long().clamp(0, t)[:, None] - 1
           - torch.arange(t, device=xc.device)[None, :]).clamp(min=0)
    rows = (torch.arange(b, device=xc.device)[:, None] * t + src).reshape(-1)
    words = xc.reshape(b * t, dw).view(torch.int64)
    return words.index_select(0, rows).view(xc.dtype).view(b, t, dw)


def _cluster_pack(wx, wh, bias, dw: int, c: int):
    """wx (2, D, 4H) -> (2, C, N, DW) with zero rows past D, wh (2, H, 4H)
    -> (2, C, N, H), both transposed so that block j's N = 4H / C gate
    columns lie in rows, and bias (2, 4H) -> (2, C, N), in the kernel's
    column order (``_cluster_columns``)."""
    h = wh.shape[1]
    cols = _cluster_columns(h, c, wh.device)
    n = 4 * h // c
    if wx.shape[1] != dw:
        wx = F.pad(wx, (0, 0, 0, dw - wx.shape[1]))
    wxp = wx[:, :, cols].view(2, dw, c, n).permute(0, 2, 3, 1).contiguous()
    whp = wh[:, :, cols].view(2, h, c, n).permute(0, 2, 3, 1).contiguous()
    return wxp, whp, bias[:, cols].contiguous()


# --------------------------------------------------------------------------
# which kernel runs blstm_recurrence: the "grid" route of
# csrc/blstm_gx_grid.cu where gx_plan fits, else the row-tiled csrc/blstm.cu;
# a rule computed before the launch
# --------------------------------------------------------------------------

GX_WARPS = 8  # warps of a grid block (NT / 32 of the source)
GX_CHUNK = 32  # k rows of h and W_h a chunk (KC)
GX_TILES = (1, 2, 4)  # m16 tiles a warp (MW; MW_MAX the largest)
GX_STAGES = 8  # chunks in flight at most (MAX_STAGES)


class GxPlan(NamedTuple):
    """The grid route's launch: P blocks a direction of ``units`` hidden
    units each, the first ``resident`` k rows of a block's W_h slice kept
    in shared memory (the rest streamed a frame), ``stages`` chunks in
    flight, warp tiles of ``m_tiles`` m16 tiles by ``col_groups``
    16-column groups (4 units each), ``k_splits`` warp groups splitting the
    k steps, ``smem`` bytes of shared memory a block."""

    blocks: int
    units: int
    resident: int
    stages: int
    m_tiles: int
    col_groups: int
    k_splits: int
    smem: int


def gx_smem(b: int, h: int, n_u: int, itemsize: int, resident: int,
            stages: int, m_tiles: int, col_groups: int,
            k_splits: int) -> int:
    """Bytes of dynamic shared memory of one grid block, each part rounded
    up to 16 bytes: the resident rows of its W_h slice (rows of 4 n_u + 8
    elements, as ``gx_pack`` pads them), ``stages`` h stages of MA rows (M
    = B rounded up to 16, then up to whole warp tiles of ``m_tiles`` m16
    tiles) of 32 elements, ``stages`` W_h stages of 32 rows where not all
    of H is resident, gx of a frame (M rows of 4 n_u + 4 float32), the k
    slices' sums ((k_splits - 1) x warp tiles x m_tiles x col_groups x 32
    lanes x 8 float32), M + 1 int32 and ``stages`` 8-byte mbarriers.
    ``gx_layout`` of the kernel source computes the same."""
    m = _round_up(b, 16)
    n = 4 * n_u
    ws, gxs = n + 8, n + 4
    blocks_m = -(-(m // 16) // m_tiles)
    ma = blocks_m * m_tiles * 16
    groups = blocks_m * (n_u // 4 // col_groups)
    parts = (resident * ws * itemsize, stages * ma * GX_CHUNK * itemsize,
             stages * GX_CHUNK * ws * itemsize if resident < h else 0,
             m * gxs * 4,
             (k_splits - 1) * groups * m_tiles * col_groups * 32 * 8 * 4,
             (m + 1) * 4, stages * 8)
    return sum(_round_up(x, 16) for x in parts)


def gx_plan(b: int, h: int, itemsize: int, n_sm: int,
            smem_optin: int) -> Optional[GxPlan]:
    """The grid route's plan, or None where it does not fit: H a multiple
    of 32 up to ``MAX_HIDDEN``; n_u the fewest units a block (a multiple of
    4 that divides H) whose 2 H / n_u blocks fit one an SM; the fewest
    m16 tiles a warp (1, 2 or 4) that leave the warp tiles (of one
    16-column group, 4 units) within 8 warps, 4 tiles by one group taken
    as 2 by 2 where the groups pair up (as many warp tiles, fewer fragment
    loads and tf32 splits), and the largest power-of-2 k split of the
    warps left over; all of W_h's slice resident with the most chunks in
    flight (8 at most, 3 at least, or all of H / 32 where fewer) that fit
    ``smem_optin``, else that least number in flight and the most 32-row
    pieces of the slice resident that fit."""
    if b < 1 or h < GX_CHUNK or h % GX_CHUNK or h > MAX_HIDDEN:
        return None
    n_u = next((u for u in range(4, h + 1, 4)
                if h % u == 0 and 2 * (h // u) <= n_sm), None)
    if n_u is None:
        return None
    mt, pairs = _round_up(b, 16) // 16, n_u // 4
    m_tiles = next((w for w in GX_TILES
                    if -(-mt // w) * pairs <= GX_WARPS), None)
    if m_tiles is None:
        return None
    col_groups = 1
    if m_tiles == 4 and pairs % 2 == 0:
        m_tiles, col_groups = 2, 2
    groups = -(-mt // m_tiles) * (pairs // col_groups)
    k_splits = 1
    while groups * k_splits * 2 <= GX_WARPS:
        k_splits *= 2
    chunks = h // GX_CHUNK
    tail = (m_tiles, col_groups, k_splits)
    least = min(3, max(2, chunks))  # chunks in flight at least
    most = min(GX_STAGES, max(2, chunks))
    for ns in range(most, least - 1, -1):
        smem = gx_smem(b, h, n_u, itemsize, h, ns, *tail)
        if smem <= smem_optin:
            return GxPlan(h // n_u, n_u, h, ns, *tail, smem)
    for resident in range(h - GX_CHUNK, -1, -GX_CHUNK):
        smem = gx_smem(b, h, n_u, itemsize, resident, least, *tail)
        if smem <= smem_optin:
            return GxPlan(h // n_u, n_u, resident, least, *tail, smem)
    return None


# blstm_recurrence launches by route
GX_ROUTE_LAUNCHES = {"grid": 0, "row_tiled": 0}
_forced_gx_route = None


@contextlib.contextmanager
def _force_gx_route(route: str):
    """Run every ``blstm_recurrence`` launch inside the block on one route
    ("grid" or "row_tiled"): the tests and ``chip_smoke.py`` hold both to
    the plain version and time them in turns. Forcing "grid" where the plan
    does not fit raises."""
    global _forced_gx_route
    check(route in GX_ROUTE_LAUNCHES, f"unknown route {route!r}")
    prev, _forced_gx_route = _forced_gx_route, route
    try:
        yield
    finally:
        _forced_gx_route = prev


@functools.lru_cache(maxsize=None)
def _gx_plan_on(index: int, b: int, h: int, itemsize: int):
    """The grid plan of these shapes on card ``index``."""
    return gx_plan(b, h, itemsize, *device_limits(index))


def _gx_grid(b: int, h: int, wh: torch.Tensor) -> Optional[GxPlan]:
    """The grid plan of this layer on wh's card, or None for the row-tiled
    kernel: past the plan, or where "row_tiled" is forced."""
    if _forced_gx_route == "row_tiled":
        return None
    plan = _gx_plan_on(wh.device.index, b, h, wh.element_size())
    check(plan is not None or _forced_gx_route is None,
          f"the grid route does not fit B={b} H={h} {wh.dtype}")
    return plan


def gx_pack(wh: torch.Tensor, n_u: int) -> torch.Tensor:
    """wh (2, H, 4H) -> (2, P, H, 4 n_u + 8), P = H / n_u: block p's gate
    columns, in the order of ``_cluster_columns`` with P blocks (16 columns
    a group of 4 units, (i f) of each unit, then (g o) of each unit), so
    that lane t of an m16n8 tile pair holds i, f, g, o of unit t; 8 zero
    columns after them, the padding of the kernel's shared-memory rows, so
    that a chunk of rows is one contiguous copy."""
    h = wh.shape[1]
    p = h // n_u
    cols = _cluster_columns(h, p, wh.device)
    packed = wh[:, :, cols].view(2, h, p, 4 * n_u).permute(0, 2, 1, 3)
    return F.pad(packed, (0, 8)).contiguous()


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

    CPU tensors run the plain version; CUDA tensors launch the kernel of
    the layer's route (``gx_plan``; ``GX_ROUTE_LAUNCHES`` counts them) or
    raise: ``csrc/blstm_gx_grid.cu`` with W_h packed by ``gx_pack`` (at
    every call, as ``_cluster_pack`` packs), else ``csrc/blstm.cu``.
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
    bf16 = int(wh.dtype == torch.bfloat16)
    stream = torch.cuda.current_stream(gx.device).cuda_stream
    plan = _gx_grid(b, h_dim, wh)
    if plan is not None:
        wp = gx_pack(wh, plan.units)
        # h_t of both directions by frame parity, in the compute dtype, as
        # (2, 2, H / 32, B, 32) chunks (the kernel's swizzled layout); zeros
        # where no frame writes
        hbuf = torch.zeros((2, 2, b, h_dim), dtype=wh.dtype, device=gx.device)
        barrier = grid_barrier(gx.device, stream, counters=2)
        launch("blstm_gx_grid", aligned16(gx).data_ptr(), wp.data_ptr(),
               lengths.data_ptr(), hbuf.data_ptr(), out.data_ptr(),
               barrier[0].data_ptr(), b, t, h_dim, plan.units, plan.resident,
               plan.stages, plan.m_tiles, plan.col_groups, plan.k_splits,
               plan.smem, barrier[1], bf16, stream)
        barrier[1] = (barrier[1] + t * plan.blocks) % 2**32
        GX_ROUTE_LAUNCHES["grid"] += 1
    else:
        launch("blstm_recurrence", gx.data_ptr(), wh.data_ptr(),
               lengths.data_ptr(), out.data_ptr(), b, t, h_dim,
               _rows_per_block(b, gx.device), bf16, stream)
        GX_ROUTE_LAUNCHES["row_tiled"] += 1
    blstm_recurrence.launches += 1
    return out


blstm_recurrence.launches = 0


def blstm_infer(x: torch.Tensor, lengths: torch.Tensor, wx: torch.Tensor,
                wh: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """Kernel wrapper, same contract as ``blstm_infer_plain``.

    CPU tensors run the plain version; CUDA tensors launch the kernel of
    the layer's route (``cluster_plan``; ``INFER_ROUTE_LAUNCHES`` counts
    them) or raise. Both kernels project on the tensor cores in bfloat16
    with H a multiple of 16, reading W_x in 16-row tiles, so its rows are
    zero-padded to a multiple of 16 here; the cluster route takes x padded
    the same way, a copy of it reversed per row for the backward direction
    (``_reversed_rows``) and its weights repacked (``_cluster_pack``).
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
    lengths = lengths.to(torch.int32).contiguous()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    out = torch.empty((b, t, 2 * h_dim), dtype=wx.dtype, device=x.device)
    plan = _cluster(b, d, h_dim, wh)
    if plan is not None:
        c, r, _, resident, _ = plan
        dw = _round_up(d, 16)
        wxp, whp, bp = _cluster_pack(wx, wh, bias.contiguous(), dw, c)
        xc = x.to(wx.dtype)
        if dw != d:
            xc = F.pad(xc, (0, dw - d))
        xc = xc.contiguous()
        if xc.data_ptr() % 16:  # the copy engine reads 16-byte aligned rows
            xc = xc.clone()
        xr = _reversed_rows(xc, lengths)
        launch("blstm_infer_cluster", xc.data_ptr(), xr.data_ptr(),
               wxp.data_ptr(), whp.data_ptr(), bp.data_ptr(),
               lengths.data_ptr(), out.data_ptr(), b, t, dw, h_dim, c, r,
               int(resident), stream)
        INFER_ROUTE_LAUNCHES["cluster"] += 1
        blstm_infer.launches += 1
        return out
    bf16 = wx.dtype == torch.bfloat16
    mma = bf16 and h_dim % 16 == 0
    dw = _round_up(d, 16) if mma else d
    if dw != d:
        wx = F.pad(wx, (0, 0, 0, dw - d))
    elif not wx.is_contiguous() or wx.data_ptr() % 32:  # WMMA's alignment
        wx = wx.clone(memory_format=torch.contiguous_format)
    wh, bias = wh.contiguous(), bias.contiguous()
    xc = x.to(wx.dtype).contiguous()
    launch(
        "blstm_infer", xc.data_ptr(), wx.data_ptr(), wh.data_ptr(),
        bias.data_ptr(), lengths.data_ptr(), out.data_ptr(),
        b, t, d, dw, h_dim, _rows_per_block(b, x.device), int(bf16),
        int(mma), stream,
    )
    INFER_ROUTE_LAUNCHES["row_tiled"] += 1
    blstm_infer.launches += 1
    return out


blstm_infer.launches = 0
