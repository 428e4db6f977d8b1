"""RNNLM beam step (shallow fusion): the kernels' wrapper and its plain
PyTorch version.

Counterpart of ``robust_e2e_gan_tpu/ops/lm_step_pallas.py::lm_step_fused``:
embedding row, L stacked LSTM cells and the vocabulary readout of N
hypothesis lanes in one launch. Numerics are the TPU kernel's: float32
carries and sums, ``h`` rounded to the compute dtype for the recurrent
product, each layer's output rounded to the compute dtype as the next
input, float32 logits. Two kernels compute it: ``csrc/lm_step_tile.cu``
(route "tile": the gate product over all lanes in 64-lane tiles of 32
units' four gates, each weight read once a lane tile, a grid barrier after
each layer, then the readout; a cooperative launch) wherever ``tile_plan``
fits, and ``csrc/lm_step.cu`` (route "lane": 8 lanes a block through the
whole step, the weights streamed by every block) past it, for any V, E and
L with H bounded by the threads of one block.
"""

from __future__ import annotations

import contextlib
import functools
from typing import Optional, Sequence, Tuple

import torch

from robust_e2e_gan_torch.models.layers import mm_f32
from robust_e2e_gan_torch.utils.build import launch
from robust_e2e_gan_torch.utils.impl import (
    SMEM_LIMIT,
    aligned16,
    check,
    check_no_grad,
    device_limits,
    grid_barrier,
    on_cuda,
)
from robust_e2e_gan_torch.utils.trace import traced

MAX_HIDDEN = 1024  # one thread per hidden unit in a block (route "lane")
ROWS = 8  # lanes per block (csrc/lm_step.cu)


def lm_step_plain(tok: torch.Tensor, emb: torch.Tensor,
                  wxs: Sequence[torch.Tensor], whs: Sequence[torch.Tensor],
                  biases: Sequence[torch.Tensor], out_w: torch.Tensor,
                  out_b: torch.Tensor, h: torch.Tensor, c: torch.Tensor,
                  dtype: torch.dtype = torch.float32
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One LM step on token ids ``tok`` (N,), already >= 0.

    emb (V, E); wxs[0] (E, 4H), deeper layers (H, 4H); whs (H, 4H);
    biases (4H,); out_w (H, V); out_b (V,); h, c (L, N, H) float32.
    Returns (h_new, c_new (L, N, H) float32, logits (N, V) float32).
    """
    lm_step_plain.calls += 1
    inp = emb.to(dtype)[tok.long()]
    hs, cs = [], []
    for li, (wx, wh, b) in enumerate(zip(wxs, whs, biases)):
        gates = (mm_f32(inp, wx.to(dtype))
                 + mm_f32(h[li].to(dtype), wh.to(dtype)) + b.float())
        gi, gf, gg, go = gates.chunk(4, dim=-1)
        c_new = torch.sigmoid(gf) * c[li] + torch.sigmoid(gi) * torch.tanh(gg)
        h_new = torch.sigmoid(go) * torch.tanh(c_new)
        hs.append(h_new)
        cs.append(c_new)
        inp = h_new.to(dtype)
    logits = mm_f32(inp, out_w.to(dtype)) + out_b.float()
    return torch.stack(hs), torch.stack(cs), logits


lm_step_plain.calls = 0


def smem_bytes(e: int, h: int) -> int:
    """Shared memory of one block of ``csrc/lm_step.cu``."""
    ks = max(1, min(4, MAX_HIDDEN // h))
    return 4 * (ROWS * (max(e, h) + h) + (ks - 1) * ROWS * 4 * h)


# --------------------------------------------------------------------------
# which kernel runs lm_step: csrc/lm_step_tile.cu (route "tile") where
# tile_plan fits, else csrc/lm_step.cu ("lane"); a rule computed before the
# launch
# --------------------------------------------------------------------------

TILE_LANES = 64  # lanes of a gate-product tile (TM)
TILE_UNITS = 32  # hidden units of a tile (TU): its 4 TU gate columns
TILE_CHUNK = {2: 64, 4: 32}  # rows of [x | h] and [Wx; Wh] a chunk, by itemsize
TILE_STAGES = 4  # chunks in flight (NS)
TILE_W_STRIDE = 4 * TILE_UNITS + 8  # elements a row of a W buffer (WS)
TILE_GATE_STRIDE = 4 * TILE_UNITS + 4  # floats a row of the gates tile (GS)
READ_LANES = {2: 16, 4: 8}  # lanes of a readout group, by itemsize
TILE_THREADS = 256  # a block's threads (NT)


def _r16(x: int) -> int:
    return -(-x // 16) * 16


def _readout_smem(h: int, v: int, itemsize: int) -> int:
    """The readout's bytes, each part rounded up to 16 bytes: in bfloat16
    (tensor-core products) the 16 lanes' rows as (16, Hp + 8) and Wout as
    (Hp, Vp + 8), H and V rounded up to 16, then 16 max(threads / 2, Vp)
    float32 partial sums; in float32 the 8 lanes' rows as (8, H) and Wout
    as (H, V), then 8 x threads float32 partial sums."""
    if itemsize == 2:
        hp, vp = _r16(h), _r16(v)
        return (_r16(2 * 16 * (hp + 8)) + _r16(2 * hp * (vp + 8))
                + 4 * 16 * max(TILE_THREADS // 2, vp))
    return (_r16(4 * READ_LANES[4] * h) + _r16(4 * h * v)
            + 4 * READ_LANES[4] * TILE_THREADS)


def tile_smem(h: int, v: int, itemsize: int) -> int:
    """Bytes of dynamic shared memory of one block of the "tile" route
    (``Layout`` of ``csrc/lm_step_tile.cu`` computes the same): the largest
    of the gate product's 4 A buffers of 64 lane rows of KC + 16 bytes and
    4 W buffers of KC rows of 136 elements (KC = 64 in bfloat16, 32 in
    float32), the (64, 132) float32 gates tile laid over them, and the
    readout's (``_readout_smem``), laid over them too."""
    kc, piece = TILE_CHUNK[itemsize], 16 // itemsize
    bufs = TILE_STAGES * (TILE_LANES * (kc + piece)
                          + kc * TILE_W_STRIDE) * itemsize
    gates = TILE_LANES * TILE_GATE_STRIDE * 4
    return max(bufs, gates, _readout_smem(h, v, itemsize))


def tile_plan(n: int, v: int, e: int, h: int, layers: int, itemsize: int,
              n_sm: int, smem_optin: int):
    """(KC rows a chunk, chunks in flight, grid, shared-memory bytes) of the
    "tile" route, or None where it does not fit: a compute dtype of 2 or 4
    bytes, E and H whole 16-byte pieces (the lanes' rows and the weight
    columns are copied in them), and the gate buffers and the staged Wout
    within ``smem_optin``. The grid is one block a tile (ceil(N / 64) x
    ceil(H / 32) tiles), at most one block per SM: the launch is
    cooperative, and a block takes tiles i, i + grid, ..."""
    if itemsize not in TILE_CHUNK or min(n, v, e, h, layers) < 1:
        return None
    piece = 16 // itemsize
    if e % piece or h % piece:
        return None
    smem = tile_smem(h, v, itemsize)
    if smem > smem_optin:
        return None
    tiles = -(-n // TILE_LANES) * -(-h // TILE_UNITS)
    return TILE_CHUNK[itemsize], TILE_STAGES, min(tiles, n_sm), smem


# lm_step launches by route
LM_ROUTE_LAUNCHES = {"tile": 0, "lane": 0}
_forced_lm_route = None


@contextlib.contextmanager
def _force_lm_route(route: str):
    """Run every ``lm_step`` launch inside the block on one route ("tile"
    or "lane"): the tests and ``chip_smoke.py`` hold both to the plain
    version. Forcing "tile" where the plan does not fit raises."""
    global _forced_lm_route
    check(route in LM_ROUTE_LAUNCHES, f"unknown route {route!r}")
    prev, _forced_lm_route = _forced_lm_route, route
    try:
        yield
    finally:
        _forced_lm_route = prev


@functools.lru_cache(maxsize=None)
def _tile_plan_on(index: int, n, v, e, h, layers, itemsize):
    """The "tile" plan of these shapes on card ``index``."""
    return tile_plan(n, v, e, h, layers, itemsize, *device_limits(index))


def _tile(n, v, e, h, layers, itemsize, x: torch.Tensor) -> Optional[tuple]:
    """The "tile" plan of these shapes on x's card, or None for the "lane"
    kernel: past the plan, or where "lane" is forced."""
    if _forced_lm_route == "lane":
        return None
    plan = _tile_plan_on(x.device.index, n, v, e, h, layers, itemsize)
    check(plan is not None or _forced_lm_route is None,
          f"the tile route does not fit N={n} V={v} E={e} H={h} L={layers} "
          f"itemsize {itemsize}")
    return plan


@traced("rg.op.lm_step")
def lm_step(tok: torch.Tensor, emb: torch.Tensor,
            wxs: Sequence[torch.Tensor], whs: Sequence[torch.Tensor],
            biases: Sequence[torch.Tensor], out_w: torch.Tensor,
            out_b: torch.Tensor, h: torch.Tensor, c: torch.Tensor,
            dtype: torch.dtype = torch.float32
            ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Kernel wrapper, same contract as ``lm_step_plain``.

    CPU tensors run the plain version; CUDA tensors launch the kernel of
    the shapes' route (``tile_plan``; ``LM_ROUTE_LAUNCHES`` counts them) or
    raise. Inference only: it raises under autograd.
    """
    check_no_grad("lm_step", emb, *wxs, *whs, *biases, out_w, out_b, h, c)
    if not on_cuda(tok, emb, out_w, h, c):
        return lm_step_plain(tok, emb, wxs, whs, biases, out_w, out_b, h, c,
                             dtype)
    layers, n, h_dim = h.shape
    v, e = emb.shape
    check(dtype in (torch.float32, torch.bfloat16), f"dtype {dtype}")
    check(len(wxs) == len(whs) == len(biases) == layers,
          f"{len(wxs)} layers of weights for a state of {layers}")
    check(tok.shape == (n,), f"tok shape {tuple(tok.shape)} for N={n}")
    check(c.shape == h.shape, f"c shape {tuple(c.shape)}")
    check(wxs[0].shape == (e, 4 * h_dim), f"wx0 shape {tuple(wxs[0].shape)}")
    check(all(w.shape == (h_dim, 4 * h_dim) for w in (*wxs[1:], *whs)),
          "deeper wx and every wh must be (H, 4H)")
    check(out_w.shape == (h_dim, v) and out_b.shape == (v,),
          f"readout shapes {tuple(out_w.shape)} {tuple(out_b.shape)}")
    plan = _tile(n, v, e, h_dim, layers, dtype.itemsize, h)
    if plan is None:
        check(1 <= h_dim <= MAX_HIDDEN, f"H={h_dim} outside [1, {MAX_HIDDEN}]")
        check(smem_bytes(e, h_dim) <= SMEM_LIMIT,
              f"E={e}, H={h_dim} need {smem_bytes(e, h_dim)} bytes of shared "
              f"memory, more than a block's {SMEM_LIMIT}")

    def cast(w):
        return w.to(dtype).contiguous()

    wx0 = cast(wxs[0])
    wx_rest = (torch.stack([cast(w) for w in wxs[1:]]) if layers > 1
               else wx0)  # not read for one layer
    wh = (cast(whs[0]) if layers == 1
          else torch.stack([cast(w) for w in whs]))
    bias = (biases[0].float().contiguous() if layers == 1
            else torch.stack([b.float() for b in biases]))
    emb_c, out_w_c = cast(emb), cast(out_w)
    out_b_c = out_b.float().contiguous()
    h_in, c_in = h.float().contiguous(), c.float().contiguous()
    tok_c = tok.to(torch.int32).contiguous()
    h_out, c_out = torch.empty_like(h_in), torch.empty_like(c_in)
    logits = torch.empty((n, v), dtype=torch.float32, device=h.device)
    stream = torch.cuda.current_stream(h.device).cuda_stream
    ins = [tok_c, emb_c, wx0, wx_rest, wh, bias, out_w_c, out_b_c, h_in, c_in]
    outs = (h_out.data_ptr(), c_out.data_ptr(), logits.data_ptr())
    bf16 = int(dtype == torch.bfloat16)
    if plan is not None:
        kc, stages, grid, smem = plan
        for i in (1, 2, 3, 4, 6, 8):  # emb, wx0, wxs, whs, out_w, h_in
            ins[i] = aligned16(ins[i])
        # T(h') of a layer, by layer parity (16-byte aligned: H is whole
        # 16-byte pieces)
        scratch = torch.empty((min(layers, 2), n, h_dim), dtype=dtype,
                              device=h.device)
        barrier = grid_barrier(h.device, stream)
        launch("lm_step_tile", *(x.data_ptr() for x in ins), *outs,
               scratch.data_ptr(), barrier[0].data_ptr(), n, v, e, h_dim,
               layers, kc, stages, grid, smem, barrier[1], bf16, stream)
        barrier[1] = (barrier[1] + layers * grid) % 2**32
        LM_ROUTE_LAUNCHES["tile"] += 1
    else:
        launch("lm_step", *(x.data_ptr() for x in ins), *outs, n, v, e,
               h_dim, layers, bf16, stream)
        LM_ROUTE_LAUNCHES["lane"] += 1
    lm_step.launches += 1
    return h_out, c_out, logits


lm_step.launches = 0
