"""The whole beam step of the attention decoder: kernel wrapper and plain
version.

Counterpart of ``robust_e2e_gan_tpu/ops/att_pallas.py::att_dec_step_fused``,
same arguments: location-aware attention (as ``ops/att.py``), then the
token embedding, the single-layer LSTM cell and the vocabulary readout, in
one launch. Two kernels compute it: ``csrc/att_dec_utt.cu`` (route "utt":
the attention an utterance a block, then the cell over all B x K lanes and
the readout, on a co-resident grid with two grid barriers) wherever
``utt_plan`` fits, and ``csrc/att_dec.cu`` (route "hyp": one block an
utterance for the whole step) past it. The rounding points are the TPU
kernel's (``att_pallas.py:341-388``), which differ from the unfused step's
in bfloat16: the context is rounded to the compute dtype, the embedding
rows are exact, ``gx = emb @ Wx[:EMB] + ctx @ Wx[EMB:]`` and
``gh = T(z) @ Wh`` are products of compute-dtype operands with float32
sums, the gates plus bias are float32 in the order i, f, g, o, and
``logits = T(z') @ Wout[:H] + ctx @ Wout[H:] + b``, where the unfused cell
promotes ``Wh`` to float32 against the float32 state instead. In float32
the two compute the same values.

The JAX package falls back to the attention kernel and the XLA cell where
the fused step does not fit its VMEM plan; the wrapper here raises beyond
the "hyp" kernel's shared-memory plan instead.
"""

from __future__ import annotations

import contextlib
import functools
from typing import Optional, Tuple

import torch

from robust_e2e_gan_torch.models.layers import mm_f32
from robust_e2e_gan_torch.ops import att
from robust_e2e_gan_torch.ops.att import MAX_CHANNELS, location_attention
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

MAX_HIDDEN = 1024  # one thread per hidden unit in a block
ROWS = 8  # lanes per pass of the cell (csrc/att_dec.cu)

Step = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]


def att_dec_step_plain(feat, enc_proj, enc, dec, wloc, g, mask,
                       sharpening: float, tok, emb_table, cell_wx, cell_wh,
                       cell_bias, out_w, out_b, z_prev, c_prev) -> Step:
    """feat (B, K, T, C), enc_proj (B, T, A), enc (B, T, E), dec (B, K, A),
    wloc (C, A), g (A,), emb_table (V, EMB), cell_wx (EMB + E, 4H),
    cell_wh (H, 4H), out_w (H + E, V) in the compute dtype; mask (B, T);
    tok (B, K) token ids, already >= 0; cell_bias (4H,), out_b (V,),
    z_prev, c_prev (B, K, H) float32.

    Returns (logits (B, K, V), att (B, K, T), z_new, c_new (B, K, H)), all
    float32.
    """
    att_dec_step_plain.calls += 1
    b, k = tok.shape
    n = b * k
    dt = enc.dtype
    embd, h = emb_table.shape[1], cell_wh.shape[0]
    ctx, att = location_attention(feat, enc_proj, enc, dec, wloc, g, mask,
                                  sharpening)
    ctxc = ctx.to(dt).reshape(n, -1)
    emb = emb_table[tok.reshape(n).long()]  # exact table rows
    gx = mm_f32(emb, cell_wx[:embd]) + mm_f32(ctxc, cell_wx[embd:])
    gh = mm_f32(z_prev.reshape(n, h).to(dt), cell_wh)
    gates = (gx + gh) + cell_bias.float()
    gi, gf, gg, go = gates.chunk(4, dim=-1)
    c_new = (torch.sigmoid(gf) * c_prev.reshape(n, h).float()
             + torch.sigmoid(gi) * torch.tanh(gg))
    z_new = torch.sigmoid(go) * torch.tanh(c_new)
    logits = (mm_f32(z_new.to(dt), out_w[:h]) + mm_f32(ctxc, out_w[h:])
              + out_b.float())
    return (logits.reshape(b, k, -1), att, z_new.reshape(b, k, h),
            c_new.reshape(b, k, h))


att_dec_step_plain.calls = 0


def smem_bytes(k: int, t: int, c: int, a: int, e: int, embd: int,
               h: int) -> int:
    """Shared memory of one block of ``csrc/att_dec.cu``."""
    ks = max(1, min(4, MAX_HIDDEN // h))
    warps = -(-ks * h // 32)
    return 4 * (c * a + 2 * a + t + warps * MAX_CHANNELS + 32
                + k * (embd + e) + k * h + (ks - 1) * ROWS * 4 * h)


# --------------------------------------------------------------------------
# which kernel runs att_dec_step: csrc/att_dec_utt.cu (route "utt") where
# utt_plan fits, else csrc/att_dec.cu ("hyp"); a rule computed before the
# launch
# --------------------------------------------------------------------------

UTT_TILE_LANES = 64  # lanes of a gate-product tile (TM)
UTT_TILE_UNITS = 32  # hidden units of a tile (TU): its 4 TU gate columns
UTT_CHUNK = {2: 64, 4: 32}  # rows of [Wx; Wh] a copied chunk, by itemsize
UTT_GATE_STRIDE = 4 * UTT_TILE_UNITS + 4  # floats a row of the gates tile
UTT_STAGES = 4  # chunks in flight in the gate product
UTT_THREADS = {2: 512, 4: 256}  # a block's threads, by itemsize


def utt_row_width(embd: int, e: int, h: int, itemsize: int) -> int:
    """Elements of a lane's row [emb | ctx | z] in the "utt" route's
    scratch: EMB + E + H rounded up to a whole chunk (zeros past it)."""
    kc = UTT_CHUNK[itemsize]
    return -(-(embd + e + h) // kc) * kc


def utt_smem(k: int, t: int, c: int, a: int, e: int, h: int, itemsize: int,
             chunk: int, splits: int, vc: int) -> int:
    """Bytes of dynamic shared memory of one block of the "utt" route
    (``DecLayout`` of ``csrc/att_dec_utt.cu`` computes the same): the
    largest of the attention's (``ops/att.py::utt_smem``); the gate
    product's 4 A buffers of 64 lane rows of KC + 16 bytes and 4 W buffers
    of KC rows of 128 gate columns + 16 bytes (KC = 64 in bfloat16, 32 in
    float32), or the (64, 132) float32 gates tile laid over them; and the
    readout's (``_readout_smem``)."""
    kc, piece = UTT_CHUNK[itemsize], 16 // itemsize
    cols = 4 * UTT_TILE_UNITS
    bufs = UTT_STAGES * (UTT_TILE_LANES * (kc + piece)
                         + kc * (cols + piece)) * itemsize
    gates = UTT_TILE_LANES * UTT_GATE_STRIDE * 4
    return max(att.utt_smem(k, t, c, a, e, itemsize, chunk, splits), bufs,
               gates, _readout_smem(k, e, h, itemsize, vc))


def _readout_smem(k: int, e: int, h: int, itemsize: int, vc: int) -> int:
    """The readout's bytes, each part rounded up to 16 bytes: in bfloat16
    (tensor-core products) the lanes' rows as (16, KW + 8) and the chunk of
    Wout as (KW, Vp + 8) bfloat16, KW = H and E each rounded up to 16, Vp =
    vc rounded up to 16, then 2 K 16 max(16, Vp / 16) float32 partial
    sums; in float32 the lanes' rows as (K, HEp) and the chunk as (HEp, vc),
    HEp = H + E rounded up to 4, then 2 K max(256, vc) partial sums."""
    r16 = att._r16
    if itemsize == 2:
        kw = r16(h) + r16(e)
        vp = r16(vc)
        return (r16(2 * 16 * (kw + 8)) + r16(2 * kw * (vp + 8))
                + 4 * 2 * k * 16 * max(16, vp // 16))
    hep = -(-(h + e) // 4) * 4
    return (r16(4 * k * hep) + r16(4 * hep * vc)
            + 4 * 2 * k * max(UTT_THREADS[itemsize], vc))


def _utt_shapes_fit(k: int, c: int, h: int, itemsize: int) -> bool:
    """The shape limits of the "utt" route that need no card: the
    attention's K and C, whole 16-byte copies of the weight columns (H a
    multiple of 8), a compute dtype of 2 or 4 bytes."""
    return (itemsize in UTT_CHUNK and 1 <= k <= att.UTT_MAX_K
            and 1 <= c <= MAX_CHANNELS and h >= 1 and h % 8 == 0)


def utt_plan(b: int, k: int, t: int, c: int, a: int, e: int, embd: int,
             h: int, v: int, itemsize: int, n_sm: int, smem_optin: int):
    """(attention chunk frames F, column splits S, readout columns a chunk
    VC, grid, shared-memory bytes) of the "utt" route, or None where it
    does not fit: ``ops/att.py::utt_plan`` must fit the attention (K <= 16,
    C <= 32), H is a multiple of 8, and the readout's lane rows and at
    least one column of Wout fit ``smem_optin`` beside nothing else (the
    three phases reuse one shared memory). VC is V where it fits, else the
    most that does. The grid is one block an utterance or a gate tile
    (ceil(B K / 64) x ceil(H / 32) tiles), whichever is more, and at most
    one block per SM: the launch is cooperative."""
    if not _utt_shapes_fit(k, c, h, itemsize) or min(b, embd, v) < 1:
        return None
    fit = att.utt_plan(b, k, t, c, a, e, itemsize, smem_optin)
    if fit is None:
        return None
    chunk, splits, _ = fit
    # the most columns of Wout whose readout fits (its bytes grow with vc)
    lo, hi = 0, v
    while lo < hi:
        mid = (lo + hi + 1) // 2
        if _readout_smem(k, e, h, itemsize, mid) <= smem_optin:
            lo = mid
        else:
            hi = mid - 1
    vc = lo
    if vc < 1:
        return None
    smem = utt_smem(k, t, c, a, e, h, itemsize, chunk, splits, vc)
    if smem > smem_optin:
        return None
    tiles = -(-b * k // UTT_TILE_LANES) * -(-h // UTT_TILE_UNITS)
    return chunk, splits, vc, min(n_sm, max(b, tiles)), smem


# att_dec_step launches by route
DEC_ROUTE_LAUNCHES = {"utt": 0, "hyp": 0}
_forced_dec_route = None


@contextlib.contextmanager
def _force_dec_route(route: str):
    """Run every ``att_dec_step`` launch inside the block on one route
    ("utt" or "hyp"): the tests and ``chip_smoke.py`` hold both to the
    plain version. Forcing "utt" where the plan does not fit raises."""
    global _forced_dec_route
    check(route in DEC_ROUTE_LAUNCHES, f"unknown route {route!r}")
    prev, _forced_dec_route = _forced_dec_route, route
    try:
        yield
    finally:
        _forced_dec_route = prev


@functools.lru_cache(maxsize=None)
def _utt_plan_on(index: int, b, k, t, c, a, e, embd, h, v, itemsize):
    """The "utt" plan of these shapes on card ``index``."""
    return utt_plan(b, k, t, c, a, e, embd, h, v, itemsize,
                    *device_limits(index))


def _utt(b, k, t, c, a, e, embd, h, v, x: torch.Tensor) -> Optional[tuple]:
    """The "utt" plan of these shapes on x's card, or None for the "hyp"
    kernel: past the plan, or where "hyp" is forced. Route "utt" is the
    default wherever its plan fits: it beat "hyp" at B=128 and B=16 in
    both compute dtypes (PERF.md §6, row 5)."""
    if _forced_dec_route == "hyp":
        return None
    plan = None
    if _utt_shapes_fit(k, c, h, x.element_size()):
        plan = _utt_plan_on(x.device.index, b, k, t, c, a, e, embd, h, v,
                            x.element_size())
    check(plan is not None or _forced_dec_route is None,
          f"the utt route does not fit B={b} K={k} T={t} C={c} A={a} E={e} "
          f"EMB={embd} H={h} V={v} {x.dtype}")
    return plan


@traced("rg.op.att_dec_step")
def att_dec_step(feat, enc_proj, enc, dec, wloc, g, mask, sharpening: float,
                 tok, emb_table, cell_wx, cell_wh, cell_bias, out_w, out_b,
                 z_prev, c_prev) -> Step:
    """Kernel wrapper, same contract as ``att_dec_step_plain``.

    CPU tensors run the plain version; CUDA tensors launch the kernel of
    the shapes' route (``utt_plan``; ``DEC_ROUTE_LAUNCHES`` counts them) or
    raise. Inference only: it raises under autograd.
    """
    floats = (feat, enc_proj, enc, dec, wloc, g, mask, emb_table, cell_wx,
              cell_wh, cell_bias, out_w, out_b, z_prev, c_prev)
    check_no_grad("att_dec_step", *floats)
    if not on_cuda(tok, *floats):
        return att_dec_step_plain(feat, enc_proj, enc, dec, wloc, g, mask,
                                  sharpening, tok, emb_table, cell_wx,
                                  cell_wh, cell_bias, out_w, out_b, z_prev,
                                  c_prev)
    b, k, t, c = feat.shape
    a, e = enc_proj.shape[-1], enc.shape[-1]
    v, embd = emb_table.shape
    h = cell_wh.shape[0]
    dt = enc.dtype
    check(dt in (torch.float32, torch.bfloat16), f"compute dtype {dt}")
    check(1 <= c <= MAX_CHANNELS, f"C={c} outside [1, {MAX_CHANNELS}]")
    typed = {"feat": (feat, (b, k, t, c)), "enc_proj": (enc_proj, (b, t, a)),
             "enc": (enc, (b, t, e)), "dec": (dec, (b, k, a)),
             "wloc": (wloc, (c, a)), "g": (g, (a,)),
             "emb_table": (emb_table, (v, embd)),
             "cell_wx": (cell_wx, (embd + e, 4 * h)),
             "cell_wh": (cell_wh, (h, 4 * h)), "out_w": (out_w, (h + e, v))}
    for name, (x, shape) in typed.items():
        check(tuple(x.shape) == shape,
              f"{name} shape {tuple(x.shape)} != {shape}")
        check(x.dtype == dt, f"{name} dtype {x.dtype} != {dt}")
    for name, x, shape in (("mask", mask, (b, t)), ("tok", tok, (b, k)),
                           ("cell_bias", cell_bias, (4 * h,)),
                           ("out_b", out_b, (v,)),
                           ("z_prev", z_prev, (b, k, h)),
                           ("c_prev", c_prev, (b, k, h))):
        check(tuple(x.shape) == shape,
              f"{name} shape {tuple(x.shape)} != {shape}")
    plan = _utt(b, k, t, c, a, e, embd, h, v, enc)
    if plan is None:
        check(1 <= h <= MAX_HIDDEN, f"H={h} outside [1, {MAX_HIDDEN}]")
        need = smem_bytes(k, t, c, a, e, embd, h)
        check(need <= SMEM_LIMIT,
              f"K={k}, T={t}, EMB+E={embd + e}, H={h} need {need} bytes of "
              f"shared memory, more than a block's {SMEM_LIMIT}")
    ins = [x.contiguous() for x in (feat, enc_proj, enc, dec, wloc, g)]
    ins.append(mask.float().contiguous())
    ins.append(tok.to(torch.int32).contiguous())
    ins += [x.contiguous() for x in (emb_table, cell_wx, cell_wh)]
    ins.append(cell_bias.float().contiguous())
    ins.append(out_w.contiguous())
    ins += [x.float().contiguous() for x in (out_b, z_prev, c_prev)]
    dev = enc.device
    logits = torch.empty((b, k, v), dtype=torch.float32, device=dev)
    att_ = torch.empty((b, k, t), dtype=torch.float32, device=dev)
    z_new = torch.empty((b, k, h), dtype=torch.float32, device=dev)
    c_new = torch.empty_like(z_new)
    outs = (logits.data_ptr(), att_.data_ptr(), z_new.data_ptr(),
            c_new.data_ptr())
    bf16 = int(dt == torch.bfloat16)
    stream = torch.cuda.current_stream(dev).cuda_stream
    if plan is not None:
        chunk, splits, vc, grid, smem = plan
        for i in (1, 9, 10, 12):  # enc_proj, cell_wx, cell_wh, out_w
            ins[i] = aligned16(ins[i])
        # the lanes' rows (B K, Dp) then T(z') (B K, H), both 16-byte
        # aligned (Dp is a multiple of 32)
        rows = b * k * utt_row_width(embd, e, h, enc.element_size())
        scratch = torch.empty(rows + b * k * h, dtype=dt, device=dev)
        barrier = grid_barrier(dev, stream)
        launch("att_dec_utt", *(x.data_ptr() for x in ins), *outs,
               scratch.data_ptr(),
               scratch.data_ptr() + rows * scratch.element_size(),
               barrier[0].data_ptr(), b, k, t, c, a, e, v, embd, h, chunk,
               splits, vc, grid, smem, barrier[1], float(sharpening), bf16,
               stream)
        barrier[1] = (barrier[1] + 2 * grid) % 2**32
        DEC_ROUTE_LAUNCHES["utt"] += 1
    else:
        launch("att_dec_step", *(x.data_ptr() for x in ins), *outs, b, k, t,
               c, a, e, v, embd, h, float(sharpening), bf16, stream)
        DEC_ROUTE_LAUNCHES["hyp"] += 1
    att_dec_step.launches += 1
    return logits, att_, z_new, c_new


att_dec_step.launches = 0
