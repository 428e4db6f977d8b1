"""One beam step of location-aware attention: kernel wrapper and plain
version.

Counterpart of ``robust_e2e_gan_tpu/ops/att_pallas.py::att_loc_fused``,
same arguments and layouts. Two kernels compute it: ``csrc/att_loc_utt.cu``
(route "utt", one block per utterance) wherever ``utt_plan`` fits, and
``csrc/att_loc.cu`` (route "hyp", one block per hypothesis) past the plan.
The plain version is the XLA beam branch of ``models/attention.py::AttLoc``
(``models/attention.py:185-192`` then ``_finish``).
"""

from __future__ import annotations

import contextlib
import functools
from typing import Optional, Tuple

import torch

from robust_e2e_gan_torch.utils.build import launch
from robust_e2e_gan_torch.utils.impl import (
    check,
    check_no_grad,
    device_limits,
    on_cuda,
)
from robust_e2e_gan_torch.utils.trace import traced

MASK_MIN = -1e9
MAX_CHANNELS = 32  # location-conv channels a warp keeps in shared memory


def att_loc_step_plain(feat, enc_proj, enc, dec, wloc, g, mask,
                       sharpening: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """feat (B, K, T, C), enc_proj (B, T, A), enc (B, T, E), dec (B, K, A),
    wloc (C, A), g (A,) in the compute dtype; mask (B, T) -> (ctx (B, K, E)
    f32, att (B, K, T) f32).

    Rounding points: the location projection, the two adds and the tanh
    are in the compute dtype; the score, softmax and context are float32.
    """
    att_loc_step_plain.calls += 1
    return location_attention(feat, enc_proj, enc, dec, wloc, g, mask,
                              sharpening)


att_loc_step_plain.calls = 0


def location_attention(feat, enc_proj, enc, dec, wloc, g, mask,
                       sharpening: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """The arithmetic of ``att_loc_step_plain``, uncounted: the plain
    version of ``ops/att_dec.py`` runs it too."""
    loc = feat @ wloc  # (B, K, T, A)
    pre = enc_proj[:, None] + loc + dec[:, :, None, :]
    e = (torch.tanh(pre).float() * g.float()).sum(dim=-1)
    return finish(e, mask[:, None, :], enc, sharpening)


def finish(e: torch.Tensor, m: torch.Tensor, enc: torch.Tensor,
           sharpening: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sharpened masked softmax over T and the float32 context
    (``AttLoc._finish``): scores (B, K, T), mask broadcastable to them."""
    e = sharpening * e
    e = torch.where(m > 0, e, MASK_MIN)
    att = torch.softmax(e, dim=-1)
    att = att * m
    att = att / torch.clamp_min(att.sum(dim=-1, keepdim=True), 1e-8)
    ctx = torch.einsum("bkt,bte->bke", att, enc.float())
    return ctx, att


# --------------------------------------------------------------------------
# which kernel runs att_loc_step: the per-utterance csrc/att_loc_utt.cu
# where its plan fits, else the per-hypothesis csrc/att_loc.cu; a rule
# computed before the launch
# --------------------------------------------------------------------------

UTT_MAX_K = 16  # hypotheses an utterance: the largest beam the tests hold it to
UTT_WARPS = {2: 16, 4: 8}  # warps a block by itemsize: bfloat16, float32


def _r16(x: int) -> int:
    return -(-x // 16) * 16


def utt_smem(k: int, t: int, c: int, a: int, e: int, itemsize: int,
             chunk: int, splits: int) -> int:
    """Bytes of dynamic shared memory of one block of the "utt" route
    (``Layout`` of ``csrc/att_loc_utt.cu`` computes the same), with Kp = K
    rounded up to 4 (the kernel takes hypotheses four at a time) and Ap =
    A rounded up to 8: two staging slots of ``chunk`` rows of max(A, E)
    and two sets of K raw feat slots of ``chunk`` x C, each 16 bytes
    longer than its data; feat repacked as (Kp, chunk, CP + 8) in
    bfloat16 (CP = 16 or 32) or (Kp, chunk, C | 1) in float32; wloc as
    (Ap, CP + 8) bfloat16 or (C, Ap) float32; g (Ap) float32; dec (Kp, Ap)
    in the compute dtype; then the larger of the partial scores (splits,
    Kp, chunk), the scores (T, Kp) and the context (Kp, E), float32, and
    the raw dec (K x A), wloc (C x A) and g (A) slots that share their
    bytes. Every part is rounded up to 16 bytes."""
    ap = -(-a // 8) * 8
    kp = -(-k // 4) * 4
    cp = 16 if c <= 16 else 32
    if itemsize == 2:
        fpad, w = kp * chunk * (cp + 8) * 2, ap * (cp + 8) * 2
    else:
        fpad, w = kp * chunk * (c | 1) * 4, c * ap * 4

    def slots(*counts):
        return sum(_r16(n * itemsize) + 16 for n in counts)

    shared = max(4 * splits * kp * chunk + _r16(4 * kp * t) + _r16(4 * kp * e),
                 slots(k * a, c * a, a))
    return (slots(*[chunk * max(a, e)] * 2, *[chunk * c] * (2 * k))
            + _r16(fpad) + _r16(w) + 4 * ap + _r16(itemsize * kp * ap)
            + shared)


def utt_plan(b: int, k: int, t: int, c: int, a: int, e: int, itemsize: int,
             smem_optin: int):
    """(chunk frames F, column splits S, shared-memory bytes) of the "utt"
    route, or None where it does not fit: C <= 32, K <= 16, a compute
    dtype of 2 or 4 bytes. The block's W warps (16 in bfloat16, 8 in
    float32) form S column splits of A's 8-column tiles by W / S frame
    groups of 16 frames, so F = 16 W / S. S starts at the largest power of
    two <= min(4, ceil(A / 8)) and doubles, F halving, until the block's
    bytes fit ``smem_optin``; a T whose K x T scores do not fit beside the
    rest at F = 16 gives None."""
    if (itemsize not in UTT_WARPS or not 1 <= c <= MAX_CHANNELS
            or not 1 <= k <= UTT_MAX_K or min(b, t, a, e) < 1):
        return None
    warps = UTT_WARPS[itemsize]
    splits = 1
    while splits * 2 <= min(4, -(-a // 8)):
        splits *= 2
    while splits <= warps:
        chunk = 16 * (warps // splits)
        smem = utt_smem(k, t, c, a, e, itemsize, chunk, splits)
        if smem <= smem_optin:
            return chunk, splits, smem
        splits *= 2
    return None


# The share of the card's SMs that the "utt" route's B blocks (one an
# utterance) must fill for it to be the default, by itemsize: a float32
# block costs ~2.8 bfloat16 ones, and at B=16 the "hyp" kernel's B x K
# blocks beat 16 of them in float32, not in bfloat16 (PERF.md, row 2)
UTT_MIN_FILL = {2: 0.1, 4: 0.75}


def utt_preferred(b: int, itemsize: int, n_sm: int) -> bool:
    """Whether the "utt" route, where its plan fits, is the default at B
    utterances on a card of ``n_sm`` SMs (``UTT_MIN_FILL``)."""
    return b >= UTT_MIN_FILL[itemsize] * n_sm


# att_loc_step launches by route
ATT_ROUTE_LAUNCHES = {"utt": 0, "hyp": 0}
_forced_att_route = None


@contextlib.contextmanager
def _force_att_route(route: str):
    """Run every ``att_loc_step`` launch inside the block on one route
    ("utt" or "hyp"): the tests and ``chip_smoke.py`` hold both to the
    plain version. Forcing "utt" where the plan does not fit raises."""
    global _forced_att_route
    check(route in ATT_ROUTE_LAUNCHES, f"unknown route {route!r}")
    prev, _forced_att_route = _forced_att_route, route
    try:
        yield
    finally:
        _forced_att_route = prev


@functools.lru_cache(maxsize=None)
def _utt_plan_on(index: int, b, k, t, c, a, e, itemsize):
    """(plan, preferred) of these shapes on card ``index``."""
    n_sm, smem_optin = device_limits(index)
    return (utt_plan(b, k, t, c, a, e, itemsize, smem_optin),
            utt_preferred(b, itemsize, n_sm))


def _utt(b, k, t, c, a, e, x: torch.Tensor) -> Optional[tuple]:
    """The "utt" plan of these shapes on x's card, or None for the "hyp"
    kernel: past the plan, or where the route is not preferred and not
    forced."""
    if _forced_att_route == "hyp":
        return None
    plan, preferred = _utt_plan_on(x.device.index, b, k, t, c, a, e,
                                   x.element_size())
    check(plan is not None or _forced_att_route is None,
          f"the utt route does not fit B={b} K={k} T={t} C={c} A={a} "
          f"E={e} {x.dtype}")
    return plan if preferred or _forced_att_route == "utt" else None


@traced("rg.op.att_loc_step")
def att_loc_step(feat, enc_proj, enc, dec, wloc, g, mask,
                 sharpening: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel wrapper, same contract as ``att_loc_step_plain``.

    CPU tensors run the plain version; CUDA tensors launch the kernel of
    the shapes' route (``utt_plan``; ``ATT_ROUTE_LAUNCHES`` counts them)
    or raise.
    """
    check_no_grad("att_loc_step", feat, enc_proj, enc, dec, wloc, g, mask)
    if not on_cuda(feat, enc_proj, enc, dec, wloc, g, mask):
        return att_loc_step_plain(feat, enc_proj, enc, dec, wloc, g, mask,
                                  sharpening)
    b, k, t, c = feat.shape
    a, e = enc_proj.shape[-1], enc.shape[-1]
    dt = enc.dtype
    check(dt in (torch.float32, torch.bfloat16), f"compute dtype {dt}")
    check(1 <= c <= MAX_CHANNELS, f"C={c} outside [1, {MAX_CHANNELS}]")
    expect = {"feat": (feat, (b, k, t, c)), "enc_proj": (enc_proj, (b, t, a)),
              "enc": (enc, (b, t, e)), "dec": (dec, (b, k, a)),
              "wloc": (wloc, (c, a)), "g": (g, (a,))}
    for name, (x, shape) in expect.items():
        check(tuple(x.shape) == shape,
              f"{name} shape {tuple(x.shape)} != {shape}")
        check(x.dtype == dt, f"{name} dtype {x.dtype} != {dt}")
    check(tuple(mask.shape) == (b, t), f"mask shape {tuple(mask.shape)}")
    plan = _utt(b, k, t, c, a, e, enc)
    args = [x.contiguous() for x in (feat, enc_proj, enc, dec, wloc, g)]
    if plan is not None and args[1].data_ptr() % 16:
        args[1] = args[1].clone()  # enc_proj's rows are read in pairs
    maskf = mask.float().contiguous()
    ctx = torch.empty((b, k, e), dtype=torch.float32, device=enc.device)
    att = torch.empty((b, k, t), dtype=torch.float32, device=enc.device)
    ptrs = [x.data_ptr() for x in args]
    bf16 = int(dt == torch.bfloat16)
    stream = torch.cuda.current_stream(enc.device).cuda_stream
    if plan is not None:
        launch("att_loc_utt", *ptrs, maskf.data_ptr(), ctx.data_ptr(),
               att.data_ptr(), b, k, t, c, a, e, *plan, float(sharpening),
               bf16, stream)
        ATT_ROUTE_LAUNCHES["utt"] += 1
    else:
        launch("att_loc_step", *ptrs, maskf.data_ptr(), ctx.data_ptr(),
               att.data_ptr(), b, k, t, c, a, e, float(sharpening), bf16,
               stream)
        ATT_ROUTE_LAUNCHES["hyp"] += 1
    att_loc_step.launches += 1
    return ctx, att


att_loc_step.launches = 0
