"""CTC prefix scores of the beam search: kernel wrappers and plain versions.

Counterparts of ``robust_e2e_gan_tpu/ops/ctc_prefix_tiled.py``
(``prefix_psi_tiled``, ``prefix_state_tiled``) and of
``ops/ctc_prefix_pallas.py::prefix_scores_psi_pallas`` (``prefix_psi_utt``),
same contracts, and ``prefix_state_step``: the state of a beam step's
survivors with the searcher's gathers and selects around it. The plain
versions are the JAX package's twopass forms,
``decode/beam.py::batched_prefix_psi`` and ``prefix_state_for_token``,
with the frame loop written out. The kernels are ``csrc/ctc_prefix.cu``
(psi and state on two routes each: "utt", one block per utterance, where
``psi_plan``/``state_plan`` fit, and "lane", one thread per lane, past
them) and ``csrc/ctc_prefix_utt.cu`` (psi one block per utterance over
a ring of frame chunks, where ``utt_psi_plan`` fits). Everything is
float32.
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

LOG_ZERO = -1e10


def gather_beam(x: torch.Tensor, k_idx: torch.Tensor) -> torch.Tensor:
    """Rows of x (B, K, ...) picked by k_idx (B, K)."""
    idx = k_idx.view(k_idx.shape + (1,) * (x.dim() - 2))
    return torch.gather(x, 1, idx.expand(k_idx.shape + x.shape[2:]))


def _phi_prev(r_n, r_b, is_last, lengths):
    """(B, K, T[, V]) transition scores into frame t from the parent:
    phi0 at t=0, then r_b[t-1] where the token repeats the last one, else
    logaddexp(r_n, r_b)[t-1]."""
    r_sum = torch.logaddexp(r_n, r_b)
    if is_last.dim() == 3:  # (B, K, V): one lane per vocab extension
        log_phi = torch.where(is_last[:, :, None, :], r_b[..., None],
                              r_sum[..., None])
    else:
        log_phi = torch.where(is_last[..., None], r_b, r_sum)
    phi0 = torch.where(lengths == 0, 0.0, LOG_ZERO).to(r_n.dtype)
    phi0 = phi0.view(phi0.shape + (1,) * (log_phi.dim() - 2))
    phi0 = phi0.expand(log_phi[:, :, :1].shape)
    return torch.cat([phi0, log_phi[:, :, :-1]], dim=2)


def _patch_psi(psi, r_n, r_b, blank: int, eos: int):
    """eos candidate = full-sequence CTC score of the prefix itself; blank
    is never a label."""
    psi[..., eos] = torch.logaddexp(r_n[:, :, -1], r_b[:, :, -1])
    psi[..., blank] = LOG_ZERO
    return psi


def prefix_psi_recursion_plain(lpz, last_tok, lengths, r_n, r_b):
    """psi (B, K, V) of every vocab extension, before the eos/blank
    patches: the frame loop of ``batched_prefix_psi``.

    lpz (B, T, V) masked CTC log-probs; last_tok, lengths (B, K); r_n, r_b
    (B, K, T) forward variables of the current prefixes.
    """
    prefix_psi_recursion_plain.calls += 1
    b, t, v = lpz.shape
    k = last_tok.shape[1]
    vocab = torch.arange(v, device=lpz.device)
    is_last = ((vocab[None, None, :] == last_tok[..., None])
               & (lengths[..., None] > 0))
    phi = _phi_prev(r_n, r_b, is_last, lengths)  # (B, K, T, V)
    psi = torch.full((b, k, v), LOG_ZERO, device=lpz.device)
    for i in range(t):
        psi = torch.logaddexp(psi, phi[:, :, i] + lpz[:, None, i])
    return psi


prefix_psi_recursion_plain.calls = 0


def prefix_psi_plain(lpz, last_tok, lengths, r_n, r_b, blank: int,
                     eos: int) -> torch.Tensor:
    """psi (B, K, V) with the eos/blank columns set
    (``batched_prefix_psi``)."""
    psi = prefix_psi_recursion_plain(lpz, last_tok, lengths, r_n, r_b)
    return _patch_psi(psi, r_n, r_b, blank, eos)


def prefix_state_plain(lpz, tok, last_tok, lengths, r_n, r_b,
                       blank: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(r_n, r_b) (B, K, T) of the parents extended by ``tok``
    (``prefix_state_for_token``); last_tok/lengths/r_n/r_b describe the
    parents."""
    prefix_state_plain.calls += 1
    t = lpz.shape[1]
    is_last = (tok == last_tok) & (lengths > 0)
    phi = _phi_prev(r_n, r_b, is_last, lengths)  # (B, K, T)
    # lpz at the chosen tokens: (B, T, K) -> (B, K, T)
    x_tok = torch.gather(lpz, 2, tok.long()[:, None, :].expand(-1, t, -1))
    x_tok = x_tok.transpose(1, 2)
    x_blank = lpz[:, :, blank]  # (B, T)
    rn = torch.full(tok.shape, LOG_ZERO, device=lpz.device)
    rb = torch.full(tok.shape, LOG_ZERO, device=lpz.device)
    rns, rbs = [], []
    for i in range(t):
        rn_new = x_tok[:, :, i] + torch.logaddexp(rn, phi[:, :, i])
        rb = x_blank[:, i, None] + torch.logaddexp(rn, rb)
        rn = rn_new
        rns.append(rn)
        rbs.append(rb)
    return torch.stack(rns, dim=2), torch.stack(rbs, dim=2)


prefix_state_plain.calls = 0


def prefix_state_step_plain(lpz, k_idx, tok, append, last_tok, lengths, r_n,
                            r_b, blank: int
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(r_n, r_b) (B, K, T) after a beam step's pruning: the searcher's
    sequence. Row k is parent ``k_idx[:, k]``'s (``r_n``, ``r_b``,
    ``last_tok``, ``lengths`` describe the parents before the step)
    extended by ``tok`` where ``append``, else the parent's unchanged."""
    rn_par, rb_par = gather_beam(r_n, k_idx), gather_beam(r_b, k_idx)
    rn_sel, rb_sel = prefix_state_plain(
        lpz, tok, gather_beam(last_tok, k_idx), gather_beam(lengths, k_idx),
        rn_par, rb_par, blank)
    sel = append[..., None]
    return torch.where(sel, rn_sel, rn_par), torch.where(sel, rb_sel, rb_par)


# --------------------------------------------------------------------------
# which kernels run psi and the state: one block per utterance (route
# "utt", csrc/ctc_prefix.cu) where the plans fit, else one thread per lane
# (route "lane", the same file); a rule computed before the launch
# --------------------------------------------------------------------------

PSI_MAX_THREADS = 1024  # a block's threads: K x V lanes x S frame splits
PSI_MAX_SPLITS = 8
PSI_CHUNKS = (256, 128, 64, 32)  # frames of lpz staged at a time, tried in turn
STATE_MAX_K = 32  # hypotheses the chain's one warp carries
STATE_CHUNKS = (64, 32, 16, 8)


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def psi_smem(k: int, v: int, splits: int, chunk: int) -> int:
    """Shared bytes of the "utt" psi kernel: a chunk's lpz rows (F, V) and
    two phi tables (K, F), then the (max, sum) pairs of K x V x S
    threads."""
    return 4 * max(chunk * (v + 2 * k), 2 * k * v * splits)


def psi_plan(k: int, t: int, v: int,
             smem_optin: int) -> Optional[Tuple[int, int]]:
    """(frame splits S, chunk frames F) of the "utt" psi kernel at K
    hypotheses, T frames and V columns, or None past it. Each of the K x V
    lanes sums every S-th frame in one thread, S as large as 1,024
    threads allow (at most ``PSI_MAX_SPLITS``); F is the largest of
    ``PSI_CHUNKS`` (cut to T rounded up to 32) whose ``psi_smem`` fits in
    ``smem_optin`` bytes."""
    lanes = k * v
    if lanes > PSI_MAX_THREADS:
        return None
    splits = min(PSI_MAX_SPLITS, PSI_MAX_THREADS // lanes)
    for chunk in PSI_CHUNKS:
        chunk = min(chunk, _round_up(t, 32))
        if psi_smem(k, v, splits, chunk) <= smem_optin:
            return splits, chunk
    return None


def state_smem(k: int, v: int, chunk: int) -> int:
    """Shared bytes of the "utt" state kernel: two buffers of a chunk's
    lpz rows (F, V) and the extensions' phi, r_n and r_b (K, F) each."""
    return 8 * chunk * (v + 3 * k)


def state_plan(k: int, t: int, v: int, smem_optin: int) -> Optional[int]:
    """Chunk frames F of the "utt" state kernel at K hypotheses, T frames
    and V columns, or None past it: K <= ``STATE_MAX_K``, and F the
    largest of ``STATE_CHUNKS`` (cut to T rounded up to 8) whose
    ``state_smem`` fits in ``smem_optin`` bytes."""
    if k > STATE_MAX_K:
        return None
    for chunk in STATE_CHUNKS:
        chunk = min(chunk, _round_up(t, 8))
        if state_smem(k, v, chunk) <= smem_optin:
            return chunk
    return None


# csrc/ctc_prefix_utt.cu's constants (kUttMaxThreads, kUttMaxSplits,
# kUttAhead, kUttTabs), its chunk frames and the ring's stages, tried in
# turn
UTT_MAX_THREADS = 1024  # a block's threads: consumers and a producer warp
UTT_MAX_SPLITS = 8
UTT_AHEAD = 2  # phi items (k, t) of a chunk a consumer thread forms
UTT_TABLES = 4  # phi tables in flight
UTT_CHUNKS = (192, 128, 64, 32, 16, 8, 4)
UTT_STAGES = (3, 2)


def _r16(x: int) -> int:
    return _round_up(x, 16)


def utt_units(k: int, v: int) -> int:
    """Units of work of ``csrc/ctc_prefix_utt.cu``: K x ceil(V / 2) pairs
    of lanes (k, v), (k, v + ceil(V / 2)) sharing their phi loads, and K
    lanes of the hypotheses' last tokens, whose phi is r_b."""
    return k * -(-v // 2) + k


def utt_consumers(k: int, v: int, splits: int) -> int:
    """Consumer threads of the kernel: the units x splits in whole warps,
    at most all of a block's warps but the producer's."""
    return min(_round_up(utt_units(k, v) * splits, 32), UTT_MAX_THREADS - 32)


def utt_psi_smem(k: int, v: int, splits: int, chunk: int,
                 stages: int) -> int:
    """Shared bytes of ``csrc/ctc_prefix_utt.cu`` (its ``utt_layout``):
    ``stages`` stages of a chunk's lpz rows (F x V floats and 8 of slack);
    ``UTT_TABLES`` phi buffers, each 2K rows of F + 4 floats and 8 more;
    the (max, sum) pairs of the units' two lanes and splits; phi0, the eos
    column and the last token of each hypothesis; two 8-byte mbarriers a
    stage and one a phi buffer."""
    stage = _r16(4 * (chunk * v + 8))
    tables = UTT_TABLES * 4 * (2 * k * (chunk + 4) + 8)
    pairs = _r16(16 * utt_units(k, v) * splits)
    return (stages * stage + tables + pairs + _r16(12 * k)
            + 8 * (2 * stages + UTT_TABLES))


def utt_psi_plan(k: int, t: int, v: int,
                 smem_optin: int) -> Optional[Tuple[int, int, int]]:
    """(frame splits S, chunk frames F, stages) of the per-utterance psi
    kernel at K hypotheses, T frames and V columns, or None past it: K x V
    above 1,024 lanes, ``utt_units`` above the 992 consumer threads (a
    beam above 330 at V = 3, above 496 at V <= 2), or no chunk fitting.
    Each unit takes
    S splits, a consumer each, S as large as the consumers allow (at most
    ``UTT_MAX_SPLITS``); F from ``UTT_CHUNKS``, cut to T rounded up to 4,
    with K x F phi items at most ``UTT_AHEAD`` a consumer; the ring holds
    3 chunks, or 2 (also where T takes at most two), and the first (F,
    stages) whose ``utt_psi_smem`` fits in ``smem_optin`` bytes is taken.
    Shared memory does not grow with T."""
    units = utt_units(k, v)
    consumers = UTT_MAX_THREADS - 32
    if k * v > UTT_MAX_THREADS or units > consumers:
        return None
    splits = min(UTT_MAX_SPLITS, consumers // units)
    for chunk in UTT_CHUNKS:
        chunk = min(chunk, _round_up(t, 4))
        if k * chunk > UTT_AHEAD * utt_consumers(k, v, splits):
            continue
        n_chunks = -(-t // chunk)
        for stages in UTT_STAGES:
            stages = min(stages, max(2, n_chunks))
            if utt_psi_smem(k, v, splits, chunk, stages) <= smem_optin:
                return splits, chunk, stages
    return None


# launches of the psi and the state kernels by route
PREFIX_ROUTE_LAUNCHES = {"psi": {"utt": 0, "lane": 0},
                         "state": {"utt": 0, "lane": 0}}
_forced_prefix_route = None


@contextlib.contextmanager
def _force_prefix_route(route: str):
    """Run every psi and state launch inside the block on one route ("utt"
    or "lane"): the tests and ``chip_smoke.py`` hold both to the plain
    versions. Forcing "utt" where a plan does not fit raises."""
    global _forced_prefix_route
    check(route in ("utt", "lane"), f"unknown route {route!r}")
    prev, _forced_prefix_route = _forced_prefix_route, route
    try:
        yield
    finally:
        _forced_prefix_route = prev


def _route(plan, what: str):
    """``plan`` for the "utt" kernel, or None for the "lane" one: past the
    plan, or where "lane" is forced. A forced "utt" that does not fit
    raises."""
    if _forced_prefix_route == "lane":
        return None
    check(plan is not None or _forced_prefix_route is None,
          f"the utt route does not fit {what}")
    return plan


@functools.lru_cache(maxsize=None)
def _psi_plan_on(index: int, k: int, t: int, v: int):
    return psi_plan(k, t, v, device_limits(index)[1])


@functools.lru_cache(maxsize=None)
def _utt_psi_plan_on(index: int, k: int, t: int, v: int):
    return utt_psi_plan(k, t, v, device_limits(index)[1])


@functools.lru_cache(maxsize=None)
def _state_plan_on(index: int, k: int, t: int, v: int):
    return state_plan(k, t, v, device_limits(index)[1])


def _check_common(lpz, r_n, r_b, ints):
    b, t, v = lpz.shape
    k = r_n.shape[1]
    check(lpz.dtype == torch.float32, f"lpz dtype {lpz.dtype}")
    for name, x in (("r_n", r_n), ("r_b", r_b)):
        check(tuple(x.shape) == (b, k, t) and x.dtype == torch.float32,
              f"{name} must be (B, K, T) float32, got {tuple(x.shape)} "
              f"{x.dtype}")
    for name, x in ints.items():
        check(tuple(x.shape) == (b, k), f"{name} shape {tuple(x.shape)}")
    return b, k, t, v


@traced("rg.op.prefix_psi")
def prefix_psi(lpz, last_tok, lengths, r_n, r_b, blank: int,
               eos: int) -> torch.Tensor:
    """Kernel wrapper, same contract as ``prefix_psi_plain``.

    CPU tensors run the plain version; CUDA tensors launch the kernel of
    the shapes' route (``psi_plan``; ``PREFIX_ROUTE_LAUNCHES["psi"]``
    counts them) or raise.
    """
    check_no_grad("prefix_psi", lpz, r_n, r_b)
    if not on_cuda(lpz, last_tok, lengths, r_n, r_b):
        return prefix_psi_plain(lpz, last_tok, lengths, r_n, r_b, blank, eos)
    b, k, t, v = _check_common(lpz, r_n, r_b,
                               {"last_tok": last_tok, "lengths": lengths})
    check(0 <= blank < v and 0 <= eos < v,
          f"blank={blank} or eos={eos} outside [0, {v})")
    plan = _route(_psi_plan_on(lpz.device.index, k, t, v),
                  f"psi K={k} T={t} V={v}")
    lpz, r_n, r_b = lpz.contiguous(), r_n.contiguous(), r_b.contiguous()
    last_tok = last_tok.to(torch.int32).contiguous()
    lengths = lengths.to(torch.int32).contiguous()
    psi = torch.empty((b, k, v), dtype=torch.float32, device=lpz.device)
    ptrs = (lpz.data_ptr(), last_tok.data_ptr(), lengths.data_ptr(),
            r_n.data_ptr(), r_b.data_ptr(), psi.data_ptr())
    stream = torch.cuda.current_stream(lpz.device).cuda_stream
    if plan is not None:  # eos and blank columns set in the kernel
        launch("ctc_prefix_psi_utt", *ptrs, b, k, t, v, blank, eos, *plan,
               stream)
        route = "utt"
    else:
        launch("ctc_prefix_psi", *ptrs, b, k, t, v, stream)
        route = "lane"
        psi = _patch_psi(psi, r_n, r_b, blank, eos)
    PREFIX_ROUTE_LAUNCHES["psi"][route] += 1
    prefix_psi.launches += 1
    return psi


prefix_psi.launches = 0


@traced("rg.op.prefix_psi_utt")
def prefix_psi_utt(lpz, last_tok, lengths, r_n, r_b, blank: int,
                   eos: int) -> torch.Tensor:
    """The per-utterance kernel's wrapper: the contract of
    ``robust_e2e_gan_tpu/ops/ctc_prefix_pallas.py::prefix_scores_psi_pallas``,
    which is ``prefix_psi``'s, so its plain version is ``prefix_psi_plain``.

    CPU tensors run the plain version; CUDA tensors launch
    ``csrc/ctc_prefix_utt.cu`` (one block per utterance, chunks of frames
    through a ring in shared memory at ``utt_psi_plan``, the eos and blank
    columns set in the kernel) or raise, e.g. past the plan (K x V above
    1,024 lanes). Any T runs.
    """
    check_no_grad("prefix_psi_utt", lpz, r_n, r_b)
    if not on_cuda(lpz, last_tok, lengths, r_n, r_b):
        return prefix_psi_plain(lpz, last_tok, lengths, r_n, r_b, blank, eos)
    b, k, t, v = _check_common(lpz, r_n, r_b,
                               {"last_tok": last_tok, "lengths": lengths})
    check(0 <= blank < v and 0 <= eos < v,
          f"blank={blank} or eos={eos} outside [0, {v})")
    plan = _utt_psi_plan_on(lpz.device.index, k, t, v)
    check(plan is not None,
          f"K*V={k * v} lanes at T={t}: past utt_psi_plan (more than "
          f"{UTT_MAX_THREADS} lanes, as many as a block's threads, or no "
          "chunk fits shared memory)")
    splits, chunk, stages = plan
    lpz, r_n, r_b = lpz.contiguous(), r_n.contiguous(), r_b.contiguous()
    last_tok = last_tok.to(torch.int32).contiguous()
    lengths = lengths.to(torch.int32).contiguous()
    psi = torch.empty((b, k, v), dtype=torch.float32, device=lpz.device)
    launch(
        "ctc_prefix_utt", lpz.data_ptr(), last_tok.data_ptr(),
        lengths.data_ptr(), r_n.data_ptr(), r_b.data_ptr(), psi.data_ptr(),
        b, k, t, v, blank, eos, splits, chunk, stages,
        utt_psi_smem(k, v, splits, chunk, stages),
        torch.cuda.current_stream(lpz.device).cuda_stream,
    )
    prefix_psi_utt.launches += 1
    return psi


prefix_psi_utt.launches = 0


def _state(lpz, tok, last_tok, lengths, r_n, r_b, blank: int, k_idx=None,
           append=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the state kernel of the shapes' route on CUDA tensors: the
    contract of ``prefix_state_plain`` with ``k_idx``/``append`` None, that
    of ``prefix_state_step_plain`` with them."""
    b, k, t, v = _check_common(
        lpz, r_n, r_b, {"tok": tok, "last_tok": last_tok, "lengths": lengths})
    check(0 <= blank < v, f"blank={blank} outside [0, {v})")
    if k_idx is not None:
        check(tuple(k_idx.shape) == (b, k) and tuple(append.shape) == (b, k),
              f"k_idx {tuple(k_idx.shape)}, append {tuple(append.shape)}")
    chunk = _route(_state_plan_on(lpz.device.index, k, t, v),
                   f"the state K={k} T={t} V={v}")
    if chunk is None and k_idx is not None:
        # the lane kernel between the plain version's gathers and selects
        rn_par, rb_par = gather_beam(r_n, k_idx), gather_beam(r_b, k_idx)
        rn_sel, rb_sel = _state(lpz, tok, gather_beam(last_tok, k_idx),
                                gather_beam(lengths, k_idx), rn_par, rb_par,
                                blank)
        sel = append[..., None]
        return (torch.where(sel, rn_sel, rn_par),
                torch.where(sel, rb_sel, rb_par))
    lpz, r_n, r_b = lpz.contiguous(), r_n.contiguous(), r_b.contiguous()
    tok, last_tok, lengths = (x.to(torch.int32).contiguous()
                              for x in (tok, last_tok, lengths))
    rn_out = torch.empty((b, k, t), dtype=torch.float32, device=lpz.device)
    rb_out = torch.empty_like(rn_out)
    outs = (rn_out.data_ptr(), rb_out.data_ptr(), b, k, t, v, blank)
    stream = torch.cuda.current_stream(lpz.device).cuda_stream
    if chunk is None:
        launch("ctc_prefix_state", lpz.data_ptr(), tok.data_ptr(),
               last_tok.data_ptr(), lengths.data_ptr(), r_n.data_ptr(),
               r_b.data_ptr(), *outs, stream)
        PREFIX_ROUTE_LAUNCHES["state"]["lane"] += 1
        return rn_out, rb_out
    if k_idx is not None:
        k_idx = k_idx.to(torch.int64).contiguous()
        append = append.to(torch.bool).contiguous()
    launch("ctc_prefix_state_utt", lpz.data_ptr(),
           0 if k_idx is None else k_idx.data_ptr(), tok.data_ptr(),
           0 if append is None else append.data_ptr(), last_tok.data_ptr(),
           lengths.data_ptr(), r_n.data_ptr(), r_b.data_ptr(), *outs, chunk,
           stream)
    PREFIX_ROUTE_LAUNCHES["state"]["utt"] += 1
    return rn_out, rb_out


def prefix_state(lpz, tok, last_tok, lengths, r_n, r_b,
                 blank: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel wrapper, same contract as ``prefix_state_plain`` (``tok``
    must lie in [0, V)).

    CPU tensors run the plain version; CUDA tensors launch the kernel of
    the shapes' route (``state_plan``; ``PREFIX_ROUTE_LAUNCHES["state"]``
    counts them) or raise.
    """
    check_no_grad("prefix_state", lpz, r_n, r_b)
    if not on_cuda(lpz, tok, last_tok, lengths, r_n, r_b):
        return prefix_state_plain(lpz, tok, last_tok, lengths, r_n, r_b, blank)
    out = _state(lpz, tok, last_tok, lengths, r_n, r_b, blank)
    prefix_state.launches += 1
    return out


prefix_state.launches = 0


@traced("rg.op.prefix_state_step")
def prefix_state_step(lpz, k_idx, tok, append, last_tok, lengths, r_n, r_b,
                      blank: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel wrapper, same contract as ``prefix_state_step_plain``
    (``tok`` in [0, V), ``k_idx`` in [0, K)); fresh output rows.

    CPU tensors run the plain version; CUDA tensors launch the state
    kernel of the shapes' route (on "utt" it reads the parents by
    ``k_idx`` and copies the rows where ``append`` is false itself; on
    "lane" the plain version's gathers and selects run around it) or
    raise.
    """
    check_no_grad("prefix_state_step", lpz, r_n, r_b)
    if not on_cuda(lpz, k_idx, tok, append, last_tok, lengths, r_n, r_b):
        return prefix_state_step_plain(lpz, k_idx, tok, append, last_tok,
                                       lengths, r_n, r_b, blank)
    out = _state(lpz, tok, last_tok, lengths, r_n, r_b, blank, k_idx, append)
    prefix_state_step.launches += 1
    return out


prefix_state_step.launches = 0
