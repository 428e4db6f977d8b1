"""CTC loss: log-space forward algorithm, its kernel and plain versions.

Port of ``robust_e2e_gan_tpu/ops/ctc.py``. What the JAX package keeps
outside its kernel stays outside here: the log-softmax, the emission
gather and ``alpha0`` (``ctc.py:61-90``), and the final two-position
log-sum-exp and the reduction (``ctc.py:145-167``). The alpha recursion
in between is ``ctc_alpha`` (the counterpart of
``ops/ctc_pallas.py::ctc_alpha_final``, kernel ``csrc/ctc_alpha.cu``) for
``ctc_impl`` "auto"/"fused", or its plain version for "scan".

The plain forward is the JAX scan step (``ctc.py:92-115``) as a loop; the
plain backward is the hand-derived adjoint of ``ctc_pallas.py:144-199``.
Sentinels and clamps are the reference's: -1e30 for log 0, -5e29 as the
kernel's compare threshold, sums clamped at 1e-37. Everything is float32.
"""

from __future__ import annotations

import torch

from robust_e2e_gan_torch.utils.build import launch
from robust_e2e_gan_torch.utils.impl import check, kernel_enabled, on_cuda

NEG_INF = -1e30
NEG_THRESH = -5e29
MAX_POSITIONS = 1024  # one thread per extended-label position


def _shifts(alpha: torch.Tensor, skip_add: torch.Tensor):
    """alpha[u-1] and alpha[u-2] + skip, -1e30 where the shift runs off."""
    fill = alpha.new_full(alpha.shape[:-1] + (2,), NEG_INF)
    padded = torch.cat([fill, alpha], dim=-1)
    return padded[..., 1:-1], padded[..., :-2] + skip_add


def ctc_alpha_fwd_plain(emit, alpha0, skip_add, pos_add, lengths,
                        with_hist: bool = True):
    """The scan step of ``ops/ctc.py`` as a loop: emit (B, T, U), alpha0,
    skip_add, pos_add (B, U), lengths (B,) -> (final alpha (B, U), history
    (T, B, U) with row 0 = alpha0, or None)."""
    ctc_alpha_fwd_plain.calls += 1
    t = emit.shape[1]
    alpha = alpha0
    hist = [alpha0]
    for i in range(1, t):
        sh1, sh2 = _shifts(alpha, skip_add)
        stacked = torch.stack([alpha, sh1, sh2])
        m = stacked.max(dim=0).values
        safe_m = torch.where(m <= NEG_INF, 0.0, m)
        summed = torch.clamp_min(torch.exp(stacked - safe_m).sum(dim=0), 1e-37)
        new = torch.where(m <= NEG_INF, NEG_INF,
                          safe_m + torch.log(summed)) + emit[:, i] + pos_add
        new = torch.clamp_min(new, NEG_INF)
        alpha = torch.where((i < lengths)[:, None], new, alpha)
        hist.append(alpha)
    return alpha, (torch.stack(hist) if with_hist else None)


ctc_alpha_fwd_plain.calls = 0


def ctc_alpha_bwd_plain(emit, skip_add, pos_add, lengths, hist, dfin):
    """The adjoint of the recursion (``ctc_pallas.py::_bwd_kernel``):
    -> (demit (B, T, U) with frame 0 zero, dalpha0 (B, U))."""
    t = emit.shape[1]
    da = dfin
    demit = torch.zeros_like(emit)
    for i in range(t - 1, 0, -1):
        a_prev, a_new = hist[i - 1], hist[i]
        active = (i < lengths)[:, None]
        da_na = torch.where(active, da, 0.0)
        da_pass = torch.where(active, 0.0, da)
        pre = a_new - emit[:, i] - pos_add
        dpre = torch.where(active & (a_new > NEG_THRESH), da_na, 0.0)
        demit[:, i] = dpre
        sh1, sh2 = _shifts(a_prev, skip_add)
        safe_pre = torch.where(pre <= NEG_THRESH, 0.0, pre)
        w0 = torch.exp(torch.clamp_min(a_prev - safe_pre, NEG_INF))
        w1 = torch.exp(torch.clamp_min(sh1 - safe_pre, NEG_INF))
        w2 = torch.exp(torch.clamp_min(sh2 - safe_pre, NEG_INF))
        zero = da.new_zeros(da.shape[:-1] + (2,))
        g1 = torch.cat([w1 * dpre, zero], dim=-1)[..., 1:-1]
        g2 = torch.cat([w2 * dpre, zero], dim=-1)[..., 2:]
        da = w0 * dpre + g1 + g2 + da_pass
    return demit, da


def _fwd_kernel(emit, alpha0, skip_add, pos_add, lengths, with_hist: bool):
    b, t, u = emit.shape
    afin = torch.empty((b, u), device=emit.device)
    hist = (torch.empty((t, b, u), device=emit.device) if with_hist
            else None)
    launch("ctc_alpha_fwd", emit.data_ptr(), alpha0.data_ptr(),
           skip_add.data_ptr(), pos_add.data_ptr(), lengths.data_ptr(),
           0 if hist is None else hist.data_ptr(), afin.data_ptr(), b, t, u,
           torch.cuda.current_stream(emit.device).cuda_stream)
    ctc_alpha.launches += 1
    return afin, hist


def _bwd_kernel(emit, skip_add, pos_add, lengths, hist, dfin):
    b, t, u = emit.shape
    demit = torch.empty_like(emit)
    da0 = torch.empty((b, u), device=emit.device)
    dfin = dfin.contiguous()
    launch("ctc_alpha_bwd", emit.data_ptr(), skip_add.data_ptr(),
           pos_add.data_ptr(), lengths.data_ptr(), hist.data_ptr(),
           dfin.data_ptr(), demit.data_ptr(), da0.data_ptr(), b, t, u,
           torch.cuda.current_stream(emit.device).cuda_stream)
    ctc_alpha.launches += 1
    return demit, da0


class _CTCAlpha(torch.autograd.Function):
    """(emit, alpha0) -> final alpha; skip/pos/lengths are constants."""

    @staticmethod
    def forward(ctx, emit, alpha0, skip_add, pos_add, lengths, kernel: bool):
        if kernel:
            afin, hist = _fwd_kernel(emit, alpha0, skip_add, pos_add, lengths,
                                     True)
        else:
            afin, hist = ctc_alpha_fwd_plain(emit, alpha0, skip_add, pos_add,
                                             lengths)
        ctx.kernel = kernel
        ctx.save_for_backward(emit, skip_add, pos_add, lengths, hist)
        return afin

    @staticmethod
    def backward(ctx, dfin):
        emit, skip_add, pos_add, lengths, hist = ctx.saved_tensors
        fn = _bwd_kernel if ctx.kernel else ctc_alpha_bwd_plain
        demit, da0 = fn(emit, skip_add, pos_add, lengths, hist, dfin)
        return demit, da0, None, None, None, None


def _needs_grad(*tensors) -> bool:
    return torch.is_grad_enabled() and any(x.requires_grad for x in tensors)


def ctc_alpha_plain(emit, alpha0, skip_add, pos_add, lengths) -> torch.Tensor:
    """Plain version of ``ctc_alpha`` on any device."""
    if _needs_grad(emit, alpha0):
        return _CTCAlpha.apply(emit, alpha0, skip_add, pos_add, lengths, False)
    return ctc_alpha_fwd_plain(emit, alpha0, skip_add, pos_add, lengths,
                               with_hist=False)[0]


def ctc_alpha(emit: torch.Tensor, alpha0: torch.Tensor,
              skip_add: torch.Tensor, pos_add: torch.Tensor,
              lengths: torch.Tensor) -> torch.Tensor:
    """Final frozen alpha (B, U) of the recursion, differentiable with
    respect to ``emit`` (B, T, U) and ``alpha0`` (B, U); the contract of
    ``ctc_pallas.py::ctc_alpha_final``. Without a gradient to record, the
    kernel writes no history.

    CPU tensors run the plain version; CUDA tensors launch
    ``csrc/ctc_alpha.cu`` or raise.
    """
    if not on_cuda(emit, alpha0, skip_add, pos_add, lengths):
        return ctc_alpha_plain(emit, alpha0, skip_add, pos_add, lengths)
    b, t, u = emit.shape
    check(1 <= u <= MAX_POSITIONS, f"U={u} outside [1, {MAX_POSITIONS}]")
    for name, x in (("alpha0", alpha0), ("skip_add", skip_add),
                    ("pos_add", pos_add)):
        check(tuple(x.shape) == (b, u), f"{name} shape {tuple(x.shape)}")
    check(tuple(lengths.shape) == (b,), f"lengths shape {tuple(lengths.shape)}")
    args = [x.float().contiguous() for x in (emit, alpha0, skip_add, pos_add)]
    lens = lengths.to(torch.int32).contiguous()
    if _needs_grad(emit, alpha0):
        return _CTCAlpha.apply(*args, lens, True)
    return _fwd_kernel(*args, lens, False)[0]


ctc_alpha.launches = 0


def ctc_loss(logits: torch.Tensor, logit_lengths: torch.Tensor,
             labels: torch.Tensor, label_lengths: torch.Tensor,
             blank_id: int = 0, log_input: bool = False,
             reduction: str = "mean", impl: str = "auto") -> torch.Tensor:
    """Negative log-likelihood of the CTC alignment marginal, as
    ``ops/ctc.py::ctc_loss``: logits (B, T, V), logit_lengths (B,), labels
    (B, S) (padding arbitrary past label_lengths), label_lengths (B,).
    ``reduction``: "mean" (per label token, torch semantics), "sum" or
    "none" -> (B,). ``impl``: "scan" runs the plain recursion, "auto" or
    "fused" the kernel wrapper."""
    b, t, v = logits.shape
    s = labels.shape[1]
    u = 2 * s + 1
    dev = logits.device
    lp = logits if log_input else torch.log_softmax(logits, dim=-1)
    lp = lp.float()
    labels = labels.long()
    label_lengths = label_lengths.long()
    ext = torch.full((b, u), blank_id, dtype=torch.long, device=dev)
    ext[:, 1::2] = labels
    ext_shift2 = torch.cat([torch.full((b, 2), -1, dtype=torch.long,
                                       device=dev), ext[:, :-2]], dim=1)
    allow_skip = (ext != blank_id) & (ext != ext_shift2)
    skip_add = torch.where(allow_skip, 0.0, NEG_INF)
    emit = torch.gather(lp, 2, ext[:, None, :].expand(b, t, u))  # (B, T, U)
    valid_pos = torch.arange(u, device=dev)[None, :] < (2 * label_lengths[:, None] + 1)
    pos_add = torch.where(valid_pos, 0.0, NEG_INF)

    alpha0 = torch.full((b, u), NEG_INF, device=dev)
    alpha0[:, 0] = emit[:, 0, 0]
    if s > 0:
        alpha0[:, 1] = torch.where(label_lengths > 0, emit[:, 0, 1], NEG_INF)
    alpha0 = torch.clamp_min(alpha0 + pos_add, NEG_INF)

    fn = ctc_alpha if kernel_enabled(impl) else ctc_alpha_plain
    alpha = fn(emit, alpha0, skip_add, pos_add, logit_lengths)

    last = 2 * label_lengths
    a_last = alpha.gather(1, last[:, None])[:, 0]
    a_prev = alpha.gather(1, torch.clamp_min(last - 1, 0)[:, None])[:, 0]
    a_prev = torch.where(label_lengths > 0, a_prev, NEG_INF)
    m = torch.maximum(a_last, a_prev)
    safe_m = torch.where(m <= NEG_INF, 0.0, m)
    ll = safe_m + torch.log(torch.clamp_min(
        torch.exp(a_last - safe_m) + torch.exp(a_prev - safe_m), 1e-37))
    nll = -torch.where(m <= NEG_INF, NEG_INF, ll)
    if reduction == "none":
        return nll
    if reduction == "sum":
        return nll.sum()
    if reduction == "mean":
        return (nll / torch.clamp_min(label_lengths.float(), 1.0)).mean()
    raise ValueError(f"unknown reduction {reduction!r}")


def ctc_greedy_decode(logits: torch.Tensor, logit_lengths: torch.Tensor,
                      blank_id: int = 0) -> torch.Tensor:
    """Best-path decode: (B, T) int32 with repeats and blanks replaced by
    -1 at non-emitting positions."""
    ids = torch.argmax(logits, dim=-1).to(torch.int32)
    prev = torch.cat([torch.full_like(ids[:, :1], -1), ids[:, :-1]], dim=1)
    in_range = (torch.arange(ids.shape[1], device=ids.device)[None, :]
                < logit_lengths[:, None])
    emit = (ids != prev) & (ids != blank_id) & in_range
    return torch.where(emit, ids, -1)
