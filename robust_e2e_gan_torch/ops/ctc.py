"""CTC loss: log-space forward algorithm, its kernels and plain versions.

Port of ``robust_e2e_gan_tpu/ops/ctc.py``. ``ctc_loss`` is the dispatch
and the reduction (``ctc.py:160-167``); the per-utterance loss is
``ctc_nll`` (kernels ``ctc_nll_fwd``/``ctc_nll_bwd`` of
``csrc/ctc_alpha.cu``, one launch each way) for ``ctc_impl``
"auto"/"fused", or ``ctc_nll_plain`` for "scan". The JAX package keeps
the log-softmax, the emission gather, ``alpha0`` (``ctc.py:61-90``) and
the final two-position log-sum-exp (``ctc.py:145-158``) outside its
kernel; ``ctc_nll_plain`` keeps them so, around the alpha recursion
``ctc_alpha_plain``, and the kernels take them in.

``ctc_alpha`` is the JAX kernel's own contract (``ops/ctc_pallas.py::
ctc_alpha_final``: emissions and alpha0 in, final alpha out), on the same
per-frame steps in ``csrc/ctc_alpha.cu``; no path runs it.

The plain forward is the JAX scan step (``ctc.py:92-115``) as a loop; the
plain backward is the hand-derived adjoint of ``ctc_pallas.py:144-199``.
Sentinels and clamps are the reference's: -1e30 for log 0, -5e29 as the
kernel's compare threshold, sums clamped at 1e-37. The recursion is
float32.
"""

from __future__ import annotations

import torch

from robust_e2e_gan_torch.utils.build import launch
from robust_e2e_gan_torch.utils.impl import check, kernel_enabled, on_cuda
from robust_e2e_gan_torch.utils.trace import traced

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


@traced("rg.op.ctc_alpha")
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


def ctc_alpha_inputs(logits: torch.Tensor, labels: torch.Tensor,
                     label_lengths: torch.Tensor, blank_id: int = 0,
                     log_input: bool = False):
    """What the recursion takes (``ops/ctc.py:61-90``): the emissions
    (B, T, U) (the log-softmax gathered at the blank-interleaved labels,
    float32), alpha0, the skip and position masks (B, U)."""
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
    return emit, alpha0, skip_add, pos_add


def ctc_nll_plain(logits: torch.Tensor, logit_lengths: torch.Tensor,
                  labels: torch.Tensor, label_lengths: torch.Tensor,
                  blank_id: int = 0, log_input: bool = False) -> torch.Tensor:
    """Negative log-likelihood (B,) of each utterance's CTC alignment
    marginal, as ``ops/ctc.py::ctc_loss`` before its reduction: logits
    (B, T, V) (log-probabilities with ``log_input``), logit_lengths (B,),
    labels (B, S) (padding arbitrary past label_lengths, but in [0, V)),
    label_lengths (B,). An utterance too short for its label gets 1e30.
    Plain PyTorch on any device, differentiable with respect to the
    logits."""
    ctc_nll_plain.calls += 1
    emit, alpha0, skip_add, pos_add = ctc_alpha_inputs(
        logits, labels, label_lengths, blank_id, log_input)
    alpha = ctc_alpha_plain(emit, alpha0, skip_add, pos_add, logit_lengths)

    label_lengths = label_lengths.long()
    last = 2 * label_lengths
    a_last = alpha.gather(1, last[:, None])[:, 0]
    a_prev = alpha.gather(1, torch.clamp_min(last - 1, 0)[:, None])[:, 0]
    a_prev = torch.where(label_lengths > 0, a_prev, NEG_INF)
    m = torch.maximum(a_last, a_prev)
    safe_m = torch.where(m <= NEG_INF, 0.0, m)
    ll = safe_m + torch.log(torch.clamp_min(
        torch.exp(a_last - safe_m) + torch.exp(a_prev - safe_m), 1e-37))
    return -torch.where(m <= NEG_INF, NEG_INF, ll)


ctc_nll_plain.calls = 0


_LOGIT_DTYPES = (torch.float32, torch.bfloat16)
_INDEX_DTYPES = (torch.int32, torch.int64)


def _nll_flags(logits, logit_lengths, labels, label_lengths,
               blank_id) -> int:
    """Check what the kernels take; returns their int64 flags (bit 0
    labels, 1 logit lengths, 2 label lengths). Messages are formatted only
    for a refusal."""
    check(logits.dim() == 3 and logits.dtype in _LOGIT_DTYPES,
          "logits %s %s: expected (B, T, V) float32 or bfloat16",
          tuple(logits.shape), logits.dtype)
    b, t, v = logits.shape
    check(b >= 1 and t >= 1, "logits shape %s", tuple(logits.shape))
    check(labels.dim() == 2 and labels.shape[0] == b
          and logit_lengths.shape == (b,) and label_lengths.shape == (b,),
          "labels %s, logit_lengths %s, label_lengths %s for B=%d",
          tuple(labels.shape), tuple(logit_lengths.shape),
          tuple(label_lengths.shape), b)
    index = (labels, logit_lengths, label_lengths)
    check(all(x.dtype in _INDEX_DTYPES for x in index),
          "labels and lengths must be int32 or int64, not %s %s %s",
          labels.dtype, logit_lengths.dtype, label_lengths.dtype)
    u = 2 * labels.shape[1] + 1
    check(u <= MAX_POSITIONS, "U=%d outside [1, %d]", u, MAX_POSITIONS)
    check(0 <= blank_id < v, "blank_id %d outside [0, %d)", blank_id, v)
    return sum((x.dtype == torch.int64) << bit for bit, x in enumerate(index))


def _stream(x: torch.Tensor) -> int:
    return torch.cuda.current_stream(x.device).cuda_stream


def _nll_fwd(logits, logit_lengths, labels, label_lengths, blank_id,
             log_input, flags, with_hist: bool):
    """-> nll (B,), lse (B, T), and with the history hist (T, B, U) and
    the backward's scratch: demit (B, T, U), two sums (B, 2T) and the
    label heads (B, V) as int32 (``csrc/ctc_alpha.cu::nll_bwd_kernel``)."""
    b, t, v = logits.shape
    u = 2 * labels.shape[1] + 1
    nll = torch.empty((b,), device=logits.device)
    size = b * t + (t * b * u + b * t * (u + 2) + b * v if with_hist else 0)
    work = torch.empty((size,), device=logits.device)  # one buffer for all
    lse = work[:b * t].view(b, t)
    hist = work[b * t:b * t * (u + 1)].view(t, b, u) if with_hist else None
    scratch = work[b * t * (u + 1):] if with_hist else None
    launch("ctc_nll_fwd", logits.data_ptr(), labels.data_ptr(),
           logit_lengths.data_ptr(), label_lengths.data_ptr(),
           0 if hist is None else hist.data_ptr(), lse.data_ptr(),
           nll.data_ptr(), b, t, v, u, blank_id, int(log_input),
           int(logits.dtype == torch.bfloat16), flags, _stream(logits))
    ctc_nll.launches += 1
    return nll, lse, hist, scratch


class _CTCNLL(torch.autograd.Function):
    """logits -> nll (B,); lengths and labels are constants."""

    @staticmethod
    def forward(ctx, logits, logit_lengths, labels, label_lengths, blank_id,
                log_input, flags):
        nll, lse, hist, scratch = _nll_fwd(logits, logit_lengths, labels,
                                           label_lengths, blank_id, log_input,
                                           flags, True)
        ctx.save_for_backward(logits, logit_lengths, labels, label_lengths,
                              hist, lse, scratch)
        ctx.args = (blank_id, log_input, flags)
        return nll

    @staticmethod
    def backward(ctx, dnll):
        logits, logit_lengths, labels, label_lengths, hist, lse, scratch = \
            ctx.saved_tensors
        blank_id, log_input, flags = ctx.args
        b, t, v = logits.shape
        dlogits = torch.empty_like(logits)
        launch("ctc_nll_bwd", logits.data_ptr(), labels.data_ptr(),
               logit_lengths.data_ptr(), label_lengths.data_ptr(),
               hist.data_ptr(), lse.data_ptr(), dnll.data_ptr(),
               scratch.data_ptr(), dlogits.data_ptr(), dnll.stride(0), b, t,
               v, hist.shape[2], blank_id, int(log_input),
               int(logits.dtype == torch.bfloat16), flags, _stream(logits))
        ctc_nll.launches += 1
        return dlogits, None, None, None, None, None, None


@traced("rg.op.ctc_nll")
def ctc_nll(logits: torch.Tensor, logit_lengths: torch.Tensor,
            labels: torch.Tensor, label_lengths: torch.Tensor,
            blank_id: int = 0, log_input: bool = False) -> torch.Tensor:
    """``ctc_nll_plain``'s function, differentiable with respect to the
    logits: one launch of ``ctc_nll_fwd`` (with the alpha history only
    when autograd records) and one of ``ctc_nll_bwd`` for the gradient.
    Logits float32 or bfloat16, labels and lengths int32 or int64, each
    read as it is. A label outside [0, V) at a position inside the label,
    or a label length outside [0, S], is a device-side assert in the
    forward, as ``torch.gather``'s in the plain version on CUDA.

    CPU tensors run the plain version; CUDA tensors launch the kernels or
    raise (U <= 1,024).
    """
    if not on_cuda(logits, logit_lengths, labels, label_lengths):
        return ctc_nll_plain(logits, logit_lengths, labels, label_lengths,
                             blank_id, log_input)
    flags = _nll_flags(logits, logit_lengths, labels, label_lengths, blank_id)
    args = (logits.contiguous(), logit_lengths.contiguous(),
            labels.contiguous(), label_lengths.contiguous(), blank_id,
            log_input, flags)
    if _needs_grad(logits):
        return _CTCNLL.apply(*args)
    return _nll_fwd(*args, with_hist=False)[0]


ctc_nll.launches = 0


def ctc_loss(logits: torch.Tensor, logit_lengths: torch.Tensor,
             labels: torch.Tensor, label_lengths: torch.Tensor,
             blank_id: int = 0, log_input: bool = False,
             reduction: str = "mean", impl: str = "auto") -> torch.Tensor:
    """Negative log-likelihood of the CTC alignment marginal, as
    ``ops/ctc.py::ctc_loss``: logits (B, T, V), logit_lengths (B,), labels
    (B, S) (padding arbitrary past label_lengths), label_lengths (B,).
    ``reduction``: "mean" (per label token, torch semantics), "sum" or
    "none" -> (B,). ``impl``: "scan" runs ``ctc_nll_plain``, "auto" or
    "fused" the kernel wrapper ``ctc_nll``."""
    fn = ctc_nll if kernel_enabled(impl) else ctc_nll_plain
    nll = fn(logits, logit_lengths, labels, label_lengths, blank_id,
             log_input)
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
