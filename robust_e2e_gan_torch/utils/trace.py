"""Spans on the profiler's clock, and one flat export of the kernel
counters.

``span(name, args=None)`` marks a part of the program while a profiler
records (``torch.profiler.profile``; ``torch.autograd.profiler.emit_nvtx``
for NVTX ranges): it is then a ``torch.profiler.record_function`` range,
in the same trace as the device's kernels and copies and on the same
clock. With no profiler recording it returns one shared no-op context, and
builds nothing: no allocation, no string formatting. A span never
synchronises, on or off; the device time of a span is read from the trace
(each kernel's launch call lies inside the span that issued it). There is
no switch but the profiler: profile any call and its spans appear.

The spans, nested as the calls are (``args`` of a root: what identifies
its request):

- ``rg.search`` (B): ``decode/beam.py::make_beam_searcher``'s search.
- ``rg.encode``: the decode's encoder pass (``pipeline.py``'s
  ``encode_for_decode``, ``_feats``, ``_spec``); inside it
  ``rg.encode.frontend`` (STFT power; log-mel and CMVN),
  ``rg.encode.enhancer``, ``rg.encode.vgg`` and ``rg.encode.blstmp`` (the
  encoder's two halves, in training too) and ``rg.encode.heads`` (CTC
  logits and the attention's projection of the encoder).
- ``rg.beam``: ``beam_search_from_encoder``, set-up and loop; each loop
  iteration ``rg.beam.step``, with ``rg.beam.step.decoder`` (decoder step,
  the LM's, their log-softmax), ``.psi`` (the CTC prefix scores),
  ``.prune`` (joint scores to the top K and the gathers) and ``.state``
  (the CTC prefix state and the carries' permutation).
- ``rg.train.step`` (the step number): the joint adversarial step; inside
  it ``rg.train.d.forward`` (the generator without a graph),
  ``rg.train.d.disc`` (D's two calls, its loss and gradients),
  ``rg.train.d.optimizer``, ``rg.train.g.forward`` (the generator, D and
  the losses), ``rg.train.g.backward`` and ``rg.train.g.optimizer``.
- ``rg.op.<wrapper>``: a kernel wrapper of ``ops/*`` (``traced``), the
  whole call: its checks, plans, casts and allocations, and its launches.
- ``rg.launch`` (the entry point): ``utils/build.py::launch``, the call
  into the kernel library.

``SPAN_HOST`` tallies the entries and host seconds of each span while a
profiler records, so that a program that profiled a call can read them
without the trace.

``counters()`` is every route tally, wrapper launch count and plain-version
call count of ``ops/*``, flat: ``route.<kernel>.<route>``,
``launch.<wrapper>``, ``plain.<wrapper>``; ``since(before)`` what moved.
The counters stay on their modules, where the tests read them.
"""

from __future__ import annotations

import contextlib
import functools
import time
from typing import Callable, Dict, List, Optional

import torch

# true under torch.profiler.profile and emit_nvtx, on every thread they
# reach (the autograd engine's too)
_recording = torch._C._autograd._profiler_enabled
_OFF = contextlib.nullcontext()

# span name -> [entries, host seconds], counted while a profiler records
SPAN_HOST: Dict[str, List[float]] = {}


class _Span:
    """A ``record_function`` range that also adds its host time to
    ``SPAN_HOST``."""

    __slots__ = ("name", "range", "t0")

    def __init__(self, name: str, args):
        self.name = name
        self.range = torch.profiler.record_function(
            name, None if args is None else str(args))

    def __enter__(self):
        self.range.__enter__()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        dt = time.perf_counter() - self.t0
        tally = SPAN_HOST.setdefault(self.name, [0, 0.0])
        tally[0] += 1
        tally[1] += dt
        return self.range.__exit__(*exc)


def span(name: str, args=None):
    """A context marking ``name`` in a profiler's trace while one records
    (``args``, formatted only then, rides on the range); otherwise the
    shared no-op."""
    if not _recording():
        return _OFF
    return _Span(name, args)


def traced(name: str) -> Callable:
    """Decorator: the whole call of the function is span ``name``. The
    wrapper is what the module binds, so attributes set on that name
    afterwards (``.launches``) live on it."""
    def wrap(fn):
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            if not _recording():
                return fn(*args, **kwargs)
            with _Span(name, None):
                return fn(*args, **kwargs)
        return inner
    return wrap


def _tables():
    """(route tallies, wrappers, plain versions) of ``ops/*``, by the
    names of the export."""
    from robust_e2e_gan_torch.ops import (
        att,
        att_dec,
        blstm,
        blstm_train,
        ctc,
        ctc_prefix,
        fbank_fused,
        lm_step,
    )
    tallies = {
        "blstm_infer": blstm.INFER_ROUTE_LAUNCHES,
        "blstm_recurrence": blstm.GX_ROUTE_LAUNCHES,
        "blstm_train": blstm_train.ROUTE_LAUNCHES,
        "gemm": blstm_train.GEMM_ROUTE_LAUNCHES,
        "att_loc_step": att.ATT_ROUTE_LAUNCHES,
        "att_dec_step": att_dec.DEC_ROUTE_LAUNCHES,
        "ctc_prefix_psi": ctc_prefix.PREFIX_ROUTE_LAUNCHES["psi"],
        "ctc_prefix_state": ctc_prefix.PREFIX_ROUTE_LAUNCHES["state"],
        "fbank_fused": fbank_fused.FBANK_ROUTE_LAUNCHES,
        "fbank_fused_bwd": fbank_fused.FBANK_BWD_ROUTE_LAUNCHES,
        "lm_step": lm_step.LM_ROUTE_LAUNCHES,
    }
    wrappers = {fn.__name__: fn for fn in (
        blstm.blstm_infer, blstm.blstm_recurrence, blstm_train.blstm_train,
        blstm_train.blstm_train_gx, blstm_train.gemm, att.att_loc_step,
        att_dec.att_dec_step, ctc.ctc_nll, ctc.ctc_alpha,
        ctc_prefix.prefix_psi, ctc_prefix.prefix_psi_utt,
        ctc_prefix.prefix_state, ctc_prefix.prefix_state_step,
        fbank_fused.fbank_fused, fbank_fused.fbank_fused_bwd,
        lm_step.lm_step)}
    plains = {
        "blstm_infer": blstm.blstm_infer_plain,
        "blstm_recurrence": blstm.blstm_recurrence_plain,
        "blstm_train": blstm_train.blstm_train_plain,
        "blstm_train_gx": blstm_train.blstm_train_gx_plain,
        "gemm": blstm_train.gemm_plain,
        "att_loc_step": att.att_loc_step_plain,
        "att_dec_step": att_dec.att_dec_step_plain,
        "ctc_nll": ctc.ctc_nll_plain,
        "ctc_alpha": ctc.ctc_alpha_fwd_plain,
        "prefix_psi": ctc_prefix.prefix_psi_recursion_plain,
        "prefix_state": ctc_prefix.prefix_state_plain,
        "fbank_fused": fbank_fused.fbank_fused_plain,
        "fbank_fused_bwd": fbank_fused.fbank_fused_bwd_plain,
        "lm_step": lm_step.lm_step_plain,
    }
    return tallies, wrappers, plains


def counters() -> Dict[str, int]:
    """Every counter of ``ops/*`` so far, flat: ``route.<kernel>.<route>``,
    ``launch.<wrapper>``, ``plain.<wrapper>``."""
    tallies, wrappers, plains = _tables()
    out: Dict[str, int] = {}
    for name, routes in tallies.items():
        for route, n in routes.items():
            out[f"route.{name}.{route}"] = int(n)
    for name, fn in wrappers.items():
        out[f"launch.{name}"] = int(fn.launches)
    for name, fn in plains.items():
        out[f"plain.{name}"] = int(fn.calls)
    return out


def since(before: Optional[Dict[str, int]] = None) -> Dict[str, int]:
    """The counters' growth since ``before`` (all of them without it),
    leaving out those that did not move."""
    before = before or {}
    return {k: v - before.get(k, 0) for k, v in counters().items()
            if v - before.get(k, 0)}
