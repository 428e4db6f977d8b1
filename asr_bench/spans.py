"""The port's ``rg.*`` spans in a profiled window, reduced by name.

The port marks its parts with ``record_function`` ranges while a profiler
records (``robust_e2e_gan_torch/utils/trace.py``); they land in the Chrome
trace beside the device's operations and the runtime's calls, on one
clock. For each span name in the window [lo, hi] (microseconds, the
trace's unit):

- ``count``; ``host_s``, the sum of its durations; ``self_s``, that less
  the durations of its direct ``rg.*`` children on the same thread;
- ``device_s``, inclusive: the device time of the kernels, copies and sets
  whose launching runtime or driver call lies inside one of its intervals,
  matched by ``args.correlation`` (a span covers calls on any thread in
  its interval: the autograd engine launches the backward from its own);
  ``kernel_s`` the kernels' part;
- ``self_device_s`` and ``kernels``: the device time of the operations
  whose launch has this span as its innermost (the launching thread's
  innermost span, else the shortest around the call), in all and by
  kernel name;
- ``launches``: the launch calls (``trace.LAUNCH_CALLS``) inside it;
- ``idle_s``: the idle gaps whose midpoint has this span as the innermost
  (shortest) ``rg.*`` span around it; the gaps outside every span are the
  row ``OUTSIDE``.

Nothing here reads the device's clock apart from the trace: a span never
synchronises.
"""

from __future__ import annotations

import heapq
from collections import defaultdict
from typing import Dict, List, Sequence, Tuple

from asr_bench.trace import DEVICE_CATS, LAUNCH_CALLS

PREFIX = "rg."
OUTSIDE = "(outside rg spans)"
CALL_CATS = ("cuda_runtime", "cuda_driver")
FIELDS = ("count", "host_s", "self_s", "device_s", "kernel_s",
          "self_device_s", "launches", "idle_s")


def _row() -> dict:
    row = dict.fromkeys(FIELDS, 0.0)
    row["count"] = row["launches"] = 0
    row["kernels"] = defaultdict(float)
    return row


def sweep(spans: List[dict], points: List[Tuple[float, int]]):
    """For each (time, index) of ``points`` in time order, the spans whose
    interval holds the time: yields (index, active spans)."""
    spans = sorted(spans, key=lambda e: e["ts"])
    active: List[Tuple[float, int, dict]] = []  # (end, order, span)
    at = 0
    for t, i in sorted(points):
        while at < len(spans) and spans[at]["ts"] <= t:
            e = spans[at]
            heapq.heappush(active, (e["ts"] + e["dur"], at, e))
            at += 1
        while active and active[0][0] < t:
            heapq.heappop(active)
        yield i, [e for end, _, e in active if end >= t]


def innermost(active: List[dict], tid=None):
    """The shortest span of ``active``, on thread ``tid`` where one is."""
    own = [e for e in active if e.get("tid") == tid] if tid is not None \
        else []
    pool = own or active
    return min(pool, key=lambda e: e["dur"]) if pool else None


def reduce(events: Sequence[dict], lo: float, hi: float,
           gaps: Sequence[Tuple[float, float]]) -> Dict[str, dict]:
    """{span name: its row} over the window; see the module's docstring.
    ``gaps`` are the window's idle intervals (``trace.union``'s)."""
    spans = [e for e in events if e.get("cat") == "user_annotation"
             and str(e.get("name", "")).startswith(PREFIX) and "dur" in e
             and lo <= e["ts"] <= hi]
    out: Dict[str, dict] = defaultdict(_row)
    for e in spans:
        row = out[e["name"]]
        row["count"] += 1
        row["host_s"] += e["dur"] * 1e-6
    # self time: less each direct child's, thread by thread
    by_thread = defaultdict(list)
    for e in spans:
        by_thread[(e.get("pid"), e.get("tid"))].append(e)
    for group in by_thread.values():
        group.sort(key=lambda e: (e["ts"], -e["dur"]))
        stack: List[dict] = []
        child_us: Dict[int, float] = defaultdict(float)
        for e in group:
            while stack and stack[-1]["ts"] + stack[-1]["dur"] <= e["ts"]:
                stack.pop()
            if stack:
                child_us[id(stack[-1])] += e["dur"]
            stack.append(e)
        for e in group:
            out[e["name"]]["self_s"] += (e["dur"] - child_us[id(e)]) * 1e-6

    # device operations by the correlation of the call that launched them
    dev_us: Dict[int, float] = defaultdict(float)
    ker_us: Dict[int, Dict[str, float]] = defaultdict(
        lambda: defaultdict(float))
    for e in events:
        if e.get("cat") in DEVICE_CATS and "dur" in e \
                and e["ts"] < hi and e["ts"] + e["dur"] > lo:
            corr = (e.get("args") or {}).get("correlation")
            if corr is None:
                continue
            dur = min(e["ts"] + e["dur"], hi) - max(e["ts"], lo)
            dev_us[corr] += dur
            if e["cat"] == "kernel":
                ker_us[corr][e["name"]] += dur
    calls = [e for e in events if e.get("cat") in CALL_CATS
             and lo <= e.get("ts", hi + 1) <= hi]
    for i, active in sweep(spans, [(e["ts"], i)
                                    for i, e in enumerate(calls)]):
        call = calls[i]
        corr = (call.get("args") or {}).get("correlation")
        dev = dev_us.get(corr, 0.0) * 1e-6
        kers = ker_us.get(corr, {})
        ker = sum(kers.values()) * 1e-6
        launch = call.get("name") in LAUNCH_CALLS
        for name in {e["name"] for e in active}:
            row = out[name]
            row["device_s"] += dev
            row["kernel_s"] += ker
            row["launches"] += launch
        inner = innermost(active, call.get("tid"))
        if inner is not None and dev:
            row = out[inner["name"]]
            row["self_device_s"] += dev
            for k, v in kers.items():
                row["kernels"][k] += v * 1e-6

    gaps = list(gaps)
    for i, active in sweep(spans, [(0.5 * (a + b), i)
                                    for i, (a, b) in enumerate(gaps)]):
        a, b = gaps[i]
        inner = innermost(active)
        out[OUTSIDE if inner is None else inner["name"]]["idle_s"] += \
            (b - a) * 1e-6
    return {k: dict(v, kernels=dict(v["kernels"])) for k, v in out.items()}


def window(events: Sequence[dict], name: str) -> Tuple[float, float]:
    """(start, end) in microseconds of the first ``name`` annotation."""
    for e in events:
        if e.get("name") == name and e.get("cat") == "user_annotation":
            return e["ts"], e["ts"] + e["dur"]
    raise RuntimeError(f"no span {name!r} in the trace")
