"""A profiled window at the end of a traced run, reduced to what the
per-layer metrics read.

``torch.profiler`` records a few steady batches or steps inside one
``record_function`` span; its Chrome trace gives each device operation's
interval (kernels, copies, sets, on any stream), each runtime call on the
host, and the host's ops. From them: the device's busy time as the union
of the device intervals inside the span (two streams overlap, so a sum
would count time twice), the idle gaps named by the host op that was
running, the launches by the runtime's launch calls, and the device time
of each kernel name.
"""

from __future__ import annotations

import heapq
import json
import os
import tempfile
from collections import defaultdict
from typing import Callable, Dict, List, Sequence, Tuple

WINDOW = "asr_bench.window"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver",
             "python_function")
# one launch each, whatever API the program launched through
LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC",
                "cudaLaunchCooperativeKernel",
                "cudaLaunchCooperativeKernelMultiDevice", "cuLaunchKernel",
                "cuLaunchKernelEx", "cuLaunchCooperativeKernel",
                "cudaGraphLaunch", "cuGraphLaunch")

Interval = Tuple[float, float]


def union(intervals: Sequence[Interval], lo: float, hi: float
          ) -> Tuple[float, List[Interval]]:
    """(covered length, gaps) of ``intervals`` clipped to [lo, hi]."""
    xs = sorted((max(a, lo), min(b, hi)) for a, b in intervals
                if b > lo and a < hi)
    covered, gaps, at = 0.0, [], lo
    for a, b in xs:
        if a > at:
            gaps.append((at, a))
            at = a
        if b > at:
            covered += b - at
            at = b
    if at < hi:
        gaps.append((at, hi))
    return covered, gaps


class Profile:
    """The reduced trace of one profiled window (times in seconds)."""

    def __init__(self, events: List[dict], units: int):
        win = [e for e in events if e.get("name") == WINDOW
               and e.get("cat") == "user_annotation"]
        if not win:
            raise RuntimeError("the profiled window's span is not in the "
                               "trace")
        lo = win[0]["ts"]
        hi = lo + win[0]["dur"]
        self.units = units  # batches or steps profiled
        self.window_s = (hi - lo) * 1e-6
        dev = [e for e in events if e.get("cat") in DEVICE_CATS
               and "dur" in e and e["ts"] < hi and e["ts"] + e["dur"] > lo]
        self.kernel_s: Dict[str, float] = defaultdict(float)
        for e in dev:
            if e["cat"] == "kernel":
                self.kernel_s[e["name"]] += e["dur"] * 1e-6
        busy, gaps = union([(e["ts"], e["ts"] + e["dur"]) for e in dev],
                           lo, hi)
        self.busy_s = busy * 1e-6
        self.launches = sum(1 for e in events
                            if e.get("cat") in ("cuda_runtime", "cuda_driver")
                            and e.get("name") in LAUNCH_CALLS
                            and lo <= e["ts"] <= hi)
        self.device_ops = sorted(
            ((k, v) for k, v in self.kernel_s.items()), key=lambda x: -x[1])
        host = [e for e in events if e.get("cat") in HOST_CATS
                and "dur" in e and e.get("name") != WINDOW]
        self.idle_gaps = _name_gaps(gaps, host)

    def kernel_time(self, patterns: Sequence[str]) -> float:
        """Device seconds of the kernels whose names hold a pattern."""
        return sum(v for k, v in self.kernel_s.items()
                   if any(p in k for p in patterns))

    def breakdown(self, top: int = 10) -> dict:
        return {"device_ops": [[k[:160], v] for k, v in
                               self.device_ops[:top]],
                "idle_gaps": [[k[:160], v] for k, v in
                              self.idle_gaps[:top]]}


def roofline_share(run, bound_s: float, kernels: Sequence[str]):
    """100 x ``bound_s``, the bound of a function's work in the profiled
    window, over the device time of its ``kernels``; None where either is
    missing."""
    prof = run.get("profile")
    if prof is None:
        return None
    busy = prof.kernel_time(kernels)
    if busy <= 0 or bound_s <= 0:
        return None
    return 100.0 * bound_s / busy


def _name_gaps(gaps: List[Interval], host: List[dict]
               ) -> List[Tuple[str, float]]:
    """Idle seconds by the host op running at each gap's midpoint (the
    innermost, i.e. shortest, op that covers it), largest first: a sweep
    over the midpoints with the ops started so far in a heap by length,
    those already ended dropped as they surface."""
    host = sorted(host, key=lambda e: e["ts"])
    out: Dict[str, float] = defaultdict(float)
    active: List[Tuple[float, float, str]] = []
    at = 0
    for a, b in sorted(gaps, key=lambda g: g[0] + g[1]):
        mid = 0.5 * (a + b)
        while at < len(host) and host[at]["ts"] <= mid:
            e = host[at]
            heapq.heappush(active, (e["dur"], e["ts"] + e["dur"], e["name"]))
            at += 1
        while active and active[0][1] < mid:
            heapq.heappop(active)
        out[active[0][2] if active else "(host between ops)"] += (b - a) * 1e-6
    return sorted(out.items(), key=lambda x: -x[1])


def profile(fn: Callable[[], None], units: int, sync: Callable[[], None]
            ) -> Profile:
    """Run ``fn`` (one batch or step) ``units`` times under the profiler,
    inside the window span that ends in ``sync()``."""
    from torch.profiler import ProfilerActivity, profile as tprofile
    from torch.profiler import record_function

    sync()
    with tprofile(activities=[ProfilerActivity.CPU,
                              ProfilerActivity.CUDA]) as prof:
        with record_function(WINDOW):
            for _ in range(units):
                fn()
            sync()
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.remove(path)
    return Profile(events, units)
