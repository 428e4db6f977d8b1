"""A cell's profiled window by the port's ``rg.*`` spans, and what the
spans cost.

    python3 asr_bench/span_report.py --workload <cell> --seed <n>
        [--units 3] [--rounds 4] [--out spans.json]

Sets the cell's program up as its driver does (weights and batches from
the seed, the warm batches or steps), then profiles ``--units`` batches or
steps ``--rounds`` times with the spans on and as often with them off
(``utils/trace.py``'s profiler test patched to false, so every span and
wrapper takes its no-op path under the same profiler), in turns (on, off,
off, on, ...; one window of each first, unread, to warm). Prints, and
with ``--out`` writes as JSON: the first read on-window reduced by span
(``spans.reduce``: count, device, host, self host, launches and idle a
unit, the top kernels launched with the span innermost, the runtime calls'
host time by name with the span innermost), the idle gaps by span and by
the host op at their midpoint, the coverage of the window by the spans,
the profiled window's wall a unit on and off, and the host cost of a span
and of a traced wrapper with no profiler. Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

TOP = 8
NAME = 160  # characters of a kernel's name kept


def profile_events(fn, units: int, sync):
    """(Chrome trace events, window wall seconds) of ``units`` calls of
    ``fn`` under the profiler, inside the benchmark's window span."""
    from torch.profiler import ProfilerActivity, profile, record_function

    from asr_bench import trace

    sync()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        with record_function(trace.WINDOW):
            for _ in range(units):
                fn()
            sync()
        wall = time.perf_counter() - t0
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            return json.load(f)["traceEvents"], wall
    finally:
        os.remove(path)


def setup(cell: str, seed: int, dev):
    """(one batch or step, sync, kind) of the cell's program, warm."""
    import torch

    from asr_bench import core, weights

    bench = core.benchmark()
    w = core.workload(bench, cell)
    cfg = core.config_file(bench, w["config"])
    traffic = core.traffic_file(w["traffic"])
    drv = core.driver(traffic["kind"])
    sync = torch.cuda.synchronize
    if traffic["kind"] == "decode":
        lm_cfg = drv.lm_fields(traffic)
        vocab = cfg["e2e"]["decoder"]["vocab_size"]
        wg = weights.make(weights.generator_layout(cfg), seed, dev)
        lm_w = (weights.make(weights.lm_layout(lm_cfg, vocab), seed, dev,
                             "lm") if lm_cfg else None)
        _, searcher, _ = drv.program(cfg, traffic, wg, lm_w, dev)
        host = [(x.pin_memory(), n.pin_memory())
                for x, n in drv.pool(cfg, traffic, seed)]
        at = [0]

        def one():
            x, n = host[at[0] % len(host)]
            at[0] += 1
            res = searcher(x.to(dev, non_blocking=True),
                           n.to(dev, non_blocking=True))
            res.tokens.cpu(), res.lengths.cpu(), res.scores.cpu()

        warm = traffic["warmup_batches"]
    else:
        wg = weights.make(weights.generator_layout(cfg), seed, dev)
        wd = weights.make(weights.discriminator_layout(cfg), seed, dev,
                          "discriminator")
        state, step = drv.program(cfg, traffic, wg, wd, dev)
        host = [{k: v.pin_memory() for k, v in h.items()}
                for h in drv.pool(cfg, traffic, seed)]
        at = [0]

        def one():
            data = {k: v.to(dev, non_blocking=True)
                    for k, v in host[at[0] % len(host)].items()}
            at[0] += 1
            step(state, data)

        warm = traffic["checked_steps"] + traffic["warmup_steps"]
    for _ in range(warm):
        one()
    sync()
    return one, sync, traffic["kind"]


def noop_cost(n: int = 200_000) -> dict:
    """Host microseconds, with no profiler, of a span entered and left
    (over an empty function's call) and of a traced wrapper's call (over
    the bare function's): the best of 5 loops of ``n``."""
    from robust_e2e_gan_torch.utils.trace import span, traced

    def empty(x):
        return x

    def with_span(x):
        with span("rg.cost"):
            return x

    wrapped = traced("rg.op.cost")(empty)
    took = {}
    for name, fn in (("empty", empty), ("span", with_span),
                     ("traced", wrapped)):
        best = float("inf")
        for _ in range(5):
            t0 = time.perf_counter()
            for _ in range(n):
                fn(1)
            best = min(best, (time.perf_counter() - t0) / n * 1e6)
        took[name] = best
    return {"call_us": took["empty"],
            "span_us": took["span"] - took["empty"],
            "wrapper_us": took["traced"] - took["empty"]}


def _innermost_rows(spans_in, points, names):
    """{(innermost span or OUTSIDE, name): seconds} of (time, index) points
    whose ``names[index]`` and weight (seconds) are given by ``names``."""
    from collections import defaultdict

    from asr_bench import spans

    out = defaultdict(float)
    for i, active in spans.sweep(spans_in, points):
        inner = spans.innermost(active, names[i][2])
        key = (spans.OUTSIDE if inner is None else inner["name"],
               names[i][0])
        out[key] += names[i][1]
    return out


def cross(events, lo, hi, gaps, units: int) -> dict:
    """The idle gaps by (innermost rg span, host op at the midpoint), and
    the runtime calls' host time by (innermost rg span on the calling
    thread, call name and the innermost host op around it): the top rows,
    ms a unit."""
    from asr_bench import spans, trace

    rg = [e for e in events if e.get("cat") == "user_annotation"
          and str(e.get("name", "")).startswith(spans.PREFIX)
          and "dur" in e and lo <= e["ts"] <= hi]
    host = [e for e in events if e.get("cat") in trace.HOST_CATS
            and "dur" in e and e.get("name") != trace.WINDOW
            and not str(e.get("name", "")).startswith(spans.PREFIX)]
    mids = [(0.5 * (a + b), i) for i, (a, b) in enumerate(gaps)]
    ops = {}
    for i, active in spans.sweep(host, mids):
        inner = spans.innermost(active)
        ops[i] = "(host between ops)" if inner is None else inner["name"]
    gap_rows = _innermost_rows(rg, mids, [
        (ops[i], (b - a) * 1e-6, None) for i, (a, b) in enumerate(gaps)])
    calls = [e for e in events if e.get("cat") in spans.CALL_CATS
             and "dur" in e and lo <= e["ts"] <= hi]
    at = [(e["ts"], i) for i, e in enumerate(calls)]
    around = {}
    for i, active in spans.sweep([e for e in host if e.get("cat")
                                   not in spans.CALL_CATS], at):
        inner = spans.innermost(active, calls[i].get("tid"))
        around[i] = "-" if inner is None else inner["name"]
    call_rows = _innermost_rows(rg, at, [
        (f"{e['name']} in {around[i]}", e["dur"] * 1e-6, e.get("tid"))
        for i, e in enumerate(calls)])

    def top(rows, n=24):
        return [[s, k, v / units * 1e3] for (s, k), v in
                sorted(rows.items(), key=lambda x: -x[1])[:n]]

    return {"idle_by_span_and_op": top(gap_rows),
            "calls_by_span": top(call_rows)}


def report(events, units: int, kind: str) -> dict:
    from asr_bench import spans, trace

    prof = trace.Profile(events, units)
    lo, hi = spans.window(events, trace.WINDOW)
    dev = [(e["ts"], e["ts"] + e["dur"]) for e in events
           if e.get("cat") in trace.DEVICE_CATS and "dur" in e]
    _, gaps = trace.union(dev, lo, hi)
    rows = spans.reduce(events, lo, hi, gaps)
    table = {}
    for name, r in sorted(rows.items()):
        kers = sorted(r["kernels"].items(), key=lambda x: -x[1])
        table[name] = {
            "count": r["count"] / units,
            "device_ms": r["device_s"] / units * 1e3,
            "self_device_ms": r["self_device_s"] / units * 1e3,
            "host_ms": r["host_s"] / units * 1e3,
            "self_ms": r["self_s"] / units * 1e3,
            "launches": r["launches"] / units,
            "idle_ms": r["idle_s"] / units * 1e3,
            "top_kernels": [[k[:NAME], v / units * 1e3]
                            for k, v in kers[:TOP]]}
    kernel_s = sum(prof.kernel_s.values())
    if kind == "decode":
        search = rows.get("rg.search", {})
        cover = {"kernel_share_in_rg.search":
                 search.get("kernel_s", 0.0) / kernel_s if kernel_s else None,
                 "beam_steps_a_batch":
                 rows.get("rg.beam.step", {}).get("count", 0) / units}
    else:
        step = rows.get("rg.train.step", {}).get("host_s", 0.0)
        six = sum(rows.get(f"rg.train.{n}", {}).get("host_s", 0.0)
                  for n in ("d.forward", "d.disc", "d.optimizer",
                            "g.forward", "g.backward", "g.optimizer"))
        cover = {"host_share_of_step_in_six": six / step if step else None}
    return {"window_ms_a_unit": prof.window_s / units * 1e3,
            "busy_ms_a_unit": prof.busy_s / units * 1e3,
            "launches_a_unit": prof.launches / units,
            "idle_gaps_ms": [[k, v / units * 1e3]
                             for k, v in prof.idle_gaps[:12]],
            "coverage": cover,
            "spans_a_unit": sum(r["count"] for r in rows.values()) / units,
            **cross(events, lo, hi, gaps, units),
            "by_span": table}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--units", type=int, default=3)
    ap.add_argument("--rounds", type=int, default=4)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    from asr_bench import core

    core.environment(ROOT)
    import torch

    if not torch.cuda.is_available():
        print("no result: span_report needs a CUDA card", file=sys.stderr)
        return 2
    from robust_e2e_gan_torch.utils import trace as port_trace

    dev = torch.device("cuda", 0)
    one, sync, kind = setup(args.workload, args.seed, dev)
    recording = port_trace._recording
    walls = {"on": [], "off": []}
    first = None
    order = ["on", "off"] + [m for r in range(args.rounds)
                             for m in (("on", "off") if r % 2 == 0
                                       else ("off", "on"))]
    try:
        for i, mode in enumerate(order):
            port_trace._recording = (recording if mode == "on"
                                     else (lambda: False))
            events, wall = profile_events(one, args.units, sync)
            if i < 2:  # the warming pair
                continue
            walls[mode].append(wall / args.units * 1e3)
            if mode == "on" and first is None:
                first = events
    finally:
        port_trace._recording = recording
    out = report(first, args.units, kind)
    out.update(workload=args.workload, seed=args.seed, units=args.units,
               wall_ms_a_unit={k: v for k, v in walls.items()},
               wall_median_ms={k: statistics.median(v)
                               for k, v in walls.items()},
               noop=noop_cost(), card=core.gpu_facts(),
               torch=torch.__version__)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    print(json.dumps({k: v for k, v in out.items()
                      if k not in ("by_span", "idle_by_span_and_op",
                                   "calls_by_span")}))
    for key in ("idle_by_span_and_op", "calls_by_span"):
        for span_name, name, ms in out[key]:
            print(f"{key} {span_name:24s} {ms:8.3f} {name[:60]}")
    for name, r in out["by_span"].items():
        print(f"{name:28s} n {r['count']:7.1f} dev {r['device_ms']:8.2f} "
              f"selfdev {r['self_device_ms']:8.2f} host {r['host_ms']:8.2f} "
              f"self {r['self_ms']:8.2f} launches {r['launches']:7.0f} "
              f"idle {r['idle_ms']:7.2f}")
        for k, ms in r["top_kernels"]:
            print(f"    {ms:8.3f} {k[:120]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
