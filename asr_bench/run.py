"""Run one cell of the benchmark of ``robust_e2e_gan_torch`` on this
machine's card and print its result as the last line of standard output.

    python asr_bench/run.py --workload <cell> --seed <n> --seconds <s>
        --trace <0|1>

``--trace 0`` reports the cell's end-to-end metrics, ``--trace 1`` its
per-layer metrics (spans around each call into a layer, a profiled window
after the timed one). Set-up runs from the start of this process to the
first timed batch or step. Every run ends with the comparison of what the
timed path produced with the plain reference; the numbers compared are the
last lines of standard error and the last key of the result line. Without
a CUDA card, or with fewer than the cell asks for, it prints no result
and exits 2; if a module of JAX or the JAX package was loaded, 3.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


class Ctx:
    """What a driver is handed for one run."""

    def __init__(self, **kw):
        self.__dict__.update(kw)
        self.setup_s = None
        self.marks = {}

    def mark(self, name: str):
        """Seconds from the start to a point of set-up, for the notes."""
        self.marks[name] = time.perf_counter() - self.t_start

    def setup_done(self):
        self.setup_s = time.perf_counter() - self.t_start

    def routes(self, before=None):
        from asr_bench import routes
        return routes.since(before) if before is not None else routes.read()


def run_cell(cell: str, seed: int, seconds: float, trace: bool, device,
             cfg=None, traffic=None, limits=None, program=None,
             t_start=None):
    """(result line, notes for standard output, lines for standard error)
    of one run. The keyword arguments stand in for the cell's files and
    the program (tests)."""
    import torch

    from asr_bench import core

    bench = core.benchmark()
    w = core.workload(bench, cell)
    cfg = cfg or core.config_file(bench, w["config"])
    traffic = traffic or core.traffic_file(w["traffic"])
    drv = core.driver(traffic["kind"])
    ctx = Ctx(cfg=cfg, traffic=traffic, seed=seed, seconds=seconds,
              trace=trace, device=device,
              limits=limits or core.limits_file(cell),
              program=program or drv.program,
              t_start=T_START if t_start is None else t_start)
    out = drv.run(ctx)

    on_cuda = device.type == "cuda"
    dev_line = {"platform": "gpu" if on_cuda else device.type,
                "kind": torch.cuda.get_device_name(device) if on_cuda
                else "cpu",
                "count": w["chips"],
                "memory_peak_bytes": int(out["memory_peak_bytes"])}
    result = {"correct": core.within(out["checks"]),
              "attempted": out["attempted"], "failed": out["failed"]}
    if trace:
        layer = dict(out["layer"], cfg=cfg, traffic=traffic)
        result["metrics"] = core.read_metrics(
            core.per_layer_metrics(bench, cell), layer)
        prof = out["layer"]["profile"]
        if prof is not None:
            dev_line.update(busy_s=prof.busy_s, window_s=prof.window_s)
            result["breakdown"] = prof.breakdown()
    else:
        values = dict(out["e2e"], setup_s=ctx.setup_s)
        result["metrics"] = {
            m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
            for m in core.end_to_end_metrics(bench, cell)
            if m["name"] in values}
    result["device"] = dev_line
    result["checks"] = core.check_line(out["checks"])
    notes = [f"routes {json.dumps(out['routes'], sort_keys=True)}",
             f"setup_s {ctx.setup_s} memory_peak_bytes "
             f"{out['memory_peak_bytes']} iterations "
             f"{out.get('iterations', '-')}",
             f"setup marks {json.dumps(ctx.marks)}",
             f"ms a batch or step: min, quartiles, max "
             f"{out.get('spread')}",
             f"read, not compared {json.dumps(out.get('uncompared', {}))}"]
    err = [f"check {k} {v} limit {lim}"
           for k, (v, lim) in out["checks"].items()]
    return result, notes, err


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from asr_bench import core

    core.environment(ROOT)
    import torch

    chips = core.workload(core.benchmark(ROOT), args.workload)["chips"]
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have < chips:
        print(f"no result: {args.workload} needs {chips} CUDA card(s), "
              f"this machine has {have}", file=sys.stderr)
        return 2
    result, notes, err = run_cell(args.workload, args.seed, args.seconds,
                                  bool(args.trace), torch.device("cuda", 0))
    bad = core.forbidden_modules()
    if bad:
        print(f"no result: modules of JAX or the JAX package were loaded: "
              f"{bad}", file=sys.stderr)
        return 3
    for line in notes:
        print(line)
    print(f"card {core.gpu_facts()}")
    for line in err:
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
