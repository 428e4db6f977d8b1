"""What every driver of the benchmark shares: the files a cell is made of,
the per-layer metric readers found by name, the import guard, the device
facts, and the result line.

A cell is one entry of ``BENCHMARK.json``'s ``workloads``: a configuration
file (``configs/<config>.json``), a traffic file (``traffic/<traffic>.json``,
whose ``kind`` picks ``drivers/<kind>.py``) and the limits of its
comparison with the reference (``limits/<cell>.json``). A per-layer metric
is ``metrics/<name>.py`` with a ``read(run)`` function. Adding a cell, a
traffic mix, a driver kind or a metric is adding files and entries.
"""

from __future__ import annotations

import importlib.util
import json
import math
import os
import statistics
import subprocess
import sys
from typing import Dict, Iterable, List, Optional, Sequence

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
# top-level module names that may not be loaded: the JAX stack and the JAX
# package the port was made from
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "robust_e2e_gan_tpu")


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark(root: str = ROOT) -> dict:
    return load_json(os.path.join(root, "BENCHMARK.json"))


def workload(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise SystemExit(f"no workload {name!r} in BENCHMARK.json")


def config_file(bench: dict, name: str, root: str = ROOT) -> dict:
    for c in bench["configs"]:
        if c["name"] == name:
            return load_json(os.path.join(root, c["file"]))
    raise SystemExit(f"no configuration {name!r} in BENCHMARK.json")


def traffic_file(name: str) -> dict:
    return load_json(os.path.join(HERE, "traffic", f"{name}.json"))


def limits_file(cell: str) -> dict:
    return load_json(os.path.join(HERE, "limits", f"{cell}.json"))


def load_module(path: str, name: str):
    """A module from a file path (metric files have dots in their names)."""
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def driver(kind: str):
    return load_module(os.path.join(HERE, "drivers", f"{kind}.py"),
                       f"asr_bench_driver_{kind}")


def metric_reader(name: str, metrics_dir: Optional[str] = None):
    """``read(run)`` of ``metrics/<name>.py``."""
    path = os.path.join(metrics_dir or os.path.join(HERE, "metrics"),
                        f"{name}.py")
    return load_module(path, "asr_bench_metric_" + name.replace(".", "_")).read


def per_layer_metrics(bench: dict, cell: str) -> List[dict]:
    """The per-layer metrics this cell reports: those that list it, and
    those without a list that move an end-to-end metric the cell has."""
    e2e = {m["name"] for m in end_to_end_metrics(bench, cell)}
    out = []
    for m in bench["per_layer"]:
        if "workloads" in m:
            if cell in m["workloads"]:
                out.append(m)
        elif m["moves"] in e2e:
            out.append(m)
    return out


def end_to_end_metrics(bench: dict, cell: str) -> List[dict]:
    return [m for m in bench["end_to_end"]
            if "workloads" not in m or cell in m["workloads"]]


def read_metrics(specs: Iterable[dict], run, metrics_dir=None) -> dict:
    """Each metric's reader over ``run``; a reader that finds nothing to
    read returns None and the metric is left out of the line."""
    out = {}
    for m in specs:
        value = metric_reader(m["name"], metrics_dir)(run)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def forbidden_modules(modules: Iterable[str] = None) -> List[str]:
    """Loaded modules whose top-level name (before the first dot) is one of
    ``FORBIDDEN``, compared whole."""
    names = sys.modules if modules is None else modules
    return sorted({n for n in names if n.split(".", 1)[0] in FORBIDDEN})


def percentile(values: Sequence[float], q: float) -> float:
    """The nearest-rank ``q`` percentile of all values."""
    xs = sorted(values)
    if not xs:
        raise ValueError("no values")
    k = max(1, math.ceil(q / 100.0 * len(xs)))
    return xs[k - 1]


def quartiles(xs):
    """Quartiles and extremes of a run's batch or step times, for the
    notes."""
    if len(xs) < 4:
        return None
    q = statistics.quantiles(xs, n=4)
    return [min(xs), q[0], q[1], q[2], max(xs)]


def gpu_facts() -> str:
    """The card's name, power limit, clocks and power draw, as
    ``nvidia-smi`` reads them (empty where it cannot)."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit,power.draw,"
             "clocks.sm,clocks.max.sm,temperature.gpu",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20)
        return out.stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return ""


def limited(numbers: Dict[str, float], limits: Dict[str, float]
            ) -> Dict[str, tuple]:
    """(number, limit) of each number the cell's limits file names; one it
    names that the run did not read counts as failed."""
    return {k: (numbers.get(k, float("nan")), lim)
            for k, lim in limits.items()}


def check_line(checks: Dict[str, tuple]) -> dict:
    """``{name: {"value": v, "limit": l}}`` of the numbers compared."""
    return {k: {"value": v, "limit": lim} for k, (v, lim) in checks.items()}


def within(checks: Dict[str, tuple]) -> bool:
    """Every number at or under its limit (a NaN is not)."""
    return all(v <= lim for v, lim in checks.values())


def environment(root: str = ROOT) -> None:
    """The process's settings, before torch is imported: kernel caches
    inside the checkout at fixed paths (the port builds into
    ``robust_e2e_gan_torch/_build``; Triton and extension builds, were
    anything to use them, land under ``.bench_cache``), and one host thread
    for PyTorch's and OpenMP's CPU work, so that the thread that launches
    the kernels does not compete with spinning workers on a shared host."""
    os.environ["OMP_NUM_THREADS"] = "1"
    os.environ["MKL_NUM_THREADS"] = "1"
    base = os.path.join(root, ".bench_cache")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(base, "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(base,
                                                      "torch_extensions")
    os.environ["USE_FLAX"] = "0"
