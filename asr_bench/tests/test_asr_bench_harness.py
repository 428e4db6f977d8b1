"""The harness on the CPU: the files each cell names, metric readers found
by name, the import guard, the look for a card, and whole tiny runs (with
that look skipped) through each driver, traced and not."""

import json
import os
import subprocess
import sys

import pytest

import bench_tiny
from asr_bench import core

ROOT = core.ROOT


def test_every_cell_has_its_files():
    bench = core.benchmark()
    for w in bench["workloads"]:
        core.config_file(bench, w["config"])
        traffic = core.traffic_file(w["traffic"])
        assert os.path.exists(os.path.join(core.HERE, "drivers",
                                           f"{traffic['kind']}.py"))
        limits = core.limits_file(w["name"])
        # an exact comparison (the served choice) has the limit 0
        assert limits and all(v >= 0 for v in limits.values())
        assert any(v > 0 for v in limits.values())
        # every cell reports set-up, another end-to-end metric and a
        # per-layer one
        e2e = {m["name"] for m in core.end_to_end_metrics(bench, w["name"])}
        assert "setup_s" in e2e and len(e2e) >= 2
        assert core.per_layer_metrics(bench, w["name"])
    for m in bench["per_layer"]:
        assert os.path.exists(os.path.join(core.HERE, "metrics",
                                           f"{m['name']}.py")), m["name"]


def test_a_metric_added_as_a_file_is_found(tmp_path):
    (tmp_path / "queue_depth.decode.py").write_text(
        "def read(run):\n"
        "    if run['kind'] != 'decode':\n"
        "        return None\n"
        "    return float(len(run['batch_ms']))\n")
    specs = [{"name": "queue_depth.decode", "unit": "batches"}]
    out = core.read_metrics(specs, {"kind": "decode", "batch_ms": [1, 2]},
                            metrics_dir=str(tmp_path))
    assert out == {"queue_depth.decode": {"value": 2.0, "unit": "batches"}}
    assert core.read_metrics(specs, {"kind": "train"},
                             metrics_dir=str(tmp_path)) == {}


def test_per_layer_metrics_follow_their_workloads():
    bench = {"end_to_end": [{"name": "a"}, {"name": "b",
                                            "workloads": ["x"]}],
             "per_layer": [{"name": "p", "moves": "a"},
                           {"name": "q", "moves": "b", "workloads": ["x"]},
                           {"name": "r", "moves": "b"}]}
    assert [m["name"] for m in core.per_layer_metrics(bench, "x")] == [
        "p", "q", "r"]
    assert [m["name"] for m in core.per_layer_metrics(bench, "y")] == ["p"]


def test_a_limit_without_its_number_fails():
    checks = core.limited({"a": 0.5, "b": 9.0}, {"a": 1.0})
    assert checks == {"a": (0.5, 1.0)} and core.within(checks)
    checks = core.limited({"a": 0.5}, {"a": 1.0, "c": 1.0})
    assert not core.within(checks)
    assert not core.within({"a": (float("nan"), 1.0)})


def test_forbidden_modules_compare_whole_top_level_names():
    names = ["jax", "jax.numpy", "jaxtyping", "jaxlib.xla_client",
             "flax.linen", "optaxx", "robust_e2e_gan_tpu.models",
             "robust_e2e_gan_torch.ops", "robust_e2e_gan_tpu_extra"]
    assert core.forbidden_modules(names) == [
        "flax.linen", "jax", "jax.numpy", "jaxlib.xla_client",
        "robust_e2e_gan_tpu.models"]


def test_the_reference_imports_nothing_of_the_program():
    code = ("import sys; sys.path.insert(0, %r)\n"
            "import asr_bench.reference.model, asr_bench.reference."
            "decode_check, asr_bench.reference.train_check, asr_bench.synth,"
            " asr_bench.weights, asr_bench.flops, asr_bench.trace\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('robust_e2e_gan_torch', 'robust_e2e_gan_tpu', 'jax', 'flax')]\n"
            "print(bad)\n" % ROOT)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_no_result_without_a_card():
    out = subprocess.run(
        [sys.executable, os.path.join(ROOT, "asr_bench", "run.py"),
         "--workload", "flagship.decode_enh", "--seed", str(2**31 + 5),
         "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=300, cwd=ROOT,
        env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert out.returncode == 2
    assert out.stdout.strip() == ""
    assert "no result" in out.stderr


@pytest.mark.parametrize("traffic,clean_lm", [
    ("flagship.decode_enh", False), ("flagship.decode_clean_lm", True)])
@pytest.mark.parametrize("trace", [False, True])
def test_a_tiny_decode_run_is_correct(traffic, clean_lm, trace):
    # the clean traffic (no enhancer, the fused frontend, an LM) runs under
    # the benchmark's decode cell
    result, notes, err = bench_tiny.run(
        "flagship.decode_enh", bench_tiny.decode_traffic(clean_lm),
        trace=trace)
    assert result["correct"], result["checks"]
    assert result["attempted"] > 0 and result["failed"] == 0
    assert list(result)[-1] == "checks"
    json.dumps(result)
    names = set(result["metrics"])
    if trace:
        assert {"decode_batch_ms.p95", "encode_ms", "search_ms",
                "mfu.decode"} <= names
    else:
        assert names == {"decode_utt_per_s", "setup_s"}
    assert len(err) == len(result["checks"])
    assert any(n.startswith("routes ") for n in notes)


@pytest.mark.parametrize("trace", [False, True])
def test_a_tiny_train_run_is_correct(trace):
    result, _, _ = bench_tiny.run("reference.train_joint",
                                  bench_tiny.train_traffic(), trace=trace)
    assert result["correct"], result["checks"]
    assert result["attempted"] > 0
    if trace:
        assert {"train_step_ms.p95", "mfu.train"} <= set(result["metrics"])
    else:
        assert set(result["metrics"]) == {"train_utt_per_s", "setup_s"}
