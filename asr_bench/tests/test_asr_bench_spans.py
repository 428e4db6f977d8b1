"""``spans.reduce`` on a hand-made trace (inclusive device time by the
launch's correlation, a launch on a second thread, launches, self time,
idle by innermost span), the existing ``trace.Profile`` fields unchanged
by the spans, the readers of the port's span tally, and ``span_report``'s
reduction of a window."""

import types

import pytest

from asr_bench import core, spans, trace

US = 1e-6


def _span(name, ts, dur, tid=1):
    return {"name": name, "cat": "user_annotation", "ts": ts, "dur": dur,
            "pid": 1, "tid": tid}


def _call(name, ts, corr, tid=1):
    return {"name": name, "cat": "cuda_runtime", "ts": ts, "dur": 2,
            "pid": 1, "tid": tid, "args": {"correlation": corr}}


def _dev(name, ts, dur, corr, cat="kernel"):
    return {"name": name, "cat": cat, "ts": ts, "dur": dur, "pid": 0,
            "tid": 7, "args": {"correlation": corr}}


def _events(with_spans=True):
    ev = [_span(trace.WINDOW, 0, 1000),
          _call("cudaLaunchKernel", 120, 1), _dev("k_enc", 130, 50, 1),
          _call("cudaMemcpyAsync", 405, 4),
          _dev("Memcpy HtoD", 406, 10, 4, "gpu_memcpy"),
          _call("cudaLaunchKernel", 450, 2), _dev("k_step", 460, 100, 2),
          # the autograd engine's thread, inside rg.beam's interval
          _call("cudaLaunchKernel", 700, 5, tid=2),
          _dev("k_bwd", 710, 30, 5),
          _call("cudaLaunchKernel", 950, 3), _dev("k_out", 955, 20, 3),
          {"name": "aten::add", "cat": "cpu_op", "ts": 440, "dur": 15,
           "pid": 1, "tid": 1}]
    if with_spans:
        ev += [_span("rg.search", 100, 800), _span("rg.encode", 110, 290),
               _span("rg.beam", 400, 490), _span("rg.beam.step", 410, 190)]
    return ev


def _reduce(events):
    lo, hi = spans.window(events, trace.WINDOW)
    dev = [(e["ts"], e["ts"] + e["dur"]) for e in events
           if e["cat"] in trace.DEVICE_CATS]
    _, gaps = trace.union(dev, lo, hi)
    return spans.reduce(events, lo, hi, gaps)


def test_reduce_by_span():
    got = _reduce(_events())
    want = {  # count, host, self, device, kernel, self device, launches,
        # idle (microseconds)
        "rg.search": (1, 800, 20, 190, 180, 0, 3, 0),
        "rg.encode": (1, 290, 290, 50, 50, 50, 1, 226),
        "rg.beam": (1, 490, 300, 140, 130, 40, 2, 365),
        "rg.beam.step": (1, 190, 190, 100, 100, 100, 1, 44),
    }
    for name, (n, host, own, dev, ker, self_dev, launches, idle) in \
            want.items():
        row = got[name]
        assert row["count"] == n and row["launches"] == launches, name
        for field, us in (("host_s", host), ("self_s", own),
                          ("device_s", dev), ("kernel_s", ker),
                          ("self_device_s", self_dev), ("idle_s", idle)):
            assert row[field] == pytest.approx(us * US), (name, field)
    assert got["rg.beam"]["kernels"] == pytest.approx({"k_bwd": 30 * US})
    assert got["rg.beam.step"]["kernels"] == pytest.approx(
        {"k_step": 100 * US})
    assert got[spans.OUTSIDE]["idle_s"] == pytest.approx(155 * US)
    # every idle gap lands in one row
    assert sum(r["idle_s"] for r in got.values()) == pytest.approx(
        (1000 - 50 - 10 - 100 - 30 - 20) * US)


def test_profile_fields_are_the_same_with_spans():
    plain = trace.Profile(_events(False), 2)
    marked = trace.Profile(_events(True), 2)
    for field in ("units", "window_s", "busy_s", "launches", "device_ops"):
        assert getattr(marked, field) == getattr(plain, field), field
    assert dict(marked.kernel_s) == dict(plain.kernel_s)
    assert sum(v for _, v in marked.idle_gaps) == pytest.approx(
        sum(v for _, v in plain.idle_gaps))
    assert spans.reduce(_events(False), 0, 1000, []) == {}


@pytest.fixture
def tally(monkeypatch):
    from robust_e2e_gan_torch.utils import trace as port_trace
    held = {}
    monkeypatch.setattr(port_trace, "SPAN_HOST", held)
    return held


@pytest.mark.parametrize("name,kind,spans_s,value", [
    ("beam_step_host_us", "decode", {"rg.beam.step": [96, 0.0192]}, 200.0),
    ("g_forward_host_ms", "train", {"rg.train.g.forward": [3, 0.09]}, 30.0),
    ("g_backward_host_ms", "train", {"rg.train.g.backward": [3, 0.15]},
     50.0),
    ("optimizer_host_ms", "train", {"rg.train.d.optimizer": [3, 0.03],
                                    "rg.train.g.optimizer": [3, 0.06]},
     30.0),
])
def test_span_metrics(tally, name, kind, spans_s, value):
    read = core.metric_reader(name)
    prof = types.SimpleNamespace(units=3)
    other = "train" if kind == "decode" else "decode"
    assert read({"kind": kind, "profile": prof}) is None  # nothing tallied
    tally.update(spans_s)
    assert read({"kind": kind, "profile": prof}) == pytest.approx(value)
    assert read({"kind": other, "profile": prof}) is None
    assert read({"kind": kind, "profile": None}) is None


def test_span_report_reads_a_window():
    from asr_bench import span_report
    out = span_report.report(_events(), 1, "decode")
    assert out["coverage"]["beam_steps_a_batch"] == 1
    # k_out (20 us) was launched outside rg.search
    assert out["coverage"]["kernel_share_in_rg.search"] == pytest.approx(
        180 / 200)
    assert out["by_span"]["rg.encode"]["device_ms"] == pytest.approx(0.05)
    gaps = {(s, op): ms for s, op, ms in out["idle_by_span_and_op"]}
    assert gaps[("rg.encode", "(host between ops)")] == pytest.approx(0.226)
    calls = {(s, c): ms for s, c, ms in out["calls_by_span"]}
    assert calls[("rg.beam", "cudaLaunchKernel in -")] == pytest.approx(
        0.002)
