"""The port's spans and its export of the kernel counters
(``utils/trace.py``), on the CPU at tiny widths: with no profiler a span is
one shared no-op that enters no ``record_function`` and no span ever
synchronises; under a CPU ``torch.profiler.profile`` a plain decode and a
joint step emit the spans of the module's table, each inside its parent,
one ``rg.beam.step`` a step; ``counters()`` holds every route tally,
``.launches`` and ``.calls`` that ``ops/*`` has, and ``since()`` what
moved."""

import importlib
import pkgutil

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from robust_e2e_gan_torch import configs, ops
from robust_e2e_gan_torch.config import BeamSearchConfig, TrainConfig
from robust_e2e_gan_torch.data.synthetic import SyntheticConfig, make_batch
from robust_e2e_gan_torch.decode.beam import make_beam_searcher
from robust_e2e_gan_torch.ops import att, blstm
from robust_e2e_gan_torch.tools import dp_phases, verify_drive
from robust_e2e_gan_torch.train import loop, steps
from robust_e2e_gan_torch.utils import trace

STEPS = 3
# each span's parent: the innermost rg.* span around it (the encoder's
# halves run in the decode's encode and in the G-step's forward)
PARENTS = {
    "rg.search": {None},
    "rg.encode": {"rg.search"},
    "rg.encode.frontend": {"rg.encode"},
    "rg.encode.enhancer": {"rg.encode"},
    "rg.encode.vgg": {"rg.encode", "rg.train.g.forward"},
    "rg.encode.blstmp": {"rg.encode", "rg.train.g.forward"},
    "rg.encode.heads": {"rg.encode"},
    "rg.beam": {"rg.search"},
    "rg.beam.step": {"rg.beam"},
    "rg.beam.step.decoder": {"rg.beam.step"},
    "rg.beam.step.psi": {"rg.beam.step"},
    "rg.beam.step.prune": {"rg.beam.step"},
    "rg.beam.step.state": {"rg.beam.step"},
    "rg.train.step": {None},
    "rg.train.d.forward": {"rg.train.step"},
    "rg.train.d.disc": {"rg.train.step"},
    "rg.train.d.optimizer": {"rg.train.step"},
    "rg.train.g.forward": {"rg.train.step"},
    "rg.train.g.backward": {"rg.train.step"},
    "rg.train.g.optimizer": {"rg.train.step"},
}


class _Counting:
    """Stands in for ``record_function`` and counts its instances."""

    made = 0

    def __init__(self, *args):
        type(self).made += 1

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


def test_span_off_is_one_shared_noop(monkeypatch):
    syncs = []
    monkeypatch.setattr(torch.profiler, "record_function", _Counting)
    monkeypatch.setattr(torch.cuda, "synchronize",
                        lambda *a: syncs.append(a))
    _Counting.made = 0
    assert not trace._recording()
    a, b = trace.span("rg.beam"), trace.span("rg.search", 4)
    assert a is b is trace._OFF
    with a, b:
        pass
    fn = trace.traced("rg.op.toy")(lambda x: x + 1)
    assert fn(1) == 2
    assert _Counting.made == 0 and not syncs
    # on, the same calls enter a range each and still never synchronise
    with profile(activities=[ProfilerActivity.CPU]):
        with trace.span("rg.beam"):
            assert fn(1) == 2
    assert _Counting.made == 2 and not syncs


def _innermost_parent(e, spans):
    """The shortest other rg.* span on ``e``'s thread that encloses it."""
    outer = [s for s in spans if s is not e and s.thread == e.thread
             and s.time_range.start <= e.time_range.start
             and e.time_range.end <= s.time_range.end]
    if not outer:
        return None
    return min(outer, key=lambda s: s.time_range.elapsed_us()).name


def test_decode_and_joint_step_emit_nested_spans():
    jcfg = configs.tiny_config(12)
    state = loop.init_state(jcfg, TrainConfig(optimizer="adam"), "cpu")
    data = make_batch(2, SyntheticConfig(vocab_size=12, min_tokens=2,
                                         max_tokens=3),
                      np.random.default_rng(0))
    data = {k: torch.from_numpy(v) for k, v in data.items()}
    search = make_beam_searcher(state.model.eval(), jcfg.e2e,
                                BeamSearchConfig(beam_size=2,
                                                 max_steps=STEPS))
    step = steps.make_joint_train_step(jcfg)
    before = {k: list(v) for k, v in trace.SPAN_HOST.items()}
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        search(data["noisy_wav"], data["wav_lengths"])
        state.model.train()
        step(state, data)
    spans = [e for e in prof.events() if e.name.startswith("rg.")]
    names = [e.name for e in spans]
    assert set(PARENTS) <= set(names)
    assert names.count("rg.beam.step") == STEPS
    assert names.count("rg.search") == names.count("rg.train.step") == 1
    for e in spans:
        parent = _innermost_parent(e, spans)
        if e.name in PARENTS:
            assert parent in PARENTS[e.name], (e.name, parent)
        else:  # a wrapper or a launch: inside some span of the program
            assert e.name.startswith(("rg.op.", "rg.launch")), e.name
            assert parent is not None, e.name
    # the host tally saw the same entries
    for name in PARENTS:
        got = trace.SPAN_HOST[name][0] - before.get(name, [0])[0]
        assert got == names.count(name), name


def _ops_counters():
    """(label, owner, key) of every counter ``ops/*`` defines: the route
    tallies (dicts of ints, nested once for the prefix kernels), the
    wrappers' ``.launches`` and the plain versions' ``.calls``."""
    found = []
    for info in pkgutil.iter_modules(ops.__path__):
        mod = importlib.import_module(f"{ops.__name__}.{info.name}")
        for name, obj in vars(mod).items():
            label = f"{info.name}.{name}"
            if name.endswith("ROUTE_LAUNCHES") and isinstance(obj, dict):
                for key, v in obj.items():
                    if isinstance(v, dict):
                        found += [(f"{label}.{key}.{r}", v, r) for r in v]
                    else:
                        found.append((f"{label}.{key}", obj, key))
            elif callable(obj) and getattr(obj, "__module__",
                                           None) == mod.__name__:
                for attr in ("launches", "calls"):
                    if isinstance(getattr(obj, attr, None), int):
                        found.append((f"{label}.{attr}", obj, attr))
    return found


def _bump(owner, key, by):
    if isinstance(owner, dict):
        owner[key] += by
    else:
        setattr(owner, key, getattr(owner, key) + by)


@pytest.mark.parametrize("label,owner,key", _ops_counters(),
                         ids=[c[0] for c in _ops_counters()])
def test_counters_hold_every_ops_counter(label, owner, key):
    before = trace.counters()
    _bump(owner, key, 3)
    try:
        moved = trace.since(before)
    finally:
        _bump(owner, key, -3)
    assert list(moved.values()) == [3], (label, moved)


def test_since_keeps_what_moved_and_the_tools_read_it():
    before = trace.counters()
    drive, dp = verify_drive.route_launches(), dp_phases.counters()
    blstm.INFER_ROUTE_LAUNCHES["cluster"] += 2
    att.att_loc_step.launches += 1
    att.att_loc_step_plain.calls += 4
    try:
        assert trace.since(before) == {"route.blstm_infer.cluster": 2,
                                       "launch.att_loc_step": 1,
                                       "plain.att_loc_step": 4}
        assert trace.since() == {k: v for k, v in trace.counters().items()
                                 if v}
        drive_now, dp_now = verify_drive.route_launches(), dp_phases.counters()
        assert {k: v - drive[k] for k, v in drive_now.items()
                if v != drive[k]} == {"blstm_infer/cluster": 2}
        assert {k: v - dp[k] for k, v in dp_now.items() if v != dp[k]} == {
            "blstm_infer_cluster": 2, "att_loc_step": 1,
            "att_loc_step_plain": 4, "att_plain": 4}
    finally:
        blstm.INFER_ROUTE_LAUNCHES["cluster"] -= 2
        att.att_loc_step.launches -= 1
        att.att_loc_step_plain.calls -= 4
