"""Host milliseconds a joint step in the profiled window inside the port's
span ``rg.train.g.backward``: the G-step's gradients (``autograd.grad``,
whose backward the autograd engine's thread dispatches while this one
waits), as ``robust_e2e_gan_torch/utils/trace.py::SPAN_HOST`` tallies it
while a profiler records."""

from asr_bench.program_spans import per_unit


def read(run):
    if run["kind"] != "train":
        return None
    s = per_unit(run, ("rg.train.g.backward",))
    return None if s is None else s * 1e3
