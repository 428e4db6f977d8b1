"""Host milliseconds a joint step in the profiled window inside the port's
spans ``rg.train.d.optimizer`` and ``rg.train.g.optimizer``: both
optimizers' steps (the gradients' global norm and clip, then Adam, leaf by
leaf), as ``robust_e2e_gan_torch/utils/trace.py::SPAN_HOST`` tallies them
while a profiler records."""

from asr_bench.program_spans import per_unit


def read(run):
    if run["kind"] != "train":
        return None
    s = per_unit(run, ("rg.train.d.optimizer", "rg.train.g.optimizer"))
    return None if s is None else s * 1e3
