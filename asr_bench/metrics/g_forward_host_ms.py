"""Host milliseconds a joint step in the profiled window inside the port's
span ``rg.train.g.forward``: the G-step's forward (the generator, the
discriminator on its output and the losses), as ``robust_e2e_gan_torch/
utils/trace.py::SPAN_HOST`` tallies it while a profiler records."""

from asr_bench.program_spans import per_unit


def read(run):
    if run["kind"] != "train":
        return None
    s = per_unit(run, ("rg.train.g.forward",))
    return None if s is None else s * 1e3
