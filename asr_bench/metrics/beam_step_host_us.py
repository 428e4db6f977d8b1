"""Host microseconds a beam step in the profiled window: the port's span
``rg.beam.step`` (one iteration of the search loop, from its decoder step
to the CTC state and the carries' permutation), its host time over its
entries, as ``robust_e2e_gan_torch/utils/trace.py::SPAN_HOST`` tallies the
spans while a profiler records."""

from asr_bench.program_spans import per_entry


def read(run):
    if run["kind"] != "decode" or run.get("profile") is None:
        return None
    s = per_entry("rg.beam.step")
    return None if s is None else s * 1e6
