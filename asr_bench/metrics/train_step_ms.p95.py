"""95th percentile (nearest rank) of every joint step's span in the traced
window, each synchronised at its end."""

from asr_bench.core import percentile


def read(run):
    if run["kind"] != "train" or not run["step_ms"]:
        return None
    return percentile(run["step_ms"], 95)
