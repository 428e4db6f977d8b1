"""95th percentile (nearest rank) of every batch's span in the traced
window, from the copy of the waveforms to the device to the tokens on the
host: the searcher entry's latency."""

from asr_bench.core import percentile


def read(run):
    if run["kind"] != "decode" or not run["batch_ms"]:
        return None
    return percentile(run["batch_ms"], 95)
