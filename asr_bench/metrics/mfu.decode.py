"""The model FLOPs of the batches the traced window finished (``flops.
decode_batch_flops``) over the window's seconds, as a share of the card's
bfloat16 peak."""

from asr_bench.flops import PEAK_FLOPS


def read(run):
    if run["kind"] != "decode" or not run["model_flops"]:
        return None
    return 100.0 * run["model_flops"] / (run["window_s"]
                                         * PEAK_FLOPS["bfloat16"])
