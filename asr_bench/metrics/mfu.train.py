"""The model FLOPs of the joint steps the traced window finished
(``flops.train_step_flops``) over the window's seconds, as a share of the
card's bfloat16 peak."""

from asr_bench.flops import PEAK_FLOPS


def read(run):
    if run["kind"] != "train" or not run["model_flops"]:
        return None
    return 100.0 * run["model_flops"] / (run["window_s"]
                                         * PEAK_FLOPS["bfloat16"])
