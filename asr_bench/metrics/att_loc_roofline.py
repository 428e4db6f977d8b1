"""The beam step's location attention's share of its roofline in the
profiled window: the bound of every step (``flops.att_loc_step``) over
the device time of its kernels, either route."""

from asr_bench import flops
from asr_bench.trace import roofline_share

KERNELS = ("att_utt_kernel", "att_loc_kernel")


def bound_s(lengths, cfg: dict, traffic: dict) -> float:
    """Seconds of the bound of one batch's beam steps."""
    hf = flops.enc_frames(flops.stft_frames(lengths,
                                            cfg["e2e"]["frontend"]))
    att, beam = cfg["e2e"]["attention"], traffic["beam"]
    return beam["max_steps"] * flops.bound_s(*flops.att_loc_step(
        hf, beam["beam_size"], att["conv_channels"], att["dim"],
        cfg["e2e"]["encoder"]["proj_dim"]), "bfloat16")


def read(run):
    if run["kind"] != "decode":
        return None
    return roofline_share(run, sum(bound_s(x, run["cfg"], run["traffic"])
                                   for x in run["profile_lengths"]), KERNELS)
