"""The inference BLSTM layers' share of their roofline in the profiled
window: the bound of every layer (``flops.blstm_infer``: the enhancer's,
where the traffic runs it, and the encoder's) over the device time of
``blstm_infer``'s kernels, either route."""

from asr_bench import flops
from asr_bench.trace import roofline_share

KERNELS = ("blstm_infer_cluster_kernel", "blstm_infer_kernel")


def bound_s(lengths, cfg: dict, traffic: dict) -> float:
    """Seconds of the bound of one batch of waveforms of ``lengths``."""
    frames = flops.stft_frames(lengths, cfg["e2e"]["frontend"])
    total = 0.0
    if traffic["use_enhancer"]:
        ecfg = cfg["enhancer"]
        d = ecfg["input_dim"]
        for i in range(ecfg["num_layers"]):  # layer 0 reads float32 spectra
            total += flops.bound_s(*flops.blstm_infer(
                frames, d, ecfg["hidden_dim"], 4 if i == 0 else 2),
                "bfloat16")
            d = 2 * ecfg["hidden_dim"]
    enc = cfg["e2e"]["encoder"]
    hf = flops.enc_frames(frames)
    d = flops.vgg_out_dim(enc)
    for _ in range(enc["num_layers"]):
        total += flops.bound_s(*flops.blstm_infer(hf, d, enc["hidden_dim"],
                                                  2), "bfloat16")
        d = enc["proj_dim"]
    return total


def read(run):
    if run["kind"] != "decode":
        return None
    return roofline_share(run, sum(bound_s(x, run["cfg"], run["traffic"])
                                   for x in run["profile_lengths"]), KERNELS)
