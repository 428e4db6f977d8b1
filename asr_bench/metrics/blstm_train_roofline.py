"""The training BLSTM layers' share of their roofline in the profiled
window: the bound of every layer's forward and backward in the G-step
(``flops.blstm_train``) over the device time of the kernels below: the
frame loops of either route and ``gemm.cu``'s products and column sums."""

from asr_bench import flops
from asr_bench.trace import roofline_share

KERNELS = ("fwd_resident", "bwd_resident", "::fwd_kernel", "::bwd_kernel",
           "gemm_tc_kernel", "gemm_simt_kernel", "colsum_kernel")


def bound_s(lengths, cfg: dict) -> float:
    """Seconds of the bound of one joint step's training BLSTM layers."""
    frames = flops.stft_frames(lengths, cfg["e2e"]["frontend"])
    total = 0.0
    ecfg = cfg["enhancer"]
    d = ecfg["input_dim"]
    for i in range(ecfg["num_layers"]):  # layer 0 reads float32, no dx
        total += flops.bound_s(*flops.blstm_train(
            frames, d, ecfg["hidden_dim"], 4 if i == 0 else 2, dx=i > 0),
            "bfloat16")
        d = 2 * ecfg["hidden_dim"]
    enc = cfg["e2e"]["encoder"]
    hf = flops.enc_frames(frames)
    d = flops.vgg_out_dim(enc)
    for _ in range(enc["num_layers"]):
        total += flops.bound_s(*flops.blstm_train(hf, d, enc["hidden_dim"],
                                                  2, dx=True), "bfloat16")
        d = enc["proj_dim"]
    return total


def read(run):
    if run["kind"] != "train":
        return None
    return roofline_share(run, sum(bound_s(x, run["cfg"])
                                   for x in run["profile_lengths"]), KERNELS)
