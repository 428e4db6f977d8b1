"""The benchmark's arithmetic against hand counts at small shapes: the
FLOP, byte and roofline counts, the interval union behind the idle share,
the percentile over all samples, the weight layout and the frozen traffic
generator against the port's."""

import numpy as np
import pytest

from asr_bench import core, flops, trace, weights


def test_blstm_infer_counts():
    # n = 5 frames, D = 4, H = 2: 2 directions x 2 (mul-add) x (D + H) x 4H
    f, b = flops.blstm_infer([3, 2], d=4, h=2, x_itemsize=4)
    assert f == 5 * 2 * 2 * 6 * 8 == 960
    # x f32, W_x and W_h bf16, bias f32, lengths int32, y bf16
    assert b == 5 * 4 * 4 + 2 * 6 * 8 * 2 + 2 * 8 * 4 + 2 * 4 + 5 * 4 * 2


def test_blstm_train_counts():
    f, _ = flops.blstm_train([3, 2], d=4, h=2, x_itemsize=2, dx=True)
    # forward (D + H), backward dh + dW_h (2H) + dW_x + dx (2D)
    assert f == 5 * 2 * 2 * 8 * ((4 + 2) + (2 + 2 + 4) + 4)
    f0, _ = flops.blstm_train([3, 2], d=4, h=2, x_itemsize=2, dx=False)
    assert f - f0 == 5 * 2 * 2 * 8 * 4


def test_att_and_lm_counts():
    f, b = flops.att_loc_step([2, 3], k=2, c=3, a=4, e=5)
    assert f == 2 * 5 * 2 * (3 * 4 + 4 + 5)
    assert b == ((2 * 5 * 3 + 5 * 4 + 5 * 5 + 2 * 2 * 4 + 3 * 4 + 4 + 5) * 2
                 + 2 * 2 * 5 * 4 + 2 * 5 * 4)
    f, _ = flops.lm_step(lanes=3, e=2, h=4, v=5)
    assert f == 3 * (2 * 6 * 16 + 2 * 4 * 5)


def test_bound_is_the_larger_of_compute_and_memory():
    assert flops.bound_s(989e12, 0, "bfloat16") == pytest.approx(1.0)
    assert flops.bound_s(1.0, 3.35e12, "bfloat16") == pytest.approx(1.0)
    assert flops.bound_s(67e12, 1.0, "float32") == pytest.approx(1.0)


def test_vgg_and_frames():
    # T = 4 frames, D = 4 mels, channels (2, 3): 16 positions at 1->2->2,
    # then 2 x 2 positions at 2->3->3, 3x3 kernels
    assert flops._vgg([4], 4, (2, 3)) == 16 * 18 * (2 + 4) + 4 * 18 * (6 + 9)
    fcfg = {"frame_length": 400, "frame_shift": 160}
    assert flops.stft_frames([400, 559, 560, 100], fcfg) == [1, 1, 2, 0]
    assert flops.enc_frames([694, 5, 1]) == [174, 2, 1]


def test_union_and_gaps():
    covered, gaps = trace.union([(0, 2), (1, 3), (5, 6)], 0, 10)
    assert covered == 4 and gaps == [(3, 5), (6, 10)]
    covered, gaps = trace.union([(-1, 1), (8, 12)], 0, 10)
    assert covered == 3 and gaps == [(1, 8)]


def test_profile_reduction():
    ev = [{"cat": "user_annotation", "name": trace.WINDOW, "ts": 0,
           "dur": 100},
          {"cat": "kernel", "name": "k_a", "ts": 10, "dur": 10},
          {"cat": "kernel", "name": "k_b", "ts": 15, "dur": 15},
          {"cat": "gpu_memcpy", "name": "Memcpy HtoD", "ts": 50, "dur": 10},
          {"cat": "kernel", "name": "k_a", "ts": 120, "dur": 10},
          {"cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": 9,
           "dur": 1},
          {"cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": 14,
           "dur": 1},
          {"cat": "cuda_driver", "name": "cuLaunchKernelEx", "ts": 35,
           "dur": 1},
          {"cat": "cuda_runtime", "name": "cudaMemcpyAsync", "ts": 45,
           "dur": 1},
          {"cat": "cpu_op", "name": "aten::outer", "ts": 30, "dur": 60},
          {"cat": "cpu_op", "name": "aten::inner", "ts": 32, "dur": 16}]
    p = trace.Profile(ev, units=2)
    # two streams overlap: 10-30 and 50-60 busy, 30 us of a 100 us window
    assert p.busy_s == pytest.approx(30e-6)
    assert p.window_s == pytest.approx(100e-6)
    assert p.launches == 3
    assert p.kernel_time(["k_a"]) == pytest.approx(10e-6)
    gaps = dict(p.idle_gaps)
    assert gaps["aten::inner"] == pytest.approx(20e-6)  # 30-50
    assert gaps["aten::outer"] == pytest.approx(40e-6)  # 60-100
    assert gaps["(host between ops)"] == pytest.approx(10e-6)  # 0-10
    assert sum(gaps.values()) == pytest.approx(70e-6)


def test_percentile_takes_every_sample():
    assert core.percentile(list(range(1, 101)), 95) == 95
    assert core.percentile(list(range(20, 0, -1)), 95) == 19
    assert core.percentile([7.0], 95) == 7.0


@pytest.mark.parametrize("name", ["flagship", "reference"])
def test_weight_layout_is_the_ports(name):
    from robust_e2e_gan_torch.config import JointConfig, LMConfig, from_dict
    from robust_e2e_gan_torch.models.enhancement import Discriminator
    from robust_e2e_gan_torch.models.lm import RNNLM
    from robust_e2e_gan_torch.pipeline import build_model

    cfg = core.load_json(f"{core.HERE}/configs/{name}.json")
    jcfg = from_dict(JointConfig, cfg)
    for leaves, module in (
            (weights.generator_layout(cfg), build_model(jcfg)),
            (weights.discriminator_layout(cfg),
             Discriminator(jcfg.discriminator))):
        assert [(k, tuple(s)) for k, s, _ in leaves] == [
            (k, tuple(v.shape)) for k, v in module.state_dict().items()]
    lm = {"embed_dim": 128, "hidden_dim": 256, "num_layers": 1}
    v = cfg["e2e"]["decoder"]["vocab_size"]
    model = RNNLM(LMConfig(vocab_size=v, **lm))
    assert [(k, tuple(s)) for k, s, _ in weights.lm_layout(lm, v)] == [
        (k, tuple(t.shape)) for k, t in model.state_dict().items()]


def test_weights_repeat_by_seed_and_differ_by_stream():
    import torch
    leaves = [("a", (3, 4), 4), ("b", (5,), 4)]
    w1 = weights.make(leaves, 2**31 + 77, torch.device("cpu"))
    w2 = weights.make(leaves, 2**31 + 77, torch.device("cpu"))
    w3 = weights.make(leaves, 2**31 + 77, torch.device("cpu"), "lm")
    assert all(torch.equal(w1[k], w2[k]) for k in w1)
    assert not torch.equal(w1["a"], w3["a"])
    assert float(w1["a"].abs().max()) <= 0.5


def test_decode_flops_grow_with_the_beam():
    cfg = core.load_json(f"{core.HERE}/configs/flagship.json")
    beam = {"beam_size": 8, "max_steps": 48, "lm_weight": 0.0}
    lens = [111360] * 4
    f8 = flops.decode_batch_flops(lens, cfg, beam, True)
    f4 = flops.decode_batch_flops(lens, cfg, dict(beam, beam_size=4), True)
    hf = flops.enc_frames(flops.stft_frames(lens, cfg["e2e"]["frontend"]))
    assert f8 - f4 == pytest.approx(48 * (flops._dec_step(hf, 8, cfg)
                                          - flops._dec_step(hf, 4, cfg)))


@pytest.mark.parametrize("hard", [False, True], ids=["decode", "hard_task"])
def test_the_frozen_generator_matches_the_ports(hard):
    from robust_e2e_gan_torch.data import synthetic

    from asr_bench import synth

    def batch(mod):
        cfg = (mod.hard_task(vocab_size=32) if hard else
               mod.SyntheticConfig(vocab_size=52, min_tokens=4,
                                   max_tokens=6))
        return mod.make_batch(3, cfg, np.random.default_rng(2**33 + 5),
                              pad_to_samples=None)

    got, want = batch(synth), batch(synthetic)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])


def test_roofline_metrics_count_their_own_bound():
    # each roofline metric file sums its function's bound from the
    # profiled batches' lengths and the cell's files
    def metric(name):
        return core.load_module(f"{core.HERE}/metrics/{name}.py", name)

    enc = {"input_dim": 8, "vgg_channels": [2, 3], "num_layers": 2,
           "hidden_dim": 4, "proj_dim": 5}
    cfg = {"e2e": {"frontend": {"frame_length": 400, "frame_shift": 160},
                   "encoder": enc,
                   "attention": {"dim": 6, "conv_channels": 2}},
           "enhancer": {"input_dim": 7, "num_layers": 1, "hidden_dim": 3}}
    traffic = {"use_enhancer": True,
               "beam": {"max_steps": 4, "beam_size": 2}}
    lens = [400 + 160 * 9, 400 + 160 * 5]  # 10 and 6 frames
    frames, hf = [10, 6], [3, 2]
    assert flops.vgg_out_dim(enc) == 2 * 3
    want = (flops.bound_s(*flops.blstm_infer(frames, 7, 3, 4), "bfloat16")
            + flops.bound_s(*flops.blstm_infer(hf, 6, 4, 2), "bfloat16")
            + flops.bound_s(*flops.blstm_infer(hf, 5, 4, 2), "bfloat16"))
    got = metric("blstm_infer_roofline").bound_s(lens, cfg, traffic)
    assert got == pytest.approx(want)
    want = 4 * flops.bound_s(*flops.att_loc_step(hf, 2, 2, 6, 5),
                             "bfloat16")
    got = metric("att_loc_roofline").bound_s(lens, cfg, traffic)
    assert got == pytest.approx(want)
    want = (flops.bound_s(*flops.blstm_train(frames, 7, 3, 4, dx=False),
                          "bfloat16")
            + flops.bound_s(*flops.blstm_train(hf, 6, 4, 2, dx=True),
                            "bfloat16")
            + flops.bound_s(*flops.blstm_train(hf, 5, 4, 2, dx=True),
                            "bfloat16"))
    assert metric("blstm_train_roofline").bound_s(lens, cfg) == \
        pytest.approx(want)
