"""The port's data parallelism (``robust_e2e_gan_torch/parallel``) on the
CPU, in gloo ranks of one thread each, at ``tests/test_parallel.py``'s tiny
configuration: the mesh record and batch slices give the JAX package's
values and error texts, ``partition_rule`` its specs; a 2-rank joint step
on shards with unequal token counts equals the port's single-process step
(which ``test_torch_train_step.py`` holds against JAX) at the JAX test's
tolerance, where a mean of per-rank means would not; a 2-rank beam search
equals the single-process one with one shard finishing first; 2-rank
``train()`` ends with bit-equal ranks and one set of checkpoints; and a
rank that fails ends the launch with its error."""

import dataclasses
import time

import pytest

pytest.importorskip("jax")

import numpy as np  # noqa: E402
import torch  # noqa: E402

from robust_e2e_gan_tpu import parallel as jax_parallel  # noqa: E402
from robust_e2e_gan_torch import configs  # noqa: E402
from robust_e2e_gan_torch.config import (  # noqa: E402
    BeamSearchConfig,
    TrainConfig,
)
from robust_e2e_gan_torch.convert import (  # noqa: E402
    from_flax,
    init_disc_params,
    init_params,
)
from robust_e2e_gan_torch.data.synthetic import (  # noqa: E402
    SyntheticConfig,
    make_batch,
)
from robust_e2e_gan_torch.parallel import (  # noqa: E402
    launch,
    local_batch_size,
    make_mesh,
    partition_rule,
    process_batch_slice,
    shard_batch,
)
from robust_e2e_gan_torch.pipeline import build_model  # noqa: E402
from robust_e2e_gan_torch.tools import dp_phases  # noqa: E402
from robust_e2e_gan_torch.train import loop, steps  # noqa: E402

JCFG = configs.tiny_config(12)
SCFG = SyntheticConfig(vocab_size=12, max_tokens=3, min_tokens=2)
TCFG = TrainConfig(optimizer="adam", learning_rate=1e-3)
# tests/test_parallel.py:93-96
RTOL, ATOL = 2e-4, 2e-5
LIMIT_S = 120.0


def _joint_batch():
    """B=8 whose two shards hold 4 and 12 label tokens."""
    batch = make_batch(8, SCFG, np.random.default_rng(0))
    batch["labels"][:4, 1:] = -1
    batch["labels"][4:, :3] = np.maximum(batch["labels"][4:, :3], 2)
    return batch


def _decode_batch():
    """B=8: four utterances of one token, then four of three, so the first
    shard reaches its length limits (maxlen_ratio) and stops first."""
    pad = SCFG.max_samples
    rng = np.random.default_rng(2)
    short = make_batch(4, dataclasses.replace(SCFG, min_tokens=1), rng,
                       max_tokens=1, pad_to_samples=pad)
    long = make_batch(4, dataclasses.replace(SCFG, min_tokens=3), rng,
                      pad_to_samples=pad)
    width = long["labels"].shape[1]
    short["labels"] = np.pad(short["labels"], ((0, 0), (0, width - 1)),
                             constant_values=-1)
    return {k: np.concatenate([short[k], long[k]]) for k in short}


def _params():
    return (from_flax(init_params(JCFG, seed=0)),
            from_flax(init_disc_params(JCFG.discriminator, seed=1)))


BCFG = BeamSearchConfig(beam_size=4, ctc_weight=0.3, max_steps=8,
                        maxlen_ratio=0.3, early_exit=True)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """One 2-rank launch of the joint steps, the beam decode and train(),
    and the same drives in this process."""
    sg, sd = _params()
    joint = [_joint_batch(), make_batch(8, SCFG, np.random.default_rng(1))]
    dec = _decode_batch()
    rng = np.random.default_rng(3)
    train_b = [make_batch(4, SCFG, rng) for _ in range(2)]
    dev_b = [make_batch(4, SCFG, rng)]
    ckpt = str(tmp_path_factory.mktemp("dp_train"))
    # Adadelta at a learning rate too small to move dev accuracy: epoch 1
    # is a plateau, which decays eps
    tcfg = TrainConfig(learning_rate=1e-3, num_epochs=2,
                       checkpoint_dir=ckpt, log_every=1)
    calls = [
        (dp_phases.joint_steps, (JCFG, TCFG, sg, sd, joint), {}),
        (dp_phases.beam_decode, (JCFG, sg, dec["noisy_wav"],
                                 dec["wav_lengths"], BCFG), {}),
        (dp_phases.train_and_restore, (JCFG, tcfg, train_b, dev_b), {}),
    ]
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        ranks = launch(dp_phases.run_all, make_mesh(2, 1, "cpu"), calls,
                       limit_s=LIMIT_S)
        one = [fn(None, *args, **kw) for fn, args, kw in calls[:2]]
    finally:
        torch.set_num_threads(n)
    return {"ranks": ranks, "one": one, "joint": joint, "sg": sg}


def test_make_mesh_matches_jax(monkeypatch):
    assert make_mesh(4, 1, "cpu").shape == jax_parallel.make_mesh(4, 1).shape
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 8)
    assert make_mesh(device="cuda").shape == jax_parallel.make_mesh().shape
    for n in (16, 9):
        with pytest.raises(ValueError) as want:
            jax_parallel.make_mesh(n, 1)
        with pytest.raises(ValueError) as got:
            make_mesh(n, 1, "cuda")
        assert str(got.value) == str(want.value)
    # ranks sharing a card, and CPU ranks, have no device limit
    assert make_mesh(16, 1, "cuda:0").n_data == make_mesh(16, 1, "cpu").n_data
    # a model axis: the JAX shapes, and its errors past the cards
    assert make_mesh(4, 2, "cpu").shape == jax_parallel.make_mesh(4, 2).shape
    assert make_mesh(None, 2, "cuda").shape == jax_parallel.make_mesh(
        None, 2).shape
    for n_data, n_model in ((8, 2), (5, 2), (None, 3)):
        with pytest.raises(ValueError) as want:
            jax_parallel.make_mesh(n_data, n_model)
        with pytest.raises(ValueError) as got:
            make_mesh(n_data, n_model, "cuda")
        assert str(got.value) == str(want.value)


def test_batch_slices_match_jax():
    jmesh = jax_parallel.make_mesh(2, 1)
    mesh = make_mesh(2, 1, "cpu")
    assert process_batch_slice(16) == jax_parallel.process_batch_slice(16)
    assert local_batch_size(16, mesh) == jax_parallel.local_batch_size(
        16, jmesh)
    with pytest.raises(ValueError) as want:
        jax_parallel.local_batch_size(5, jmesh)
    with pytest.raises(ValueError) as got:
        local_batch_size(5, mesh)
    assert str(got.value) == str(want.value)
    x = np.zeros((5, 3), np.float32)
    with pytest.raises(ValueError) as want:
        jax_parallel.shard_batch({"x": x}, jax_parallel.make_mesh(8, 1))
    with pytest.raises(ValueError) as got:
        shard_batch({"x": x}, make_mesh(8, 1, "cpu"))
    assert str(got.value) == str(want.value)
    rows = np.arange(8)
    assert [shard_batch({"r": rows}, dataclasses.replace(mesh, rank=r))["r"]
            .tolist() for r in (0, 1)] == [[0, 1, 2, 3], [4, 5, 6, 7]]


@pytest.mark.parametrize("shape,n_model", [((1024, 1024), 2),
                                           ((1024, 1023), 2), ((7,), 2),
                                           ((1024, 1024), 1)])
def test_partition_rule_matches_jax(shape, n_model):
    assert partition_rule(shape, n_model) == tuple(
        jax_parallel.partition_rule(shape, n_model))


def test_two_rank_joint_step_equals_one_process(runs):
    one = runs["one"][0]
    ranks = [r[0] for r in runs["ranks"]]
    for step in range(2):
        want = one["metrics"][step]
        for rank in ranks:
            got = rank["metrics"][step]
            assert got.keys() == want.keys()
            for k in want:
                np.testing.assert_allclose(got[k], want[k], rtol=RTOL,
                                           atol=ATOL, err_msg=k)
    for k, w in one["params"].items():
        assert torch.equal(ranks[0]["params"][k], ranks[1]["params"][k]), k
        np.testing.assert_allclose(ranks[0]["params"][k].numpy(), w.numpy(),
                                   rtol=0, atol=1e-5, err_msg=k)


def test_a_mean_of_rank_means_would_fail(runs):
    """The teeth of the global token count: loss_att as each shard's own
    mean, averaged over the two shards, is not the global batch's."""
    batch = runs["joint"][0]
    model = build_model(JCFG)
    model.load_state_dict(runs["sg"])
    eval_fn = steps.make_eval_step(use_enhancer=True)
    mesh = make_mesh(2, 1, "cpu")
    means = []
    for r in (0, 1):
        rows = shard_batch({k: batch[k] for k in loop.BATCH_KEYS
                            if k in batch}, dataclasses.replace(mesh, rank=r))
        means.append(float(eval_fn(model, loop.device_batch(rows, "cpu"))[
            "loss_att"]))
    naive = sum(means) / 2
    got = runs["ranks"][0][0]["metrics"][0]["loss_att"]
    want = runs["one"][0]["metrics"][0]["loss_att"]
    assert abs(got - want) <= ATOL + RTOL * abs(want)
    assert abs(naive - want) > 1e-3, (naive, want)


def test_two_rank_beam_decode_equals_one_process(runs):
    one = runs["one"][1]
    ranks = [r[1] for r in runs["ranks"]]
    np.testing.assert_array_equal(
        np.concatenate([r["tokens"] for r in ranks]), one["tokens"])
    np.testing.assert_allclose(
        np.concatenate([r["scores"] for r in ranks]), one["scores"],
        rtol=1e-4, atol=1e-4)
    # a prefix-state call a search step: the short shard stopped first
    steps0, steps1 = (r["launches"]["state_plain"] for r in ranks)
    assert steps0 < steps1 == one["launches"]["state_plain"]


def test_two_rank_train_loop_agrees_and_restores(runs):
    r0, r1 = (r[2] for r in runs["ranks"])
    assert r0["step"] == r1["step"] == 4
    for k in r0["params"]:
        assert torch.equal(r0["params"][k], r1["params"][k]), k
        assert torch.equal(r0["restored"][k], r1["restored"][k]), k
        assert torch.equal(r0["restored"][k], r0["params"][k]), k
    # the dev plateau of epoch 1 decayed eps on both ranks alike
    assert r0["eps"] == r1["eps"] and r0["eps"][0] < TrainConfig().adadelta_eps
    ckpts = [f for f in r0["files"] if f.startswith("ckpt_")]
    assert ckpts == ["ckpt_2.pt", "ckpt_4.pt"] and r0["files"] == r1["files"]


def test_a_failing_rank_ends_the_launch():
    t0 = time.perf_counter()
    with pytest.raises(ValueError, match="rank 1 failed before"):
        launch(dp_phases.fail_before_collective, make_mesh(2, 1, "cpu"), 1,
               limit_s=LIMIT_S)
    assert time.perf_counter() - t0 < LIMIT_S / 2
