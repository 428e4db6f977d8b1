"""The port's tensor parallelism (the model axis of
``robust_e2e_gan_torch/parallel``) on the CPU, in four gloo ranks of one
thread each on a (2, 2) mesh, at ``tests/test_parallel.py``'s tiny
configuration with ``min_shard_dim=32``: each leaf's local shard is the
JAX package's ``shard_params`` shard on that model column; joint steps
(unclipped, and with the clip engaged), a beam search and ``train()`` with
its checkpoints equal one process's; the model ranks of a data index are
bit-equal, and store the column slices of parameters and optimizer
state."""

import os
import shutil

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
    to_flax,
)
from robust_e2e_gan_torch.data.synthetic import (  # noqa: E402
    SyntheticConfig,
    make_batch,
)
from robust_e2e_gan_torch.parallel import (  # noqa: E402
    launch,
    local_shard,
    make_mesh,
)
from robust_e2e_gan_torch.parallel.sharding import shard_dim  # noqa: E402
from robust_e2e_gan_torch.tools import dp_phases  # noqa: E402

JCFG = configs.tiny_config(12)
SCFG = SyntheticConfig(vocab_size=12, max_tokens=3, min_tokens=2)
MIN_SHARD_DIM = 32
# tests/test_parallel.py:170
RTOL, ATOL = 5e-4, 5e-5
PARAM_ATOL = 1e-6
LIMIT_S = 120.0
BCFG = BeamSearchConfig(beam_size=4, ctc_weight=0.3, max_steps=8,
                        maxlen_ratio=0.3, early_exit=True)
# far below the first step's generator norm (~2.7): the clip engages
CLIP = 0.01


def _params():
    return (from_flax(init_params(JCFG, seed=0)),
            from_flax(init_disc_params(JCFG.discriminator, seed=1)))


def _joint_batch():
    """B=8 whose two data shards hold 4 and 12 label tokens."""
    batch = make_batch(8, SCFG, np.random.default_rng(0))
    batch["labels"][:4, 1:] = -1
    batch["labels"][4:, :3] = np.maximum(batch["labels"][4:, :3], 2)
    return batch


def _train_cfg(ckpt, epochs):
    # Adadelta at a learning rate too small to move dev accuracy
    return TrainConfig(learning_rate=1e-3, num_epochs=epochs,
                       checkpoint_dir=str(ckpt), log_every=1)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """One (2, 2) launch of every drive, and the same drives in this
    process."""
    sg, sd = _params()
    joint = [_joint_batch(), make_batch(8, SCFG, np.random.default_rng(1))]
    dec = make_batch(8, SCFG, np.random.default_rng(2))
    rng = np.random.default_rng(3)
    train_b = [make_batch(4, SCFG, rng) for _ in range(2)]
    dev_b = [make_batch(4, SCFG, rng)]
    tmp = tmp_path_factory.mktemp("tp_train")
    blstm = {k: sg[f"enhancer.blstm0.{k}"] for k in ("wx", "wh", "bias")}
    clipped = TrainConfig(grad_clip=CLIP)
    kw = {"min_shard_dim": MIN_SHARD_DIM}
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        # one process's run, which the mesh resumes and which checks the
        # mesh's checkpoint layout
        one_train = dp_phases.train_and_restore(
            None, JCFG, _train_cfg(tmp / "one", 1), train_b, dev_b)
        for d in ("resume_mesh", "resume_one"):
            shutil.copytree(tmp / "one", tmp / d)
        calls = [
            (dp_phases.joint_steps, (JCFG, TrainConfig(), sg, sd, joint), kw),
            (dp_phases.joint_steps, (JCFG, clipped, sg, sd, joint[:1]), kw),
            (dp_phases.beam_decode, (JCFG, sg, dec["noisy_wav"],
                                     dec["wav_lengths"], BCFG), kw),
            (dp_phases.train_and_restore,
             (JCFG, _train_cfg(tmp / "mesh", 1), train_b, dev_b), kw),
            (dp_phases.train_and_restore,
             (JCFG, _train_cfg(tmp / "resume_mesh", 2), train_b, dev_b),
             {**kw, "resume": True}),
            (dp_phases.blstm_layer, (blstm, 4, 10, torch.float32, 0), kw),
            (dp_phases.mesh_view, (16,), {}),
        ]
        ranks = launch(dp_phases.run_all, make_mesh(2, 2, "cpu"), calls,
                       limit_s=LIMIT_S)
        one = [fn(None, *args) for fn, args, _ in calls[:3]]
        one_resume = dp_phases.train_and_restore(
            None, JCFG, _train_cfg(tmp / "resume_one", 2), train_b, dev_b,
            resume=True)
        one_blstm = dp_phases.blstm_layer(None, *calls[5][1])
    finally:
        torch.set_num_threads(n)
    return {"ranks": ranks, "one": one, "one_train": one_train,
            "one_resume": one_resume, "one_blstm": one_blstm, "tmp": tmp}


def _close(got, want, what):
    for k, w in want.items():
        np.testing.assert_allclose(got[k].numpy(), w.numpy(), rtol=0,
                                   atol=PARAM_ATOL, err_msg=f"{what} {k}")


@pytest.mark.parametrize("min_shard_dim", [MIN_SHARD_DIM, 4])
def test_local_shards_match_jax_shard_params(min_shard_dim):
    """(a) Each leaf's ``local_shard`` at model indices 0 and 1 is the
    shard JAX's ``shard_params`` places on the devices of that model
    column of a (4, 2) mesh; at 4 the convolution kernels (stored
    transposed from the flax layout) shard too."""
    tree = init_params(JCFG, seed=0)
    jmesh = jax_parallel.make_mesh(4, 2)
    placed = jax_parallel.shard_params(tree, jmesh,
                                       min_shard_dim=min_shard_dim)
    n_sharded = 0
    for key, t in from_flax(tree).items():
        leaf = placed
        for part in key.split("."):
            leaf = leaf[part]
        n_sharded += shard_dim(key, t.shape, 2, min_shard_dim) is not None
        shards = {s.device: np.asarray(s.data)
                  for s in leaf.addressable_shards}
        for m in range(2):
            got = to_flax({key: local_shard(t, 2, m, min_shard_dim, key)})
            for part in key.split("."):
                got = got[part]
            for d in range(4):
                np.testing.assert_array_equal(
                    got, shards[jmesh.devices[d, m]], err_msg=f"{key} {m}")
    assert n_sharded >= 1


def test_mesh_ranks_take_their_data_index_rows(runs):
    views = [r[6] for r in runs["ranks"]]
    assert [(v["data_index"], v["model_index"]) for v in views] == [
        (0, 0), (0, 1), (1, 0), (1, 1)]
    assert [v["rows"] for v in views] == [v["process_slice"] for v in views]
    assert [v["rows"] for v in views] == [slice(0, 8), slice(0, 8),
                                          slice(8, 16), slice(8, 16)]


@pytest.mark.parametrize("drive", [0, 1], ids=["unclipped", "clipped"])
def test_joint_steps_equal_one_process(runs, drive):
    """(b, c) The (2, 2) joint steps against one process's: metrics at the
    JAX test's tolerance, ``grad_norm_g`` within 1e-6 relative (with the
    clip engaged, a norm over the rank's shard alone would report and
    apply another), parameters within 1e-6; the model ranks of each data
    index bit-equal."""
    one = runs["one"][drive]
    ranks = [r[drive] for r in runs["ranks"]]
    for i, want in enumerate(one["metrics"]):
        for rank in ranks:
            got = rank["metrics"][i]
            assert got.keys() == want.keys()
            for k in want:
                np.testing.assert_allclose(got[k], want[k], rtol=RTOL,
                                           atol=ATOL, err_msg=k)
            np.testing.assert_allclose(got["grad_norm_g"],
                                       want["grad_norm_g"], rtol=1e-6)
    if drive:
        assert one["metrics"][0]["grad_norm_g"] > 10 * CLIP
    for rank in ranks:
        _close(rank["params"], one["params"], "param")
        for k, slots in one["slots"].items():
            _close(rank["slots"][k], slots, f"slot of {k}")
    for a, b in ((0, 1), (2, 3)):
        for k in one["params"]:
            assert torch.equal(ranks[a]["params"][k], ranks[b]["params"][k])


def test_shards_store_the_column_slices(runs):
    """(b) Each model-sharded leaf's stored parameter and optimizer state
    are the rank's column slice of the full ones."""
    for r, rank in enumerate(runs["ranks"]):
        got = rank[0]
        sharded = {k for k, t in got["params"].items()
                   if shard_dim(k[2:], t.shape, 2, MIN_SHARD_DIM) is not None}
        assert set(got["shards"]) == sharded and sharded
        for k, local in got["shards"].items():
            full = {"param": got["params"][k], **got["slots"][k]}
            assert local.keys() == full.keys() == {
                "param", "square_avg", "acc_delta"}
            for slot, t in full.items():
                assert torch.equal(local[slot], local_shard(
                    t, 2, r % 2, MIN_SHARD_DIM, k[2:])), (k, slot)
        # the optimizer state of a sharded leaf takes half the bytes
        assert got["state_bytes"] < runs["one"][0]["state_bytes"]


def test_beam_decode_equals_one_process(runs):
    """(d) Tokens of the sharded model's search equal one process's."""
    one = runs["one"][2]
    ranks = [r[2] for r in runs["ranks"]]
    for m in range(2):
        np.testing.assert_array_equal(
            np.concatenate([ranks[m]["tokens"], ranks[2 + m]["tokens"]]),
            one["tokens"])
        np.testing.assert_allclose(
            np.concatenate([ranks[m]["scores"], ranks[2 + m]["scores"]]),
            one["scores"], rtol=1e-4, atol=1e-4)


def test_sharded_blstm_equals_whole(runs):
    """The inference BLSTM layer with wx, wh and bias model-sharded gives
    the unsharded layer's output exactly on every rank
    (``tests/test_parallel.py:339-365``)."""
    for rank in runs["ranks"]:
        got = rank[5]
        assert got["equal"] and got["sha256"] == runs["one_blstm"]["sha256"]
        assert got["sharded"] == ["parametrizations.bias.original",
                                  "parametrizations.wh.original",
                                  "parametrizations.wx.original"]


def test_train_checkpoint_has_the_one_process_layout(runs):
    """(e) ``train()`` on the mesh writes the single-process layout: the
    same keys and shapes as one process's checkpoint, restored in one
    process to the mesh's parameters, which are one process's."""
    tmp = runs["tmp"]
    mesh_ckpt = torch.load(os.path.join(tmp / "mesh", "ckpt_2.pt"),
                           weights_only=True)
    one_ckpt = torch.load(os.path.join(tmp / "one", "ckpt_2.pt"),
                          weights_only=True)
    for part in ("model", "discriminator"):
        assert list(mesh_ckpt[part]) == list(one_ckpt[part])
        assert all(mesh_ckpt[part][k].shape == v.shape
                   for k, v in one_ckpt[part].items())
    for part in ("opt_g", "opt_d"):
        got, want = (c[part]["opt"]["state"] for c in (mesh_ckpt, one_ckpt))
        assert {i: {k: v.shape for k, v in s.items()} for i, s in
                got.items()} == {i: {k: v.shape for k, v in s.items()}
                                 for i, s in want.items()}
    for rank in runs["ranks"]:
        got = rank[3]
        assert got["step"] == got["restored_step"] == 2
        for k, v in got["params"].items():
            assert torch.equal(got["restored"][k], v), k
        _close(got["params"], runs["one_train"]["params"], "train")


def test_one_process_checkpoint_resumes_on_the_mesh(runs):
    """(e) A one-process checkpoint resumes on the mesh: the step count
    continues, and the parameters are one process's resumed run's."""
    want = runs["one_resume"]
    for rank in runs["ranks"]:
        got = rank[4]
        assert got["step"] == want["step"] == 4
        assert got["files"] == want["files"]
        _close(got["params"], want["params"], "resumed")
        assert got["eps"] == pytest.approx(want["eps"])


def test_a_model_axis_mesh_outside_a_launch_refuses_collectives():
    mesh = make_mesh(2, 2, "cpu")
    assert (mesh.shape, mesh.size) == ({"data": 2, "model": 2}, 4)
    with pytest.raises(RuntimeError, match="only inside parallel.launch"):
        dp_phases.joint_steps(mesh, JCFG, TrainConfig(),
                              *_params(), [_joint_batch()])
