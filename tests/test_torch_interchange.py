"""Model interchange between the two packages, on the CPU: the port's
``TableTokenizer`` against the JAX class, ``utils/flax_msgpack.py``
against flax's own serialization of real JAX states, JAX experiment
directories (written by the JAX package's ``save_checkpoint``) restored,
decoded and warm-started from in the port, the refusal to resume a JAX
run, the JAX layout the port writes, and ``AsyncCheckpointer``."""

import dataclasses
import json
import os
import shutil
import threading

import pytest

pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402
from flax import serialization  # noqa: E402

from robust_e2e_gan_tpu import config as jax_config  # noqa: E402
from robust_e2e_gan_tpu.data import dataset as jax_dataset  # noqa: E402
from robust_e2e_gan_tpu.models.enhancement import (  # noqa: E402
    Discriminator as JaxDiscriminator,
)
from robust_e2e_gan_tpu.models import lm as jax_lm  # noqa: E402
from robust_e2e_gan_tpu.pipeline import RobustE2E as JaxRobustE2E  # noqa: E402
from robust_e2e_gan_tpu.train import lm as jax_train_lm  # noqa: E402
from robust_e2e_gan_tpu.train import steps as jax_steps  # noqa: E402
from robust_e2e_gan_tpu.utils import checkpoint as jax_ckpt  # noqa: E402
from robust_e2e_gan_torch import configs  # noqa: E402
from robust_e2e_gan_torch.config import LMConfig, TrainConfig  # noqa: E402
from robust_e2e_gan_torch.convert import to_flax  # noqa: E402
from robust_e2e_gan_torch.data import dataset  # noqa: E402
from robust_e2e_gan_torch.data.synthetic import (  # noqa: E402
    SyntheticConfig,
    make_batch,
)
from robust_e2e_gan_torch.decode import cli as decode_cli  # noqa: E402
from robust_e2e_gan_torch.train import cli as train_cli  # noqa: E402
from robust_e2e_gan_torch.train import loop  # noqa: E402
from robust_e2e_gan_torch.train.lm import load_lm, train_lm  # noqa: E402
from robust_e2e_gan_torch.utils import checkpoint as ckpt  # noqa: E402
from robust_e2e_gan_torch.utils import flax_msgpack  # noqa: E402

SYNTH = SyntheticConfig(vocab_size=12, min_tokens=2, max_tokens=3)
UNITS = {"letters": [f"{c} {i + 1}" for i, c in enumerate("abcdefghij")],
         # an <unk> unit, ids with a gap, a token of two characters
         "unk_gap": ["<unk> 1", "a 2", "b 3", "ch 5", "d 6"]}


def _jax(cfg):
    """The JAX package's config of the same class name and field values."""
    return jax_config.from_dict(getattr(jax_config, type(cfg).__name__),
                                dataclasses.asdict(cfg))


@pytest.fixture
def one_thread():
    """Torch on one thread, as the other training tests run it: under six
    test workers each thread count costs more than it gives."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# TableTokenizer
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("units", list(UNITS))
def test_table_tokenizer_matches_jax(units, tmp_path):
    path = tmp_path / "units.txt"
    path.write_text("\n".join(UNITS[units]) + "\n\n")
    want = jax_dataset.TableTokenizer.from_units(str(path))
    got = dataset.TableTokenizer.from_units(str(path))
    assert (got.vocab_size, got.blank_id, got.sos_eos_id, got.unk_id) == (
        want.vocab_size, want.blank_id, want.sos_eos_id, want.unk_id)
    for text in ("cab", "bad", "xa", ""):
        ids = got.encode(text)
        assert ids == want.encode(text)
        ids = ids + [0, got.sos_eos_id, 4]
        assert got.decode(ids) == want.decode(ids)
    got.save(str(tmp_path / "port.json"))
    want.save(str(tmp_path / "jax.json"))
    assert (tmp_path / "port.json").read_text() == (
        tmp_path / "jax.json").read_text()
    for saved in ("port.json", "jax.json"):
        back = dataset.load_tokenizer(str(tmp_path / saved))
        assert isinstance(back, dataset.TableTokenizer)
        assert back.id2tok == want.id2tok
        assert back.encode("cab") == want.encode("cab")
    chars = dataset.CharTokenizer(list("ab"))
    chars.save(str(tmp_path / "chars.json"))
    assert isinstance(dataset.load_tokenizer(str(tmp_path / "chars.json")),
                      dataset.CharTokenizer)


# ---------------------------------------------------------------------------
# one JAX TrainState and LMState, and their experiment dirs
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """A JAX joint run's TrainState at the tiny config (Adadelta), saved
    by the JAX package into an experiment dir with its config and
    tokenizer, and a JAX LM run's LMState (Adam) likewise."""
    root = tmp_path_factory.mktemp("jax_runs")
    jcfg = configs.tiny_config(12)
    tcfg = TrainConfig(seed=5)
    batch = {k: jnp.asarray(v) for k, v in
             make_batch(2, SYNTH, np.random.default_rng(0)).items()}
    state, _, _ = jax_steps.init_train_state(
        JaxRobustE2E(_jax(jcfg)), JaxDiscriminator(_jax(jcfg.discriminator)),
        _jax(tcfg), batch, seed=5)
    exp = str(root / "joint")
    os.makedirs(exp)
    jax_config.save_config(
        {"joint": jax_config.to_dict(_jax(jcfg)),
         "train": jax_config.to_dict(_jax(tcfg)), "mode": "joint",
         "input_kind": "wav", "spec_log_domain": False},
        os.path.join(exp, "config.json"))
    jax_dataset.CharTokenizer(list("abcdefghi")).save(
        os.path.join(exp, "tokenizer.json"))
    jax_ckpt.save_checkpoint(exp, state, 3, metric=0.5,
                             extra={"epoch": 0, "epoch_complete": True})

    lmcfg = LMConfig(vocab_size=12, embed_dim=16, hidden_dim=24)
    ltcfg = TrainConfig(optimizer="adam", warmup_steps=4)
    lm_state, _ = jax_train_lm.init_lm_state(
        jax_lm.RNNLM(_jax_lm(lmcfg)), _jax(ltcfg), seed=2)
    lm_dir = str(root / "lm")
    os.makedirs(lm_dir)
    jax_config.save_config(
        {"lm": jax_config.to_dict(_jax_lm(lmcfg)),
         "train": jax_config.to_dict(_jax(ltcfg)), "mode": "lm"},
        os.path.join(lm_dir, "config.json"))
    jax_ckpt.save_checkpoint(lm_dir, lm_state, 7, metric=-1.0)
    return dict(jcfg=jcfg, tcfg=tcfg, state=state, exp=exp, lmcfg=lmcfg,
                ltcfg=ltcfg, lm_state=lm_state, lm_dir=lm_dir,
                batch=jax.tree_util.tree_map(np.array, batch))


def _jax_lm(cfg):
    return jax_config.from_dict(jax_lm.LMConfig, dataclasses.asdict(cfg))


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


def _assert_same_tree(got, want):
    """The same names, and leaves equal bit for bit (type, dtype, shape
    and bytes)."""
    got, want = dict(_leaves(got)), dict(_leaves(want))
    assert set(got) == set(want)
    for name, w in want.items():
        g = got[name]
        if isinstance(w, np.ndarray):
            assert isinstance(g, np.ndarray), name
            assert (g.dtype, g.shape) == (w.dtype, w.shape), name
            assert g.tobytes() == w.tobytes(), name
        else:
            assert type(g) is type(w) and g == w, name


@pytest.mark.parametrize("which", ["train_state", "lm_state"])
def test_reader_gives_flax_leaves(jax_run, which):
    """The reader on ``flax.serialization.to_bytes`` of a JAX TrainState
    and LMState gives ``msgpack_restore``'s leaves, names and values."""
    data = serialization.to_bytes(
        jax_run["state" if which == "train_state" else "lm_state"])
    got = flax_msgpack.loads(data)
    _assert_same_tree(got, serialization.msgpack_restore(data))
    assert flax_msgpack.dumps(got) == data  # and writes the same bytes


def test_flax_restores_the_writers_bytes():
    rng = np.random.default_rng(1)
    tree = {"a": {"kernel": rng.standard_normal((3, 5)).astype(np.float32),
                  "count": np.asarray(7, np.int32)},
            "scalars": {"f": 0.25, "i": -300, "big": 2 ** 40, "b": False,
                        "n": None, "s": "x" * 40, "np": np.float32(1.5),
                        "c": complex(1.0, -2.0), "raw": b"\x00\x01" * 200},
            "empty": {}, "wide": np.arange(70_000, dtype=np.int16)}
    back = serialization.msgpack_restore(flax_msgpack.dumps(tree))
    _assert_same_tree(flax_msgpack.loads(flax_msgpack.dumps(tree)), back)
    _assert_same_tree(back, serialization.msgpack_restore(
        serialization.msgpack_serialize(tree)))


def test_chunked_array_and_bfloat16_leaf(monkeypatch):
    """An array past flax's chunk size (made small here) comes back whole;
    a bfloat16 leaf comes back as a torch bfloat16 tensor of its bits."""
    rng = np.random.default_rng(2)
    big = rng.standard_normal((37, 11)).astype(np.float32)
    monkeypatch.setattr(serialization, "MAX_CHUNK_SIZE", 256)
    data = serialization.msgpack_serialize({"p": {"w": big}})
    assert b"__msgpack_chunked_array__" in data
    got = flax_msgpack.loads(data)["p"]["w"]
    assert got.dtype == np.float32 and np.array_equal(got, big)
    assert flax_msgpack.dumps({"p": {"w": big}}, chunk_bytes=256) == data

    bf = jnp.asarray(rng.standard_normal((4, 6)), jnp.bfloat16)
    got = flax_msgpack.loads(serialization.to_bytes({"bf": bf}))["bf"]
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == (4, 6)
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(bf, np.float32))
    back = serialization.msgpack_restore(flax_msgpack.dumps({"bf": got}))
    assert back["bf"].dtype == jnp.bfloat16
    np.testing.assert_array_equal(np.asarray(back["bf"], np.float32),
                                  np.asarray(bf, np.float32))


# ---------------------------------------------------------------------------
# JAX experiments in the port
# ---------------------------------------------------------------------------


def test_jax_experiment_restores_and_matches_jax(jax_run, one_thread):
    """``decode.cli.load_experiment`` of the JAX dir: every parameter
    bit-equal to flax's own restore, the CTC logits and the losses of the
    restored model equal JAX's."""
    model, jcfg, tok, step, kind, _ = decode_cli.load_experiment(
        jax_run["exp"], device="cpu")
    assert (step, kind) == (3, "wav")
    assert isinstance(tok, dataset.CharTokenizer)
    restored, _ = jax_ckpt.restore_checkpoint(jax_run["exp"],
                                              jax_run["state"], "best")
    want = jax.tree_util.tree_map(np.asarray, restored.params_g)
    _assert_same_tree(to_flax(model.state_dict()), want)

    b = jax_run["batch"]
    jmodel = JaxRobustE2E(_jax(jax_run["jcfg"]))
    args = (b["noisy_wav"], b["wav_lengths"])
    w_enc = jmodel.apply({"params": want}, *map(jnp.asarray, args), True,
                         method=JaxRobustE2E.encode_for_decode)
    w_loss = jmodel.apply({"params": want}, *map(jnp.asarray, args),
                          jnp.asarray(b["labels"]), use_enhancer=True,
                          method=JaxRobustE2E.asr_forward)
    with torch.no_grad():
        g_enc = model.encode_for_decode(*map(torch.from_numpy, args), True)
        g_loss = model.asr_forward(*map(torch.from_numpy, args),
                                   torch.from_numpy(b["labels"]),
                                   use_enhancer=True)
    np.testing.assert_allclose(g_enc[3].numpy(), np.asarray(w_enc[3]),
                               rtol=1e-4, atol=1e-5)  # the CTC logits
    for key in ("loss_ctc", "loss_att"):
        np.testing.assert_allclose(g_loss[key].item(), float(w_loss[key]),
                                   rtol=1e-5)


def test_jax_lm_dir_restores(jax_run):
    """``load_lm`` of a JAX LM run: the parameters bit-equal, the logits
    equal JAX's."""
    lm = load_lm(jax_run["lm_dir"], device="cpu")
    want = jax.tree_util.tree_map(np.asarray, jax_run["lm_state"].params)
    _assert_same_tree(to_flax(lm.state_dict()), want)
    ys = np.array([[1, 4, 5, 2], [1, 7, 3, 3]], np.int32)
    w = jax_lm.RNNLM(_jax_lm(jax_run["lmcfg"])).apply({"params": want},
                                                      jnp.asarray(ys))
    with torch.no_grad():
        g = lm(torch.from_numpy(ys))
    np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4,
                               atol=1e-5)


def test_resuming_a_jax_run_raises(jax_run, tmp_path):
    """``--resume`` (train.cli's default) on a JAX dir raises before it
    writes anything, naming the reason, for the joint and the LM mode;
    so do the loops and ``restore_checkpoint`` without ``params_only``."""
    exp = str(tmp_path / "exp")
    shutil.copytree(jax_run["exp"], exp)
    before = {f: open(os.path.join(exp, f), "rb").read()
              for f in os.listdir(exp)}
    for mode in ("joint", "lm"):
        with pytest.raises(NotImplementedError, match="random streams"):
            train_cli.main(["--mode", mode, "--synthetic", "--ckpt-dir", exp,
                            "--device", "cpu"])
    assert {f: open(os.path.join(exp, f), "rb").read()
            for f in os.listdir(exp)} == before
    state = loop.init_state(jax_run["jcfg"], jax_run["tcfg"], "cpu")
    with pytest.raises(NotImplementedError, match="resuming a JAX run"):
        ckpt.restore_checkpoint(exp, state)
    tcfg = dataclasses.replace(jax_run["ltcfg"], checkpoint_dir=jax_run[
        "lm_dir"])
    with pytest.raises(NotImplementedError, match="resuming a JAX run"):
        train_lm(jax_run["lmcfg"], tcfg, lambda: iter(()), device="cpu")


def _write_manifest(root, n=4):
    rng = np.random.default_rng(8)
    batch = make_batch(n, SYNTH, rng)
    chars = "abcdefghi"
    entries = []
    for i in range(n):
        path = os.path.join(root, f"u{i}.npy")
        np.save(path, batch["noisy_wav"][i, :batch["wav_lengths"][i]])
        toks = [t for t in batch["labels"][i] if t >= 3]
        entries.append({"utt_id": f"u{i}", "noisy": path,
                        "n_samples": int(batch["wav_lengths"][i]),
                        "text": "".join(chars[t - 3] for t in toks)})
    manifest = os.path.join(root, "m.jsonl")
    with open(manifest, "w") as f:
        f.write("\n".join(json.dumps(e) for e in entries) + "\n")
    return manifest


def test_decode_and_warm_start_from_a_jax_dir(jax_run, tmp_path,
                                              one_thread):
    """The same parameters as a port experiment (``ckpt_3.pt``) and as
    the JAX dir: ``decode.cli`` writes the same ``hyp.txt`` and
    ``wer.json`` bytes, and a warm start from either trains to the same
    parameters."""
    port_exp = str(tmp_path / "port")
    shutil.copytree(jax_run["exp"], port_exp)
    os.remove(os.path.join(port_exp, "checkpoints.json"))
    for f in os.listdir(port_exp):
        if f.endswith(".msgpack"):
            os.remove(os.path.join(port_exp, f))
    state = loop.init_state(jax_run["jcfg"], jax_run["tcfg"], "cpu")
    ckpt.restore_checkpoint(jax_run["exp"], state, "best", params_only=True)
    ckpt.save_checkpoint(port_exp, state, 3, metric=0.5)

    manifest = _write_manifest(str(tmp_path))
    outs = {}
    for name, exp in (("jax", jax_run["exp"]), ("port", port_exp)):
        outs[name] = str(tmp_path / f"decode_{name}")
        decode_cli.main(["--manifest", manifest, "--ckpt-dir", exp,
                         "--device", "cpu", "--batch-size", "4",
                         "--beam-size", "2", "--max-steps", "4",
                         "--out", outs[name]])
    for f in ("hyp.txt", "wer.json"):
        assert (open(os.path.join(outs["jax"], f), "rb").read()
                == open(os.path.join(outs["port"], f), "rb").read()), f

    finals = []
    for exp in (jax_run["exp"], port_exp):
        tcfg = TrainConfig(num_epochs=1, log_every=100,
                           checkpoint_dir=str(tmp_path / f"warm{len(finals)}"))

        def batches():
            rng = np.random.default_rng(4)
            return (make_batch(2, SYNTH, rng) for _ in range(1))

        finals.append(loop.train(jax_run["jcfg"], tcfg, batches,
                                 init_from=exp, device="cpu"))
    for (k, a), (_, b) in zip(finals[0].model.state_dict().items(),
                              finals[1].model.state_dict().items()):
        assert torch.equal(a, b), k


@pytest.mark.parametrize("optimizer,warmup", [("adadelta", 0), ("adam", 0),
                                              ("adam", 3)])
def test_port_writes_the_jax_layout(jax_run, tmp_path, optimizer, warmup):
    """``save_jax_checkpoint`` of a port state after one update: flax
    restores it into the JAX TrainState of the same optimizer (the same
    tree, names and shapes), and the port reads its parameters back bit
    for bit."""
    tcfg = TrainConfig(optimizer=optimizer, warmup_steps=warmup, seed=5)
    state = loop.init_state(jax_run["jcfg"], tcfg, "cpu")
    for opt in (state.opt_g, state.opt_d):
        opt.step([torch.full_like(p, 0.01) for p in opt.params])
    state.step = 1
    ckpt.save_jax_checkpoint(str(tmp_path), state, 1, metric=0.25)
    assert ckpt.is_jax_checkpoint(str(tmp_path), "best")
    data = open(tmp_path / "ckpt_1.msgpack", "rb").read()

    js = jax_run["state"]
    opt = jax_steps.create_optimizer(_jax(tcfg))
    template = js.replace(opt_state_g=opt.init(js.params_g),
                          opt_state_d=opt.init(js.params_d))
    back = serialization.from_bytes(template, data)
    assert int(back.step) == 1
    for t, b in zip(jax.tree_util.tree_leaves(template),
                    jax.tree_util.tree_leaves(back)):
        assert np.shape(t) == np.shape(b)
        assert np.asarray(t).dtype == np.asarray(b).dtype
    _assert_same_tree(jax.tree_util.tree_map(np.asarray, serialization
                                             .to_state_dict(back)),
                      flax_msgpack.loads(data))
    counts = [np.asarray(x) for x in jax.tree_util.tree_leaves(
        back.opt_state_g) if np.asarray(x).dtype == np.int32]
    assert counts and all(int(c) == 1 for c in counts)

    fresh = loop.init_state(jax_run["jcfg"], TrainConfig(seed=9), "cpu")
    ckpt.restore_checkpoint(str(tmp_path), fresh, "best", params_only=True)
    for (k, a), (_, b) in zip(state.model.state_dict().items(),
                              fresh.model.state_dict().items()):
        assert torch.equal(a, b), k


# ---------------------------------------------------------------------------
# AsyncCheckpointer
# ---------------------------------------------------------------------------


@pytest.fixture
def port_state():
    return loop.init_state(configs.tiny_config(12), TrainConfig(), "cpu")


@pytest.fixture
def gated_writer(monkeypatch):
    """The worker's write held until the test opens the gate."""
    gate = threading.Event()
    write = ckpt._save_hosted

    def held(*args, **kw):
        assert gate.wait(30)
        return write(*args, **kw)

    monkeypatch.setattr(ckpt, "_save_hosted", held)
    return gate


def test_snapshot_survives_an_in_place_step(port_state, tmp_path,
                                            gated_writer):
    """The checkpoint holds the state at ``save()``, though the parameters
    and the optimizer state are updated in place before the worker writes
    (``state_dict()`` returns references: the snapshot copies them)."""
    opt = port_state.opt_g
    opt.step([torch.full_like(p, 0.1) for p in opt.params])
    want = {k: v.clone() for k, v in port_state.model.state_dict().items()}
    want_acc = [s["square_avg"].clone() for s in opt.opt.state.values()]
    with ckpt.AsyncCheckpointer() as saver:
        saver.save(str(tmp_path), port_state, 1)
        opt.step([torch.full_like(p, 0.3) for p in opt.params])
        with torch.no_grad():
            for p in port_state.model.parameters():
                p.add_(1.0)
        gated_writer.set()
    saved = torch.load(tmp_path / "ckpt_1.pt", weights_only=True)
    for k, v in want.items():
        assert torch.equal(saved["model"][k], v), k
    got_acc = [s["square_avg"] for s in saved["opt_g"]["opt"]["state"]
               .values()]
    assert all(torch.equal(a, b) for a, b in zip(got_acc, want_acc))
    assert not torch.equal(saved["model"][k],
                           port_state.model.state_dict()[k])


def test_worker_errors_are_raised_again(port_state, tmp_path, monkeypatch):
    def fail(*args, **kw):
        raise OSError("disk full")

    monkeypatch.setattr(ckpt, "_save_hosted", fail)
    saver = ckpt.AsyncCheckpointer()
    saver.save(str(tmp_path), port_state, 1)
    with pytest.raises(OSError, match="disk full"):
        saver.save(str(tmp_path), port_state, 2)  # raised by the next save()
    saver.wait()  # raised once: that save did not start
    saver.save(str(tmp_path), port_state, 3)
    with pytest.raises(OSError, match="disk full"):
        saver.wait()  # and by wait()
    saver.save(str(tmp_path), port_state, 4)
    with pytest.raises(OSError, match="disk full"):
        with saver:  # leaving the block waits and raises
            pass
    assert not os.listdir(tmp_path)


def test_two_saves_keep_the_sidecars_order(port_state, tmp_path,
                                           gated_writer):
    saver = ckpt.AsyncCheckpointer()
    saver.save(str(tmp_path), port_state, 1, metric=0.5)
    gated_writer.set()
    saver.save(str(tmp_path), port_state, 2, metric=0.4)
    saver.wait()
    meta = json.loads((tmp_path / "checkpoints.json").read_text())
    assert [h["step"] for h in meta["history"]] == [1, 2]
    assert meta["latest"]["step"] == 2 and meta["best"]["step"] == 1
    assert sorted(os.listdir(tmp_path)) == ["checkpoints.json", "ckpt_1.pt",
                                            "ckpt_2.pt"]
