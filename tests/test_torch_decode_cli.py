"""The port's serving entry point ``robust_e2e_gan_torch.decode.cli`` against
the JAX package's ``decode/cli.py`` on the CPU: the same manifest and the
same parameters decode to the same ``hyp.txt``, ``wer.json`` and n-best
lists, with ``--serving-impls fused`` and ``xla``, a ragged final batch and
``--greedy``; the Kaldi sources and speaker CMVN decode as the manifest
and global CMVN they stand for, and refuse what the JAX CLI refuses with
its message; ``--mesh-data 2`` decodes over two gloo ranks to the files
of one process and of the JAX CLI's ``--mesh-data 2``; ``--pipelined
on`` (the staged schedule) decodes to the files of ``--pipelined off``
and of the JAX CLI's ``--pipelined on``, alone and over two ranks;
``--pipelined chunked`` raises, and without ``--device cpu`` the CLI
raises where there is no GPU."""

import dataclasses
import json
import os
import shutil

import pytest

pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from robust_e2e_gan_tpu import config as jax_config  # noqa: E402
from robust_e2e_gan_tpu.data import dataset as jax_dataset  # noqa: E402
from robust_e2e_gan_tpu.data import synthetic as jax_synthetic  # noqa: E402
from robust_e2e_gan_tpu.decode import cli as jax_cli  # noqa: E402
from robust_e2e_gan_tpu.models.enhancement import Discriminator  # noqa: E402
from robust_e2e_gan_tpu.pipeline import build_model as jax_build_model  # noqa: E402
from robust_e2e_gan_tpu.train.steps import init_train_state  # noqa: E402
from robust_e2e_gan_tpu.utils import checkpoint as jax_ckpt  # noqa: E402
from robust_e2e_gan_torch import configs  # noqa: E402
from robust_e2e_gan_torch.config import TrainConfig  # noqa: E402
from robust_e2e_gan_torch.convert import from_flax  # noqa: E402
from robust_e2e_gan_torch.data.dataset import CharTokenizer  # noqa: E402
from robust_e2e_gan_torch.data.synthetic import (  # noqa: E402
    SyntheticConfig,
    synth_utterance,
)
from robust_e2e_gan_torch.decode import cli  # noqa: E402
from robust_e2e_gan_torch.ops import att_dec  # noqa: E402
from robust_e2e_gan_torch.parallel import launcher, make_mesh  # noqa: E402
from robust_e2e_gan_torch.tools import dp_phases  # noqa: E402
from robust_e2e_gan_torch.train.loop import init_state  # noqa: E402
from robust_e2e_gan_torch.utils import checkpoint as ckpt_lib  # noqa: E402

ALPHABET = "abcdefghij"
N_UTTS = 7  # batches of 4: the final batch is ragged and padded


def _jax(cfg):
    """The JAX package's config of the same class name and field values."""
    return jax_config.from_dict(getattr(jax_config, type(cfg).__name__),
                                dataclasses.asdict(cfg))


@pytest.fixture(scope="module")
def exp(tmp_path_factory):
    """A manifest of synthetic .npy utterances, and one set of parameters
    in a JAX experiment dir (msgpack) and a port experiment dir (.pt)."""
    root = tmp_path_factory.mktemp("decode_cli")
    scfg = SyntheticConfig(vocab_size=12, min_tokens=2, max_tokens=4)
    rng = np.random.default_rng(0)
    entries = []
    for i in range(N_UTTS):
        toks = rng.integers(2, 12, size=(int(rng.integers(2, 5)),))
        clean, noisy = synth_utterance(toks.astype(np.int32), scfg, rng)
        np.save(root / f"n{i}.npy", noisy)
        np.save(root / f"c{i}.npy", clean)
        entries.append({"utt_id": f"u{i}", "noisy": f"n{i}.npy",
                        "clean": f"c{i}.npy", "n_samples": len(clean),
                        "text": "".join(ALPHABET[t - 2] for t in toks)})
    manifest = root / "manifest.jsonl"
    manifest.write_text("\n".join(json.dumps(e) for e in entries))

    tok = CharTokenizer(list(ALPHABET))
    jcfg = configs.tiny_config(tok.vocab_size)
    tcfg = TrainConfig(optimizer="adam", learning_rate=1e-3)
    dirs = {"jax": str(root / "jax_exp"), "port": str(root / "port_exp")}
    for d in dirs.values():
        os.makedirs(d)
        with open(os.path.join(d, "config.json"), "w") as f:
            json.dump({"joint": dataclasses.asdict(jcfg),
                       "train": dataclasses.asdict(tcfg), "mode": "joint",
                       "input_kind": "wav"}, f)
        tok.save(os.path.join(d, "tokenizer.json"))
    jj = _jax(jcfg)
    sample = {k: jnp.asarray(v) for k, v in jax_synthetic.make_batch(
        2, jax_synthetic.SyntheticConfig(vocab_size=tok.vocab_size),
        np.random.default_rng(0), ignore_id=-1).items()}
    state, _, _ = init_train_state(jax_build_model(jj),
                                   Discriminator(jj.discriminator),
                                   _jax(tcfg), sample, seed=3)
    jax_ckpt.save_checkpoint(dirs["jax"], state, 1)
    port = init_state(jcfg, tcfg, "cpu")
    for module, params in ((port.model, state.params_g),
                           (port.discriminator, state.params_d)):
        module.load_state_dict(from_flax(jax.tree_util.tree_map(np.asarray,
                                                                params)))
    ckpt_lib.save_checkpoint(dirs["port"], port, 1)
    return {"root": root, "manifest": str(manifest), **dirs}


def _decode(exp, which, out, *extra):
    argv = ["--manifest", exp["manifest"], "--ckpt-dir", exp[which],
            "--out", str(exp["root"] / out), "--batch-size", "4",
            "--beam-size", "3", "--max-steps", "6",
            "--length-buckets", "16000", *extra]
    if which == "port":
        cli.main(argv + ["--device", "cpu"])
    else:
        jax_cli.main(argv)
    return str(exp["root"] / out)


def _read(path):
    with open(path) as f:
        return f.read()


@pytest.mark.parametrize("impls", ["fused", "xla"])
def test_decode_cli_matches_jax(exp, impls):
    want = _decode(exp, "jax", f"jax_{impls}", "--serving-impls", impls,
                   "--nbest", "2")
    calls = att_dec.att_dec_step_plain.calls
    got = _decode(exp, "port", f"port_{impls}", "--serving-impls", impls,
                  "--nbest", "2")
    # fused: one fused step per beam step of each of the two batches
    assert att_dec.att_dec_step_plain.calls - calls == (
        2 * 6 if impls == "fused" else 0)
    for name in ("hyp.txt", "wer.json"):
        assert _read(os.path.join(got, name)) == _read(os.path.join(want,
                                                                    name))
    hyp = _read(os.path.join(got, "hyp.txt")).split("\n")[:-1]
    assert sorted(line.split()[0] for line in hyp) == [
        f"u{i}" for i in range(N_UTTS)]  # each once: no pad duplicates
    rows = [[json.loads(line) for line in _read(os.path.join(d, "nbest.jsonl"))
             .splitlines()] for d in (got, want)]
    assert len(rows[0]) == len(rows[1]) == N_UTTS
    for g, w in zip(*rows):
        assert g["utt_id"] == w["utt_id"]
        assert [e["tokens"] for e in g["nbest"]] == [
            e["tokens"] for e in w["nbest"]]
        assert [e["text"] for e in g["nbest"]] == [
            e["text"] for e in w["nbest"]]
        np.testing.assert_allclose([e["score"] for e in g["nbest"]],
                                   [e["score"] for e in w["nbest"]],
                                   rtol=1e-4, atol=1e-3)


def test_greedy_and_attention_dump(exp):
    """--greedy against the JAX CLI; --dump-attention writes one map per
    utterance, labels + eos rows by valid encoder frames."""
    want = _decode(exp, "jax", "jax_greedy", "--greedy")
    got = _decode(exp, "port", "port_greedy", "--greedy", "--dump-attention")
    for name in ("hyp.txt", "wer.json"):
        assert _read(os.path.join(got, name)) == _read(os.path.join(want,
                                                                    name))
    assert json.loads(_read(os.path.join(got, "wer.json")))["decoder"] == (
        "greedy")
    maps = sorted(os.listdir(os.path.join(got, "att")))
    assert maps == [f"u{i}.npy" for i in range(N_UTTS)]
    entries = [json.loads(line) for line in _read(exp["manifest"]).split("\n")]
    for e in entries:
        att = np.load(os.path.join(got, "att", e["utt_id"] + ".npy"))
        assert att.shape[0] == len(e["text"]) + 1
        np.testing.assert_allclose(att.sum(axis=1), 1.0, rtol=1e-5)


@pytest.fixture(scope="module")
def kaldi(exp):
    """``exp``'s manifest as a Kaldi recipe (wav.scp of (1, N) vectors,
    ``text``, ``utt2spk`` with one speaker), the global log-mel stats of
    its utterances as a "global" ark and as that speaker's ark, and two
    copies of the port experiment: one with global CMVN (its cmvn.ark
    in the dir) and one with speaker CMVN."""
    from robust_e2e_gan_torch.data import cmvn, kaldi_io
    from robust_e2e_gan_torch.data.featbin_cli import extract_iter

    root = exp["root"] / "kaldi"
    os.makedirs(root)
    entries = [json.loads(line) for line in _read(exp["manifest"]).split("\n")]
    wavs = {e["utt_id"]: np.load(exp["root"] / e["noisy"]) for e in entries}
    kaldi_io.write_ark_scp(((k, v[None]) for k, v in wavs.items()),
                           str(root / "wav.ark"), str(root / "wav.scp"))
    (root / "text").write_text(
        "".join(f"{e['utt_id']} {e['text']}\n" for e in entries))
    (root / "utt2spk").write_text("".join(f"{k} spk\n" for k in wavs))
    jcfg = configs.tiny_config(12)
    acc = cmvn.CmvnAccumulator(jcfg.e2e.frontend.n_mels)
    for _, feats in extract_iter(iter(wavs.items()), jcfg.e2e.frontend,
                                 "fbank", "cpu"):
        acc.add(feats)
    cmvn.save_cmvn_ark(acc.stats(), str(root / "global.ark"))
    cmvn.save_cmvn_ark(acc.stats(), str(root / "spk.ark"), key="spk")
    dirs = {}
    for mode, ark in (("global", "global.ark"), ("speaker", "spk.ark")):
        d = dirs[mode] = str(root / f"exp_{mode}")
        shutil.copytree(exp["port"], d)
        shutil.copy(root / ark, os.path.join(d, "cmvn.ark"))
        with open(os.path.join(d, "config.json")) as f:
            saved = json.load(f)
        saved["joint"]["e2e"]["frontend"]["cmvn"] = mode
        with open(os.path.join(d, "config.json"), "w") as f:
            json.dump(saved, f)
    return {"root": root, "scp": str(root / "wav.scp"),
            "text": str(root / "text"), "utt2spk": str(root / "utt2spk"),
            "spk_ark": str(root / "spk.ark"), **dirs}


def _jax_exit(monkeypatch, argv, cmvn="utterance", input_kind="wav"):
    """The JAX CLI's SystemExit for ``argv``, from an experiment of that
    CMVN mode and input kind (its restore stubbed: the CLI refuses before
    it runs the model)."""
    jcfg = _jax(configs.tiny_config(12))
    jcfg = dataclasses.replace(jcfg, e2e=dataclasses.replace(
        jcfg.e2e, frontend=dataclasses.replace(jcfg.e2e.frontend,
                                               cmvn=cmvn)))
    monkeypatch.setattr(jax_cli, "load_experiment", lambda *a, **kw: (
        None, None, None, jcfg, None, 1, input_kind, False))
    with pytest.raises(SystemExit) as exc:
        jax_cli.main(argv)
    return str(exc.value)


def _port_exit(argv):
    with pytest.raises(SystemExit) as exc:
        cli.main(argv + ["--device", "cpu"])
    return str(exc.value)


def _decoded(exp, ckpt, out, *extra):
    """hyp.txt, wer.json and nbest.jsonl of a port decode."""
    argv = ["--ckpt-dir", ckpt, "--out", str(exp["root"] / out),
            "--batch-size", "4", "--beam-size", "3", "--max-steps", "6",
            "--length-buckets", "16000", "--nbest", "2", "--device", "cpu",
            *extra]
    cli.main(argv)
    return [_read(str(exp["root"] / out / name))
            for name in ("hyp.txt", "wer.json", "nbest.jsonl")]


@pytest.mark.parametrize("flag", [
    ["--noisy-scp", "x.scp", "--text", "text"], ["--feats-scp", "f.scp"],
    ["--utt2num-frames", "u"], ["--index-cache", "c"], ["--utt2spk", "u"],
    ["--cmvn-ark", "c.ark"], ["--pipelined", "on"],
    ["--pipelined", "chunked"]], ids=lambda f: f[0] + f[-1])
def test_unported_flags_raise(exp, kaldi, monkeypatch, tmp_path, flag):
    """The flag of the path that stays unported (the chunked schedule)
    raises; ``--pipelined on`` decodes to the files of ``--pipelined off``
    and of the JAX CLI's ``--pipelined on``; the Kaldi flags do what the
    JAX CLI's do: the same SystemExit, or a decode equal to the one it
    stands for."""
    name = flag[0]
    if flag == ["--pipelined", "chunked"]:
        with pytest.raises(NotImplementedError, match="'Not to port'"):
            cli.main(["--ckpt-dir", str(tmp_path), "--manifest", "m.jsonl",
                      "--device", "cpu", *flag])
        assert not os.listdir(tmp_path)
    elif name == "--pipelined":  # on: two batches, the second padded
        src = ["--manifest", exp["manifest"], "--serving-impls", "xla"]
        got = _decoded(exp, exp["port"], "staged", *src, *flag)
        assert got == _decoded(exp, exp["port"], "sequential", *src,
                               "--pipelined", "off")
        jax_out = _decode(exp, "jax", "jax_staged", "--serving-impls",
                          "xla", "--nbest", "2", *flag)
        want = [_read(os.path.join(jax_out, n))
                for n in ("hyp.txt", "wer.json", "nbest.jsonl")]
        assert got[:2] == want[:2]
        for g, w in zip(*[[json.loads(line) for line in f.splitlines()]
                          for f in (got[2], want[2])]):
            assert [e["tokens"] for e in g["nbest"]] == [
                e["tokens"] for e in w["nbest"]]
            np.testing.assert_allclose([e["score"] for e in g["nbest"]],
                                       [e["score"] for e in w["nbest"]],
                                       rtol=1e-4, atol=1e-3)
    elif name == "--noisy-scp":
        # a wav.scp with its text decodes as the JAX CLI decodes it, and as
        # the manifest it was made from
        src = ["--noisy-scp", kaldi["scp"], "--text", kaldi["text"]]
        got = _decoded(exp, exp["port"], "kaldi_scp", *src)
        jax_cli.main(["--ckpt-dir", exp["jax"], "--out",
                      str(exp["root"] / "jax_scp"), "--batch-size", "4",
                      "--beam-size", "3", "--max-steps", "6",
                      "--length-buckets", "16000", *src])
        assert got[:2] == [_read(str(exp["root"] / "jax_scp" / n))
                           for n in ("hyp.txt", "wer.json")]
        assert got == _decoded(exp, exp["port"], "kaldi_manifest",
                               "--manifest", exp["manifest"])
    elif name == "--feats-scp":  # a waveform experiment
        argv = ["--ckpt-dir", exp["port"], "--feats-scp", "f.scp", "--text",
                kaldi["text"]]
        msg = _port_exit(argv)
        assert msg == _jax_exit(monkeypatch, argv)
        assert "--train-feats-scp" in msg
    elif name == "--utt2num-frames":  # no source
        argv = ["--ckpt-dir", exp["port"], "--utt2num-frames", "u"]
        assert _port_exit(argv) == _jax_exit(monkeypatch, argv)
    elif name == "--index-cache":
        # the same lengths cached as the JAX dataset's; the second decode
        # probes no ark header and decodes the same
        from robust_e2e_gan_torch.data import dataset

        cache = str(tmp_path / "index.json")
        argv = ["--noisy-scp", kaldi["scp"], "--text", kaldi["text"],
                "--index-cache", cache]
        first = _decoded(exp, exp["port"], "cached_1", *argv)
        jax_dataset.AudioTextDataset.from_kaldi(
            kaldi["scp"], kaldi["text"], index_cache=str(tmp_path / "j.json"))
        with open(cache) as a, open(tmp_path / "j.json") as b:
            assert json.load(a) == json.load(b)
        monkeypatch.setattr(dataset, "_probe_shape", None)
        assert _decoded(exp, exp["port"], "cached_2", *argv) == first
    elif name == "--utt2spk":
        # every utterance's speaker holds the global stats: the speaker
        # experiment decodes as the global one, bit for bit
        assert _decoded(exp, kaldi["speaker"], "spk", "--manifest",
                        exp["manifest"], "--utt2spk", kaldi["utt2spk"],
                        "--cmvn-ark", kaldi["spk_ark"]) == _decoded(
            exp, kaldi["global"], "global", "--manifest", exp["manifest"])
    else:  # --cmvn-ark without --utt2spk on a speaker experiment
        argv = ["--ckpt-dir", kaldi["speaker"], "--manifest",
                exp["manifest"], "--cmvn-ark", kaldi["spk_ark"]]
        msg = _port_exit(argv)
        assert msg == _jax_exit(monkeypatch, argv, cmvn="speaker")
        assert "--utt2spk" in msg


MESH_DECODES = {  # tag -> flags of a --mesh-data 2 decode
    "4": ("--batch-size", "4", "--nbest", "2", "--dump-attention"),
    "3": ("--batch-size", "3", "--nbest", "2", "--dump-attention"),
    "4_staged": ("--batch-size", "4", "--nbest", "2", "--pipelined", "on"),
}


@pytest.fixture(scope="module")
def mesh_decodes(exp):
    """Every ``--mesh-data 2`` decode of this file in one launch of two
    gloo ranks: each argv goes through ``cli.main`` up to its launch, and
    one launch runs every rank's ``_decode`` of them in turn. One torch
    thread a rank: beside the suite's other workers, thread hand-offs
    would cost more than the arithmetic."""
    calls = []
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(cli, "launch", lambda fn, mesh, args: calls.append(
            (fn, (args,), {})))
        for tag, extra in MESH_DECODES.items():
            _decode(exp, "port", f"mesh_{tag}", "--mesh-data", "2", *extra)
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        launcher.launch(dp_phases.run_all, make_mesh(2, 1, "cpu"), calls,
                        limit_s=300.0)
    finally:
        torch.set_num_threads(n)
    return {tag: str(exp["root"] / f"mesh_{tag}") for tag in MESH_DECODES}


@pytest.mark.parametrize("batch", ["4", "3"])
def test_mesh_data_decodes_as_one_process(exp, mesh_decodes, batch):
    """``--mesh-data 2``: two gloo ranks decode the rows of each batch that
    divides over them (batches of 4), rank 0 alone each that does not
    (batches of 3); ``hyp.txt`` and ``wer.json`` are byte-identical to one
    process's (and, at 4, to the JAX CLI's ``--mesh-data 2``), the n-best
    lists hold the same hypotheses and the attention maps are the same. At
    4, ``--pipelined on`` stages each rank's rows: its files are the
    sequential ranks', byte for byte."""
    extra = MESH_DECODES[batch]
    one = _decode(exp, "port", f"one_{batch}", *extra)
    got = mesh_decodes[batch]
    names = ("hyp.txt", "wer.json")
    want = [_read(os.path.join(one, n)) for n in names]
    assert [_read(os.path.join(got, n)) for n in names] == want
    if batch == "4":
        jax = _decode(exp, "jax", "jax_mesh", "--mesh-data", "2",
                      "--batch-size", batch)
        assert [_read(os.path.join(jax, n)) for n in names] == want
        staged = mesh_decodes["4_staged"]
        for n in names + ("nbest.jsonl",):
            assert _read(os.path.join(staged, n)) == _read(
                os.path.join(got, n)), n
    rows = [[json.loads(line) for line in _read(os.path.join(d, "nbest.jsonl"))
             .splitlines()] for d in (got, one)]
    for g, w in zip(*rows):
        assert g["utt_id"] == w["utt_id"]
        assert [e["tokens"] for e in g["nbest"]] == [
            e["tokens"] for e in w["nbest"]]
        np.testing.assert_allclose([e["score"] for e in g["nbest"]],
                                   [e["score"] for e in w["nbest"]],
                                   rtol=1e-5, atol=1e-5)
    assert sorted(os.listdir(os.path.join(got, "att"))) == [
        f"u{i}.npy" for i in range(N_UTTS)]
    for i in range(N_UTTS):
        np.testing.assert_allclose(
            np.load(os.path.join(got, "att", f"u{i}.npy")),
            np.load(os.path.join(one, "att", f"u{i}.npy")),
            rtol=1e-5, atol=1e-6)


def test_precomputed_feature_experiment_raises(exp, monkeypatch, tmp_path):
    """A feats experiment decoded from a manifest raises the JAX CLI's
    SystemExit; its discriminator is rebuilt at the features' width."""
    shutil.copytree(exp["port"], tmp_path / "feats_exp")
    with open(tmp_path / "feats_exp" / "config.json") as f:
        saved = json.load(f)
    with open(tmp_path / "feats_exp" / "config.json", "w") as f:
        json.dump({**saved, "input_kind": "feats"}, f)
    argv = ["--ckpt-dir", str(tmp_path / "feats_exp"), "--manifest",
            exp["manifest"]]
    msg = _port_exit(argv)
    assert msg == _jax_exit(monkeypatch, argv, input_kind="feats")
    assert "--feats-scp" in msg
    _, _, _, _, input_kind, log_domain = cli.load_experiment(
        str(tmp_path / "feats_exp"), device="cpu")
    assert (input_kind, log_domain) == ("feats", False)


def test_cli_raises_without_a_gpu(exp, monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    out = tmp_path / "out"
    with pytest.raises(RuntimeError, match="--device cpu"):
        cli.main(["--manifest", exp["manifest"], "--ckpt-dir", exp["port"],
                  "--out", str(out)])
    assert not out.exists()  # refused before writing anything
