"""The port's ``robust_e2e_gan_torch.decode.enhance_cli`` against the JAX
package's ``decode/enhance_cli.py`` on the CPU: the parameters the port
restores from its experiment dir, handed to the JAX CLI's program in place
of its own restore, enhance the same manifest (a ragged final batch
included) to arks and scps with the same keys, frame counts and values in
both domains, which each package's ``kaldi_io`` reads; a Kaldi wav.scp
enhances as the manifest it was made from; ``--mesh-data 2`` enhances
over two gloo ranks to one process's features and the JAX CLI's
``--mesh-data 2``; a Kaldi flag without its pair raises, and without
``--device cpu`` the CLI raises where there is no GPU."""

import dataclasses
import json
import os
import types

import pytest

pytest.importorskip("jax")

import numpy as np  # noqa: E402
import torch  # noqa: E402

from robust_e2e_gan_tpu import config as jax_config  # noqa: E402
from robust_e2e_gan_tpu.data import kaldi_io as jax_kio  # noqa: E402
from robust_e2e_gan_tpu.decode import enhance_cli as jax_enhance  # noqa: E402
from robust_e2e_gan_tpu.pipeline import build_model as jax_build_model  # noqa: E402
from robust_e2e_gan_torch import configs  # noqa: E402
from robust_e2e_gan_torch.config import TrainConfig  # noqa: E402
from robust_e2e_gan_torch.convert import to_flax  # noqa: E402
from robust_e2e_gan_torch.data import kaldi_io  # noqa: E402
from robust_e2e_gan_torch.data.synthetic import (  # noqa: E402
    SyntheticConfig,
    synth_utterance,
)
from robust_e2e_gan_torch.decode import enhance_cli  # noqa: E402
from robust_e2e_gan_torch.ops import blstm  # noqa: E402
from robust_e2e_gan_torch.parallel import launcher  # noqa: E402
from robust_e2e_gan_torch.train.loop import init_state  # noqa: E402
from robust_e2e_gan_torch.utils import checkpoint as ckpt_lib  # noqa: E402

N_UTTS = 5  # batches of 4: the final batch is ragged and padded


@pytest.fixture(scope="module")
def exp(tmp_path_factory):
    """A manifest of synthetic .npy utterances and a port experiment dir
    (``test_torch_decode_cli.py``'s pattern), and its parameters in the
    flax layout."""
    root = tmp_path_factory.mktemp("enhance_cli")
    scfg = SyntheticConfig(vocab_size=12, min_tokens=2, max_tokens=4)
    rng = np.random.default_rng(1)
    entries = []
    for i in range(N_UTTS):
        toks = rng.integers(2, 12, size=(int(rng.integers(2, 5)),))
        _, noisy = synth_utterance(toks.astype(np.int32), scfg, rng)
        np.save(root / f"n{i}.npy", noisy)
        entries.append({"utt_id": f"u{i}", "noisy": f"n{i}.npy",
                        "n_samples": len(noisy), "text": "ab"})
    manifest = root / "manifest.jsonl"
    manifest.write_text("\n".join(json.dumps(e) for e in entries))

    jcfg = configs.tiny_config(12)
    tcfg = TrainConfig(optimizer="adam", learning_rate=1e-3, seed=5)
    port_dir = str(root / "port_exp")
    os.makedirs(port_dir)
    with open(os.path.join(port_dir, "config.json"), "w") as f:
        json.dump({"joint": dataclasses.asdict(jcfg),
                   "train": dataclasses.asdict(tcfg), "mode": "joint",
                   "input_kind": "wav"}, f)
    port = init_state(jcfg, tcfg, "cpu")
    ckpt_lib.save_checkpoint(port_dir, port, 1)
    jj = jax_config.from_dict(jax_config.JointConfig, dataclasses.asdict(jcfg))
    return {"root": root, "manifest": str(manifest), "entries": entries,
            "port": port_dir, "jax_model": jax_build_model(jj),
            "params": to_flax(port.model.state_dict())}


def _jax_enhance(exp, monkeypatch, argv):
    """The JAX CLI with the port's parameters in place of its restore."""
    state = types.SimpleNamespace(params_g=exp["params"])
    monkeypatch.setattr(jax_enhance, "load_experiment", lambda *a, **kw: (
        exp["jax_model"], None, state, None, None, 1, None, None))
    jax_enhance.main(argv)


@pytest.mark.parametrize("domain,dim", [("logmel", 24), ("power", 257)])
def test_enhance_cli_matches_jax(exp, monkeypatch, domain, dim):
    out = {w: str(exp["root"] / f"{w}_{domain}") for w in ("jax", "port")}
    argv = ["--manifest", exp["manifest"], "--ckpt-dir", exp["port"],
            "--domain", domain, "--batch-size", "4", "--length-buckets",
            "16000"]
    _jax_enhance(exp, monkeypatch, argv + ["--out", out["jax"]])
    enhance_cli.main(argv + ["--out", out["port"], "--device", "cpu"])
    # each package reads the other's scp
    got = dict(jax_kio.read_mat_scp(out["port"] + ".scp"))
    want = dict(kaldi_io.read_mat_scp(out["jax"] + ".scp"))
    assert sorted(got) == sorted(want) == [f"u{i}" for i in range(N_UTTS)]
    for e in exp["entries"]:
        g, w = got[e["utt_id"]], want[e["utt_id"]]
        assert g.shape == w.shape == ((e["n_samples"] - 400) // 160 + 1, dim)
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("flag", [["--noisy-scp", "wav.scp"],
                                  ["--text", "text"]], ids=lambda f: f[0])
def test_unported_flags_raise(exp, monkeypatch, tmp_path, flag):
    """A Kaldi flag without its pair raises the JAX CLI's SystemExit,
    before anything is written."""
    argv = ["--ckpt-dir", exp["port"], "--out", str(tmp_path / "e"), *flag]
    with pytest.raises(SystemExit) as port:
        enhance_cli.main(argv + ["--device", "cpu"])
    with pytest.raises(SystemExit) as jax_exit:
        _jax_enhance(exp, monkeypatch, argv)
    assert str(port.value) == str(jax_exit.value) == (
        "need --manifest or --noisy-scp/--text")
    assert not os.listdir(tmp_path)


@pytest.fixture
def one_thread():
    """One torch thread here, and so one a rank: beside the suite's other
    workers, thread hand-offs would cost more than the arithmetic."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("batch", ["4", "3"])
def test_mesh_data_enhances_as_one_process(exp, monkeypatch, batch,
                                           one_thread):
    """``--mesh-data 2``: two gloo ranks enhance the rows of each batch
    that divides over them (batches of 4), rank 0 alone each that does not
    (batches of 3); the features equal one process's at rtol/atol 1e-5
    (``tests/test_cli.py:606-610``), and at 4 the JAX CLI's ``--mesh-data
    2`` at the tolerance of ``test_enhance_cli_matches_jax``."""
    monkeypatch.setattr(launcher, "DEFAULT_LIMIT_S", 300.0)
    argv = ["--manifest", exp["manifest"], "--ckpt-dir", exp["port"],
            "--batch-size", batch, "--length-buckets", "16000"]
    out = {w: str(exp["root"] / f"{w}_mesh_{batch}")
           for w in ("one", "mesh", "jax")}
    enhance_cli.main(argv + ["--out", out["one"], "--device", "cpu"])
    enhance_cli.main(argv + ["--out", out["mesh"], "--mesh-data", "2",
                             "--device", "cpu"])
    want = dict(kaldi_io.read_mat_scp(out["one"] + ".scp"))
    got = dict(kaldi_io.read_mat_scp(out["mesh"] + ".scp"))
    assert list(got) == list(want)
    assert sorted(got) == [f"u{i}" for i in range(N_UTTS)]
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=1e-5)
    if batch == "4":
        _jax_enhance(exp, monkeypatch, argv + ["--out", out["jax"],
                                               "--mesh-data", "2"])
        jax = dict(jax_kio.read_mat_scp(out["jax"] + ".scp"))
        for k in want:
            np.testing.assert_allclose(got[k], jax[k], rtol=1e-4, atol=1e-5)


def test_enhance_cli_from_a_wav_scp(exp, monkeypatch, tmp_path):
    """A Kaldi wav.scp and text enhance as the JAX CLI enhances them, and
    to the ark and scp of the manifest they were made from, byte for
    byte."""
    wavs = {e["utt_id"]: np.load(exp["root"] / e["noisy"])
            for e in exp["entries"]}
    kaldi_io.write_ark_scp(((k, v[None]) for k, v in wavs.items()),
                           str(tmp_path / "wav.ark"), str(tmp_path / "wav.scp"))
    (tmp_path / "text").write_text("".join(f"{k} ab\n" for k in wavs))
    out = {}
    for tag, src in (("scp", ["--noisy-scp", str(tmp_path / "wav.scp"),
                              "--text", str(tmp_path / "text")]),
                     ("manifest", ["--manifest", exp["manifest"]])):
        out[tag] = tmp_path / tag
        enhance_cli.main([*src, "--ckpt-dir", exp["port"], "--out",
                          str(out[tag]), "--batch-size", "4",
                          "--length-buckets", "16000", "--device", "cpu"])
    _jax_enhance(exp, monkeypatch, [
        "--noisy-scp", str(tmp_path / "wav.scp"), "--text",
        str(tmp_path / "text"), "--ckpt-dir", exp["port"], "--out",
        str(tmp_path / "jax"), "--batch-size", "4", "--length-buckets",
        "16000"])
    got = dict(kaldi_io.read_mat_scp(str(tmp_path / "scp.scp")))
    want = dict(jax_kio.read_mat_scp(str(tmp_path / "jax.scp")))
    assert sorted(got) == sorted(want) == sorted(wavs)
    for k in wavs:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, atol=1e-5)
    assert (tmp_path / "scp.ark").read_bytes() == (
        tmp_path / "manifest.ark").read_bytes()
    assert (tmp_path / "scp.scp").read_text().replace("scp.ark", "x") == (
        tmp_path / "manifest.scp").read_text().replace("manifest.ark", "x")


def test_enhance_cli_raises_without_a_gpu(exp, monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    calls = blstm.blstm_infer_plain.calls
    with pytest.raises(RuntimeError, match="--device cpu"):
        enhance_cli.main(["--manifest", exp["manifest"], "--ckpt-dir",
                          exp["port"], "--out", str(tmp_path / "e")])
    assert not os.listdir(tmp_path)  # refused before writing anything
    assert blstm.blstm_infer_plain.calls == calls
