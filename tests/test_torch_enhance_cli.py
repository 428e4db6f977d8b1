"""The port's ``robust_e2e_gan_torch.decode.enhance_cli`` against the JAX
package's ``decode/enhance_cli.py`` on the CPU: the parameters the port
restores from its experiment dir, handed to the JAX CLI's program in place
of its own restore, enhance the same manifest (a ragged final batch
included) to arks and scps with the same keys, frame counts and values in
both domains, which each package's ``kaldi_io`` reads; the flags of
unported paths raise, and without ``--device cpu`` the CLI raises where
there is no GPU."""

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
                                  ["--text", "text"], ["--mesh-data", "2"]],
                         ids=lambda f: f[0])
def test_unported_flags_raise(tmp_path, flag):
    match = "data parallel" if flag[0] == "--mesh-data" else (
        "Kaldi and precomputed-feature inputs")
    with pytest.raises(NotImplementedError, match=match):
        enhance_cli.main(["--ckpt-dir", str(tmp_path), "--out",
                          str(tmp_path / "e"), "--device", "cpu", *flag])
    assert not os.listdir(tmp_path)


def test_enhance_cli_raises_without_a_gpu(exp, monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    calls = blstm.blstm_infer_plain.calls
    with pytest.raises(RuntimeError, match="--device cpu"):
        enhance_cli.main(["--manifest", exp["manifest"], "--ckpt-dir",
                          exp["port"], "--out", str(tmp_path / "e")])
    assert not os.listdir(tmp_path)  # refused before writing anything
    assert blstm.blstm_infer_plain.calls == calls
