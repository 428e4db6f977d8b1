"""The port's Kaldi featbin tools (``data/featbin_cli.py``), the waveform
sources of its ``cmvn`` tool and its unified entry point
(``python -m robust_e2e_gan_torch``) against the JAX package's on the CPU:
``fbank`` log-mel at rtol 1e-4 / atol 1e-5 and log spectra as power at
rtol 1e-4 / atol 1e-6 of the peak, from a wav.scp and a manifest;
``copy-feats`` arks and scps byte-identical at every compression; ``cmvn
--wav-scp`` stats within float32 sums of the JAX ones; the entry point
lists its seven subcommands and exits 2 on an unknown one, and the device
tools raise without a GPU unless asked for the CPU."""

import json

import pytest

pytest.importorskip("jax")

import numpy as np  # noqa: E402
import torch  # noqa: E402

from robust_e2e_gan_tpu.data import cmvn_cli as jax_cmvn_cli  # noqa: E402
from robust_e2e_gan_tpu.data import featbin_cli as jax_featbin  # noqa: E402
from robust_e2e_gan_torch import __main__ as entry  # noqa: E402
from robust_e2e_gan_torch.data import cmvn_cli, featbin_cli  # noqa: E402
from robust_e2e_gan_torch.data import kaldi_io  # noqa: E402
from robust_e2e_gan_torch.data.synthetic import (  # noqa: E402
    SyntheticConfig,
    synth_utterance,
)

SUBCOMMANDS = ("train", "decode", "enhance", "score", "cmvn", "fbank",
               "copy-feats")


@pytest.fixture(scope="module")
def wavs(tmp_path_factory):
    """Four synthetic noisy waveforms of different lengths as a Kaldi
    wav.scp of (1, N) vectors and as a manifest of .npy files."""
    root = tmp_path_factory.mktemp("featbin")
    scfg = SyntheticConfig(vocab_size=12, min_tokens=2, max_tokens=4)
    rng = np.random.default_rng(8)
    data, entries = {}, []
    for i in range(4):
        toks = rng.integers(2, 12, size=(int(rng.integers(2, 5)),))
        _, noisy = synth_utterance(toks.astype(np.int32), scfg, rng)
        data[f"w{i}"] = noisy
        np.save(root / f"w{i}.npy", noisy)
        entries.append({"utt_id": f"w{i}", "noisy": f"w{i}.npy",
                        "n_samples": len(noisy), "text": "ab"})
    kaldi_io.write_ark_scp(((k, v[None]) for k, v in data.items()),
                           str(root / "wav.ark"), str(root / "wav.scp"))
    (root / "m.jsonl").write_text("\n".join(json.dumps(e) for e in entries))
    return {"root": root, "data": data, "scp": str(root / "wav.scp"),
            "manifest": str(root / "m.jsonl")}


@pytest.mark.parametrize("kind,source,dim", [
    ("fbank", "scp", 24), ("spectrogram", "scp", 257),
    ("fbank", "manifest", 24)])
def test_fbank_matches_jax(wavs, kind, source, dim):
    src = (["--wav-scp", wavs["scp"]] if source == "scp"
           else ["--manifest", wavs["manifest"]])
    out = {t: str(wavs["root"] / f"{t}_{kind}_{source}")
           for t in ("port", "jax")}
    argv = [*src, "--feats-kind", kind, "--n-mels", "24"]
    jax_featbin.main_fbank(argv + ["--out-ark", out["jax"] + ".ark",
                                   "--out-scp", out["jax"] + ".scp"])
    featbin_cli.main_fbank(argv + ["--out-ark", out["port"] + ".ark",
                                   "--out-scp", out["port"] + ".scp",
                                   "--device", "cpu"])
    got = list(kaldi_io.read_mat_scp(out["port"] + ".scp"))
    want = dict(kaldi_io.read_mat_scp(out["jax"] + ".scp"))
    assert [k for k, _ in got] == list(wavs["data"])
    for key, mat in got:
        n = len(wavs["data"][key])
        assert mat.shape == want[key].shape == ((n - 400) // 160 + 1, dim)
        if kind == "fbank":
            np.testing.assert_allclose(mat, want[key], rtol=1e-4, atol=1e-5,
                                       err_msg=key)
        else:
            # log power per bin: a bin near silence amplifies the float32
            # DFT sums' rounding (a few 1e-8 of the frame's energy) by
            # 1 / power, so the spectra compare as the power the model
            # reads (pipeline.py::RobustE2E._spec_mask, log_domain)
            got_p, want_p = np.exp(mat), np.exp(want[key])
            np.testing.assert_allclose(got_p, want_p, rtol=1e-4,
                                       atol=1e-6 * want_p.max(), err_msg=key)


@pytest.mark.parametrize("compress", [0, 1, 2, 3])
def test_copy_feats_matches_jax(tmp_path, compress):
    """Byte-identical arks and scps from an scp source (and, compressed,
    from an ark source), each read back by the other package."""
    rng = np.random.default_rng(compress)
    mats = {f"u{i}": (rng.standard_normal((int(rng.integers(2, 30)), 9))
                      * 3).astype(np.float32) for i in range(4)}
    kaldi_io.write_ark_scp(iter(mats.items()), str(tmp_path / "in.ark"),
                           str(tmp_path / "in.scp"))
    for src in (["--feats-scp", str(tmp_path / "in.scp")],
                ["--feats-ark", str(tmp_path / "in.ark")]):
        for tag, main in (("port", featbin_cli.main_copy),
                          ("jax", jax_featbin.main_copy)):
            main([*src, "--out-ark", str(tmp_path / f"{tag}.ark"),
                  "--out-scp", str(tmp_path / f"{tag}.scp"), "--compress",
                  str(compress)])
        assert (tmp_path / "port.ark").read_bytes() == (
            tmp_path / "jax.ark").read_bytes()
        # the scps name their own arks: the same entries, offsets included
        port_scp = (tmp_path / "port.scp").read_text()
        assert port_scp.replace("port.ark", "jax.ark") == (
            tmp_path / "jax.scp").read_text()
    got = dict(kaldi_io.read_mat_scp(str(tmp_path / "port.scp")))
    assert list(got) == list(mats)
    if compress == 0:
        for key, mat in mats.items():
            np.testing.assert_array_equal(got[key], mat)


def test_cmvn_cli_waveform_sources_match_jax(wavs, tmp_path):
    """``cmvn --wav-scp`` and ``--manifest`` run the frontend without CMVN:
    float64 sums of features that agree at rtol 1e-4."""
    jax_cmvn_cli.main(["--wav-scp", wavs["scp"], "--out",
                       str(tmp_path / "jax.ark"), "--n-mels", "24"])
    want = dict(kaldi_io.read_mat_ark(str(tmp_path / "jax.ark")))["global"]
    for src in (["--wav-scp", wavs["scp"]],
                ["--manifest", wavs["manifest"]]):
        cmvn_cli.main([*src, "--out", str(tmp_path / "port.ark"),
                       "--n-mels", "24", "--device", "cpu"])
        got = dict(kaldi_io.read_mat_ark(str(tmp_path / "port.ark")))
        assert list(got) == ["global"]
        assert got["global"].shape == (2, 25)
        assert got["global"][0, -1] == want[0, -1]  # the frame count
        np.testing.assert_allclose(got["global"], want, rtol=1e-4)


def test_device_tools_raise_without_a_gpu(wavs, monkeypatch, tmp_path):
    """``fbank`` and the waveform sources of ``cmvn`` run on the GPU unless
    asked for the CPU, and refuse before writing anything; ``cmvn
    --feats-scp`` and ``copy-feats`` run on the host."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        featbin_cli.main_fbank(["--wav-scp", wavs["scp"], "--out-ark",
                                str(tmp_path / "f.ark")])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cmvn_cli.main(["--wav-scp", wavs["scp"], "--out",
                       str(tmp_path / "c.ark")])
    assert not list(tmp_path.iterdir())
    mats = {"u0": np.ones((3, 4), np.float32)}
    kaldi_io.write_ark_scp(iter(mats.items()), str(tmp_path / "in.ark"),
                           str(tmp_path / "in.scp"))
    cmvn_cli.main(["--feats-scp", str(tmp_path / "in.scp"), "--out",
                   str(tmp_path / "c.ark")])
    featbin_cli.main_copy(["--feats-scp", str(tmp_path / "in.scp"),
                           "--out-ark", str(tmp_path / "o.ark")])
    assert (tmp_path / "c.ark").exists() and (tmp_path / "o.ark").exists()


def test_unified_entry_lists_the_subcommands(capsys):
    for argv, code in ((["--help"], 0), (["-h"], 0), ([], 2),
                       (["mfcc"], 2)):
        with pytest.raises(SystemExit) as exc:
            entry.main(argv)
        assert exc.value.code == code, argv
        out = capsys.readouterr().out
        assert out.startswith("usage: python -m robust_e2e_gan_torch {"
                              + " | ".join(SUBCOMMANDS) + "}")
        for name in SUBCOMMANDS:
            assert f"\n  {name} " in out, name
    assert tuple(entry.COMMANDS) == SUBCOMMANDS


def test_unified_entry_dispatches(tmp_path):
    """``copy-feats`` and ``score`` through the entry point give what
    their modules give."""
    mats = {"u0": np.arange(12, dtype=np.float32).reshape(3, 4)}
    kaldi_io.write_ark_scp(iter(mats.items()), str(tmp_path / "in.ark"),
                           str(tmp_path / "in.scp"))
    entry.main(["copy-feats", "--feats-scp", str(tmp_path / "in.scp"),
                "--out-ark", str(tmp_path / "a.ark")])
    featbin_cli.main_copy(["--feats-scp", str(tmp_path / "in.scp"),
                           "--out-ark", str(tmp_path / "b.ark")])
    assert (tmp_path / "a.ark").read_bytes() == (
        tmp_path / "b.ark").read_bytes()
    (tmp_path / "ref").write_text("u0 a b c\n")
    (tmp_path / "hyp").write_text("u0 a c\n")
    entry.main(["score", "--ref", str(tmp_path / "ref"), "--hyp",
                str(tmp_path / "hyp"), "--out", str(tmp_path / "r.json")])
    report = json.loads((tmp_path / "r.json").read_text())
    assert report["wer"]["error_rate"] == pytest.approx(1 / 3)
