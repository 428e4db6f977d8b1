"""The port's ``train.cli`` on a jsonl manifest of .npy utterances against
the JAX package's on the CPU: the same train batches epoch after epoch,
the same dev batches, the same ``tokenizer.json`` and the same ``--mode
lm`` label batches; a run trains, resumes, and its experiment decodes
through ``decode.cli`` to word and char rates that ``score_cli`` gives
again from ``hyp.txt``."""

import json
import os

import pytest

pytest.importorskip("jax")

import numpy as np  # noqa: E402
import torch  # noqa: E402

from robust_e2e_gan_tpu.data import dataset as jax_dataset  # noqa: E402
from robust_e2e_gan_tpu.train import cli as jax_cli  # noqa: E402
from robust_e2e_gan_tpu.train import lm as jax_train_lm  # noqa: E402
from robust_e2e_gan_torch.data.synthetic import (  # noqa: E402
    SyntheticConfig,
    synth_utterance,
)
from robust_e2e_gan_torch.decode import cli as decode_cli  # noqa: E402
from robust_e2e_gan_torch.decode import score_cli  # noqa: E402
from robust_e2e_gan_torch.train import cli  # noqa: E402

ALPHABET = "abcdefghij"
N_UTTS = 7
TINY = ["--n-mels", "24", "--enc-layers", "1", "--enc-hidden", "32",
        "--enc-proj", "32", "--att-dim", "24", "--dec-hidden", "32",
        "--dec-embed", "16", "--enh-layers", "1", "--enh-hidden", "32",
        "--batch-size", "4", "--length-buckets", "8000,16000",
        "--log-every", "1", "--device", "cpu"]


@pytest.fixture
def one_thread():
    """Tiny eager training steps run on one thread: beside the suite's
    other workers, thread hand-offs would cost more than the arithmetic."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """A manifest of synthetic .npy utterances and a Kaldi text file of
    its references."""
    root = tmp_path_factory.mktemp("train_manifest")
    scfg = SyntheticConfig(vocab_size=12, min_tokens=2, max_tokens=4)
    rng = np.random.default_rng(5)
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
    text = root / "text"
    text.write_text("".join(f"{e['utt_id']} {e['text']}\n" for e in entries))
    return {"root": root, "manifest": str(manifest), "text": str(text)}


def _args(parser, corpus, *extra):
    return parser.parse_args(
        ["--train-manifest", corpus["manifest"], "--dev-manifest",
         corpus["manifest"], "--batch-size", "2", "--seed", "3",
         "--length-buckets", "8000,16000", "--max-label-len", "3",
         "--ckpt-dir", str(corpus["root"] / "unused"), *extra])


def _assert_batches_equal(got, want):
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        assert g["utt_ids"] == w["utt_ids"]
        for k in ("noisy_wav", "clean_wav", "wav_lengths", "labels"):
            assert g[k].dtype == w[k].dtype, k
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)


def test_corpus_factories_match_jax(corpus, tmp_path):
    """Two epochs of train batches (reshuffled by one seeded batcher; the
    longer labels cut to --max-label-len) and the dev batches in order."""
    want = jax_cli._corpus_factories(_args(jax_cli.build_parser(), corpus))
    got = cli._corpus_factories(_args(cli.build_parser(), corpus))
    assert got[2] == want[2] == 13  # the vocabulary of the seen characters
    orders = []
    for _ in range(2):
        g, w = list(got[0]()), list(want[0]())
        _assert_batches_equal(g, w)
        orders.append([b["utt_ids"] for b in g])
    assert orders[0] != orders[1]  # each epoch reshuffles
    _assert_batches_equal(list(got[1]()), list(want[1]()))
    for tag, tok in (("port", got[3]), ("jax", want[3])):
        tok.save(str(tmp_path / f"{tag}.json"))
    assert (tmp_path / "port.json").read_bytes() == (
        tmp_path / "jax.json").read_bytes()


def test_lm_label_batches_match_jax(corpus, monkeypatch, tmp_path):
    """``--mode lm --train-manifest``: a new permutation each epoch from
    one generator, rows -1-padded to --max-label-len; tokenizer.json."""
    argv = ["--mode", "lm", "--train-manifest", corpus["manifest"],
            "--batch-size", "3", "--seed", "4", "--max-label-len", "5"]
    captured = {}
    monkeypatch.setattr(jax_train_lm, "train_lm",
                        lambda lmcfg, tcfg, batches, **kw: captured.update(
                            batches=batches, vocab=lmcfg.vocab_size))
    jax_cli._lm_main(jax_cli.build_parser().parse_args(
        argv + ["--ckpt-dir", str(tmp_path / "jax")]))
    batches, tok = cli._lm_manifest_batches(cli.build_parser().parse_args(
        argv + ["--ckpt-dir", str(tmp_path / "port")]))
    assert tok.vocab_size == captured["vocab"]
    for _ in range(2):
        want, got = list(captured["batches"]()), list(batches())
        assert [g.shape for g in got] == [(3, 5), (3, 5), (1, 5)]
        for g, w in zip(got, want):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)
    assert jax_dataset.CharTokenizer.load(
        str(tmp_path / "jax" / "tokenizer.json")).chars == tok.chars


def test_cli_trains_resumes_decodes_and_scores(corpus, tmp_path, one_thread):
    ckpt = str(tmp_path / "exp")
    argv = ["--mode", "joint", "--train-manifest", corpus["manifest"],
            "--dev-manifest", corpus["manifest"], "--ckpt-dir", ckpt, *TINY]
    cli.main(argv + ["--epochs", "1"])
    with open(os.path.join(ckpt, "checkpoints.json")) as f:
        first = json.load(f)
    assert first["latest"]["step"] == 2 and "best" in first
    cli.main(argv + ["--epochs", "2"])  # resumes: one more epoch
    with open(os.path.join(ckpt, "checkpoints.json")) as f:
        assert json.load(f)["latest"]["step"] == 4
    lines = (corpus["root"] / "manifest.jsonl").read_text().splitlines()
    jax_dataset.CharTokenizer.from_texts(
        [json.loads(line)["text"] for line in lines]).save(
        str(tmp_path / "jax_tokenizer.json"))
    with open(os.path.join(ckpt, "tokenizer.json"), "rb") as f:
        assert f.read() == (tmp_path / "jax_tokenizer.json").read_bytes()

    out = str(tmp_path / "decode")
    decode_cli.main(["--manifest", corpus["manifest"], "--ckpt-dir", ckpt,
                     "--out", out, "--batch-size", "4", "--beam-size", "2",
                     "--max-steps", "5", "--length-buckets", "16000",
                     "--device", "cpu"])
    with open(os.path.join(out, "wer.json")) as f:
        wer = json.load(f)
    report, _ = score_cli.score_files(corpus["text"],
                                      os.path.join(out, "hyp.txt"),
                                      strict=True)
    assert report["n_utts"] == wer["n_utts"] == N_UTTS
    for kind in ("wer", "cer"):
        assert report[kind] == wer[kind]


def test_cli_without_a_source_exits_as_jax(tmp_path):
    argv = ["--ckpt-dir", str(tmp_path)]
    with pytest.raises(SystemExit) as want:
        jax_cli._corpus_factories(jax_cli.build_parser().parse_args(argv))
    with pytest.raises(SystemExit) as got:
        cli.main(argv + ["--device", "cpu"])
    assert str(got.value) == str(want.value)
    assert not os.listdir(tmp_path)
