"""The port's CMVN statistics (``data/cmvn.py``) and ``cmvn`` tool
(``data/cmvn_cli.py``) against the JAX package's on the CPU: the
accumulated stats, ``stats_to_mean_inv_std`` and ``SpeakerCmvn.lookup``
bit-equal, the written arks byte-identical, and ``compute_stats`` over a
feats.scp, global and per speaker, bit-equal."""

import pytest

pytest.importorskip("jax")

import numpy as np  # noqa: E402

from robust_e2e_gan_tpu.data import cmvn as jax_cmvn  # noqa: E402
from robust_e2e_gan_tpu.data import cmvn_cli as jax_cmvn_cli  # noqa: E402
from robust_e2e_gan_torch.data import cmvn, cmvn_cli, kaldi_io  # noqa: E402

DIM = 6


def _mats(seed, n=5):
    rng = np.random.default_rng(seed)
    return {f"u{i}": (rng.standard_normal((int(rng.integers(3, 40)), DIM))
                      * (i + 1) + i).astype(np.float32)
            for i in range(n)}


def _assert_bit_equal(got, want):
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def test_accumulator_and_stats_match_jax(tmp_path):
    mats = _mats(0)
    ours, theirs = cmvn.CmvnAccumulator(DIM), jax_cmvn.CmvnAccumulator(DIM)
    mask = (np.arange(len(mats["u1"])) % 3 > 0).astype(np.float32)
    for key, m in mats.items():
        ours.add(m, mask if key == "u1" else None)
        theirs.add(m, mask if key == "u1" else None)
    _assert_bit_equal(ours.stats(), theirs.stats())
    for got, want in zip(ours.mean_inv_std(), theirs.mean_inv_std()):
        _assert_bit_equal(got, want)
    _assert_bit_equal(
        cmvn.compute_cmvn_stats(iter(mats.values()), DIM),
        jax_cmvn.compute_cmvn_stats(iter(mats.values()), DIM))
    with pytest.raises(ValueError, match="expected"):
        ours.add(np.zeros(DIM))

    cmvn.save_cmvn_ark(ours.stats(), str(tmp_path / "port.ark"))
    jax_cmvn.save_cmvn_ark(theirs.stats(), str(tmp_path / "jax.ark"))
    assert (tmp_path / "port.ark").read_bytes() == (
        tmp_path / "jax.ark").read_bytes()
    _assert_bit_equal(cmvn.load_cmvn_ark(str(tmp_path / "jax.ark")),
                      jax_cmvn.load_cmvn_ark(str(tmp_path / "port.ark")))


def test_speaker_cmvn_lookup_matches_jax(tmp_path):
    utt2spk = {"u0": "a", "u1": "b", "u2": "a", "u3": "c"}
    (tmp_path / "utt2spk").write_text(
        "".join(f"{u} {s}\n" for u, s in utt2spk.items()) + "bad line x\n")
    stats = {}
    for spk, seed in (("a", 1), ("b", 2), ("c", 3)):
        acc = cmvn.CmvnAccumulator(DIM)
        for m in _mats(seed, 2).values():
            acc.add(m)
        stats[spk] = acc.stats()
    with open(tmp_path / "spk.ark", "wb") as f:
        for spk, st in stats.items():
            kaldi_io.write_mat(f, spk, st)
    ours = cmvn.SpeakerCmvn.load(str(tmp_path / "spk.ark"),
                                 str(tmp_path / "utt2spk"))
    theirs = jax_cmvn.SpeakerCmvn.load(str(tmp_path / "spk.ark"),
                                       str(tmp_path / "utt2spk"))
    assert ours.utt2spk == theirs.utt2spk == utt2spk
    assert ours.dim == theirs.dim == DIM
    ids = ["u3", "u0", "u1", "u2", "u0"]
    for got, want in zip(ours.lookup(ids), theirs.lookup(ids)):
        _assert_bit_equal(got, want)
    with pytest.raises(KeyError, match="no speaker CMVN stats"):
        ours.lookup(["u9"])
    with pytest.raises(ValueError, match="empty"):
        cmvn.SpeakerCmvn({}, utt2spk)


@pytest.mark.parametrize("per_speaker", [False, True],
                         ids=["global", "utt2spk"])
def test_cmvn_cli_feats_scp_matches_jax(tmp_path, per_speaker):
    """``cmvn --feats-scp`` accumulates on the host: the arks of both
    CLIs hold bit-equal stats in the same order, byte for byte."""
    mats = _mats(4, 6)
    kaldi_io.write_ark_scp(iter(mats.items()), str(tmp_path / "f.ark"),
                           str(tmp_path / "f.scp"))
    extra = []
    if per_speaker:  # u5 has no speaker: skipped with a warning
        (tmp_path / "utt2spk").write_text(
            "".join(f"u{i} s{i % 2}\n" for i in range(5)))
        extra = ["--utt2spk", str(tmp_path / "utt2spk")]
    for tag, main in (("port", cmvn_cli.main), ("jax", jax_cmvn_cli.main)):
        main(["--feats-scp", str(tmp_path / "f.scp"), "--out",
              str(tmp_path / f"{tag}.ark"), *extra])
    assert (tmp_path / "port.ark").read_bytes() == (
        tmp_path / "jax.ark").read_bytes()
    got = dict(kaldi_io.read_mat_ark(str(tmp_path / "port.ark")))
    assert list(got) == (["s0", "s1"] if per_speaker else ["global"])
    utt2spk = ({f"u{i}": f"s{i % 2}" for i in range(5)} if per_speaker
               else None)
    want = jax_cmvn_cli.compute_stats(iter(mats.items()), utt2spk)
    for key, st in cmvn_cli.compute_stats(iter(mats.items()),
                                          utt2spk).items():
        _assert_bit_equal(st, want[key])
    with pytest.raises(SystemExit, match="no utterances"):
        cmvn_cli.compute_stats(iter(mats.items()), {})
