"""The port's ``data/kaldi_io.py`` against the JAX package's on the CPU:
arks and scps written by either are byte-identical, for plain and
compressed (CM, CM2, CM3) matrices and vectors, and each package reads the
other's, by whole file and by scp pointer."""

import pytest

pytest.importorskip("jax")

import numpy as np  # noqa: E402

from robust_e2e_gan_tpu.data import kaldi_io as jax_kio  # noqa: E402
from robust_e2e_gan_torch.data import kaldi_io as kio  # noqa: E402


def _entries(compress):
    rng = np.random.default_rng(compress)
    out = [(f"utt{i}", (rng.standard_normal((int(rng.integers(3, 40)), 13))
                        * (i + 1)).astype(np.float32)) for i in range(4)]
    if not compress:  # vectors are written uncompressed only
        out.append(("vec", rng.standard_normal(7).astype(np.float32)))
    return out


@pytest.mark.parametrize("compress", [0, 1, 2, 3])
def test_kaldi_io_matches_jax(tmp_path, compress):
    ark, scp = str(tmp_path / "feats.ark"), str(tmp_path / "feats.scp")
    written = {}
    for tag, lib in (("jax", jax_kio), ("port", kio)):
        assert lib.write_ark_scp(iter(_entries(compress)), ark, scp,
                                 compress=compress) == len(_entries(compress))
        with open(ark, "rb") as a, open(scp) as s:
            written[tag] = (a.read(), s.read())
    assert written["port"] == written["jax"]  # byte-identical ark and scp

    # the last write is the port's; write the JAX one beside it
    jark, jscp = str(tmp_path / "j.ark"), str(tmp_path / "j.scp")
    jax_kio.write_ark_scp(iter(_entries(compress)), jark, jscp,
                          compress=compress)
    for reader, (a, s) in ((kio, (jark, jscp)), (jax_kio, (ark, scp))):
        by_ark = list(reader.read_mat_ark(a))
        by_scp = list(reader.read_mat_scp(s))
        want = list(jax_kio.read_mat_ark(jark))
        assert [k for k, _ in by_ark] == [k for k, _ in want] == [
            k for k, _ in by_scp]
        for (_, m), (_, w), (_, n) in zip(by_ark, want, by_scp):
            np.testing.assert_array_equal(m, w)
            np.testing.assert_array_equal(n, w)
        index = kio.read_scp_index(s)
        assert index == jax_kio.read_scp_index(s)
        for key, (path, offset) in index.items():
            np.testing.assert_array_equal(kio.read_mat_at(path, offset),
                                          dict(want)[key])
            assert kio.read_shape_at(path, offset) == jax_kio.read_shape_at(
                path, offset)
    if not compress:  # plain float32 blobs round-trip exactly
        for (_, m), (_, w) in zip(kio.read_mat_scp(scp), _entries(0)):
            np.testing.assert_array_equal(m, w)


def test_text_matrix_reads_as_jax(tmp_path):
    path = tmp_path / "stats.ark"
    path.write_bytes(b"spk1  [\n  1 2 3\n  4 5 6 ]\nspk2 [ 7 8 ]\n")
    got = list(kio.read_mat_ark(str(path)))
    want = list(jax_kio.read_mat_ark(str(path)))
    assert [k for k, _ in got] == [k for k, _ in want] == ["spk1", "spk2"]
    for (_, g), (_, w) in zip(got, want):
        np.testing.assert_array_equal(g, w)
