"""The port's host library (``robust_e2e_gan_torch/utils/native.py`` over
``csrc/host``) against its plain versions and the JAX package's native and
Python paths on the CPU: edit distance over random pairs and the corpus
call; ``.npy`` batches in ``<f4`` and ``<f8`` with clipping at ``pad_to``
(a ``<i2`` file raises in both packages) and ``BucketBatcher``'s batches
bit-equal to its numpy collation; Kaldi FM, DM and CM* feature batches
bit-equal to the JAX package's native reader and within ulps of numpy; a
source change rebuilds the library, and threads that ask for it at once
build it once."""

import os
import shutil
import struct
import sys
import threading
import warnings

import pytest

pytest.importorskip("jax")

import numpy as np  # noqa: E402

from robust_e2e_gan_tpu.data import dataset as jax_dataset  # noqa: E402
from robust_e2e_gan_tpu.ops import editdistance as jax_ed  # noqa: E402
from robust_e2e_gan_tpu.utils import native as jax_native  # noqa: E402
from robust_e2e_gan_torch.data import dataset, kaldi_io  # noqa: E402
from robust_e2e_gan_torch.ops import editdistance as ed  # noqa: E402
from robust_e2e_gan_torch.utils import native  # noqa: E402

# the C++ readers decode CM2 and CM3 in float32 arithmetic (three
# roundings), CM's percentile headers in a float32 product, where numpy
# computes in float64: within these many ulps of each matrix's largest
# magnitude (the values near zero come from a cancellation at that scale)
CM_ULPS = {1: 1.0, 2: 3.0, 3: 3.0}


@pytest.fixture(scope="module", autouse=True)
def jax_lib():
    """Both packages' libraries built: the comparisons are native to
    native, never native to a fallback."""
    assert jax_native.get_lib() is not None
    native.get_lib()


def _pairs(rng, n, vocab):
    def seq():
        return [str(x) for x in rng.integers(0, vocab,
                                             size=int(rng.integers(0, 12)))]
    return [seq() for _ in range(n)], [seq() for _ in range(n)]


def test_edit_distance_matches_plain_and_jax(monkeypatch):
    rng = np.random.default_rng(0)
    refs, hyps = _pairs(rng, 200, 5)
    got = [ed.edit_distance(r, h) for r, h in zip(refs, hyps)]
    assert got == [ed.edit_distance_plain(r, h) for r, h in zip(refs, hyps)]
    assert got == [jax_native.native_edit_distance(r, h)
                   for r, h in zip(refs, hyps)]
    monkeypatch.setattr(jax_native, "native_edit_distance",
                        lambda *a: None)  # the JAX package's Python path
    assert got == [jax_ed.edit_distance(r, h) for r, h in zip(refs, hyps)]
    assert ed.edit_distance([], list("ab")) == 2
    assert ed.edit_distance(list("kitten"), list("sitting")) == 3


@pytest.mark.parametrize("n_threads", [1, 3, 0])
def test_corpus_distance_matches_plain_and_jax(monkeypatch, n_threads):
    rng = np.random.default_rng(1)
    refs, hyps = _pairs(rng, 97, 4)
    per, total = native.native_edit_distance_corpus(refs, hyps, n_threads)
    want = [ed.edit_distance_plain(r, h) for r, h in zip(refs, hyps)]
    assert per.dtype == np.int64 and per.tolist() == want
    assert total == sum(want)
    j_per, j_total = jax_native.native_edit_distance_corpus(refs, hyps,
                                                            n_threads)
    np.testing.assert_array_equal(per, j_per)
    assert total == j_total
    report = ed.wer_details(refs, hyps)
    assert report == ed.wer_details_plain(refs, hyps)
    assert report == jax_ed.wer_details(refs, hyps)
    monkeypatch.setattr(jax_native, "native_edit_distance_corpus",
                        lambda *a, **kw: None)
    assert report == jax_ed.wer_details(refs, hyps)
    per, total = native.native_edit_distance_corpus([], [])
    assert (per.shape, total) == ((0,), 0)
    with pytest.raises(ValueError, match="equal length"):
        ed.wer_details(refs, hyps[:-1])


def _write_npys(root, rng):
    """.npy files of both float dtypes and both 2-D vector shapes."""
    paths = []
    for i, (dtype, shape) in enumerate([("<f4", (900,)), ("<f8", (1500,)),
                                        ("<f4", (1, 1200)), ("<f8", (700, 1)),
                                        ("<f4", (2000,))]):
        p = str(root / f"w{i}.npy")
        np.save(p, rng.standard_normal(shape).astype(dtype))
        paths.append(p)
    return paths


def test_npy_batches_match_plain_and_jax(tmp_path):
    """Bit-equal to numpy and to the JAX reader, each file cut at pad_to;
    the lengths the true counts (the collation clamps them)."""
    paths = _write_npys(tmp_path, np.random.default_rng(2))
    pad_to = 1300  # cuts two of the five
    got, n = native.native_load_npy_batch(paths, pad_to)
    plain, lens = dataset.load_npy_batch_plain(paths, pad_to)
    np.testing.assert_array_equal(got, plain)
    assert n.tolist() == [900, 1500, 1200, 700, 2000]
    assert np.minimum(n, pad_to).tolist() == lens.tolist()
    j_got, j_n = jax_native.native_load_npy_batch(paths, pad_to, 2)
    np.testing.assert_array_equal(got, j_got)
    np.testing.assert_array_equal(n, j_n)
    bad = str(tmp_path / "bad.npy")
    np.save(bad, np.zeros(10, "<i2"))
    msg = f"native npy batch load failed on {bad}"
    for load in (native.native_load_npy_batch,
                 jax_native.native_load_npy_batch):
        with pytest.raises(IOError, match=msg):
            load(paths[:2] + [bad], pad_to)


def _manifest_dataset(module, root, paths):
    import json

    lines = [json.dumps({"utt_id": f"u{i}", "noisy": p,
                         "clean": paths[(i + 1) % len(paths)] if i % 2
                         else None, "text": "ab"[: 1 + i % 2],
                         "n_samples": int(np.load(p).size)})
             for i, p in enumerate(paths)]
    (root / "m.jsonl").write_text("\n".join(lines))
    return module.AudioTextDataset.from_jsonl(str(root / "m.jsonl"))


def test_bucket_batcher_reads_npy_natively(tmp_path):
    """``BucketBatcher``'s batches of a manifest (clean pairs, a clipped
    utterance with its warning, a padded final batch) equal its numpy
    collation and the JAX package's batches, bit for bit."""
    paths = _write_npys(tmp_path, np.random.default_rng(3))
    runs = []
    for module, plain in ((dataset, False), (dataset, True),
                          (jax_dataset, False)):
        ds = _manifest_dataset(module, tmp_path, paths)
        batcher = module.BucketBatcher(ds, 2, (1000, 1600),
                                       drop_overlong=False, pad_final=True)
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            if plain:
                with dataset._force_plain_collation():
                    batches = list(batcher.epoch(shuffle=False))
            else:
                batches = list(batcher.epoch(shuffle=False))
        runs.append((batches, [str(w.message) for w in caught
                               if "truncated" in str(w.message)]))
    (got, warned), *others = runs
    assert warned and "e.g. 'u4'" in warned[0]
    assert [b["utt_ids"] for b in got] == [["u3", "u0"], ["u2", "u1"],
                                           ["u4"]]
    for batches, msgs in others:
        assert msgs == warned
        for g, w in zip(got, batches):
            assert g.keys() == w.keys()
            for k in g:
                if k != "utt_ids":
                    assert g[k].dtype == w[k].dtype, k
                np.testing.assert_array_equal(g[k], w[k], err_msg=k)


def _write_dm(path, key, mat):
    """One uncompressed double-precision (DM) entry; its offset."""
    with open(path, "ab") as f:
        f.write(key.encode() + b" ")
        offset = f.tell()
        f.write(b"\x00BDM \x04" + struct.pack("<i", mat.shape[0])
                + b"\x04" + struct.pack("<i", mat.shape[1]))
        f.write(mat.astype("<f8").tobytes())
    return offset


@pytest.mark.parametrize("fmt", [0, 1, 2, 3, "dm"])
def test_kaldi_feats_batches_match_jax_and_plain(tmp_path, fmt):
    """FM and DM bit-equal to numpy; CM, CM2 and CM3 bit-equal to the JAX
    package's C++ reader and within CM_ULPS of numpy; rows cut at
    pad_to."""
    rng = np.random.default_rng(4)
    mats = {f"u{i}": (3 * rng.standard_normal((int(rng.integers(20, 60)),
                                               24)) - 5).astype(np.float32)
            for i in range(6)}
    ark = str(tmp_path / "f.ark")
    if fmt == "dm":
        entries = [(ark, _write_dm(ark, k, m.astype(np.float64) / 3.0))
                   for k, m in mats.items()]
    else:
        kaldi_io.write_ark_scp(iter(mats.items()), ark,
                               str(tmp_path / "f.scp"), compress=fmt)
        entries = list(kaldi_io.read_scp_index(
            str(tmp_path / "f.scp")).values())
    pad_to = 40
    got, n = native.native_load_kaldi_feats_batch(entries, pad_to, 24)
    j_got, j_n = jax_native.native_load_kaldi_feats_batch(entries, pad_to,
                                                          24)
    np.testing.assert_array_equal(got, j_got)
    np.testing.assert_array_equal(n, j_n)
    plain, lens = dataset.load_kaldi_feats_batch_plain(entries, pad_to, 24)
    assert n.tolist() == [len(m) for m in mats.values()]
    assert np.minimum(n, pad_to).tolist() == lens.tolist()
    if fmt in (0, "dm"):
        np.testing.assert_array_equal(got, plain)
    else:
        for g, p in zip(got, plain):
            ulp = np.spacing(np.abs(p).max())
            assert np.abs(g - p).max() <= CM_ULPS[fmt] * ulp
    with pytest.raises(IOError, match="native Kaldi feats batch load"):
        native.native_load_kaldi_feats_batch(entries, pad_to, 23)


@pytest.fixture
def private_build(tmp_path, monkeypatch):
    """The library built from a copy of its sources into a directory of
    this test's own, with every g++ run counted."""
    src = tmp_path / "host"
    shutil.copytree(native.HOST_SRC, src)
    monkeypatch.setattr(native, "HOST_SRC", str(src))
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(native, "LIB_PATH",
                        str(tmp_path / "build" / "librg_host.so"))
    monkeypatch.setattr(native, "_lib", None)
    runs = []
    compile_ = native._compile

    def counted(cmd):
        runs.append(cmd)
        return compile_(cmd)

    monkeypatch.setattr(native, "_compile", counted)
    return src, runs


def test_threads_build_once(private_build):
    """More threads than cores ask for the library at once, with a short
    switch interval: one g++ run, one library object for all."""
    _, runs = private_build
    n = (os.cpu_count() or 1) + 2
    start = threading.Barrier(n)
    libs = []

    def ask():
        start.wait()
        libs.append(native.get_lib())

    threads = [threading.Thread(target=ask) for _ in range(n)]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert len(runs) == 1 and len(libs) == n
    assert all(lib is libs[0] for lib in libs)
    assert native.native_edit_distance(list("abc"), list("abd")) == 1
    assert native.build() == 0.0 and len(runs) == 1


def test_source_change_rebuilds(private_build):
    src, runs = private_build
    assert native.build() > 0.0
    stamp = open(native.LIB_PATH + ".srchash").read()
    assert native.build() == 0.0 and len(runs) == 1
    with open(src / "editdistance.cpp", "a") as f:
        f.write("// a changed source\n")
    assert native.build() > 0.0 and len(runs) == 2
    assert open(native.LIB_PATH + ".srchash").read() != stamp
    leftovers = [f for f in os.listdir(native.BUILD_DIR)
                 if f.endswith(".so") and f != "librg_host.so"]
    assert not leftovers  # the temporary output was moved into place
    with open(src / "editdistance.cpp", "a") as f:
        f.write("this is not C++\n")
    with pytest.raises(RuntimeError, match="g\\+\\+.*editdistance.cpp"):
        native.build()
    assert not [f for f in os.listdir(native.BUILD_DIR)
                if f.endswith(".so") and f != "librg_host.so"]
