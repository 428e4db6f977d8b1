"""The port's manifest loader, tokenizer and WER scoring against the JAX
package's ``data/dataset.py`` and ``ops/editdistance.py``."""

import contextlib
import json

import pytest

pytest.importorskip("jax")

import numpy as np  # noqa: E402

from robust_e2e_gan_tpu.data import dataset as jax_dataset  # noqa: E402
from robust_e2e_gan_tpu.ops import editdistance as jax_ed  # noqa: E402
from robust_e2e_gan_torch.data import dataset  # noqa: E402
from robust_e2e_gan_torch.ops import editdistance as ed  # noqa: E402


@pytest.fixture(scope="module")
def manifest(tmp_path_factory):
    """Nine .npy utterances of random lengths and texts, one longer than
    the top bucket and one with more labels than the batcher keeps; one
    without a clean file."""
    root = tmp_path_factory.mktemp("manifest")
    rng = np.random.default_rng(4)
    entries = []
    for i in range(9):
        n = 20000 if i == 4 else int(rng.integers(500, 4000))
        noisy = rng.standard_normal(n).astype(np.float32)
        np.save(root / f"n{i}.npy", noisy)
        entry = {"utt_id": f"u{i}", "noisy": f"n{i}.npy", "n_samples": n,
                 "text": "".join(rng.choice(list("abc de"),
                                            size=12 if i == 6 else 5))}
        if i != 2:
            np.save(root / f"c{i}.npy", noisy * 0.5)
            entry["clean"] = str(root / f"c{i}.npy")  # an absolute path
        entries.append(entry)
    path = root / "m.jsonl"
    path.write_text("\n".join(json.dumps(e) for e in entries) + "\n\n")
    return str(path)


def test_tokenizer_matches_jax(tmp_path):
    texts = ["hello world", "abc", "zz?"]
    ours = dataset.CharTokenizer.from_texts(texts)
    theirs = jax_dataset.CharTokenizer.from_texts(texts)
    assert ours.chars == theirs.chars and ours.vocab_size == theirs.vocab_size
    for text in texts + ["new chars!"]:
        assert ours.encode(text) == theirs.encode(text)
    ids = [0, 1, 2, 3, 7, 11, 2]
    assert ours.decode(ids) == theirs.decode(ids)
    theirs.save(str(tmp_path / "tok.json"))
    loaded = dataset.load_tokenizer(str(tmp_path / "tok.json"))
    assert loaded.chars == theirs.chars
    table = jax_dataset.TableTokenizer({3: "a", 4: "b"})
    table.save(str(tmp_path / "t.json"))
    loaded = dataset.load_tokenizer(str(tmp_path / "t.json"))
    assert isinstance(loaded, dataset.TableTokenizer)
    assert (loaded.id2tok, loaded.sos_eos_id) == (table.id2tok,
                                                 table.sos_eos_id)
    assert loaded.decode([3, 0, 4, 5]) == table.decode([3, 0, 4, 5])


@pytest.mark.parametrize("pad_final,drop_overlong",
                         [(True, True), (False, True), (True, False)])
def test_bucket_batches_match_jax(manifest, pad_final, drop_overlong):
    ours = dataset.AudioTextDataset.from_jsonl(manifest)
    theirs = jax_dataset.AudioTextDataset.from_jsonl(manifest)
    assert [u.text for u in ours.utts] == [u.text for u in theirs.utts]
    kw = dict(batch_size=3, length_buckets=(2000, 4000, 8000),
              max_label_len=8, pad_final=pad_final,
              drop_overlong=drop_overlong)
    got_b = dataset.BucketBatcher(ours, **kw)
    want_b = jax_dataset.BucketBatcher(theirs, **kw)
    assert got_b.batches == want_b.batches
    for shuffle in (False, True):
        # the overlong utterance is clipped, with a warning
        with (contextlib.nullcontext() if drop_overlong
              else pytest.warns(UserWarning)):
            got = list(got_b.epoch(shuffle=shuffle))
        with (contextlib.nullcontext() if drop_overlong
              else pytest.warns(UserWarning)):
            want = list(want_b.epoch(shuffle=shuffle))
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert g["utt_ids"] == w["utt_ids"]
            for key in ("noisy_wav", "clean_wav", "wav_lengths", "labels"):
                assert g[key].dtype == w[key].dtype, key
                np.testing.assert_array_equal(g[key], w[key], err_msg=key)


def test_edit_distance_and_scores_match_jax():
    rng = np.random.default_rng(0)
    refs, hyps = [], []
    for _ in range(20):
        refs.append(list(rng.integers(0, 5, size=int(rng.integers(0, 9)))))
        hyps.append(list(rng.integers(0, 5, size=int(rng.integers(0, 9)))))
    for r, h in zip(refs, hyps):
        assert ed.edit_distance(r, h) == jax_ed.edit_distance(r, h)
        assert ed.align_stats(r, h) == jax_ed.align_stats(r, h)
    assert ed.wer_details(refs, hyps) == jax_ed.wer_details(refs, hyps)
    ref_t = ["the cat sat", "a b c", "", "hello there world"]
    hyp_t = ["the bat sat down", "a c", "x", "hello world"]
    assert ed.score_texts(ref_t, hyp_t) == jax_ed.score_texts(ref_t, hyp_t)
    with pytest.raises(ValueError):
        ed.wer_details([[1]], [])
