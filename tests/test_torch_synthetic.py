"""The port's synthetic data module against the JAX package's: the hard
task's lexicon, transcripts, word splitting, label lists and batch
iterator equal the JAX module's (``make_batch`` itself is held in
``test_torch_guards.py::test_synthetic_batch_matches_jax``)."""

import dataclasses

import pytest

pytest.importorskip("jax")

import numpy as np  # noqa: E402

from robust_e2e_gan_tpu.data import synthetic as jax_synthetic  # noqa: E402
from robust_e2e_gan_torch.data import synthetic  # noqa: E402

# name -> the config, built from either package's synthetic module
TASKS = {
    "default": lambda m: m.SyntheticConfig(),
    "hard": lambda m: m.hard_task(32),
    "lexicon": lambda m: dataclasses.replace(m.hard_task(32), lexicon_size=50),
    "lexicon_seed_3": lambda m: dataclasses.replace(m.hard_task(32, seed=3),
                                                    lexicon_size=20),
}


def test_config_fields_and_properties_match_jax():
    for make in TASKS.values():
        ours, theirs = make(synthetic), make(jax_synthetic)
        assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)
        for prop in ("space_id", "first_token", "num_real_tokens",
                     "max_label_len", "max_samples"):
            assert getattr(ours, prop) == getattr(theirs, prop), prop


@pytest.mark.parametrize("task", ["lexicon", "lexicon_seed_3"])
def test_lexicon_matches_jax(task):
    ours = synthetic.lexicon(TASKS[task](synthetic))
    assert ours == jax_synthetic.lexicon(TASKS[task](jax_synthetic))
    # cached per config, and the caller's list is its own
    ours.clear()
    assert synthetic.lexicon(TASKS[task](synthetic))


@pytest.mark.parametrize("task", list(TASKS))
def test_sample_transcript_matches_jax(task):
    ours_rng, jax_rng = np.random.default_rng(11), np.random.default_rng(11)
    for _ in range(20):
        got = synthetic.sample_transcript(TASKS[task](synthetic), ours_rng)
        want = jax_synthetic.sample_transcript(TASKS[task](jax_synthetic),
                                               jax_rng)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    # the generators stand at the same place afterwards
    assert ours_rng.random() == jax_rng.random()


def test_split_words_and_labels_to_list_match_jax():
    rng = np.random.default_rng(2)
    cfg = synthetic.hard_task(32)
    ys = np.full((6, cfg.max_label_len), -1, np.int32)
    for i in range(6):
        t = synthetic.sample_transcript(cfg, rng)
        ys[i, :len(t)] = t
    ys[5, :4] = [2, 2, 7, 2]  # leading, doubled and trailing spaces
    for ignore_id in (-1, 2):
        assert synthetic.labels_to_list(ys, ignore_id) == (
            jax_synthetic.labels_to_list(ys, ignore_id))
    for row in synthetic.labels_to_list(ys):
        for space_id in (2, 5):
            assert synthetic.split_words(row, space_id) == (
                jax_synthetic.split_words(row, space_id))
    assert synthetic.split_words([], 2) == []


def test_batch_iterator_matches_jax():
    kw = dict(pad_to_samples=30000, ignore_id=-1)
    got = list(synthetic.batch_iterator(
        2, synthetic.hard_task(32, seed=4), 3, **kw))
    want = list(jax_synthetic.batch_iterator(
        2, jax_synthetic.hard_task(32, seed=4), 3, **kw))
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for key in w:
            np.testing.assert_array_equal(g[key], w[key], err_msg=key)
