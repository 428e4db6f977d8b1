"""The port's ``data/dataset.py::Prefetcher`` against the JAX package's on
the CPU: the same batches in the same order over the same batcher, the
worker's error raised by ``next()``, ``close()`` freeing a blocked worker,
the context-manager form, and ``depth=0`` unbounded; ``train()`` collates
on the prefetch thread, and ``train.cli --prefetch-depth`` reaches it."""

import json
import threading

import pytest

pytest.importorskip("jax")

import numpy as np  # noqa: E402
import torch  # noqa: E402

from robust_e2e_gan_tpu.data import dataset as jax_dataset  # noqa: E402
from robust_e2e_gan_torch import configs  # noqa: E402
from robust_e2e_gan_torch.config import TrainConfig  # noqa: E402
from robust_e2e_gan_torch.data import dataset  # noqa: E402
from robust_e2e_gan_torch.data.synthetic import (  # noqa: E402
    SyntheticConfig,
    make_batch,
    synth_utterance,
)
from robust_e2e_gan_torch.train import cli, loop  # noqa: E402

N_UTTS = 7


@pytest.fixture(scope="module")
def manifest(tmp_path_factory):
    root = tmp_path_factory.mktemp("prefetch")
    scfg = SyntheticConfig(vocab_size=12, min_tokens=2, max_tokens=4)
    rng = np.random.default_rng(4)
    entries = []
    for i in range(N_UTTS):
        toks = rng.integers(2, 12, size=(int(rng.integers(2, 5)),))
        clean, noisy = synth_utterance(toks.astype(np.int32), scfg, rng)
        np.save(root / f"n{i}.npy", noisy)
        np.save(root / f"c{i}.npy", clean)
        entries.append({"utt_id": f"u{i}", "noisy": f"n{i}.npy",
                        "clean": f"c{i}.npy", "n_samples": len(clean),
                        "text": "".join("abcdefghij"[t - 2] for t in toks)})
    path = root / "manifest.jsonl"
    path.write_text("\n".join(json.dumps(e) for e in entries))
    return str(path)


def _batchers(manifest, batch_size=2):
    ds = dataset.AudioTextDataset.from_jsonl(manifest)
    jds = jax_dataset.AudioTextDataset.from_jsonl(manifest)
    return (dataset.BucketBatcher(ds, batch_size, (16000,), seed=3),
            jax_dataset.BucketBatcher(jds, batch_size, (16000,), seed=3))


def test_prefetcher_matches_jax(manifest):
    port, jax = _batchers(manifest)
    for _ in range(2):  # two epochs: the shuffle moves on alike
        got = list(dataset.Prefetcher(port.epoch(shuffle=True)))
        want = list(jax_dataset.Prefetcher(jax.epoch(shuffle=True)))
        assert len(got) == len(want) == len(port)
        for g, w in zip(got, want):
            assert g["utt_ids"] == w["utt_ids"]
            for k in ("noisy_wav", "clean_wav", "wav_lengths", "labels"):
                np.testing.assert_array_equal(g[k], w[k])


def _failing(n):
    yield from range(n)
    raise RuntimeError(f"collation failed after {n}")


@pytest.mark.parametrize("cls", [dataset.Prefetcher, jax_dataset.Prefetcher],
                         ids=["port", "jax"])
def test_worker_error_raised_by_next(cls):
    pf = cls(_failing(2), depth=1)
    assert [next(pf), next(pf)] == [0, 1]
    with pytest.raises(RuntimeError, match="collation failed after 2"):
        next(pf)


def test_close_frees_a_blocked_worker_and_context_manager(manifest):
    port, _ = _batchers(manifest, batch_size=1)
    pf = dataset.Prefetcher(port.epoch(shuffle=False), depth=1)
    next(pf)  # the worker is now blocked on the full queue
    pf.close()
    assert not pf.t.is_alive()
    with dataset.Prefetcher(port.epoch(shuffle=False)) as pf2:
        assert sum(1 for _ in pf2) == len(port)
    pf2.t.join(timeout=5.0)
    assert not pf2.t.is_alive()


def test_depth_zero_is_unbounded():
    pf = dataset.Prefetcher(iter(range(50)), depth=0)
    pf.t.join(timeout=5.0)  # the worker never waits for the consumer
    assert not pf.t.is_alive() and pf.q.maxsize == 0
    assert list(pf) == list(range(50))


def test_train_collates_on_the_prefetch_thread(tmp_path):
    """Every batch of an epoch is drawn on the prefetch thread (the first
    draw, which reads the input kind, on the caller's)."""
    scfg = SyntheticConfig(vocab_size=12, min_tokens=2, max_tokens=3)
    threads = []

    def batches():
        rng = np.random.default_rng(0)
        for _ in range(2):
            threads.append(threading.current_thread().name)
            yield make_batch(2, scfg, rng)

    tcfg = TrainConfig(num_epochs=1, checkpoint_dir=str(tmp_path),
                       log_every=1)
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        state = loop.train(configs.tiny_config(12), tcfg, batches,
                           mode="asr", device="cpu", prefetch_depth=1)
    finally:
        torch.set_num_threads(n)
    assert state.step == 2
    assert threads == [threading.current_thread().name, "prefetch",
                       "prefetch"]


def test_cli_passes_the_prefetch_depth(tmp_path, monkeypatch):
    seen = {}
    monkeypatch.setattr(loop, "train", lambda *a, **kw: seen.update(kw))
    cli.main(["--synthetic", "--synthetic-utts", "4", "--batch-size", "2",
              "--ckpt-dir", str(tmp_path), "--prefetch-depth", "5",
              "--device", "cpu"])
    assert seen["prefetch_depth"] == 5 and seen["mesh"] is None
