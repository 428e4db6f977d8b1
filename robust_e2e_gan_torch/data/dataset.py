"""Dataset and loader: paired noisy/clean utterances -> padded batches.

Port of the ``.npy`` manifest path of ``robust_e2e_gan_tpu/data/dataset.py``:
``CharTokenizer`` (blank 0, sos/eos 1, unk 2, characters from id 3),
``load_tokenizer``, ``Utterance``, ``AudioTextDataset.from_jsonl`` and
``BucketBatcher`` (length-sorted batches padded to a length bucket, labels
padded with ``ignore_id``, an optional padded final batch). Batches are
read with numpy, the JAX package's own path when its native loader is not
built. The Kaldi sources, speaker CMVN, the ``TableTokenizer`` of imported
checkpoints and the prefetch thread are not ported yet (ROADMAP queue 1,
Kaldi and precomputed-feature inputs; JAX msgpack checkpoints and
TableTokenizer; Prefetcher).
"""

from __future__ import annotations

import json
import os
import warnings
from dataclasses import dataclass
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np


class CharTokenizer:
    """Character dictionary: blank=0, sos/eos=1, unk=2, chars from 3."""

    BLANK, SOS_EOS, UNK = 0, 1, 2

    def __init__(self, chars: Sequence[str]):
        self.chars = list(chars)
        self._to_id = {c: i + 3 for i, c in enumerate(self.chars)}

    @classmethod
    def from_texts(cls, texts: Sequence[str]) -> "CharTokenizer":
        return cls(sorted({c for t in texts for c in t}))

    @property
    def vocab_size(self) -> int:
        return 3 + len(self.chars)

    def encode(self, text: str) -> List[int]:
        return [self._to_id.get(c, self.UNK) for c in text]

    def decode(self, ids: Sequence[int]) -> str:
        out = []
        for i in ids:
            i = int(i)
            if i >= 3:
                out.append(self.chars[i - 3])
            elif i == self.UNK:
                out.append("<unk>")
        return "".join(out)

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump({"chars": self.chars}, f)


def load_tokenizer(path: str) -> CharTokenizer:
    """The tokenizer saved at ``path``. The id table of an imported
    reference checkpoint (``"kind": "table"``) raises: loading such
    checkpoints is not ported yet (ROADMAP queue 1, JAX msgpack
    checkpoints and TableTokenizer)."""
    with open(path) as f:
        d = json.load(f)
    if d.get("kind") == "table":
        raise NotImplementedError(
            "TableTokenizer (the id table of an imported reference "
            "checkpoint) is not ported yet (ROADMAP queue 1, JAX msgpack "
            "checkpoints and TableTokenizer)")
    return CharTokenizer(d["chars"])


@dataclass
class Utterance:
    utt_id: str
    text: str
    n_samples: int
    noisy_path: str
    clean_path: Optional[str] = None

    def load(self) -> Tuple[np.ndarray, np.ndarray]:
        """(noisy, clean) float32 waveforms; clean is noisy when absent."""
        noisy = np.load(self.noisy_path).astype(np.float32).reshape(-1)
        clean = (np.load(self.clean_path).astype(np.float32).reshape(-1)
                 if self.clean_path else noisy)
        return noisy, clean


class AudioTextDataset:
    """Paired (noisy, clean, transcript) utterances from disk."""

    def __init__(self, utts: List[Utterance], tokenizer: CharTokenizer):
        self.utts = utts
        self.tokenizer = tokenizer

    def __len__(self) -> int:
        return len(self.utts)

    @classmethod
    def from_jsonl(cls, manifest_path: str,
                   tokenizer: Optional[CharTokenizer] = None
                   ) -> "AudioTextDataset":
        """jsonl manifest: one {"utt_id","noisy","clean","text","n_samples"}
        per line; "noisy"/"clean" are .npy paths (clean optional), relative
        to the manifest's directory unless absolute."""
        root = os.path.dirname(os.path.abspath(manifest_path))

        def resolve(p):
            return p if os.path.isabs(p) else os.path.join(root, p)

        utts = []
        with open(manifest_path) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                d = json.loads(line)
                utts.append(Utterance(
                    utt_id=d["utt_id"], text=d["text"],
                    n_samples=int(d["n_samples"]),
                    noisy_path=resolve(d["noisy"]),
                    clean_path=resolve(d["clean"]) if d.get("clean") else None,
                ))
        if tokenizer is None:
            tokenizer = CharTokenizer.from_texts([u.text for u in utts])
        return cls(utts, tokenizer)


def _bucket_for(n: int, buckets: Sequence[int]) -> int:
    for b in buckets:
        if n <= b:
            return b
    return buckets[-1]


class BucketBatcher:
    """Length-sorted, bucket-padded batches.

    Sorts utterances by length, groups consecutive runs into batches, pads
    each batch's waveforms to its length bucket and labels to
    ``max_label_len``. Each epoch shuffles batch order, not contents.
    ``drop_overlong`` leaves out utterances longer than the top bucket or
    with more than ``max_label_len`` tokens. ``pad_final`` fills a ragged
    final batch up to ``batch_size`` by repeating its last utterance;
    ``utt_ids`` lists only the real ones, so consumers that iterate it
    drop the duplicates.
    """

    def __init__(self, dataset: AudioTextDataset, batch_size: int,
                 length_buckets: Sequence[int] = (32000, 64000, 112000,
                                                  160000),
                 max_label_len: int = 128, ignore_id: int = -1,
                 seed: int = 0, drop_overlong: bool = True,
                 pad_final: bool = False):
        self.ds = dataset
        self.batch_size = batch_size
        self.pad_final = pad_final
        self.buckets = sorted(length_buckets)
        self.max_label_len = max_label_len
        self.ignore_id = ignore_id
        self.rng = np.random.default_rng(seed)
        self.n_clipped = 0
        order = sorted(range(len(dataset)),
                       key=lambda i: dataset.utts[i].n_samples)
        if drop_overlong:
            order = [
                i for i in order
                if dataset.utts[i].n_samples <= self.buckets[-1]
                and len(dataset.tokenizer.encode(dataset.utts[i].text))
                <= max_label_len
            ]
        self.batches = [order[i:i + batch_size]
                        for i in range(0, len(order), batch_size)]

    def __len__(self) -> int:
        return len(self.batches)

    def _collate(self, idxs: List[int]) -> Dict[str, np.ndarray]:
        n_real = len(idxs)
        if self.pad_final and n_real < self.batch_size:
            idxs = list(idxs) + [idxs[-1]] * (self.batch_size - n_real)
        utts = [self.ds.utts[i] for i in idxs]
        pad_to = _bucket_for(max(u.n_samples for u in utts), self.buckets)
        clipped = [u.utt_id for u in utts if u.n_samples > pad_to]
        if clipped:
            # only with drop_overlong=False: the tail past the top bucket
            # is cut, never silently
            self.n_clipped += len(clipped)
            warnings.warn(
                f"{len(clipped)} utterance(s) longer than the top length "
                f"bucket ({pad_to} samples) truncated, e.g. {clipped[0]!r}; "
                f"{self.n_clipped} total so far. Raise length_buckets or "
                "use drop_overlong=True.", stacklevel=2)
        b = len(utts)
        labels = np.full((b, self.max_label_len), self.ignore_id, np.int32)
        noisy = np.zeros((b, pad_to), np.float32)
        clean = np.zeros((b, pad_to), np.float32)
        lengths = np.zeros((b,), np.int32)
        for j, u in enumerate(utts):
            toks = self.ds.tokenizer.encode(u.text)[:self.max_label_len]
            labels[j, :len(toks)] = toks
            nw, cw = u.load()
            n = min(len(nw), pad_to)
            noisy[j, :n] = nw[:n]
            clean[j, :n] = cw[:n]
            lengths[j] = n
        return {
            "noisy_wav": noisy,
            "clean_wav": clean,
            "wav_lengths": lengths,
            "labels": labels,
            "utt_ids": [u.utt_id for u in utts][:n_real],
        }

    def epoch(self, shuffle: bool = True) -> Iterator[Dict[str, np.ndarray]]:
        order = list(range(len(self.batches)))
        if shuffle:
            self.rng.shuffle(order)
        for bi in order:
            yield self._collate(self.batches[bi])
