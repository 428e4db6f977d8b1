"""Dataset and loader: paired noisy/clean utterances -> padded batches.

Port of ``robust_e2e_gan_tpu/data/dataset.py``: ``CharTokenizer`` (blank
0, sos/eos 1, unk 2, characters from id 3), ``TableTokenizer`` (the
reference's own id table, as an imported checkpoint carries it),
``load_tokenizer``,
``Utterance``, the sources (``AudioTextDataset.from_jsonl`` of ``.npy``
waveforms, ``from_kaldi`` of Kaldi waveform scp files, ``from_kaldi_feats``
of precomputed feats.scp matrices, with utterance lengths from a Kaldi
length map, a header-only probe of each ark entry, or an index cache keyed
by the scp's fingerprint) and ``BucketBatcher`` (length-sorted batches
padded to a length bucket, labels padded with ``ignore_id``, an optional
padded final batch, per-speaker CMVN stats with each batch). Batches are
read with numpy, the JAX package's own path when its native loader is not
built. The prefetch thread is not ported yet (ROADMAP queue 1,
Prefetcher).
"""
from __future__ import annotations

import json
import os
import warnings
from dataclasses import dataclass
from typing import Any, Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from robust_e2e_gan_torch.data import kaldi_io


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


class TableTokenizer:
    """An explicit token <-> id table in a reference's own id layout
    (ESPnet-era: blank 0, units at their ``units.txt`` ids, the shared
    sos/eos after the last unit), which ``CharTokenizer``'s fixed layout
    cannot hold. ``E2EConfig``'s blank, sos and eos ids carry the special
    ids (``tools/import_reference_ckpt.py --units`` sets both)."""

    def __init__(self, id2tok: Dict[int, str], blank_id: int = 0,
                 sos_eos_id: Optional[int] = None,
                 unk_id: Optional[int] = None):
        self.id2tok = {int(k): v for k, v in id2tok.items()}
        self.blank_id = blank_id
        self.sos_eos_id = (max(self.id2tok) + 1 if sos_eos_id is None
                           else sos_eos_id)
        self.unk_id = unk_id
        self._to_id = {v: k for k, v in self.id2tok.items()}

    @classmethod
    def from_units(cls, path: str) -> "TableTokenizer":
        """A Kaldi/ESPnet ``units.txt``: one "token id" pair a line; blank
        0 implicit, sos/eos after the last unit id."""
        id2tok = {}
        with open(path) as f:
            for line in f:
                parts = line.split()
                if parts:
                    id2tok[int(parts[1])] = parts[0]
        unk = next((i for i, t in id2tok.items() if t.lower() == "<unk>"),
                   None)
        return cls(id2tok, blank_id=0, unk_id=unk)

    @property
    def vocab_size(self) -> int:
        return self.sos_eos_id + 1

    def encode(self, text: str) -> List[int]:
        unk = self.unk_id if self.unk_id is not None else self.blank_id
        return [self._to_id.get(c, unk) for c in text]

    def decode(self, ids: Sequence[int]) -> str:
        skip = {self.blank_id, self.sos_eos_id}
        return "".join(self.id2tok.get(int(i), "<unk>")
                       for i in ids if int(i) not in skip)

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump({"kind": "table",
                       "id2tok": {str(k): v for k, v in self.id2tok.items()},
                       "blank_id": self.blank_id,
                       "sos_eos_id": self.sos_eos_id,
                       "unk_id": self.unk_id}, f)

    @classmethod
    def load(cls, path: str) -> "TableTokenizer":
        with open(path) as f:
            return cls._of(json.load(f))

    @classmethod
    def _of(cls, d: Dict[str, Any]) -> "TableTokenizer":
        return cls(d["id2tok"], d.get("blank_id", 0), d.get("sos_eos_id"),
                   d.get("unk_id"))


def load_tokenizer(path: str):
    """The tokenizer saved at ``path``: a ``TableTokenizer`` where the
    file says ``"kind": "table"``, else a ``CharTokenizer``."""
    with open(path) as f:
        d = json.load(f)
    if d.get("kind") == "table":
        return TableTokenizer._of(d)
    return CharTokenizer(d["chars"])


@dataclass
class Utterance:
    utt_id: str
    text: str
    n_samples: int
    # exactly one of (noisy_path, noisy_ark, feats_ark) is set per source
    # kind; for feats_ark utterances n_samples counts frames, not samples
    noisy_path: Optional[str] = None
    clean_path: Optional[str] = None
    noisy_ark: Optional[Tuple[str, int]] = None
    clean_ark: Optional[Tuple[str, int]] = None
    feats_ark: Optional[Tuple[str, int]] = None
    clean_feats_ark: Optional[Tuple[str, int]] = None  # spec-joint pairing

    def load_feats(self) -> np.ndarray:
        """(T, D) precomputed feature matrix (Kaldi feats.scp source)."""
        return kaldi_io.read_mat_at(*self.feats_ark).astype(np.float32)

    def load_clean_feats(self) -> np.ndarray:
        return kaldi_io.read_mat_at(*self.clean_feats_ark).astype(np.float32)

    def load(self) -> Tuple[np.ndarray, np.ndarray]:
        """(noisy, clean) float32 waveforms; clean is noisy when absent."""
        if self.noisy_path is not None:
            noisy = np.load(self.noisy_path).astype(np.float32).reshape(-1)
            clean = (np.load(self.clean_path).astype(np.float32).reshape(-1)
                     if self.clean_path else noisy)
        else:
            noisy = kaldi_io.read_mat_at(*self.noisy_ark).reshape(-1)
            clean = (kaldi_io.read_mat_at(*self.clean_ark).reshape(-1)
                     if self.clean_ark else noisy)
        return noisy.astype(np.float32), clean.astype(np.float32)


def _read_kv_file(path: str) -> Dict[str, str]:
    """Kaldi ``text``-style ``<key> <value...>`` map."""
    out: Dict[str, str] = {}
    with open(path) as f:
        for line in f:
            parts = line.strip().split(None, 1)
            if len(parts) == 2:
                out[parts[0]] = parts[1]
    return out


def _read_len_file(path: str) -> Dict[str, int]:
    """``<utt> <int>`` map (utt2num_frames / utt2num_samples)."""
    return {k: int(v) for k, v in _read_kv_file(path).items()}


# one open handle per ark while an index is built (scp files group their
# entries by ark, so probing reuses the handle)
_probe_files: Dict[str, Any] = {}


def _probe_shape(ark: str, off: int) -> Tuple[int, int]:
    f = _probe_files.get(ark)
    if f is None:
        f = _probe_files[ark] = open(ark, "rb")
    f.seek(off)
    return kaldi_io.read_shape(f)


def _close_probes() -> None:
    for f in _probe_files.values():
        f.close()
    _probe_files.clear()


def _scp_fingerprint(scp_path: str) -> Dict[str, Any]:
    st = os.stat(scp_path)
    return {"scp": os.path.abspath(scp_path), "size": st.st_size,
            "mtime_ns": st.st_mtime_ns}


def _load_length_cache(scp_path: str,
                       cache_path: Optional[str]) -> Dict[str, int]:
    """Lengths from an index cache, if it matches the scp's current
    fingerprint (path, size, mtime); stale or missing -> {}."""
    if not cache_path or not os.path.exists(cache_path):
        return {}
    try:
        with open(cache_path) as f:
            d = json.load(f)
        if d.get("fingerprint") == _scp_fingerprint(scp_path):
            return {k: int(v) for k, v in d["lengths"].items()}
    except (OSError, ValueError, KeyError):
        pass
    return {}


def _write_length_cache(scp_path: str, cache_path: Optional[str],
                        lengths: Dict[str, int]) -> None:
    if not cache_path:
        return
    tmp = cache_path + ".tmp"
    with open(tmp, "w") as f:
        json.dump({"fingerprint": _scp_fingerprint(scp_path),
                   "lengths": lengths}, f)
    os.replace(tmp, cache_path)


def _kaldi_index(scp: str, texts: Dict[str, str], lengths: Dict[str, int],
                 index_cache: Optional[str], length_of) -> List[tuple]:
    """(key, (ark, offset), length) of each scp entry with a transcript:
    the length from ``lengths``, else the index cache, else
    ``length_of(rows, cols)`` of a header probe; probed lengths are added
    to the cache."""
    cached = _load_length_cache(scp, index_cache)
    probed: Dict[str, int] = {}
    out = []
    for key, (ark, off) in kaldi_io.read_scp_index(scp).items():
        if key not in texts:
            continue
        n = lengths.get(key)
        if n is None:
            n = cached.get(key)
        if n is None:
            n = probed[key] = length_of(*_probe_shape(ark, off))
        out.append((key, (ark, off), n))
    _close_probes()
    if probed:
        _write_length_cache(scp, index_cache, {**cached, **probed})
    return out


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

    @classmethod
    def from_kaldi(cls, noisy_scp: str, text_path: str,
                   clean_scp: Optional[str] = None,
                   tokenizer: Optional[CharTokenizer] = None,
                   lengths_path: Optional[str] = None,
                   index_cache: Optional[str] = None) -> "AudioTextDataset":
        """Kaldi waveform source: scp files of float vectors (one an
        utterance) and a ``text`` file; only keys with a transcript.

        Lengths come from ``lengths_path`` (a ``<utt> <n>`` map of sample
        counts) when given, else from a header-only probe of each entry;
        with ``index_cache`` the probed lengths persist there and are
        reused while the scp's size and mtime match.
        """
        clean_idx = kaldi_io.read_scp_index(clean_scp) if clean_scp else {}
        texts = _read_kv_file(text_path)
        lengths = _read_len_file(lengths_path) if lengths_path else {}
        utts = [Utterance(utt_id=key, text=texts[key], n_samples=n,
                          noisy_ark=loc, clean_ark=clean_idx.get(key))
                for key, loc, n in _kaldi_index(
                    noisy_scp, texts, lengths, index_cache,
                    lambda r, c: r * c)]
        if tokenizer is None:
            tokenizer = CharTokenizer.from_texts([u.text for u in utts])
        return cls(utts, tokenizer)

    @classmethod
    def from_kaldi_feats(cls, feats_scp: str, text_path: str,
                         tokenizer: Optional[CharTokenizer] = None,
                         utt2num_frames: Optional[str] = None,
                         clean_scp: Optional[str] = None,
                         index_cache: Optional[str] = None
                         ) -> "AudioTextDataset":
        """Kaldi precomputed-features source: a feats.scp of (T, D)
        matrices (compressed CM* arks decode as they are read). Batches
        carry "feats"/"feat_lengths" instead of waveforms, and the length
        buckets count frames.

        Frame counts come from ``utt2num_frames`` when given, else from a
        header probe (a compressed payload is not decompressed), cached as
        in ``from_kaldi``. ``clean_scp`` pairs clean matrices by key (the
        spectrogram joint path).
        """
        clean_idx = kaldi_io.read_scp_index(clean_scp) if clean_scp else {}
        texts = _read_kv_file(text_path)
        frames = _read_len_file(utt2num_frames) if utt2num_frames else {}
        utts = [Utterance(utt_id=key, text=texts[key], n_samples=t,
                          feats_ark=loc, clean_feats_ark=clean_idx.get(key))
                for key, loc, t in _kaldi_index(
                    feats_scp, texts, frames, index_cache,
                    lambda r, c: r)]
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
    drop the duplicates. ``speaker_cmvn`` (``data/cmvn.py::SpeakerCmvn``)
    adds each row's speaker stats as "cmvn_mean"/"cmvn_inv_std". A
    feats.scp source gives "feats", "feat_lengths" and, where every row
    has its pair, "clean_feats" instead of waveforms.
    """

    def __init__(self, dataset: AudioTextDataset, batch_size: int,
                 length_buckets: Sequence[int] = (32000, 64000, 112000,
                                                  160000),
                 max_label_len: int = 128, ignore_id: int = -1,
                 seed: int = 0, drop_overlong: bool = True,
                 speaker_cmvn=None, pad_final: bool = False):
        self.ds = dataset
        self.batch_size = batch_size
        self.pad_final = pad_final
        self.buckets = sorted(length_buckets)
        self.max_label_len = max_label_len
        self.ignore_id = ignore_id
        self.speaker_cmvn = speaker_cmvn
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
        ids = []
        for j, u in enumerate(utts):
            toks = self.ds.tokenizer.encode(u.text)[:self.max_label_len]
            labels[j, :len(toks)] = toks
            ids.append(u.utt_id)
        if all(u.feats_ark is not None for u in utts):
            # precomputed features: (B, T_bucket, D), buckets in frames
            if not hasattr(self, "_feat_dim"):
                self._feat_dim = kaldi_io.read_shape_at(
                    *utts[0].feats_ark)[1]

            def load_batch(entries):
                m = np.zeros((b, pad_to, self._feat_dim), np.float32)
                ls = np.zeros((b,), np.int32)
                for j, e in enumerate(entries):
                    mat = kaldi_io.read_mat_at(*e).astype(np.float32)
                    n = min(mat.shape[0], pad_to)
                    m[j, :n] = mat[:n]
                    ls[j] = n
                return m, ls

            feats, flens = load_batch([u.feats_ark for u in utts])
            batch = {"feats": feats, "feat_lengths": flens,
                     "labels": labels, "utt_ids": ids[:n_real]}
            if all(u.clean_feats_ark is not None for u in utts):
                batch["clean_feats"], _ = load_batch(
                    [u.clean_feats_ark for u in utts])
        else:
            noisy = np.zeros((b, pad_to), np.float32)
            clean = np.zeros((b, pad_to), np.float32)
            lengths = np.zeros((b,), np.int32)
            for j, u in enumerate(utts):
                nw, cw = u.load()
                n = min(len(nw), pad_to)
                noisy[j, :n] = nw[:n]
                clean[j, :n] = cw[:n]
                lengths[j] = n
            batch = {"noisy_wav": noisy, "clean_wav": clean,
                     "wav_lengths": lengths, "labels": labels,
                     "utt_ids": ids[:n_real]}
        if self.speaker_cmvn is not None:
            batch["cmvn_mean"], batch["cmvn_inv_std"] = (
                self.speaker_cmvn.lookup(ids))
        return batch

    def epoch(self, shuffle: bool = True) -> Iterator[Dict[str, np.ndarray]]:
        order = list(range(len(self.batches)))
        if shuffle:
            self.rng.shuffle(order)
        for bi in order:
            yield self._collate(self.batches[bi])
