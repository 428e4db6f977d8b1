"""Global and per-speaker CMVN statistics: accumulate, save and load in
Kaldi's format, look up per batch.

Port of ``robust_e2e_gan_tpu/data/cmvn.py``, numpy on the host. The stats
are Kaldi's (2, dim+1) matrix, row 0 = [sum(x), count] and row 1 =
[sum(x^2), 0], so they interchange with ``compute-cmvn-stats``; the model
applies them on the device (``pipeline.py::RobustE2E.normalize_feats``).
"""

from __future__ import annotations

from typing import Iterable, Optional, Tuple

import numpy as np

from robust_e2e_gan_torch.data import kaldi_io


class CmvnAccumulator:
    """Streaming accumulator over (T, D) feature matrices."""

    def __init__(self, dim: int):
        self.sum = np.zeros(dim, np.float64)
        self.sumsq = np.zeros(dim, np.float64)
        self.count = 0.0

    def add(self, feats: np.ndarray, mask: Optional[np.ndarray] = None):
        f = np.asarray(feats, np.float64)
        if f.ndim != 2:
            raise ValueError(f"expected (T, D), got {f.shape}")
        if mask is not None:
            f = f[np.asarray(mask) > 0]
        self.sum += f.sum(axis=0)
        self.sumsq += (f * f).sum(axis=0)
        self.count += f.shape[0]

    def stats(self) -> np.ndarray:
        """Kaldi-layout (2, D+1) float32 stats matrix."""
        d = self.sum.shape[0]
        out = np.zeros((2, d + 1), np.float64)
        out[0, :d] = self.sum
        out[0, d] = self.count
        out[1, :d] = self.sumsq
        return out.astype(np.float32)

    def mean_inv_std(self, eps: float = 1e-8) -> Tuple[np.ndarray, np.ndarray]:
        return stats_to_mean_inv_std(self.stats(), eps)


def stats_to_mean_inv_std(
    stats: np.ndarray, eps: float = 1e-8
) -> Tuple[np.ndarray, np.ndarray]:
    """Kaldi (2, D+1) stats -> float32 (mean, inv_std)."""
    stats = np.asarray(stats, np.float64)
    d = stats.shape[1] - 1
    count = max(stats[0, d], 1.0)
    mean = stats[0, :d] / count
    var = np.maximum(stats[1, :d] / count - mean * mean, eps)
    return mean.astype(np.float32), (1.0 / np.sqrt(var)).astype(np.float32)


def compute_cmvn_stats(feature_iter: Iterable[np.ndarray],
                       dim: int) -> np.ndarray:
    """Accumulate an iterator of (T, D) matrices -> Kaldi stats."""
    acc = CmvnAccumulator(dim)
    for f in feature_iter:
        acc.add(f)
    return acc.stats()


def save_cmvn_ark(stats: np.ndarray, path: str, key: str = "global") -> None:
    with open(path, "wb") as f:
        kaldi_io.write_mat(f, key, stats)


def load_cmvn_ark(path: str) -> np.ndarray:
    """The first stats matrix of ``path`` (the global one)."""
    _, stats = next(kaldi_io.read_mat_ark(path))
    return stats


class SpeakerCmvn:
    """Per-speaker CMVN with Kaldi ``apply-cmvn --utt2spk`` semantics.

    The stats ark's keys are speaker ids; ``lookup`` stacks each
    utterance's speaker (mean, inv_std) into per-batch arrays, which the
    model applies with ``FrontendConfig.cmvn="speaker"``.
    """

    def __init__(self, spk_stats: dict, utt2spk: dict, eps: float = 1e-8):
        self.utt2spk = utt2spk
        self.by_spk = {spk: stats_to_mean_inv_std(st, eps)
                       for spk, st in spk_stats.items()}
        if not self.by_spk:
            raise ValueError("empty speaker-CMVN stats")
        self.dim = next(iter(self.by_spk.values()))[0].shape[0]

    @classmethod
    def load(cls, cmvn_ark: str, utt2spk_path: str) -> "SpeakerCmvn":
        spk_stats = dict(kaldi_io.read_mat_ark(cmvn_ark))
        utt2spk = {}
        with open(utt2spk_path) as f:
            for line in f:
                parts = line.split()
                if len(parts) == 2:
                    utt2spk[parts[0]] = parts[1]
        return cls(spk_stats, utt2spk)

    def lookup(self, utt_ids) -> Tuple[np.ndarray, np.ndarray]:
        """utt ids -> (mean (B, D), inv_std (B, D)) float32 arrays."""
        means, inv_stds = [], []
        for uid in utt_ids:
            spk = self.utt2spk.get(uid)
            if spk is None or spk not in self.by_spk:
                raise KeyError(f"no speaker CMVN stats for utterance {uid!r} "
                               f"(speaker {spk!r})")
            m, s = self.by_spk[spk]
            means.append(m)
            inv_stds.append(s)
        return np.stack(means), np.stack(inv_stds)
