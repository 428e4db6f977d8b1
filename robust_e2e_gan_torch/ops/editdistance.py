"""WER/CER scoring: Levenshtein edit distance, on the host.

Port of ``robust_e2e_gan_tpu/ops/editdistance.py`` in pure Python, the JAX
package's own form when its C++ binding is not built (the binding is not
ported yet): ``edit_distance``, ``wer_details``, ``bootstrap_wer_ci``,
``score_texts`` and ``align_stats``.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np


def edit_distance(ref: Sequence, hyp: Sequence) -> int:
    """Levenshtein distance between two token sequences."""
    n, m = len(ref), len(hyp)
    if n == 0:
        return m
    if m == 0:
        return n
    prev = list(range(m + 1))
    for i in range(1, n + 1):
        cur = [i] + [0] * m
        ri = ref[i - 1]
        for j in range(1, m + 1):
            cost = 0 if ri == hyp[j - 1] else 1
            cur[j] = min(prev[j] + 1, cur[j - 1] + 1, prev[j - 1] + cost)
        prev = cur
    return prev[m]


def wer_details(refs: List[Sequence], hyps: List[Sequence]
                ) -> Dict[str, float]:
    """Corpus-level error rate: sum(edit) / sum(ref_len), for word or
    character sequences alike."""
    if len(refs) != len(hyps):
        raise ValueError("refs and hyps must have equal length")
    total = sum(len(r) for r in refs)
    errs = sum(edit_distance(r, h) for r, h in zip(refs, hyps))
    return {
        "errors": float(errs),
        "ref_tokens": float(total),
        "error_rate": errs / max(total, 1),
    }


def bootstrap_wer_ci(refs: List[Sequence], hyps: List[Sequence],
                     n_resamples: int = 1000, alpha: float = 0.05,
                     seed: int = 0) -> Dict[str, float]:
    """Percentile-bootstrap confidence interval on the corpus error rate:
    utterances resampled with replacement (Bisani & Ney 2004), each
    utterance's edit distance computed once. The same draws as the JAX
    package's for the same ``seed``."""
    if len(refs) != len(hyps):
        raise ValueError("refs and hyps must have equal length")
    errs = np.array([edit_distance(r, h) for r, h in zip(refs, hyps)],
                    dtype=np.float64)
    lens = np.array([len(r) for r in refs], dtype=np.float64)
    n = len(refs)
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, n, size=(n_resamples, n))
    rates = errs[idx].sum(axis=1) / np.maximum(lens[idx].sum(axis=1), 1.0)
    lo, hi = np.quantile(rates, [alpha / 2, 1 - alpha / 2])
    return {
        "error_rate": float(errs.sum() / max(lens.sum(), 1.0)),
        "ci_low": float(lo),
        "ci_high": float(hi),
        "confidence": 1.0 - alpha,
        "n_resamples": int(n_resamples),
        "n_utts": int(n),
    }


def score_texts(ref_texts: List[str], hyp_texts: List[str]
                ) -> Dict[str, Dict[str, float]]:
    """Word-level WER (with its substitution, deletion and insertion
    counts) and char-level CER of plain-text refs and hyps. WER splits on
    whitespace; CER scores the characters with whitespace removed (Kaldi's
    score_cer convention)."""
    ref_words = [t.split() for t in ref_texts]
    hyp_words = [t.split() for t in hyp_texts]
    ref_chars = [list("".join(t.split())) for t in ref_texts]
    hyp_chars = [list("".join(t.split())) for t in hyp_texts]
    wer = wer_details(ref_words, hyp_words)
    subs = dels = ins = 0
    for r, h in zip(ref_words, hyp_words):
        s, d, i = align_stats(r, h)
        subs += s
        dels += d
        ins += i
    wer.update({"sub": float(subs), "del": float(dels), "ins": float(ins)})
    return {"wer": wer, "cer": wer_details(ref_chars, hyp_chars)}


def align_stats(ref: Sequence, hyp: Sequence) -> Tuple[int, int, int]:
    """(substitutions, deletions, insertions) from a full DP backtrace."""
    n, m = len(ref), len(hyp)
    dp = [[0] * (m + 1) for _ in range(n + 1)]
    for i in range(n + 1):
        dp[i][0] = i
    for j in range(m + 1):
        dp[0][j] = j
    for i in range(1, n + 1):
        for j in range(1, m + 1):
            cost = 0 if ref[i - 1] == hyp[j - 1] else 1
            dp[i][j] = min(dp[i - 1][j] + 1, dp[i][j - 1] + 1,
                           dp[i - 1][j - 1] + cost)
    subs = dels = ins = 0
    i, j = n, m
    while i > 0 or j > 0:
        if i > 0 and j > 0 and dp[i][j] == dp[i - 1][j - 1] + (
                0 if ref[i - 1] == hyp[j - 1] else 1):
            if ref[i - 1] != hyp[j - 1]:
                subs += 1
            i, j = i - 1, j - 1
        elif i > 0 and dp[i][j] == dp[i - 1][j] + 1:
            dels += 1
            i -= 1
        else:
            ins += 1
            j -= 1
    return subs, dels, ins
