"""Synthetic CHiME-4-shaped utterances for driving the decode.

Counterpart of ``robust_e2e_gan_tpu/data/synthetic.py`` in its default
form (flat token transcripts, one tone segment per token, white noise plus
an AM tone at a fixed SNR): the same seed gives the same batch, bit for
bit. The hard-task knobs (words, duration jitter, SNR ranges,
reverberation, babble, channel tilt) are not ported yet. numpy only.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Tuple

import numpy as np


@dataclass(frozen=True)
class SyntheticConfig:
    vocab_size: int = 12  # ids 0=blank, 1=sos/eos, 2.. = real tokens
    sample_rate: int = 16000
    tone_ms: float = 120.0  # duration of one token's tone segment
    min_tokens: int = 2
    max_tokens: int = 10
    base_freq: float = 220.0
    freq_step: float = 180.0
    noise_snr_db: float = 0.0

    first_token = 2

    @property
    def segment(self) -> int:
        return int(self.tone_ms * self.sample_rate / 1000.0)

    @property
    def max_samples(self) -> int:
        """Upper bound on one utterance's sample count (for padding)."""
        return self.max_tokens * self.segment


def _token_wave(token: int, n: int, cfg: SyntheticConfig) -> np.ndarray:
    """Tone + one harmonic, Hann-enveloped, unique per token id."""
    f = cfg.base_freq + (token - cfg.first_token) * cfg.freq_step
    t = np.arange(n) / cfg.sample_rate
    return ((np.sin(2 * np.pi * f * t) + 0.5 * np.sin(4 * np.pi * f * t))
            * np.hanning(n))


def sample_transcript(cfg: SyntheticConfig,
                      rng: np.random.Generator) -> np.ndarray:
    n_tok = int(rng.integers(cfg.min_tokens, cfg.max_tokens + 1))
    return rng.integers(cfg.first_token, cfg.vocab_size,
                        size=(n_tok,)).astype(np.int32)


def synth_utterance(tokens: np.ndarray, cfg: SyntheticConfig,
                    rng: np.random.Generator) -> Tuple[np.ndarray, np.ndarray]:
    """tokens -> (clean_wav, noisy_wav), float32."""
    clean = np.concatenate(
        [_token_wave(int(tk), cfg.segment, cfg) for tk in tokens]
    ).astype(np.float32)
    sig_pow = float(np.mean(clean ** 2) + 1e-9)
    noise_pow = sig_pow / (10.0 ** (cfg.noise_snr_db / 10.0))
    noise = rng.standard_normal(clean.shape).astype(np.float32)
    # AM-modulated tone interference
    t = np.arange(clean.shape[0]) / cfg.sample_rate
    am = (1 + np.sin(2 * np.pi * 3.0 * t)) * np.sin(
        2 * np.pi * (500 + 400 * rng.random()) * t)
    noise = noise + am.astype(np.float32)
    noise *= np.sqrt(noise_pow / (np.mean(noise ** 2) + 1e-9))
    return clean, (clean + noise).astype(np.float32)


def make_batch(batch_size: int, cfg: SyntheticConfig,
               rng: np.random.Generator) -> Dict[str, np.ndarray]:
    """A batch padded to ``cfg.max_samples``: noisy/clean wav, lengths and
    labels padded with -1."""
    pad_to = cfg.max_samples
    ys = np.full((batch_size, cfg.max_tokens), -1, np.int32)
    clean = np.zeros((batch_size, pad_to), np.float32)
    noisy = np.zeros((batch_size, pad_to), np.float32)
    lengths = np.zeros((batch_size,), np.int32)
    for i in range(batch_size):
        tokens = sample_transcript(cfg, rng)
        c, x = synth_utterance(tokens, cfg, rng)
        n = len(c)
        clean[i, :n] = c
        noisy[i, :n] = x
        lengths[i] = n
        ys[i, :len(tokens)] = tokens
    return {"clean_wav": clean, "noisy_wav": noisy, "wav_lengths": lengths,
            "labels": ys}
