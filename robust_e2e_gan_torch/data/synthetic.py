"""Synthetic CHiME-4-shaped utterances for training and driving the decode.

Counterpart of ``robust_e2e_gan_tpu/data/synthetic.py``, numpy only: each
token is a tone + harmonic segment, so a transcript is recoverable from
its clean audio. The default task is flat token runs under white noise
plus an AM tone at a fixed SNR; ``hard_task`` adds multi-word transcripts
(a space token rendered as a silence gap, optionally from a fixed
lexicon), per-token duration jitter, a per-utterance SNR range,
reverberation, nonstationary babble and a channel tilt. The same config
and generator state give the same batch as the JAX module, bit for bit:
every draw comes in the same order and every float64 -> float32 cast at
the same point.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass, replace
from typing import Dict, Iterator, List, Optional, Tuple

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
    seed: int = 0
    # per-utterance SNR drawn uniformly from this range (overrides
    # noise_snr_db when set)
    snr_range_db: Optional[Tuple[float, float]] = None
    # multi-word transcripts: words of real tokens separated by the space
    # token (id 2), rendered as a silence gap, so word WER is defined
    words: bool = False
    min_words: int = 2
    max_words: int = 5
    min_word_len: int = 1
    max_word_len: int = 4
    # per-token duration jitter, a uniform +/- fraction of tone_ms
    tone_jitter: float = 0.0
    # words mode only: words drawn from a fixed lexicon of this many
    # entries (``lexicon``) instead of random token strings
    lexicon_size: Optional[int] = None
    # exponential-decay random RIR on the noisy channel (T60 in seconds;
    # 0 disables); the clean target stays anechoic
    reverb_t60: float = 0.0
    # competing token-tone streams under low-frequency AM (0 disables)
    babble_streams: int = 0
    # one-pole tilt of the noisy channel, coefficient uniform in +/- this
    channel_tilt: float = 0.0

    @property
    def space_id(self) -> int:
        return 2  # only emitted when words=True

    @property
    def first_token(self) -> int:
        return 3 if self.words else 2

    @property
    def num_real_tokens(self) -> int:
        return self.vocab_size - self.first_token

    @property
    def max_label_len(self) -> int:
        if self.words:
            return self.max_words * self.max_word_len + self.max_words - 1
        return self.max_tokens

    @property
    def max_samples(self) -> int:
        """Upper bound on one utterance's sample count (for padding)."""
        seg = int(self.tone_ms * self.sample_rate / 1000.0)
        longest = int(np.ceil(seg * (1.0 + self.tone_jitter)))
        return self.max_label_len * longest


def hard_task(vocab_size: int = 32, seed: int = 0, reverb: bool = True,
              babble: bool = True) -> SyntheticConfig:
    """The non-saturating task of the paper-claim protocols: 29 real
    tokens 110 Hz apart, 2-7 words of 1-3 tokens (labels up to 27 long,
    utterances up to ~2.8 s), 30% duration jitter, SNR uniform over
    [-3, +5] dB, reverberation (T60 0.25 s), 3 babble streams and a
    channel tilt of +/-0.3. ``reverb=False, babble=False`` leaves out the
    last three."""
    return SyntheticConfig(
        vocab_size=vocab_size,
        tone_ms=80.0,
        base_freq=220.0,
        freq_step=110.0,  # keeps the 2nd harmonic under Nyquist at vocab 32
        snr_range_db=(-3.0, 5.0),
        words=True,
        min_words=2,
        max_words=7,
        min_word_len=1,
        max_word_len=3,
        tone_jitter=0.3,
        seed=seed,
        reverb_t60=0.25 if reverb else 0.0,
        babble_streams=3 if babble else 0,
        channel_tilt=0.3 if babble else 0.0,
    )


def _token_wave(token: int, n: int, cfg: SyntheticConfig) -> np.ndarray:
    """Tone + one harmonic, Hann-enveloped, unique per token id."""
    f = cfg.base_freq + (token - cfg.first_token) * cfg.freq_step
    t = np.arange(n) / cfg.sample_rate
    return ((np.sin(2 * np.pi * f * t) + 0.5 * np.sin(4 * np.pi * f * t))
            * np.hanning(n))


@functools.lru_cache(maxsize=None)
def _lexicon(cfg: SyntheticConfig) -> Tuple[Tuple[int, ...], ...]:
    rng = np.random.default_rng(cfg.seed + 7777)
    words: List[Tuple[int, ...]] = []
    seen = set()
    while len(words) < cfg.lexicon_size:
        wl = int(rng.integers(cfg.min_word_len, cfg.max_word_len + 1))
        w = tuple(int(t) for t in
                  rng.integers(cfg.first_token, cfg.vocab_size, size=(wl,)))
        if w not in seen:
            seen.add(w)
            words.append(w)
    return tuple(words)


def lexicon(cfg: SyntheticConfig) -> List[Tuple[int, ...]]:
    """The ``lexicon_size`` unique words of a lexicon config, drawn from
    ``cfg.seed`` so that train, dev and eval sets agree."""
    return list(_lexicon(cfg))


def sample_transcript(cfg: SyntheticConfig,
                      rng: np.random.Generator) -> np.ndarray:
    """A transcript: a flat token run, or words separated by spaces."""
    if not cfg.words:
        n_tok = int(rng.integers(cfg.min_tokens, cfg.max_tokens + 1))
        return rng.integers(cfg.first_token, cfg.vocab_size,
                            size=(n_tok,)).astype(np.int32)
    lex = _lexicon(cfg) if cfg.lexicon_size else None
    n_words = int(rng.integers(cfg.min_words, cfg.max_words + 1))
    out: List[int] = []
    for w in range(n_words):
        if w:
            out.append(cfg.space_id)
        if lex is not None:
            out.extend(lex[int(rng.integers(len(lex)))])
        else:
            wl = int(rng.integers(cfg.min_word_len, cfg.max_word_len + 1))
            out.extend(int(t) for t in rng.integers(
                cfg.first_token, cfg.vocab_size, size=(wl,)))
    return np.asarray(out, np.int32)


def _fft_convolve_trunc(x: np.ndarray, h: np.ndarray) -> np.ndarray:
    """FFT convolution truncated to len(x), as float32."""
    n = len(x) + len(h) - 1
    nfft = 1 << (n - 1).bit_length()
    y = np.fft.irfft(np.fft.rfft(x, nfft) * np.fft.rfft(h, nfft), nfft)
    return y[:len(x)].astype(np.float32)


def _random_rir(cfg: SyntheticConfig, rng: np.random.Generator) -> np.ndarray:
    """A synthetic room impulse response: a unit direct path, four sparse
    early reflections (5-50 ms) and an exponentially decaying diffuse tail
    at the configured T60."""
    sr = cfg.sample_rate
    length = max(int(cfg.reverb_t60 * sr), 64)
    t = np.arange(length) / sr
    # -60 dB at t60
    tail = rng.standard_normal(length) * np.exp(-6.9078 * t / cfg.reverb_t60)
    rir = 0.3 * tail
    rir[0] = 1.0
    for _ in range(4):
        d = int(rng.uniform(0.005, 0.05) * sr)
        if d < length:
            rir[d] += rng.uniform(0.2, 0.6) * (1 if rng.random() < 0.5 else -1)
    return rir.astype(np.float32)


def _babble(n: int, cfg: SyntheticConfig,
            rng: np.random.Generator) -> np.ndarray:
    """``babble_streams`` token-tone streams at random offsets under one
    random low-frequency AM envelope: interference that overlaps the
    speech tokens' spectrum."""
    out = np.zeros(n, np.float32)
    seg = int(cfg.tone_ms * cfg.sample_rate / 1000.0)
    for _ in range(cfg.babble_streams):
        pos = int(rng.integers(0, max(seg // 2, 1)))
        while pos < n:
            tk = int(rng.integers(cfg.first_token, cfg.vocab_size))
            ln = min(int(seg * rng.uniform(0.7, 1.5)), n - pos)
            if ln <= 8:
                break
            out[pos:pos + ln] += _token_wave(tk, ln, cfg).astype(np.float32)
            pos += ln + int(rng.integers(0, seg))
    t = np.arange(n) / cfg.sample_rate
    am = 0.6 + 0.4 * np.sin(
        2 * np.pi * rng.uniform(0.5, 4.0) * t + rng.uniform(0, 2 * np.pi))
    return (out * am).astype(np.float32)


def synth_utterance(tokens: np.ndarray, cfg: SyntheticConfig,
                    rng: np.random.Generator) -> Tuple[np.ndarray, np.ndarray]:
    """tokens -> (clean_wav, noisy_wav), float32. Reverberation, tilt and
    babble corrupt only the noisy channel."""
    seg = int(cfg.tone_ms * cfg.sample_rate / 1000.0)
    pieces = []
    for tk in tokens:
        n = seg
        if cfg.tone_jitter > 0.0:  # drawn for space tokens too
            n = int(round(seg * (
                1.0 + cfg.tone_jitter * (2.0 * rng.random() - 1.0))))
        if cfg.words and int(tk) == cfg.space_id:
            pieces.append(np.zeros(n))  # the inter-word gap
        else:
            pieces.append(_token_wave(int(tk), n, cfg))
    clean = np.concatenate(pieces).astype(np.float32)

    received = clean
    if cfg.reverb_t60 > 0.0:
        received = _fft_convolve_trunc(clean, _random_rir(cfg, rng))
    if cfg.channel_tilt > 0.0:
        a = cfg.channel_tilt * (2.0 * rng.random() - 1.0)
        # float64 taps: the product is float64 until the cast
        received = np.convolve(received, [1.0, -a])[:len(received)].astype(
            np.float32)

    snr_db = cfg.noise_snr_db
    if cfg.snr_range_db is not None:
        lo, hi = cfg.snr_range_db
        snr_db = float(lo + (hi - lo) * rng.random())
    sig_pow = float(np.mean(received ** 2) + 1e-9)
    noise_pow = sig_pow / (10.0 ** (snr_db / 10.0))
    noise = rng.standard_normal(clean.shape).astype(np.float32)
    if cfg.babble_streams > 0:
        noise = 0.3 * noise + _babble(len(clean), cfg, rng)
    else:
        # AM-modulated tone interference
        t = np.arange(clean.shape[0]) / cfg.sample_rate
        am = (1 + np.sin(2 * np.pi * 3.0 * t)) * np.sin(
            2 * np.pi * (500 + 400 * rng.random()) * t)
        noise = noise + am.astype(np.float32)
    noise *= np.sqrt(noise_pow / (np.mean(noise ** 2) + 1e-9))
    return clean, (received + noise).astype(np.float32)


def make_batch(batch_size: int, cfg: SyntheticConfig,
               rng: np.random.Generator, max_tokens: Optional[int] = None,
               pad_to_samples: Optional[int] = None, ignore_id: int = -1
               ) -> Dict[str, np.ndarray]:
    """A batch padded to ``pad_to_samples`` (``cfg.max_samples`` when not
    given; longer utterances are cut): noisy/clean wav, lengths, and
    labels padded with ``ignore_id`` to ``cfg.max_label_len``.
    ``max_tokens`` overrides the config's on the flat task."""
    if max_tokens is not None and not cfg.words:
        cfg = replace(cfg, max_tokens=max_tokens)
    pad_to = pad_to_samples or cfg.max_samples
    ys = np.full((batch_size, cfg.max_label_len), ignore_id, np.int32)
    clean = np.zeros((batch_size, pad_to), np.float32)
    noisy = np.zeros((batch_size, pad_to), np.float32)
    lengths = np.zeros((batch_size,), np.int32)
    for i in range(batch_size):
        tokens = sample_transcript(cfg, rng)
        c, x = synth_utterance(tokens, cfg, rng)
        n = min(len(c), pad_to)
        clean[i, :n] = c[:n]
        noisy[i, :n] = x[:n]
        lengths[i] = n
        ys[i, :len(tokens)] = tokens
    return {"clean_wav": clean, "noisy_wav": noisy, "wav_lengths": lengths,
            "labels": ys}


def batch_iterator(batch_size: int, cfg: SyntheticConfig, steps: int,
                   **kwargs) -> Iterator[Dict[str, np.ndarray]]:
    """``steps`` batches from one generator seeded with ``cfg.seed``;
    ``kwargs`` go to ``make_batch``."""
    rng = np.random.default_rng(cfg.seed)
    for _ in range(steps):
        yield make_batch(batch_size, cfg, rng, **kwargs)


def labels_to_list(ys: np.ndarray, ignore_id: int = -1) -> List[List[int]]:
    return [[int(t) for t in row if t != ignore_id] for row in ys]


def split_words(ids, space_id: int) -> List[Tuple[int, ...]]:
    """Token ids -> word tuples (split on the space token), for word
    WER."""
    words: List[Tuple[int, ...]] = []
    cur: List[int] = []
    for t in ids:
        if int(t) == space_id:
            if cur:
                words.append(tuple(cur))
                cur = []
        else:
            cur.append(int(t))
    if cur:
        words.append(tuple(cur))
    return words
