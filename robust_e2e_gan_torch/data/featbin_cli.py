"""Kaldi featbin equivalents: offline feature extraction and feats copying.

Port of ``robust_e2e_gan_tpu/data/featbin_cli.py``:

  fbank       compute-fbank-feats / compute-spectrogram-feats equivalent:
              a Kaldi wav.scp of waveform vectors or a jsonl manifest of
              .npy waveforms -> feats ark(+scp), through the training
              frontend's split chain (``ops/fbank.py``) on the device
              (``--device``, the GPU by default; it raises without one),
              without CMVN (featbin writes raw features; they are
              normalised downstream with --cmvn-ark). ``--feats-kind
              spectrogram`` writes log power spectra at n_fft//2+1 dims,
              what ``pipeline.py::RobustE2E.joint_forward_spec`` reads with
              ``log_domain=True``.
  copy-feats  feature matrices ark/scp -> ark(+scp) on the host, optionally
              re-encoded as Kaldi CompressedMatrix CM/CM2/CM3
              (``copy-feats --compress``).

  python -m robust_e2e_gan_torch fbank --wav-scp wav.scp \\
      --out-ark feats.ark --out-scp feats.scp [--feats-kind spectrogram]
  python -m robust_e2e_gan_torch copy-feats --feats-scp in.scp \\
      --out-ark out.ark --out-scp out.scp --compress 1
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Iterator, Optional, Tuple

import numpy as np
import torch

from robust_e2e_gan_torch.config import FrontendConfig
from robust_e2e_gan_torch.data import kaldi_io
from robust_e2e_gan_torch.ops import fbank as fbank_ops
from robust_e2e_gan_torch.pipeline import frame_mask_from_wav_lengths


def frontend(wav: torch.Tensor, wav_lengths: torch.Tensor,
             cfg: FrontendConfig, kind: str
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B, N) waveforms -> ((B, T, D) features without CMVN, (B, T) frame
    mask): log-mel for ``kind`` "fbank", log power spectra (Kaldi
    compute-spectrogram-feats) for "spectrogram"."""
    power = fbank_ops.stft_power(wav, cfg)
    if kind == "fbank":
        feats = fbank_ops.log_mel(power, cfg)
    else:
        feats = torch.log(torch.clamp_min(power, cfg.log_floor))
    return feats, frame_mask_from_wav_lengths(wav, wav_lengths, cfg)


def extract_iter(wavs: Iterator[Tuple[str, np.ndarray]], cfg: FrontendConfig,
                 kind: str, device) -> Iterator[Tuple[str, np.ndarray]]:
    """(key, valid frames of its features) of each (key, waveform), one
    utterance at a time on ``device``."""
    for key, mat in wavs:
        wav = torch.from_numpy(np.asarray(mat, np.float32).reshape(1, -1))
        lens = torch.tensor([wav.shape[1]], dtype=torch.int32)
        with torch.no_grad():
            feats, mask = frontend(wav.to(device), lens.to(device), cfg,
                                   kind)
        yield key, feats[0][mask[0] > 0].cpu().numpy()


def iter_manifest_wavs(path: str) -> Iterator[Tuple[str, np.ndarray]]:
    """(utt_id, noisy waveform) of each entry of a jsonl manifest."""
    root = os.path.dirname(os.path.abspath(path))
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            d = json.loads(line)
            p = d["noisy"]
            if not os.path.isabs(p):
                p = os.path.join(root, p)
            yield d["utt_id"], np.load(p).astype(np.float32).reshape(-1)


def add_device_flag(p: argparse.ArgumentParser) -> None:
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help="where the frontend runs: the GPU (raises without "
                        "one) or, when asked, the CPU")


def build_fbank_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="Offline feature extraction (Kaldi compute-fbank-feats / "
        "compute-spectrogram-feats equivalent) with the training frontend.")
    src = p.add_mutually_exclusive_group(required=True)
    src.add_argument("--wav-scp", help="Kaldi waveform scp")
    src.add_argument("--manifest", help="jsonl manifest of .npy waveforms")
    p.add_argument("--out-ark", required=True, help="output feature ark")
    p.add_argument("--out-scp", help="matching scp to write")
    p.add_argument(
        "--feats-kind", choices=("fbank", "spectrogram"), default="fbank",
        help="fbank: log-mel (no CMVN, apply downstream); spectrogram: log "
        "power spectra at n_fft//2+1 dims for the enhancement-capable "
        "precomputed path (train CLI --feats-kind log-spectrogram)")
    p.add_argument("--n-mels", type=int, default=80)
    p.add_argument("--sample-rate", type=int, default=16000)
    p.add_argument("--compress", type=int, choices=(0, 1, 2, 3), default=0,
                   help="0: float32; 1/2/3: Kaldi CompressedMatrix "
                        "CM/CM2/CM3")
    add_device_flag(p)
    return p


def main_fbank(argv: Optional[list] = None) -> None:
    from robust_e2e_gan_torch.train.loop import resolve_device

    args = build_fbank_parser().parse_args(argv)
    device = resolve_device(args.device)  # raises before any output
    cfg = FrontendConfig(n_mels=args.n_mels, sample_rate=args.sample_rate)
    wavs = (iter_manifest_wavs(args.manifest) if args.manifest
            else kaldi_io.read_mat_scp(args.wav_scp))
    n = kaldi_io.write_ark_scp(
        extract_iter(wavs, cfg, args.feats_kind, device),
        args.out_ark, args.out_scp, compress=args.compress, atomic=True)
    dim = cfg.n_mels if args.feats_kind == "fbank" else cfg.n_freqs
    print(f"extracted {n} {args.feats_kind} matrices (dim {dim}) "
          f"to {args.out_ark}")


def build_copy_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="Copy/re-encode feature matrices (Kaldi copy-feats "
        "equivalent): ark/scp in, ark(+scp) out, optional compression.")
    src = p.add_mutually_exclusive_group(required=True)
    src.add_argument("--feats-scp", help="input feature scp")
    src.add_argument("--feats-ark", help="input feature ark (sequential)")
    p.add_argument("--out-ark", required=True)
    p.add_argument("--out-scp")
    p.add_argument("--compress", type=int, choices=(0, 1, 2, 3), default=0,
                   help="0: float32; 1/2/3: Kaldi CompressedMatrix "
                        "CM/CM2/CM3")
    return p


def main_copy(argv: Optional[list] = None) -> None:
    args = build_copy_parser().parse_args(argv)
    entries = (kaldi_io.read_mat_scp(args.feats_scp) if args.feats_scp
               else kaldi_io.read_mat_ark(args.feats_ark))
    n = kaldi_io.write_ark_scp(entries, args.out_ark, args.out_scp,
                               compress=args.compress, atomic=True)
    print(f"copied {n} matrices to {args.out_ark}")


if __name__ == "__main__":
    main_fbank()
