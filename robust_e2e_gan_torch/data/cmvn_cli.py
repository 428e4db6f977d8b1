"""compute-cmvn-stats equivalent: write a cmvn.ark from a dataset.

Port of ``robust_e2e_gan_tpu/data/cmvn_cli.py``. Sources:

  --feats-scp   precomputed Kaldi feature matrices, accumulated on the host
                one matrix at a time;
  --wav-scp     Kaldi waveform vectors, whose features come from the
                training frontend's split chain without CMVN
                (``data/featbin_cli.py::frontend``) on the device
                (``--device``, the GPU by default; it raises without one);
  --manifest    a jsonl manifest of .npy waveforms, likewise.

With ``--utt2spk`` the ark holds one Kaldi (2, D+1) stats matrix per
speaker (``data/cmvn.py::SpeakerCmvn``), else one "global" matrix
(``data/cmvn.py::load_cmvn_ark``). The train and decode CLIs read it with
``--cmvn-ark``.

  python -m robust_e2e_gan_torch cmvn --feats-scp feats.scp \\
      --out cmvn.ark [--utt2spk utt2spk]
"""

from __future__ import annotations

import argparse
import os
from typing import Dict, Iterator, Optional, Tuple

import numpy as np

from robust_e2e_gan_torch.config import FrontendConfig
from robust_e2e_gan_torch.data import kaldi_io
from robust_e2e_gan_torch.data.cmvn import CmvnAccumulator
from robust_e2e_gan_torch.data.dataset import _read_kv_file
from robust_e2e_gan_torch.data.featbin_cli import (
    add_device_flag,
    extract_iter,
    iter_manifest_wavs,
)


def compute_stats(
    feats_iter: Iterator[Tuple[str, np.ndarray]],
    utt2spk: Optional[Dict[str, str]] = None,
) -> Dict[str, np.ndarray]:
    """Accumulate -> {key: Kaldi (2, D+1) stats}; key 'global' or the
    speakers, sorted."""
    accs: Dict[str, CmvnAccumulator] = {}
    n_utts = 0
    skipped = 0
    for utt_id, feats in feats_iter:
        if utt2spk is not None:
            spk = utt2spk.get(utt_id)
            if spk is None:
                skipped += 1
                continue
        else:
            spk = "global"
        acc = accs.get(spk)
        if acc is None:
            acc = accs[spk] = CmvnAccumulator(feats.shape[1])
        acc.add(feats)
        n_utts += 1
    if not accs:
        raise SystemExit("no utterances accumulated (empty source?)")
    if skipped:
        print(f"warning: {skipped} utterances missing from utt2spk, skipped")
    print(f"accumulated {n_utts} utterances into {len(accs)} stats "
          f"key(s), dim {next(iter(accs.values())).sum.shape[0]}")
    return {k: acc.stats() for k, acc in sorted(accs.items())}


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="Compute Kaldi-layout CMVN stats (compute-cmvn-stats "
        "equivalent) for --cmvn-ark consumption by the train/decode CLIs.")
    src = p.add_mutually_exclusive_group(required=True)
    src.add_argument("--feats-scp", help="precomputed Kaldi feature scp")
    src.add_argument("--wav-scp",
                     help="Kaldi waveform scp (fbank on the device)")
    src.add_argument("--manifest", help="jsonl manifest of .npy waveforms")
    p.add_argument("--out", required=True, help="output cmvn ark path")
    p.add_argument("--utt2spk",
                   help="per-speaker stats keyed by this utt->spk map "
                        "(compute-cmvn-stats --spk2utt equivalent)")
    p.add_argument("--n-mels", type=int, default=80,
                   help="frontend mel bins for waveform sources")
    add_device_flag(p)
    return p


def main(argv: Optional[list] = None) -> None:
    args = build_parser().parse_args(argv)
    if args.feats_scp:
        feats_iter = kaldi_io.read_mat_scp(args.feats_scp)
    else:
        from robust_e2e_gan_torch.train.loop import resolve_device

        device = resolve_device(args.device)  # raises before any output
        wavs = (iter_manifest_wavs(args.manifest) if args.manifest
                else kaldi_io.read_mat_scp(args.wav_scp))
        feats_iter = extract_iter(wavs, FrontendConfig(n_mels=args.n_mels),
                                  "fbank", device)
    utt2spk = _read_kv_file(args.utt2spk) if args.utt2spk else None
    stats = compute_stats(feats_iter, utt2spk)

    tmp = args.out + ".tmp"
    with open(tmp, "wb") as f:
        for key, mat in stats.items():
            kaldi_io.write_mat(f, key, mat)
    os.replace(tmp, args.out)
    print(f"wrote {len(stats)} stats matrices to {args.out}")


if __name__ == "__main__":
    main()
