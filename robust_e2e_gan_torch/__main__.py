"""Unified command-line entry: ``python -m robust_e2e_gan_torch <cmd> ...``.

Port of ``robust_e2e_gan_tpu/__main__.py``: each subcommand runs its
module's CLI, which also stays callable on its own (e.g. ``python -m
robust_e2e_gan_torch.train.cli``).

  train      clean-ASR / GAN / joint-adversarial / LM training (train/cli.py)
  decode     batched beam or greedy decoding + WER/CER scoring (decode/cli.py)
  enhance    enhancement-only inference to Kaldi ark/scp (decode/enhance_cli.py)
  score      WER/CER scoring of ref/hyp text files (decode/score_cli.py)
  cmvn       compute CMVN stats ark, global or per-speaker (data/cmvn_cli.py)
  fbank      offline fbank/spectrogram feature extraction (data/featbin_cli.py)
  copy-feats copy/re-compress feature ark/scp (data/featbin_cli.py)
"""

from __future__ import annotations

import importlib
import sys

# subcommand -> (module, function)
COMMANDS = {
    "train": ("robust_e2e_gan_torch.train.cli", "main"),
    "decode": ("robust_e2e_gan_torch.decode.cli", "main"),
    "enhance": ("robust_e2e_gan_torch.decode.enhance_cli", "main"),
    "score": ("robust_e2e_gan_torch.decode.score_cli", "main"),
    "cmvn": ("robust_e2e_gan_torch.data.cmvn_cli", "main"),
    "fbank": ("robust_e2e_gan_torch.data.featbin_cli", "main_fbank"),
    "copy-feats": ("robust_e2e_gan_torch.data.featbin_cli", "main_copy"),
}


def main(argv=None) -> None:
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] in ("-h", "--help") or argv[0] not in COMMANDS:
        known = " | ".join(COMMANDS)
        print(f"usage: python -m robust_e2e_gan_torch {{{known}}} ...")
        print((__doc__ or "").strip().split("\n\n", 1)[-1])
        raise SystemExit(0 if argv and argv[0] in ("-h", "--help") else 2)
    module, fn = COMMANDS[argv[0]]
    getattr(importlib.import_module(module), fn)(argv[1:])


if __name__ == "__main__":
    main()
