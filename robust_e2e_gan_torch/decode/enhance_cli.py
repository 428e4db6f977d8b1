"""Enhancement-only inference: denoise a dataset, write features to ark/scp.

Port of ``robust_e2e_gan_tpu/decode/enhance_cli.py``: G(noisy) -> mask *
noisy power -> enhanced log-mel features (``--domain logmel``, what a
downstream ASR consumes; no CMVN) or the enhanced linear power spectra
(``--domain power``), each utterance's valid frames written as a Kaldi
ark/scp through ``data/kaldi_io.py``. It enhances an experiment directory
written by the port's ``train.cli`` or by the JAX package on the GPU
(``--device cuda``, the default; it raises without one) or, when asked, on
the CPU (``--device cpu``), batch after batch under ``torch.no_grad()``.

The data sources are a jsonl manifest of ``.npy`` waveforms and a Kaldi
waveform scp with its ``text`` file (``--noisy-scp``/``--text``).
``--mesh-data N`` (N > 1) enhances over N data-parallel ranks, one process
each, as ``decode.cli`` decodes: each rank its rows of a batch that
divides over N, rank 0 alone one that does not, and rank 0 gathers the
features and writes the ark and scp.

  python -m robust_e2e_gan_torch.decode.enhance_cli \\
      --manifest data/eval.jsonl --ckpt-dir exp/joint \\
      --out exp/joint/enhanced --domain logmel
"""

from __future__ import annotations

import argparse
import os
from typing import Optional

import torch

from robust_e2e_gan_torch.data import kaldi_io
from robust_e2e_gan_torch.data.dataset import AudioTextDataset, BucketBatcher
from robust_e2e_gan_torch.decode.cli import load_experiment
from robust_e2e_gan_torch.parallel import launch, make_mesh, sharding
from robust_e2e_gan_torch.train.loop import resolve_device


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("--manifest", help="jsonl manifest of .npy waveforms")
    p.add_argument("--noisy-scp", help="Kaldi scp of waveforms (with --text)")
    p.add_argument("--text", help="Kaldi text file (with --noisy-scp)")
    p.add_argument("--ckpt-dir", required=True)
    p.add_argument("--which", choices=("best", "latest"), default="best")
    p.add_argument("--out", required=True, help="output prefix (.ark/.scp)")
    p.add_argument("--domain", choices=("logmel", "power"), default="logmel")
    p.add_argument("--batch-size", type=int, default=16)
    p.add_argument("--length-buckets", default="32000,64000,112000,160000")
    p.add_argument("--mesh-data", type=int, default=0,
                   help="data-parallel enhancement ranks (0/1: one "
                        "process)")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help="where to enhance: the GPU (raises without one) or, "
                        "when asked, the CPU")
    return p


def main(argv: Optional[list] = None) -> None:
    args = build_parser().parse_args(argv)
    resolve_device(args.device)  # raises before any output
    if args.mesh_data > 1:
        mesh = make_mesh(args.mesh_data, 1, args.device)
        print(f"data-parallel enhancement over {args.mesh_data} ranks "
              f"({mesh.backend})", flush=True)
        launch(_enhance, mesh, args)
    else:
        _enhance(None, args)


def _enhance(mesh, args) -> None:
    """Enhance the parsed flags' dataset: in this process, or as one rank
    of ``mesh``."""
    main_rank = mesh is None or mesh.is_main
    device = resolve_device(args.device if mesh is None else mesh.device)
    model, _, tok, step, _, _ = load_experiment(args.ckpt_dir, args.which,
                                                device=device)
    if args.manifest:
        ds = AudioTextDataset.from_jsonl(args.manifest, tokenizer=tok)
    elif args.noisy_scp and args.text:
        ds = AudioTextDataset.from_kaldi(args.noisy_scp, args.text,
                                         tokenizer=tok)
    else:
        raise SystemExit("need --manifest or --noisy-scp/--text")
    buckets = tuple(int(x) for x in args.length_buckets.split(",") if x)
    batcher = BucketBatcher(ds, args.batch_size, buckets, pad_final=True)

    ark, scp = args.out + ".ark", args.out + ".scp"

    @torch.no_grad()
    def enhance(batch, rows):
        wav = torch.from_numpy(batch["noisy_wav"][rows]).to(device)
        lens = torch.from_numpy(batch["wav_lengths"][rows]).to(device)
        enhanced, _, fmask = model.enhance(wav, lens)
        feats = (model.logmel_no_cmvn(enhanced) if args.domain == "logmel"
                 else enhanced)
        return [feats.float().cpu().numpy(),
                fmask.sum(dim=-1).long().cpu().numpy()]

    def batches():
        """Each batch's features and frame counts (on rank 0; None on the
        others)."""
        for batch in batcher.epoch(shuffle=False):
            shard, rows = sharding.serving_split(len(batch["noisy_wav"]),
                                                 mesh)
            if rows is not None:
                yield batch, sharding.gather_rows(enhance(batch, rows),
                                                  shard)

    if not main_rank:
        for _ in batches():
            pass
        return

    def entries():
        for batch, (feats, nf) in batches():
            # utt_ids holds the real utterances only: a ragged final
            # batch's repeats are not written
            for j, uid in enumerate(batch["utt_ids"]):
                yield uid, feats[j, :nf[j]]

    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    kaldi_io.write_ark_scp(entries(), ark, scp)
    print(f"wrote {ark} / {scp} (step {step}, domain {args.domain})")


if __name__ == "__main__":
    main()
