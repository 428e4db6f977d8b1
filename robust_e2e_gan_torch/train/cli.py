"""Training CLI: clean-ASR pretraining, GAN pretraining, joint adversarial,
and the RNNLM.

Port of ``robust_e2e_gan_tpu/train/cli.py``: the same flags, names and
defaults; flags override the config tree, and the resolved config is
written into the checkpoint dir. It trains on the GPU (``--device cuda``,
the default; it raises without one) or, when asked, on the CPU
(``--device cpu``). ``--lstm-impl auto`` (the default) and ``fused`` take
the CUDA kernels on the GPU and their plain versions on the CPU; ``scan``
takes the plain versions everywhere. ``--fused-frontend`` takes the fused
frontend kernel on the enhancer-free path (``--mode asr``).

  python -m robust_e2e_gan_torch.train.cli --mode joint --synthetic \\
      --ckpt-dir /tmp/exp_demo --epochs 2      # no-corpus run
  python -m robust_e2e_gan_torch.train.cli --mode lm --synthetic \\
      --ckpt-dir /tmp/lm_demo                  # the shallow-fusion LM

Only the synthetic task is ported as a data source: the corpus and
precomputed-feature flags, global or speaker CMVN and ``--mesh-data``
raise ``NotImplementedError`` naming their ROADMAP item. ``--remat`` and
``--scan-unroll`` are XLA scheduling knobs, accepted and without effect;
``--prefetch-depth`` likewise (the loop is synchronous).
``--gate-storage compute`` rounds the plain BLSTM frame loop's gate
projections to the compute dtype (``--lstm-impl scan``), as the JAX scan
does; the kernels ignore it.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
from typing import Optional

import numpy as np

from robust_e2e_gan_torch.config import (
    AttentionConfig,
    DecoderConfig,
    DiscriminatorConfig,
    E2EConfig,
    EncoderConfig,
    EnhancerConfig,
    FrontendConfig,
    JointConfig,
    TrainConfig,
)

CORPUS_FLAGS = ("train_manifest", "dev_manifest", "train_noisy_scp",
                "train_clean_scp", "train_feats_scp", "train_text",
                "index_cache", "utt2num_frames", "train_clean_feats_scp",
                "cmvn_ark", "utt2spk")
# where the refusals of the corpus and feature inputs send the reader
KALDI_ITEM = "ROADMAP queue 1, Kaldi and precomputed-feature inputs"
CORPUS_ITEMS = f"ROADMAP queue 1, train.cli on .npy manifests; {KALDI_ITEM}"


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("--mode", choices=("asr", "gan", "joint", "lm"),
                   default="joint")
    # data (only --synthetic is ported)
    for flag in CORPUS_FLAGS:
        p.add_argument("--" + flag.replace("_", "-"),
                       help=f"not ported yet ({CORPUS_ITEMS})")
    p.add_argument("--feats-kind",
                   choices=("mel", "spectrogram", "log-spectrogram"),
                   default="mel")
    p.add_argument("--synthetic", action="store_true",
                   help="use the built-in synthetic learnable task")
    p.add_argument("--synthetic-utts", type=int, default=512)
    # model dims
    p.add_argument("--n-mels", type=int, default=80)
    p.add_argument("--enc-layers", type=int, default=3)
    p.add_argument("--enc-hidden", type=int, default=512)
    p.add_argument("--enc-proj", type=int, default=512)
    p.add_argument("--att-dim", type=int, default=512)
    p.add_argument("--dec-hidden", type=int, default=512)
    p.add_argument("--dec-embed", type=int, default=512)
    p.add_argument("--enh-layers", type=int, default=2)
    p.add_argument("--enh-hidden", type=int, default=512)
    p.add_argument("--mtlalpha", type=float, default=0.5)
    p.add_argument("--label-smoothing", type=float, default=0.0)
    p.add_argument("--lambda-adv", type=float, default=1.0)
    p.add_argument("--mu-enh", type=float, default=1.0)
    p.add_argument("--compute-dtype", choices=("float32", "bfloat16"),
                   default="float32")
    p.add_argument("--remat", action="store_true", help="no effect here")
    p.add_argument("--scan-unroll", type=int, default=4,
                   help="no effect here")
    p.add_argument("--gate-storage", choices=("f32", "compute"),
                   default="f32",
                   help="'compute' rounds the plain BLSTM frame loop's gate "
                        "projections to the compute dtype (--lstm-impl "
                        "scan); the kernels ignore it")
    p.add_argument("--lstm-impl", choices=("auto", "scan", "fused"),
                   default="auto",
                   help="BLSTM frame loops: 'auto'/'fused' run the CUDA "
                        "training kernels on the GPU (their plain versions "
                        "on the CPU); 'scan' the plain versions")
    p.add_argument("--cmvn", choices=("utterance", "global", "speaker",
                                      "none"), default="utterance")
    p.add_argument("--fused-frontend", action="store_true",
                   help="fused fbank kernel on enhancer-free paths "
                        "(clean-ASR pretraining forward and backward, "
                        "no-enhancer decode)")
    # optimisation
    p.add_argument("--optimizer", choices=("adadelta", "adam"),
                   default="adadelta")
    p.add_argument("--lr", type=float, default=1.0)
    p.add_argument("--warmup-steps", type=int, default=0,
                   help="linear LR warmup steps (adam only; 0 = constant)")
    p.add_argument("--grad-clip", type=float, default=5.0)
    p.add_argument("--eps-decay", type=float, default=0.01)
    p.add_argument("--batch-size", type=int, default=16)
    p.add_argument("--epochs", type=int, default=15)
    p.add_argument("--seed", type=int, default=1)
    p.add_argument("--max-label-len", type=int, default=128)
    p.add_argument("--length-buckets", default="32000,64000,112000,160000")
    # infra
    p.add_argument("--ckpt-dir", required=True)
    p.add_argument("--init-from", help="warm-start params from this ckpt dir")
    p.add_argument("--no-resume", action="store_true")
    p.add_argument("--mesh-data", type=int, default=0,
                   help="data-parallel mesh size: not ported yet")
    p.add_argument("--log-every", type=int, default=10)
    p.add_argument("--save-every-steps", type=int, default=0,
                   help="mid-epoch checkpoint every N steps (0 = per epoch)")
    p.add_argument("--prefetch-depth", type=int, default=2,
                   help="no effect here")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help="where to train: the GPU (raises without one) or, "
                        "when asked, the CPU")
    return p


def configs_from_args(args, vocab_size: int):
    jcfg = JointConfig(
        e2e=E2EConfig(
            frontend=FrontendConfig(n_mels=args.n_mels, cmvn=args.cmvn,
                                    fused=args.fused_frontend),
            encoder=EncoderConfig(
                input_dim=args.n_mels, num_layers=args.enc_layers,
                hidden_dim=args.enc_hidden, proj_dim=args.enc_proj,
                lstm_impl=args.lstm_impl, gate_storage=args.gate_storage,
            ),
            attention=AttentionConfig(dim=args.att_dim),
            decoder=DecoderConfig(
                vocab_size=vocab_size, embed_dim=args.dec_embed,
                hidden_dim=args.dec_hidden,
                label_smoothing=args.label_smoothing,
            ),
            mtlalpha=args.mtlalpha,
        ),
        enhancer=EnhancerConfig(
            num_layers=args.enh_layers, hidden_dim=args.enh_hidden,
            lstm_impl=args.lstm_impl, gate_storage=args.gate_storage,
        ),
        discriminator=DiscriminatorConfig(input_dim=args.n_mels),
        lambda_adv=args.lambda_adv,
        mu_enh=args.mu_enh,
        compute_dtype=args.compute_dtype,
    )
    tcfg = TrainConfig(
        optimizer=args.optimizer, learning_rate=args.lr,
        warmup_steps=args.warmup_steps,
        grad_clip=args.grad_clip, eps_decay=args.eps_decay,
        batch_size=args.batch_size, num_epochs=args.epochs,
        seed=args.seed, max_label_len=args.max_label_len,
        length_buckets=tuple(
            int(x) for x in args.length_buckets.split(",") if x),
        checkpoint_dir=args.ckpt_dir, log_every=args.log_every,
    )
    return jcfg, tcfg


def _synthetic_factories(args):
    from robust_e2e_gan_torch.data.synthetic import SyntheticConfig, make_batch

    scfg = SyntheticConfig()
    steps = max(args.synthetic_utts // args.batch_size, 1)

    def train_batches():
        rng = np.random.default_rng(args.seed)
        for _ in range(steps):
            yield make_batch(args.batch_size, scfg, rng)

    def dev_batches():
        rng = np.random.default_rng(args.seed + 1)
        for _ in range(max(steps // 8, 1)):
            yield make_batch(args.batch_size, scfg, rng)

    return train_batches, dev_batches, scfg.vocab_size


def _lm_label_batches(args):
    """(factory of one epoch of (B, max_tokens) -1-padded label batches,
    vocab size): synthetic transcripts from one generator seeded once, so
    each epoch continues the stream, as the JAX CLI's ``--mode lm``."""
    from robust_e2e_gan_torch.data.synthetic import (
        SyntheticConfig,
        sample_transcript,
    )

    scfg = SyntheticConfig()
    rng = np.random.default_rng(args.seed)
    steps = max(args.synthetic_utts // args.batch_size, 1)

    def label_batches():
        for _ in range(steps):
            ys = np.full((args.batch_size, scfg.max_tokens), -1, np.int32)
            for i in range(args.batch_size):
                t = sample_transcript(scfg, rng)
                ys[i, :len(t)] = t
            yield ys

    return label_batches, scfg.vocab_size


def _lm_main(args) -> None:
    """--mode lm: train the shallow-fusion RNNLM on transcripts only."""
    from robust_e2e_gan_torch.config import LMConfig
    from robust_e2e_gan_torch.train.lm import train_lm

    label_batches, vocab = _lm_label_batches(args)
    lmcfg = LMConfig(vocab_size=vocab, embed_dim=args.dec_embed,
                     hidden_dim=args.dec_hidden)
    tcfg = TrainConfig(
        optimizer=args.optimizer, learning_rate=args.lr,
        warmup_steps=args.warmup_steps, grad_clip=args.grad_clip,
        batch_size=args.batch_size, num_epochs=args.epochs, seed=args.seed,
        max_label_len=args.max_label_len, checkpoint_dir=args.ckpt_dir,
        log_every=args.log_every)
    os.makedirs(args.ckpt_dir, exist_ok=True)
    with open(os.path.join(args.ckpt_dir, "config.json"), "w") as f:
        json.dump({"lm": dataclasses.asdict(lmcfg),
                   "train": dataclasses.asdict(tcfg), "mode": "lm"}, f,
                  indent=2)
    train_lm(lmcfg, tcfg, label_batches, log_dir=args.ckpt_dir,
             resume=not args.no_resume, device=args.device)


def _refuse_unported(args) -> None:
    given = [f for f in CORPUS_FLAGS if getattr(args, f)]
    if given or not args.synthetic:
        raise NotImplementedError(
            "the corpus and precomputed-feature data sources "
            f"({', '.join(given) or 'no --synthetic'}) are not ported yet "
            f"({CORPUS_ITEMS}); use --synthetic")
    if args.cmvn in ("global", "speaker"):
        raise NotImplementedError(
            f"--cmvn {args.cmvn} needs Kaldi CMVN stats, not ported yet "
            f"({KALDI_ITEM})")
    if args.mesh_data > 1:
        raise NotImplementedError(
            "--mesh-data: data parallelism is not ported yet "
            "(ROADMAP queue 1, data parallel)")


def main(argv: Optional[list] = None) -> None:
    from robust_e2e_gan_torch.train.loop import resolve_device

    args = build_parser().parse_args(argv)
    _refuse_unported(args)
    resolve_device(args.device)  # raises before any output without a GPU
    if args.mode == "lm":
        _lm_main(args)
        return
    train_b, dev_b, vocab = _synthetic_factories(args)
    jcfg, tcfg = configs_from_args(args, vocab)
    os.makedirs(args.ckpt_dir, exist_ok=True)
    with open(os.path.join(args.ckpt_dir, "config.json"), "w") as f:
        json.dump({"joint": dataclasses.asdict(jcfg),
                   "train": dataclasses.asdict(tcfg), "mode": args.mode,
                   "input_kind": "wav"}, f, indent=2)

    from robust_e2e_gan_torch.train.loop import train

    train(jcfg, tcfg, train_b, dev_batches=dev_b, mode=args.mode,
          log_dir=args.ckpt_dir, resume=not args.no_resume,
          init_from=args.init_from, save_every_steps=args.save_every_steps,
          device=args.device)


if __name__ == "__main__":
    main()
