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

  python -m robust_e2e_gan_torch.train.cli --mode joint \\
      --train-manifest data/train.jsonl --dev-manifest data/dev.jsonl \\
      --ckpt-dir exp/joint
  python -m robust_e2e_gan_torch.train.cli --mode lm \\
      --train-manifest data/train.jsonl --ckpt-dir exp/lm   # the RNNLM
  python -m robust_e2e_gan_torch.train.cli --mode asr \\
      --train-feats-scp data/feats.scp --train-text data/text \\
      --cmvn speaker --cmvn-ark data/cmvn.ark --utt2spk data/utt2spk \\
      --ckpt-dir exp/asr_feats          # precomputed log-mel (Kaldi)
  python -m robust_e2e_gan_torch.train.cli --mode joint --synthetic \\
      --ckpt-dir /tmp/exp_demo --epochs 2      # no-corpus run

The data sources (``data/dataset.py``) are jsonl manifests of ``.npy``
waveforms, Kaldi waveform scp files with a ``text`` file
(``--train-noisy-scp``), Kaldi feats.scp files of precomputed features
(``--train-feats-scp``: log-mel for ``--mode asr``, or with ``--feats-kind
spectrogram|log-spectrogram`` power spectra that go through the enhancer,
paired with ``--train-clean-feats-scp`` for ``--mode gan|joint``) and the
synthetic task. One length-bucketed batcher reshuffles its batch order
every epoch from ``--seed``; the dev set is ``--dev-manifest``, in order,
with the train tokenizer, which is saved as ``tokenizer.json``; ``--mode
lm`` trains on the manifest's transcripts. ``--cmvn global`` takes its
stats from ``--cmvn-ark``, ``--cmvn speaker`` from a speaker-keyed
``--cmvn-ark`` and ``--utt2spk``; the ark is copied into the run dir as
``cmvn.ark`` for decoding. ``--init-from`` takes a run dir of the port
or of the JAX package (its best parameters); resuming a JAX run in
``--ckpt-dir`` raises ``NotImplementedError`` (ROADMAP 'Not to port').
``--mesh-data N`` (N > 1) trains over N data-parallel ranks, one process
each (``parallel/``): one card each with ``--device cuda`` (NCCL; N cards
needed), gloo ranks with ``--device cpu``. Every rank reads the same
global batches, which must divide over N, and keeps its rows; this
process writes the run dir's config before the ranks start, and rank 0
the checkpoints and logs. ``--mode lm`` ignores the flag, as the JAX CLI
does. ``--prefetch-depth`` batches are collated ahead on a host thread.
``--remat`` and ``--scan-unroll`` are XLA scheduling knobs, accepted and
without effect.
``--gate-storage compute`` rounds the plain BLSTM frame loop's gate
projections to the compute dtype (``--lstm-impl scan``), as the JAX scan
does; the kernels ignore it.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import shutil
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
from robust_e2e_gan_torch.utils import checkpoint as ckpt_lib


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("--mode", choices=("asr", "gan", "joint", "lm"),
                   default="joint")
    # data
    p.add_argument("--train-manifest",
                   help="jsonl manifest of .npy waveforms (data/dataset.py)")
    p.add_argument("--dev-manifest")
    p.add_argument("--train-noisy-scp", help="Kaldi scp of noisy waveforms")
    p.add_argument("--train-clean-scp")
    p.add_argument("--train-feats-scp",
                   help="Kaldi feats.scp of precomputed features (with "
                        "--train-text; --mode asr only for log-mel, which "
                        "has lost the linear spectrum the enhancer masks). "
                        "--length-buckets are then frame counts.")
    p.add_argument("--train-text")
    p.add_argument("--index-cache",
                   help="persist probed utterance lengths to this path; "
                        "reused while the scp's size and mtime match")
    p.add_argument("--utt2num-frames",
                   help="Kaldi utt2num_frames map; skips the header probe "
                        "when building the feats.scp index")
    p.add_argument("--feats-kind",
                   choices=("mel", "spectrogram", "log-spectrogram"),
                   default="mel",
                   help="what --train-feats-scp holds: 'mel' = offline "
                        "log-mel (ASR only, no enhancer), 'spectrogram' = "
                        "linear power spectra at n_fft//2+1 dims, "
                        "'log-spectrogram' = Kaldi compute-spectrogram-"
                        "feats log power. The spectrogram kinds go through "
                        "the enhancer, so --mode gan/joint train on them "
                        "(with --train-clean-feats-scp)")
    p.add_argument("--train-clean-feats-scp",
                   help="clean spectrogram feats paired by utt key "
                        "(required for --mode gan/joint with a "
                        "spectrogram --feats-kind)")
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
    p.add_argument("--cmvn-ark",
                   help="Kaldi CMVN stats ark: global stats for --cmvn "
                        "global, speaker-keyed for --cmvn speaker "
                        "(data/cmvn.py layout)")
    p.add_argument("--utt2spk",
                   help="Kaldi utt2spk map (required for --cmvn speaker)")
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
                   help="data-parallel ranks (0/1: one process)")
    p.add_argument("--log-every", type=int, default=10)
    p.add_argument("--save-every-steps", type=int, default=0,
                   help="mid-epoch checkpoint every N steps (0 = per epoch)")
    p.add_argument("--prefetch-depth", type=int, default=2,
                   help="host batches collated ahead on a background "
                        "thread")
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

    scfg = SyntheticConfig(seed=args.seed)
    steps = max(args.synthetic_utts // args.batch_size, 1)

    def train_batches():
        rng = np.random.default_rng(args.seed)
        for _ in range(steps):
            yield make_batch(args.batch_size, scfg, rng)

    def dev_batches():
        rng = np.random.default_rng(args.seed + 1)
        for _ in range(max(steps // 8, 1)):
            yield make_batch(args.batch_size, scfg, rng)

    return train_batches, dev_batches, scfg.vocab_size, None


def _corpus_factories(args):
    """(train factory, dev factory or None, vocab size, tokenizer) of the
    corpus flags: a manifest, a Kaldi waveform scp or a Kaldi feats.scp,
    with speaker-CMVN stats on every batch for ``--cmvn speaker``."""
    from robust_e2e_gan_torch.data.dataset import (
        AudioTextDataset,
        BucketBatcher,
    )

    if args.train_manifest:
        train_ds = AudioTextDataset.from_jsonl(args.train_manifest)
    elif args.train_feats_scp and args.train_text:
        spec = args.feats_kind != "mel"
        if args.mode != "asr" and not spec:
            raise SystemExit(
                "--train-feats-scp with --feats-kind mel supports --mode "
                "asr only (offline log-mel discarded the linear spectrum "
                "the enhancer needs); use --feats-kind spectrogram for "
                "gan/joint on precomputed inputs")
        if args.mode in ("gan", "joint") and not args.train_clean_feats_scp:
            raise SystemExit(
                "--mode gan/joint on spectrogram feats needs paired clean "
                "spectra: --train-clean-feats-scp")
        train_ds = AudioTextDataset.from_kaldi_feats(
            args.train_feats_scp, args.train_text,
            utt2num_frames=args.utt2num_frames,
            clean_scp=args.train_clean_feats_scp,
            index_cache=args.index_cache)
    elif args.train_noisy_scp and args.train_text:
        train_ds = AudioTextDataset.from_kaldi(
            args.train_noisy_scp, args.train_text, args.train_clean_scp,
            index_cache=args.index_cache)
    else:
        raise SystemExit(
            "need --train-manifest, --train-noisy-scp/--train-text, "
            "--train-feats-scp/--train-text, or --synthetic")
    tok = train_ds.tokenizer
    buckets = tuple(int(x) for x in args.length_buckets.split(",") if x)

    speaker_cmvn = None
    if args.cmvn == "speaker":
        if not (args.cmvn_ark and args.utt2spk):
            raise SystemExit("--cmvn speaker requires --cmvn-ark (speaker-"
                             "keyed) and --utt2spk")
        from robust_e2e_gan_torch.data.cmvn import SpeakerCmvn

        speaker_cmvn = SpeakerCmvn.load(args.cmvn_ark, args.utt2spk)

    # one batcher shared across epochs: its generator advances every
    # epoch() call, so the batch order reshuffles each epoch
    train_batcher = BucketBatcher(train_ds, args.batch_size, buckets,
                                  args.max_label_len, seed=args.seed,
                                  speaker_cmvn=speaker_cmvn)

    def train_batches():
        return train_batcher.epoch(shuffle=True)

    dev_batches = None
    if args.dev_manifest:
        dev_ds = AudioTextDataset.from_jsonl(args.dev_manifest, tokenizer=tok)
        dev_batcher = BucketBatcher(dev_ds, args.batch_size, buckets,
                                    args.max_label_len,
                                    speaker_cmvn=speaker_cmvn)

        def dev_batches():
            return dev_batcher.epoch(shuffle=False)

    return train_batches, dev_batches, tok.vocab_size, tok


def _lm_label_batches(args):
    """(factory of one epoch of (B, max_label_len) -1-padded label batches,
    vocab size): synthetic transcripts from one generator seeded once, so
    each epoch continues the stream, as the JAX CLI's ``--mode lm``."""
    from robust_e2e_gan_torch.data.synthetic import (
        SyntheticConfig,
        sample_transcript,
    )

    scfg = SyntheticConfig(seed=args.seed)
    rng = np.random.default_rng(args.seed)
    steps = max(args.synthetic_utts // args.batch_size, 1)

    def label_batches():
        for _ in range(steps):
            ys = np.full((args.batch_size, scfg.max_label_len), -1,
                         np.int32)
            for i in range(args.batch_size):
                t = sample_transcript(scfg, rng)
                ys[i, :len(t)] = t
            yield ys

    return label_batches, scfg.vocab_size


def _lm_manifest_batches(args):
    """(factory of one epoch of (B, max_label_len) -1-padded label
    batches, tokenizer) of ``--train-manifest``'s transcripts, encoded
    once; each epoch takes a new permutation from one generator seeded
    once, as the JAX CLI's ``--mode lm``."""
    from robust_e2e_gan_torch.data.dataset import AudioTextDataset

    ds = AudioTextDataset.from_jsonl(args.train_manifest)
    tok = ds.tokenizer
    rng = np.random.default_rng(args.seed)
    encoded = [np.asarray(tok.encode(u.text)[:args.max_label_len], np.int32)
               for u in ds.utts]

    def label_batches():
        order = rng.permutation(len(encoded))
        for s in range(0, len(order), args.batch_size):
            idxs = order[s:s + args.batch_size]
            ys = np.full((len(idxs), args.max_label_len), -1, np.int32)
            for j, i in enumerate(idxs):
                ys[j, :len(encoded[i])] = encoded[i]
            yield ys

    return label_batches, tok


def _lm_main(args) -> None:
    """--mode lm: train the shallow-fusion RNNLM on transcripts only."""
    from robust_e2e_gan_torch.config import LMConfig
    from robust_e2e_gan_torch.train.lm import train_lm

    if args.synthetic:
        label_batches, vocab = _lm_label_batches(args)
        tok = None
    else:
        label_batches, tok = _lm_manifest_batches(args)
        vocab = tok.vocab_size
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
    if tok is not None:
        tok.save(os.path.join(args.ckpt_dir, "tokenizer.json"))
    train_lm(lmcfg, tcfg, label_batches, log_dir=args.ckpt_dir,
             resume=not args.no_resume, device=args.device)


def _refuse_unported(args) -> None:
    if not args.no_resume and ckpt_lib.is_jax_checkpoint(args.ckpt_dir):
        raise NotImplementedError(
            f"{args.ckpt_dir}: {ckpt_lib.JAX_RESUME}")


def _input_kind(args) -> str:
    if not args.train_feats_scp:
        return "wav"
    return "feats" if args.feats_kind == "mel" else "spec"


def _cmvn_stats(args, copy: bool = True):
    """The global (mean, inv_std) for ``--cmvn global``; for ``global``
    and ``speaker`` the stats ark is copied into the run dir (unless
    ``copy`` is False), where ``decode.cli`` finds it."""
    if args.cmvn not in ("global", "speaker"):
        return None
    if not args.cmvn_ark:
        raise SystemExit(f"--cmvn {args.cmvn} requires --cmvn-ark")
    if copy:
        shutil.copy(args.cmvn_ark, os.path.join(args.ckpt_dir, "cmvn.ark"))
    if args.cmvn == "speaker":
        return None  # the per-utterance stats ride each batch
    from robust_e2e_gan_torch.data.cmvn import (
        load_cmvn_ark,
        stats_to_mean_inv_std,
    )

    return stats_to_mean_inv_std(load_cmvn_ark(args.cmvn_ark))


def main(argv: Optional[list] = None) -> None:
    from robust_e2e_gan_torch.train.loop import resolve_device

    args = build_parser().parse_args(argv)
    _refuse_unported(args)
    resolve_device(args.device)  # raises before any output without a GPU
    if args.mode == "lm":
        _lm_main(args)
        return
    mesh = None
    if args.mesh_data > 1:
        from robust_e2e_gan_torch.parallel import (
            local_batch_size,
            make_mesh,
        )

        # both raise before anything is written
        mesh = make_mesh(args.mesh_data, 1, args.device)
        local_batch_size(args.batch_size, mesh)
    factories = (_synthetic_factories if args.synthetic
                 else _corpus_factories)
    train_b, dev_b, vocab, tok = factories(args)
    jcfg, tcfg = configs_from_args(args, vocab)
    os.makedirs(args.ckpt_dir, exist_ok=True)
    with open(os.path.join(args.ckpt_dir, "config.json"), "w") as f:
        json.dump({"joint": dataclasses.asdict(jcfg),
                   "train": dataclasses.asdict(tcfg), "mode": args.mode,
                   "input_kind": _input_kind(args),
                   "spec_log_domain": args.feats_kind == "log-spectrogram"},
                  f, indent=2)
    if tok is not None:
        tok.save(os.path.join(args.ckpt_dir, "tokenizer.json"))
    cmvn_stats = _cmvn_stats(args)
    if mesh is None:
        _run(args, jcfg, tcfg, train_b, dev_b, cmvn_stats)
    else:
        from robust_e2e_gan_torch.parallel import launch

        print(f"data-parallel training over {args.mesh_data} ranks "
              f"({mesh.backend})", flush=True)
        launch(_rank, mesh, args)


def _rank(mesh, args) -> None:
    """One rank of ``train.cli --mesh-data``: its own batchers, drawn from
    the same seed as every other rank's."""
    factories = (_synthetic_factories if args.synthetic
                 else _corpus_factories)
    train_b, dev_b, vocab, _ = factories(args)
    jcfg, tcfg = configs_from_args(args, vocab)
    _run(args, jcfg, tcfg, train_b, dev_b, _cmvn_stats(args, copy=False),
         mesh)


def _run(args, jcfg, tcfg, train_b, dev_b, cmvn_stats, mesh=None) -> None:
    from robust_e2e_gan_torch.train.loop import train

    train(jcfg, tcfg, train_b, dev_batches=dev_b, mode=args.mode,
          log_dir=args.ckpt_dir, resume=not args.no_resume,
          init_from=args.init_from, cmvn_stats=cmvn_stats,
          save_every_steps=args.save_every_steps,
          input_kind=_input_kind(args),
          log_domain=args.feats_kind == "log-spectrogram",
          device=args.device, mesh=mesh,
          prefetch_depth=args.prefetch_depth)


if __name__ == "__main__":
    main()
