"""Training loop: epochs, dev eval, eps decay, checkpoints, resume.

Port of ``robust_e2e_gan_tpu/train/loop.py``: the three regimes (clean-ASR
pretraining, enhancement-GAN pretraining, joint adversarial fine-tuning)
share one epoch loop with per-step logging, dev evaluation after each
epoch, Adadelta eps decay on a dev-accuracy plateau, best and latest
checkpoints (each epoch, and every ``save_every_steps`` within one), resume
from the latest, and a warm start (``init_from``) from another run's best
parameters, a run of the port or of the JAX package. The input kind
(waveforms, precomputed log-mel features or precomputed spectra) is the
caller's, or is read off the first batch's keys. Checkpoints are written
off the training thread by ``utils/checkpoint.py::AsyncCheckpointer``, the
last one durable before the loop returns. A ``data/dataset.py::Prefetcher``
thread collates the next ``prefetch_depth`` host batches while a step
runs; each batch is moved to the device on the training thread.

Under a mesh (``mesh``, one process a rank: ``parallel/``), every rank
draws the same global batches from the same seed and keeps its data
index's rows (``shard_batch``), padded to the global batch's widths; the
state is broadcast from rank 0 after any restore, then, on a model axis,
its parameters and optimizer state sharded by ``partition_rule`` (JAX
order: restore the full state, then shard); the steps reduce gradients
and metrics over the ranks, so dev metrics, and with them the best
checkpoint and Adadelta's eps decay, are the same on every rank. Only
rank 0 logs and writes checkpoints, in the single-process layout (the
ranks of its model group join each save's gather); every rank waits for
the last save before it returns, and for any save in flight before it
reads a resume.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Iterator, Optional, Union

import numpy as np
import torch

from robust_e2e_gan_torch.config import JointConfig, TrainConfig
from robust_e2e_gan_torch.convert import from_flax, init_disc_params, init_params
from robust_e2e_gan_torch.data.dataset import Prefetcher
from robust_e2e_gan_torch.models.enhancement import Discriminator
from robust_e2e_gan_torch.parallel import sharding
from robust_e2e_gan_torch.pipeline import build_model
from robust_e2e_gan_torch.train import steps as steps_lib
from robust_e2e_gan_torch.utils import checkpoint as ckpt_lib
from robust_e2e_gan_torch.utils.logging import MetricLogger, StepTimer

MODES = ("asr", "gan", "joint")
BATCH_KEYS = ("noisy_wav", "clean_wav", "wav_lengths", "labels", "feats",
              "feat_lengths", "clean_feats", "cmvn_mean", "cmvn_inv_std")


def resolve_device(device: Union[str, torch.device, None] = "cuda"
                   ) -> torch.device:
    """The device of training and decoding: the GPU unless the caller
    asks for the CPU. Raises when a CUDA device is asked for and none is
    present; nothing falls back to the CPU."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: the port runs on the GPU; pass device='cpu' "
            "(train.cli or decode.cli --device cpu) to run on the CPU")
    return device


def device_batch(batch: Dict[str, np.ndarray], device) -> Dict[str, torch.Tensor]:
    return {k: torch.as_tensor(batch[k]).to(device) for k in BATCH_KEYS
            if k in batch}


def init_state(jcfg: JointConfig, tcfg: TrainConfig, device,
               cmvn_stats=None, feat_dim: Optional[int] = None
               ) -> steps_lib.TrainState:
    """Generator and discriminator with fresh parameters drawn from
    ``tcfg.seed`` (the flax initialisers' distributions), on ``device``.
    ``feat_dim``: the width of a precomputed-features source, which the
    discriminator is sized to, as the JAX package initialises it on those
    features; None sizes it to the log-mel of the frontend."""
    model = build_model(jcfg, cmvn_stats=cmvn_stats)
    model.load_state_dict(from_flax(init_params(jcfg, seed=tcfg.seed)))
    dcfg = jcfg.discriminator
    if feat_dim is not None:
        dcfg = dataclasses.replace(dcfg, input_dim=feat_dim)
    disc = Discriminator(dcfg, model.dtype)
    disc.load_state_dict(from_flax(init_disc_params(dcfg,
                                                    seed=tcfg.seed + 1)))
    return steps_lib.init_train_state(model.to(device), disc.to(device),
                                      tcfg, seed=tcfg.seed)


def train(
    jcfg: JointConfig,
    tcfg: TrainConfig,
    train_batches: Callable[[], Iterator[Dict[str, np.ndarray]]],
    dev_batches: Optional[Callable[[], Iterator[Dict[str, np.ndarray]]]] = None,
    mode: str = "joint",
    log_dir: Optional[str] = None,
    resume: bool = True,
    init_from: Optional[str] = None,
    cmvn_stats=None,
    save_every_steps: int = 0,
    input_kind: Optional[str] = None,
    log_domain: bool = False,
    device: Union[str, torch.device] = "cuda",
    mesh: Optional[sharding.Mesh] = None,
    prefetch_depth: int = 2,
    min_shard_dim: int = 512,
) -> steps_lib.TrainState:
    """Run ``tcfg.num_epochs`` of the selected regime; returns the state.

    ``train_batches``/``dev_batches``: zero-argument factories of a fresh
    epoch of host batches (noisy_wav, clean_wav, wav_lengths, labels; or
    feats, feat_lengths[, clean_feats], labels; speaker-CMVN stats too).
    ``mode``: "asr", "gan" or "joint". ``init_from``: a checkpoint dir
    whose best parameters start this run (its step count is not resumed),
    written by the port or by the JAX package.
    ``input_kind``: "wav", "feats" or "spec" (``log_domain``: log power
    spectra); None reads it off the first batch.
    ``device``: the GPU by default (raises without one); "cpu" only when
    asked for. ``mesh``: a joined mesh (``parallel.launch``), whose
    rank's device replaces ``device``. ``prefetch_depth``: host batches
    collated ahead (0: no bound). ``min_shard_dim``: ``partition_rule``'s,
    on a model axis (the JAX default).
    """
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}")
    device = resolve_device(device if mesh is None else mesh.device)
    main = mesh is None or mesh.is_main
    # drawn on every run, as the JAX loop draws it (a shared batcher's
    # shuffle moves on by one epoch): a batch of features is "feats"
    # ("spec" is only ever asked for), and sizes a feats run's discriminator
    first = next(iter(train_batches()))
    if input_kind is None:
        input_kind = "feats" if "feats" in first else "wav"
    feat_dim = first["feats"].shape[-1] if input_kind == "feats" else None
    state = init_state(jcfg, tcfg, device, cmvn_stats, feat_dim)

    start_epoch = 0
    best_acc = -float("inf")
    sharding.barrier(mesh)  # no rank reads while a save is in flight
    if init_from and ckpt_lib.has_checkpoint(init_from, "best"):
        ckpt_lib.restore_checkpoint(init_from, state, "best", params_only=True)
    if resume and ckpt_lib.has_checkpoint(tcfg.checkpoint_dir):
        ckpt_lib.restore_checkpoint(tcfg.checkpoint_dir, state)
        extra = ckpt_lib.read_extra(tcfg.checkpoint_dir)
        start_epoch = int(extra.get("epoch", -1)) + int(
            bool(extra.get("epoch_complete", True)))
        best_acc = float(extra.get("best_acc", best_acc))
    sharding.shard_train_state(state, mesh, min_shard_dim)

    if mode == "asr":
        step_fn = steps_lib.make_asr_pretrain_step(
            use_enhancer=False, input_kind=input_kind, log_domain=log_domain,
            mesh=mesh)
    else:
        step_fn = steps_lib.make_joint_train_step(
            jcfg, with_asr=(mode == "joint"), input_kind=input_kind,
            log_domain=log_domain, mesh=mesh)
    eval_fn = steps_lib.make_eval_step(use_enhancer=(mode != "asr"),
                                       input_kind=input_kind,
                                       log_domain=log_domain, mesh=mesh)

    def to_device(batch):
        rows = sharding.shard_batch(
            {k: batch[k] for k in BATCH_KEYS if k in batch}, mesh)
        return device_batch(rows, device)

    logger = MetricLogger(log_dir if main else None, name=mode)
    timer = StepTimer()
    # the host snapshot on this thread, the write on the saver's
    saver = ckpt_lib.AsyncCheckpointer()

    def log(*args, **kw):
        if main:
            logger.log(*args, **kw)

    def save(epoch, complete, metric=None):
        if main:
            saver.save(
                tcfg.checkpoint_dir, state, state.step, metric=metric,
                keep=3, extra={"epoch": epoch, "epoch_complete": complete,
                               "best_acc": best_acc})
        elif mesh.n_model > 1 and mesh.data_index == 0:
            state.state_dict()  # rank 0's snapshot gathers the shards

    # leaving the saver's block waits for the last write, also where a
    # step raises
    try:
        with saver:
            for epoch in range(start_epoch, tcfg.num_epochs):
                # leaving the block frees the thread, also where a step
                # raises
                with Prefetcher(train_batches(), prefetch_depth) as batches:
                    for batch in batches:
                        timer.tic()
                        metrics = step_fn(state, to_device(batch))
                        if state.step % tcfg.log_every == 0:
                            log(state.step, metrics, prefix=f"epoch {epoch} ")
                        if (save_every_steps
                                and state.step % save_every_steps == 0):
                            save(epoch, False)
                        timer.toc()
                if main:
                    print(f"[{mode}] epoch {epoch}: {timer.mean_ms:.1f} "
                          f"ms/step (host clock, last {len(timer.times)} "
                          "steps)", flush=True)

                dev_acc = None
                if dev_batches is not None:
                    sums: Dict[str, float] = {}
                    n = 0
                    for batch in dev_batches():
                        m = eval_fn(state.model, to_device(batch))
                        for k, v in m.items():
                            sums[k] = sums.get(k, 0.0) + float(v)
                        n += 1
                    if n:
                        dev = {k: v / n for k, v in sums.items()}
                        dev_acc = dev["acc"]
                        log(state.step, dev, prefix=f"DEV epoch {epoch} ")

                if dev_acc is not None:
                    if dev_acc > best_acc:
                        best_acc = dev_acc
                    elif tcfg.optimizer == "adadelta":
                        for opt in (state.opt_g, state.opt_d):
                            steps_lib.decay_adadelta_eps(opt, tcfg.eps_decay)
                        if main:
                            print(f"[{mode}] dev plateau at epoch {epoch}: "
                                  f"eps *= {tcfg.eps_decay}", flush=True)
                save(epoch, True, dev_acc)
    finally:
        logger.close()
    sharding.barrier(mesh)  # the last save is durable on every rank's return
    return state
