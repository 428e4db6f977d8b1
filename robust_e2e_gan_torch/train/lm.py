"""RNNLM training: the next-token objective over transcript token streams.

Port of ``robust_e2e_gan_tpu/train/lm.py``: ``make_lm_train_step``
(``add_sos_eos``, ``lm_loss``, then the global-norm clip and the optimizer
of ``train/steps.py``), ``train_lm`` (the epoch loop with resume) and
``load_lm``. The teacher-forced pass runs the plain LSTM cells; the kernel
(``ops/lm_step.py``) serves the beam search. Checkpoints are the port's
``utils/checkpoint.py`` format.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Callable, Dict, Iterator, Optional, Union

import numpy as np
import torch

from robust_e2e_gan_torch import config as cfg_lib
from robust_e2e_gan_torch.config import LMConfig, TrainConfig
from robust_e2e_gan_torch.convert import from_flax, init_lm_params
from robust_e2e_gan_torch.models.e2e import add_sos_eos
from robust_e2e_gan_torch.models.lm import RNNLM, lm_loss
from robust_e2e_gan_torch.train.loop import resolve_device
from robust_e2e_gan_torch.train.steps import Optimizer, create_optimizer
from robust_e2e_gan_torch.utils import checkpoint as ckpt_lib
from robust_e2e_gan_torch.utils.logging import MetricLogger


@dataclasses.dataclass
class LMState:
    """The LM, its optimizer and the update count."""

    lm: RNNLM
    opt: Optimizer
    step: int = 0

    def state_dict(self) -> dict:
        """What a checkpoint holds (``utils/checkpoint.py``)."""
        return {"step": self.step, "lm": self.lm.state_dict(),
                "opt": self.opt.state_dict()}

    def load_state_dict(self, saved: dict, params_only: bool = False
                        ) -> None:
        """Restore in place; ``params_only`` loads the LM alone."""
        self.lm.load_state_dict(saved["lm"])
        if not params_only:
            self.opt.load_state_dict(saved["opt"])
            self.step = int(saved["step"])

    def load_jax_params(self, tree: dict) -> None:
        """Load the parameters of a JAX ``LMState`` tree (``params``)."""
        self.lm.load_state_dict(from_flax(tree["params"]))


def init_lm_state(lmcfg: LMConfig, tcfg: TrainConfig, device,
                  seed: int = 0) -> LMState:
    """A float32 LM with fresh parameters drawn from ``seed`` (the flax
    initialisers' distributions), on ``device``, and its optimizer."""
    lm = RNNLM(lmcfg)
    lm.load_state_dict(from_flax(init_lm_params(lmcfg, seed=seed)))
    lm.to(device)
    return LMState(lm, create_optimizer(lm.parameters(), tcfg))


def make_lm_train_step() -> Callable:
    """``step(state, labels (B, S) ignore_id-padded) -> metrics`` (loss,
    ppl, grad_norm as device tensors)."""

    def step_fn(state: LMState, labels: torch.Tensor
                ) -> Dict[str, torch.Tensor]:
        cfg = state.lm.cfg
        ys_in, ys_out, _ = add_sos_eos(labels, cfg.sos_id, cfg.eos_id,
                                       cfg.ignore_id)
        loss, ppl = lm_loss(state.lm(ys_in), ys_out, cfg.ignore_id)
        grads = torch.autograd.grad(loss, state.opt.params, allow_unused=True)
        norm = state.opt.step(list(grads))
        state.step += 1
        return {"loss": loss.detach(), "ppl": ppl.detach(), "grad_norm": norm}

    return step_fn


def train_lm(lmcfg: LMConfig, tcfg: TrainConfig,
             label_batches: Callable[[], Iterator[np.ndarray]],
             log_dir: Optional[str] = None, resume: bool = True,
             device: Union[str, torch.device] = "cuda") -> LMState:
    """Epoch loop over (B, S) int label batches (ignore_id padded); one
    checkpoint per epoch with metric -loss. ``device``: the GPU by default
    (raises without one); "cpu" only when asked for."""
    device = resolve_device(device)
    state = init_lm_state(lmcfg, tcfg, device, seed=tcfg.seed)
    start_epoch = 0
    if resume and ckpt_lib.has_checkpoint(tcfg.checkpoint_dir):
        ckpt_lib.restore_checkpoint(tcfg.checkpoint_dir, state)
        extra = ckpt_lib.read_extra(tcfg.checkpoint_dir)
        start_epoch = int(extra.get("epoch", -1)) + 1

    step_fn = make_lm_train_step()
    logger = MetricLogger(log_dir, name="lm")
    metrics: Dict[str, torch.Tensor] = {}
    try:
        for epoch in range(start_epoch, tcfg.num_epochs):
            for labels in label_batches():
                metrics = step_fn(state, torch.as_tensor(labels).to(device))
                if state.step % tcfg.log_every == 0:
                    logger.log(state.step, metrics, prefix=f"epoch {epoch} ")
            ckpt_lib.save_checkpoint(
                tcfg.checkpoint_dir, state, state.step,
                metric=-float(metrics["loss"]) if metrics else None, keep=3,
                extra={"epoch": epoch, "epoch_complete": True})
    finally:
        logger.close()
    return state


def load_lm(lm_dir: str, which: str = "best",
            device: Union[str, torch.device] = "cuda") -> RNNLM:
    """Rebuild the float32 RNNLM of a ``--mode lm`` run's directory on
    ``device``, in eval mode; "best" falls back to "latest" when the run
    recorded no best."""
    device = resolve_device(device)
    with open(os.path.join(lm_dir, "config.json")) as f:
        lmcfg = cfg_lib.from_dict(LMConfig, json.load(f)["lm"])
    state = init_lm_state(lmcfg, TrainConfig(optimizer="adam"), device)
    if which == "best" and not ckpt_lib.has_checkpoint(lm_dir, "best"):
        which = "latest"
    ckpt_lib.restore_checkpoint(lm_dir, state, which, params_only=True)
    return state.lm.eval()
