"""Training steps: clean-ASR pretraining, the joint adversarial step
(D/G alternation; ``with_asr=False`` is GAN pretraining) and dev eval.

Port of ``robust_e2e_gan_tpu/train/steps.py``. The JAX package compiles
each step into one XLA program over immutable parameter trees; here a step
runs eagerly and updates the modules and optimizer states of its
``TrainState`` in place. A step returns its metrics as device tensors and
does not synchronise with the host.

Optimisation is the reference's: gradients clipped to a global norm of 5
exactly as optax's ``clip_by_global_norm`` (scaled by ``max_norm / norm``
only when ``norm >= max_norm``), then Adadelta (rho and eps in the param
group, so ``decay_adadelta_eps`` changes eps in place) or Adam with
optax's ``linear_schedule`` warmup (``lr / W`` at the first update,
``lr`` from update W on).

``input_kind`` is the batch's input: "wav" (waveforms through the
frontend), "feats" (precomputed log-mel, Kaldi feats.scp: ASR only) or
"spec" (precomputed power spectra through the enhancer, linear or, with
``log_domain``, Kaldi's log power). Speaker-CMVN stats ride the batch as
"cmvn_mean"/"cmvn_inv_std".

With a data mesh (``mesh``, ``parallel/sharding.py``) a step runs on the
rank's rows of the global batch inside ``data_parallel(mesh)``: each
optimizer averages its gradients over the ranks before the clip (the JAX
step's ``psum``), the loss terms that divide by a count over the batch
(valid tokens, valid frames) take that count over the global batch, and
the metrics are the global batch's on every rank. On a model axis the
model-sharded parameters and their optimizer state are this rank's
column slices: each step runs on the full weights, gathered once at its
start (``sharding.gathered``); the optimizer averages a slice's gradient
over the data axis, every other gradient over all ranks, and clips by the
full gradient's norm; ``TrainState.state_dict`` gathers the
single-process layout.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from robust_e2e_gan_torch.config import JointConfig, TrainConfig
from robust_e2e_gan_torch.convert import from_flax, to_flax
from robust_e2e_gan_torch.models.enhancement import (
    Discriminator,
    adversarial_losses,
    enhancement_loss,
)
from robust_e2e_gan_torch.parallel import sharding
from robust_e2e_gan_torch.pipeline import RobustE2E
from robust_e2e_gan_torch.utils.trace import span

Batch = Dict[str, torch.Tensor]


INPUT_KINDS = ("wav", "feats", "spec")


def _check_input_kind(input_kind: str) -> None:
    if input_kind not in INPUT_KINDS:
        raise ValueError(f"input_kind must be one of {INPUT_KINDS}, got "
                         f"{input_kind!r}")


def _cmvn_batch(batch: Batch):
    """The per-batch speaker-CMVN stats the loader attached, or None."""
    if "cmvn_mean" in batch:
        return (batch["cmvn_mean"], batch["cmvn_inv_std"])
    return None


class Optimizer:
    """Global-norm clip, then Adadelta or Adam, over a list of
    parameters."""

    def __init__(self, params: List[torch.nn.Parameter], tcfg: TrainConfig):
        self.params = list(params)
        self.tcfg = tcfg
        if tcfg.optimizer == "adadelta":
            self.opt = torch.optim.Adadelta(
                self.params, lr=tcfg.learning_rate, rho=tcfg.adadelta_rho,
                eps=tcfg.adadelta_eps)
        elif tcfg.optimizer == "adam":
            self.opt = torch.optim.Adam(self.params, lr=self._lr(0))
        else:
            raise ValueError(f"unknown optimizer {tcfg.optimizer!r}")
        self.count = 0  # updates applied

    def _lr(self, count: int) -> float:
        lr, w = self.tcfg.learning_rate, self.tcfg.warmup_steps
        if self.tcfg.optimizer != "adam" or w <= 0:
            return lr
        init = lr / w
        return (init - lr) * (1.0 - min(count, w) / w) + lr

    def step(self, grads: List[torch.Tensor]) -> torch.Tensor:
        """Clip ``grads`` (one per parameter; None for an unused one),
        apply them, and return the unclipped global norm. Under an active
        mesh the gradients are first averaged over the ranks
        (``sharding.mean_grads``), and the norm is the full gradient's."""
        grads = sharding.mean_grads(
            self.params, [torch.zeros_like(p) if g is None else g
                          for p, g in zip(self.params, grads)])
        norm = sharding.global_norm(self.params, grads)
        max_norm = self.tcfg.grad_clip
        for p, g in zip(self.params, grads):
            p.grad = torch.where(norm < max_norm, g, g / norm * max_norm)
        for group in self.opt.param_groups:
            if self.tcfg.optimizer == "adam":
                group["lr"] = self._lr(self.count)
        self.opt.step()
        self.count += 1
        for p in self.params:
            p.grad = None
        return norm

    def state_dict(self) -> dict:
        """The single-process layout: each model-sharded parameter's state
        gathered to its full shape (collective over the model group)."""
        opt = self.opt.state_dict()
        opt["state"] = {i: {k: self._full(self.params[i], v)
                            for k, v in slots.items()}
                        for i, slots in opt["state"].items()}
        return {"opt": opt, "count": self.count}

    @staticmethod
    def _full(p: torch.Tensor, t):
        """``t`` (``p``'s or a slot of its state) at ``p``'s full shape."""
        shard = sharding.column_shard(p)
        if shard is None or not isinstance(t, torch.Tensor) or not t.dim():
            return t
        return shard.gather(t)

    def slice_state(self) -> None:
        """Slice the state of each model-sharded parameter to its columns
        (after ``sharding.shard_train_state`` sharded the parameters)."""
        for p in self.params:
            shard = sharding.column_shard(p)
            slots = self.opt.state.get(p, {}) if shard is not None else {}
            for k, v in slots.items():
                if v.dim():
                    slots[k] = shard.right_inverse(v)

    def load_state_dict(self, state: dict) -> None:
        self.opt.load_state_dict(state["opt"])
        self.count = int(state["count"])

    def optax_state(self, names: List[str]) -> dict:
        """This state as the JAX ``create_optimizer`` chain's optax state
        in the flax layout (``names``: each parameter's state-dict key):
        the clip's empty state, then ``inject_hyperparams(adadelta)``'s
        count, hyperparameters and accumulators (e_g = torch's square_avg,
        e_x = its acc_delta), or adam's count and moments (mu, nu), with a
        warmup schedule's count after them. A slot no update has made yet
        is zeros."""
        def slot(key):
            return to_flax({n: self._full(p, self.opt.state.get(p, {}).get(
                key, torch.zeros_like(p))) for n, p in zip(names, self.params)})

        count = np.asarray(self.count, np.int32)
        if isinstance(self.opt, torch.optim.Adadelta):
            group = self.opt.param_groups[0]
            hyper = {k: np.asarray(v, np.float32) for k, v in (
                ("eps", group["eps"]), ("learning_rate", group["lr"]),
                ("rho", group["rho"]), ("weight_decay", 0.0))}
            inner = {"0": {}, "1": {"e_g": slot("square_avg"),
                                    "e_x": slot("acc_delta")}, "2": {}}
            return {"0": {}, "1": {"count": count, "hyperparams": hyper,
                                   "hyperparams_states": {},
                                   "inner_state": inner}}
        adam = {"0": {"count": count, "mu": slot("exp_avg"),
                      "nu": slot("exp_avg_sq")},
                "1": {"count": count} if self.tcfg.warmup_steps > 0 else {}}
        return {"0": {}, "1": adam}


def create_optimizer(params, tcfg: TrainConfig) -> Optimizer:
    """Grad clip + Adadelta (the reference default) or Adam."""
    return Optimizer(params, tcfg)


def decay_adadelta_eps(opt: Optimizer, factor: float) -> None:
    """Multiply Adadelta's eps by ``factor`` in place (the reference's
    eps decay); a no-op for Adam."""
    if isinstance(opt.opt, torch.optim.Adadelta):
        for group in opt.opt.param_groups:
            group["eps"] *= factor


@dataclasses.dataclass
class TrainState:
    """Generator (enhancer + ASR) and discriminator with their optimizers,
    the update count, and the "dropout" and "sampling" generators."""

    model: RobustE2E
    discriminator: Discriminator
    opt_g: Optimizer
    opt_d: Optimizer
    rngs: Dict[str, torch.Generator]
    step: int = 0

    def state_dict(self) -> dict:
        """What a checkpoint holds (``utils/checkpoint.py``), in the
        single-process layout also on a model axis (collective there:
        every rank of the model group calls)."""
        return {
            "step": self.step,
            "model": sharding.full_state_dict(self.model),
            "discriminator": sharding.full_state_dict(self.discriminator),
            "opt_g": self.opt_g.state_dict(),
            "opt_d": self.opt_d.state_dict(),
            "rngs": {k: g.get_state() for k, g in self.rngs.items()},
        }

    def load_state_dict(self, saved: dict, params_only: bool = False
                        ) -> None:
        """Restore in place; ``params_only`` loads the two modules alone
        (a warm start)."""
        self.model.load_state_dict(saved["model"])
        self.discriminator.load_state_dict(saved["discriminator"])
        if params_only:
            return
        self.opt_g.load_state_dict(saved["opt_g"])
        self.opt_d.load_state_dict(saved["opt_d"])
        for k, g in self.rngs.items():
            g.set_state(saved["rngs"][k].cpu())
        self.step = int(saved["step"])

    def jax_tree(self) -> dict:
        """This state as a JAX ``TrainState`` tree in the flax layout
        (``train/steps.py:81-91`` of the JAX package): the step, both
        parameter trees, both optax states and the PRNG key of the seed
        (the torch generators have no JAX key)."""
        named = {"g": sharding.full_state_dict(self.model),
                 "d": sharding.full_state_dict(self.discriminator)}
        seed = self.opt_g.tcfg.seed
        return {"step": np.asarray(self.step, np.int32),
                "params_g": to_flax(named["g"]),
                "opt_state_g": self.opt_g.optax_state(list(named["g"])),
                "params_d": to_flax(named["d"]),
                "opt_state_d": self.opt_d.optax_state(list(named["d"])),
                "rng": np.array([0, seed], np.uint32)}

    def load_jax_params(self, tree: dict) -> None:
        """Load the parameters of a JAX ``TrainState`` tree (``params_g``,
        ``params_d``), as a warm start loads them. The tree of a run on
        precomputed log-mel has no enhancer: the enhancer keeps its
        parameters."""
        missing, unexpected = self.model.load_state_dict(
            from_flax(tree["params_g"]), strict=False)
        stray = unexpected + [k for k in missing
                              if not k.startswith("enhancer.")]
        if stray:
            raise KeyError(f"the JAX params_g does not fit the model: {stray}")
        self.discriminator.load_state_dict(from_flax(tree["params_d"]))


def init_train_state(model: RobustE2E, discriminator: Discriminator,
                     tcfg: TrainConfig, seed: int = 0) -> TrainState:
    """Optimizers over the two modules (already loaded and on their
    device) and random streams seeded from ``seed``."""
    dev = next(model.parameters()).device
    rngs = {}
    for i, name in enumerate(("dropout", "sampling")):
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed * 2 + i)
        rngs[name] = gen
    return TrainState(model, discriminator,
                      create_optimizer(model.parameters(), tcfg),
                      create_optimizer(discriminator.parameters(), tcfg),
                      rngs)


def _grads(loss: torch.Tensor, params) -> List[torch.Tensor]:
    return list(torch.autograd.grad(loss, params, allow_unused=True))


def _asr_out(model: RobustE2E, batch: Batch, input_kind: str,
             use_enhancer: bool, log_domain: bool, wav: str, **kw):
    """The ASR forward of ``batch``, as the JAX steps dispatch it: spectra
    where ``input_kind`` is "spec", else log-mel features where the batch
    has them (a waveform dev set of a feats run takes the frontend), else
    the waveforms under key ``wav``."""
    cmvn = _cmvn_batch(batch)
    if input_kind == "spec":
        return model.asr_forward_spec(
            batch["feats"], batch["feat_lengths"], batch["labels"],
            use_enhancer=use_enhancer, cmvn_batch=cmvn,
            log_domain=log_domain, **kw)
    if "feats" in batch:
        return model.asr_forward_feats(
            batch["feats"], batch["feat_lengths"], batch["labels"],
            cmvn_batch=cmvn, **kw)
    return model.asr_forward(batch[wav], batch["wav_lengths"],
                             batch["labels"], use_enhancer=use_enhancer,
                             cmvn_batch=cmvn, **kw)


def make_asr_pretrain_step(use_enhancer: bool = False,
                           input_kind: str = "wav",
                           log_domain: bool = False,
                           mesh: Optional[sharding.Mesh] = None) -> Callable:
    """Clean-ASR pretraining: ``step(state, batch) -> metrics``."""
    _check_input_kind(input_kind)

    @sharding.data_parallel(mesh)
    def step_fn(state: TrainState, batch: Batch) -> Dict[str, torch.Tensor]:
        with sharding.gathered(state.model):
            out = _asr_out(state.model, batch, input_kind, use_enhancer,
                           log_domain, "clean_wav", deterministic=False,
                           rngs=state.rngs)
            grads = _grads(out["loss"], state.opt_g.params)
        norm = state.opt_g.step(grads)
        state.step += 1
        return sharding.mean_metrics({
            "loss": out["loss"].detach(),
            "loss_ctc": out["loss_ctc"].detach(),
            "loss_att": out["loss_att"].detach(),
            "acc": out["acc"].detach(), "grad_norm": norm})

    return step_fn


def make_eval_step(use_enhancer: bool = True, input_kind: str = "wav",
                   log_domain: bool = False,
                   mesh: Optional[sharding.Mesh] = None) -> Callable:
    """Dev-eval forward: ``eval(model, batch) -> ASR metrics``, on the
    enhanced noisy speech when ``use_enhancer`` (the quantity the reference
    tracked for eps decay and the best checkpoint); under ``mesh``, the
    global batch's metrics on every rank."""
    _check_input_kind(input_kind)
    wav = "noisy_wav" if use_enhancer else "clean_wav"

    @torch.no_grad()
    @sharding.data_parallel(mesh)
    def eval_fn(model: RobustE2E, batch: Batch) -> Dict[str, torch.Tensor]:
        with sharding.gathered(model):
            out = _asr_out(model, batch, input_kind, use_enhancer,
                           log_domain, wav)
        return sharding.mean_metrics(
            {k: out[k] for k in ("loss", "loss_ctc", "loss_att", "acc")})

    return eval_fn


def make_joint_train_step(jcfg: JointConfig, with_asr: bool = True,
                          input_kind: str = "wav",
                          log_domain: bool = False,
                          mesh: Optional[sharding.Mesh] = None) -> Callable:
    """One alternating adversarial update, ``step(state, batch) ->
    metrics``: the D-step on the generator's deterministic output (no
    gradient to G), then the G-step against the updated D, with loss
    L_ASR + lambda_adv * L_adv + mu_enh * L_enh (L_ASR left out when
    ``with_asr`` is False: GAN pretraining). ``input_kind="spec"`` runs
    the same objective on precomputed spectra (batch keys feats,
    clean_feats, feat_lengths)."""
    _check_input_kind(input_kind)
    if input_kind == "feats":
        raise ValueError(
            "the joint and GAN steps need the linear spectrum the enhancer "
            "masks: precomputed log-mel features train --mode asr only")
    loss_type = jcfg.discriminator.loss_type

    @sharding.data_parallel(mesh)
    def step_fn(state: TrainState, batch: Batch) -> Dict[str, torch.Tensor]:
        with span("rg.train.step", state.step):
            return joint_step(state, batch)

    def joint_step(state: TrainState, batch: Batch
                   ) -> Dict[str, torch.Tensor]:
        model, disc = state.model, state.discriminator
        if input_kind == "spec":
            forward = model.joint_forward_spec
            args = (batch["feats"], batch["clean_feats"],
                    batch["feat_lengths"], batch["labels"])
            kw = {"log_domain": log_domain}
        else:
            forward = model.joint_forward
            args = (batch["noisy_wav"], batch["clean_wav"],
                    batch["wav_lengths"], batch["labels"])
            kw = {}
        kw["cmvn_batch"] = _cmvn_batch(batch)

        # on a model axis the generator is gathered once (it changes only
        # at the step's end), the discriminator before and after its update
        with sharding.gathered(model):
            # ---- D-step: the generator runs without a graph
            with span("rg.train.d.forward"), torch.no_grad():
                fixed = forward(*args, with_asr=False, **kw)
            with span("rg.train.d.disc"), sharding.gathered(disc):
                d_real = disc(fixed["clean_logmel"], fixed["frame_mask"])
                d_fake = disc(fixed["enhanced_logmel"], fixed["frame_mask"])
                loss_d, _ = adversarial_losses(d_real, d_fake, loss_type)
                grads_d = _grads(loss_d, state.opt_d.params)
            with span("rg.train.d.optimizer"):
                norm_d = state.opt_d.step(grads_d)

            # ---- G-step against the updated discriminator
            with sharding.gathered(disc):
                with span("rg.train.g.forward"):
                    out = forward(*args, deterministic=False,
                                  rngs=state.rngs, with_asr=with_asr, **kw)
                    d_fake = disc(out["enhanced_logmel"], out["frame_mask"])
                    d_real = disc(out["clean_logmel"], out["frame_mask"])
                    _, loss_adv = adversarial_losses(d_real, d_fake,
                                                     loss_type)
                    loss_enh = enhancement_loss(
                        out["enhanced_power"], out["clean_power"],
                        out["frame_mask"], kind=jcfg.enh_loss)
                    loss_asr = out["loss"] if with_asr else 0.0
                    loss_g = (loss_asr + jcfg.lambda_adv * loss_adv
                              + jcfg.mu_enh * loss_enh)
                with span("rg.train.g.backward"):
                    grads_g = _grads(loss_g, state.opt_g.params)
        with span("rg.train.g.optimizer"):
            norm_g = state.opt_g.step(grads_g)
        state.step += 1
        metrics = {"loss_g": loss_g, "loss_d": loss_d, "loss_adv": loss_adv,
                   "loss_enh": loss_enh, "grad_norm_g": norm_g,
                   "grad_norm_d": norm_d}
        if with_asr:
            metrics.update(loss_asr=out["loss"], loss_ctc=out["loss_ctc"],
                           loss_att=out["loss_att"], acc=out["acc"])
        return sharding.mean_metrics({k: v.detach()
                                      for k, v in metrics.items()})

    return step_fn
