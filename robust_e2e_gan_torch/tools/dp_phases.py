"""Rank functions of the data-parallel drives: the joint train step, the
beam decode and ``train()`` on a data mesh, each also runnable in one
process (``mesh=None``) for the comparison.

``parallel.launch`` runs them in spawned ranks: ``chip_smoke.py`` phase 21
on the card, ``tests/test_torch_parallel.py`` on the CPU. Inputs are the
global batches as numpy arrays and the parameters as state dicts; every
result is host data (floats, numpy arrays, CPU tensors) with the kernel
launches and plain calls the rank made (``counters``).
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional

import numpy as np
import torch

from robust_e2e_gan_torch.decode.beam import make_beam_searcher
from robust_e2e_gan_torch.models.enhancement import Discriminator
from robust_e2e_gan_torch.ops import att, blstm, blstm_train, ctc, ctc_prefix
from robust_e2e_gan_torch.parallel import sharding
from robust_e2e_gan_torch.pipeline import build_model
from robust_e2e_gan_torch.train import loop, steps
from robust_e2e_gan_torch.utils import checkpoint as ckpt_lib


def counters() -> Dict[str, int]:
    """Kernel launches (by route where a wrapper has two) and plain-version
    calls of the train step's and the serving decode's kernels so far."""
    out = {
        "blstm_train": blstm_train.blstm_train.launches,
        "blstm_train_gx": blstm_train.blstm_train_gx.launches,
        "gemm": blstm_train.gemm.launches,
        "ctc_nll": ctc.ctc_nll.launches,
        "psi": sum(ctc_prefix.PREFIX_ROUTE_LAUNCHES["psi"].values()),
        "state": sum(ctc_prefix.PREFIX_ROUTE_LAUNCHES["state"].values()),
        "blstm_train_plain": blstm_train.blstm_train_plain.calls,
        "gemm_plain": blstm_train.gemm_plain.calls,
        "ctc_nll_plain": ctc.ctc_nll_plain.calls,
        "psi_plain": ctc_prefix.prefix_psi_recursion_plain.calls,
        "state_plain": ctc_prefix.prefix_state_plain.calls,
        "blstm_infer_plain": blstm.blstm_infer_plain.calls,
        "att_plain": att.att_loc_step_plain.calls,
    }
    for route, n in blstm.INFER_ROUTE_LAUNCHES.items():
        out[f"blstm_infer_{route}"] = n
    for route, n in blstm.GX_ROUTE_LAUNCHES.items():
        out[f"blstm_recurrence_{route}"] = n
    for route, n in att.ATT_ROUTE_LAUNCHES.items():
        out[f"att_loc_step_{route}"] = n
    return out


def _since(before: Dict[str, int]) -> Dict[str, int]:
    return {k: v - before[k] for k, v in counters().items()}


def _device(mesh, device) -> torch.device:
    return mesh.device if mesh is not None else torch.device(device)


def _state(jcfg, tcfg, state_g, state_d, dev) -> steps.TrainState:
    model = build_model(jcfg)
    model.load_state_dict(state_g)
    disc = Discriminator(jcfg.discriminator, model.dtype)
    disc.load_state_dict(state_d)
    return steps.init_train_state(model.to(dev), disc.to(dev), tcfg,
                                  seed=tcfg.seed)


def params(state: steps.TrainState) -> Dict[str, torch.Tensor]:
    """Both modules' tensors on the host, keyed "g." and "d."."""
    out = {}
    for tag, module in (("g", state.model), ("d", state.discriminator)):
        for k, v in module.state_dict().items():
            out[f"{tag}.{k}"] = v.detach().to("cpu", copy=True)
    return out


def joint_steps(mesh: Optional[sharding.Mesh], jcfg, tcfg, state_g,
                state_d, batches: List[Dict[str, np.ndarray]],
                device: str = "cpu") -> dict:
    """One joint step a global batch, on the rank's rows under ``mesh``
    (on ``device`` over the whole batch without): every step's metrics,
    the parameters after the last, and the launches of the steps."""
    dev = _device(mesh, device)
    state = _state(jcfg, tcfg, state_g, state_d, dev)
    sharding.shard_train_state(state, mesh)
    step = steps.make_joint_train_step(jcfg, mesh=mesh)
    before = counters()
    metrics = []
    for batch in batches:
        rows = sharding.shard_batch(
            {k: v for k, v in batch.items() if k in loop.BATCH_KEYS}, mesh)
        m = step(state, loop.device_batch(rows, dev))
        metrics.append({k: float(v) for k, v in m.items()})
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return {"metrics": metrics, "params": params(state),
            "launches": _since(before)}


def beam_decode(mesh: Optional[sharding.Mesh], jcfg, state_g,
                wav: np.ndarray, lens: np.ndarray, bcfg,
                device: str = "cpu") -> dict:
    """The batched beam search of the rank's rows of (wav, lens) (all of
    them without ``mesh``): tokens, scores and lengths of its rows, and
    the launches and plain calls of its search."""
    dev = _device(mesh, device)
    model = build_model(jcfg)
    model.load_state_dict(state_g)
    model = sharding.replicated(model.to(dev).eval(), mesh)
    search = make_beam_searcher(model, jcfg.e2e, bcfg)
    rows = sharding.rows(len(wav), mesh)
    before = counters()
    res = search(torch.from_numpy(wav[rows]).to(dev),
                 torch.from_numpy(lens[rows]).to(dev))
    return {"tokens": res.tokens.cpu().numpy(),
            "scores": res.scores.cpu().numpy(),
            "lengths": res.lengths.cpu().numpy(),
            "launches": _since(before)}


def train_and_restore(mesh: Optional[sharding.Mesh], jcfg, tcfg,
                      train_batches: List[Dict[str, np.ndarray]],
                      dev_batches: List[Dict[str, np.ndarray]],
                      device: str = "cpu", prefetch_depth: int = 2) -> dict:
    """``train/loop.py::train`` over the batch lists (``tcfg``'s epochs,
    checkpoints in ``tcfg.checkpoint_dir``), then the latest checkpoint
    restored into a fresh state: both states' parameters, the update
    counts, Adadelta's eps and the checkpoint files."""
    state = loop.train(jcfg, tcfg, lambda: iter(train_batches),
                       lambda: iter(dev_batches), mode="joint",
                       log_dir=tcfg.checkpoint_dir, resume=False,
                       device=device, mesh=mesh,
                       prefetch_depth=prefetch_depth)
    restored = loop.init_state(jcfg, tcfg, _device(mesh, device))
    ckpt_lib.restore_checkpoint(tcfg.checkpoint_dir, restored)
    eps = [o.opt.param_groups[0].get("eps") for o in (state.opt_g,
                                                      state.opt_d)]
    return {"params": params(state), "restored": params(restored),
            "step": state.step, "restored_step": restored.step, "eps": eps,
            "files": sorted(os.listdir(tcfg.checkpoint_dir))}


def fail_before_collective(mesh: sharding.Mesh, failing_rank: int) -> None:
    """``failing_rank`` raises ValueError at once; every other rank waits
    in an all-reduce that rank never joins (the launcher's failure path)."""
    if mesh.rank == failing_rank:
        raise ValueError(f"rank {failing_rank} failed before the all-reduce")
    sharding.all_mean([torch.zeros(1, device=mesh.device)], mesh)


def run_all(mesh: Optional[sharding.Mesh], calls) -> list:
    """Several drives in one launch: ``[fn(mesh, *args, **kw) for fn,
    args, kw in calls]``."""
    return [fn(mesh, *args, **kw) for fn, args, kw in calls]
