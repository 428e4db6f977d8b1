"""Rank functions of the data- and tensor-parallel drives: the joint
train step, the beam decode, ``train()`` and one inference BLSTM layer on
a (data, model) mesh, each also runnable in one process (``mesh=None``)
for the comparison.

``parallel.launch`` runs them in spawned ranks: ``chip_smoke.py`` phases
21 and 24 on the card, ``tests/test_torch_parallel.py`` and
``tests/test_torch_tensor_parallel.py`` on the CPU. Inputs are the global
batches as numpy arrays and the parameters as state dicts; every result
is host data (floats, numpy arrays, CPU tensors) with the kernel launches
and plain calls the rank made (``counters``). ``min_shard_dim`` is
``partition_rule``'s, on a model axis.
"""

from __future__ import annotations

import hashlib
import os
from typing import Dict, List, Optional

import numpy as np
import torch

from robust_e2e_gan_torch.decode.beam import make_beam_searcher
from robust_e2e_gan_torch.models.enhancement import Discriminator
from robust_e2e_gan_torch.models.rnn import BLSTM
from robust_e2e_gan_torch.parallel import sharding
from robust_e2e_gan_torch.pipeline import build_model
from robust_e2e_gan_torch.train import loop, steps
from robust_e2e_gan_torch.utils import checkpoint as ckpt_lib
from robust_e2e_gan_torch.utils import trace


# chip_smoke.py's names of counters that the renaming below names otherwise
_ALIASES = {"psi_plain": "plain.prefix_psi",
            "state_plain": "plain.prefix_state",
            "att_plain": "plain.att_loc_step"}


def counters() -> Dict[str, int]:
    """Kernel launches and plain-version calls so far, from
    ``utils/trace.py::counters``: ``launch.<w>`` as ``<w>``,
    ``route.<k>.<r>`` as ``<k>_<r>``, ``plain.<w>`` as ``<w>_plain``;
    ``psi`` and ``state`` the CTC prefix kernels' launches over both
    routes."""
    counts = trace.counters()
    out = {}
    for key, n in counts.items():
        kind, name = key.split(".", 1)
        out[{"launch": name, "route": name.replace(".", "_"),
             "plain": f"{name}_plain"}[kind]] = n
    out.update({k: counts[v] for k, v in _ALIASES.items()})
    for kind in ("psi", "state"):
        out[kind] = sum(n for k, n in counts.items()
                        if k.startswith(f"route.ctc_prefix_{kind}."))
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
    """Both modules' tensors on the host, keyed "g." and "d.", in the
    single-process layout (gathered on a model axis)."""
    out = {}
    for tag, module in (("g", state.model), ("d", state.discriminator)):
        for k, v in sharding.full_state_dict(module).items():
            out[f"{tag}.{k}"] = v.detach().to("cpu", copy=True)
    return out


def _named(state: steps.TrainState):
    """(key, optimizer, index, parameter) of both optimizers' parameters,
    keyed as ``params`` keys them."""
    for tag, module, opt in (("g", state.model, state.opt_g),
                             ("d", state.discriminator, state.opt_d)):
        keys = getattr(module, "full_state_keys", None) or list(
            module.state_dict())
        for i, (k, p) in enumerate(zip(keys, opt.params)):
            yield f"{tag}.{k}", opt, i, p


def _host(t: torch.Tensor) -> torch.Tensor:
    return t.detach().to("cpu", copy=True)


def opt_slots(state: steps.TrainState) -> Dict[str, Dict[str, torch.Tensor]]:
    """Each parameter's optimizer state on the host, keyed as ``params``
    keys it, at the full shape (gathered on a model axis)."""
    saved = {id(opt): opt.state_dict()["opt"]["state"]
             for opt in (state.opt_g, state.opt_d)}
    return {key: {k: _host(v) for k, v in saved[id(opt)].get(i, {}).items()
                  if v.dim()}
            for key, opt, i, _ in _named(state)}


def local_shards(state: steps.TrainState) -> dict:
    """Each model-sharded parameter as this rank stores it: its slice and
    its optimizer state's, on the host."""
    return {key: {"param": _host(p), **{k: _host(v) for k, v in
                                        opt.opt.state.get(p, {}).items()
                                        if v.dim()}}
            for key, opt, _, p in _named(state)
            if sharding.column_shard(p) is not None}


def state_bytes(state: steps.TrainState) -> int:
    """Bytes this rank stores of both modules' parameters and their
    optimizer states."""
    n = 0
    for _, opt, _, p in _named(state):
        n += p.numel() * p.element_size()
        n += sum(v.numel() * v.element_size()
                 for v in opt.opt.state.get(p, {}).values() if v.dim())
    return n


def joint_steps(mesh: Optional[sharding.Mesh], jcfg, tcfg, state_g,
                state_d, batches: List[Dict[str, np.ndarray]],
                device: str = "cpu", min_shard_dim: int = 512) -> dict:
    """One joint step a global batch, on the rank's rows under ``mesh``
    (on ``device`` over the whole batch without): every step's metrics,
    the parameters and optimizer state after the last in the
    single-process layout, the model-sharded slices as the rank stores
    them, the bytes of its parameters and optimizer state (counted, and on
    a card what ``torch.cuda.memory_allocated`` grew by once the state is
    built and sharded), and the launches of the steps."""
    dev = _device(mesh, device)
    cuda = dev.type == "cuda"
    base = torch.cuda.memory_allocated(dev) if cuda else 0
    state = _state(jcfg, tcfg, state_g, state_d, dev)
    sharding.shard_train_state(state, mesh, min_shard_dim)
    allocated = None
    if cuda:
        torch.cuda.synchronize(dev)
        allocated = torch.cuda.memory_allocated(dev) - base
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
            "slots": opt_slots(state), "shards": local_shards(state),
            "state_bytes": state_bytes(state),
            "allocated_after_shard": allocated, "launches": _since(before)}


def beam_decode(mesh: Optional[sharding.Mesh], jcfg, state_g,
                wav: np.ndarray, lens: np.ndarray, bcfg,
                device: str = "cpu", min_shard_dim: int = 512) -> dict:
    """The batched beam search of the rank's rows of (wav, lens) (all of
    them without ``mesh``) on the model sharded over ``mesh``: tokens,
    scores and lengths of its rows, and the launches and plain calls of
    its search."""
    dev = _device(mesh, device)
    model = build_model(jcfg)
    model.load_state_dict(state_g)
    model = sharding.shard_params(model.to(dev).eval(), mesh, min_shard_dim)
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
                      device: str = "cpu", prefetch_depth: int = 2,
                      min_shard_dim: int = 512, resume: bool = False
                      ) -> dict:
    """``train/loop.py::train`` over the batch lists (``tcfg``'s epochs,
    checkpoints in ``tcfg.checkpoint_dir``; ``resume``: from the latest
    there), then the latest checkpoint restored into a fresh state with no
    mesh: both states' parameters, the update counts, Adadelta's eps and
    the checkpoint files."""
    state = loop.train(jcfg, tcfg, lambda: iter(train_batches),
                       lambda: iter(dev_batches), mode="joint",
                       log_dir=tcfg.checkpoint_dir, resume=resume,
                       device=device, mesh=mesh,
                       prefetch_depth=prefetch_depth,
                       min_shard_dim=min_shard_dim)
    restored = loop.init_state(jcfg, tcfg, _device(mesh, device))
    ckpt_lib.restore_checkpoint(tcfg.checkpoint_dir, restored)
    eps = [o.opt.param_groups[0].get("eps") for o in (state.opt_g,
                                                      state.opt_d)]
    return {"params": params(state), "restored": params(restored),
            "step": state.step, "restored_step": restored.step, "eps": eps,
            "files": sorted(os.listdir(tcfg.checkpoint_dir))}


def blstm_layer(mesh: Optional[sharding.Mesh], weights, b: int, t: int,
                dtype: torch.dtype, seed: int, device: str = "cpu",
                min_shard_dim: int = 512) -> dict:
    """One inference BLSTM layer (``weights``: its wx, wh and bias) on a
    (B, T, D) input drawn on the device from ``seed``, all frames valid,
    without and then with its parameters sharded over ``mesh``: whether
    the two outputs are bit-equal, the sharded output's sha256, which
    leaves were sharded, and the launches of the sharded run."""
    dev = _device(mesh, device)
    d, h = weights["wx"].shape[1], weights["wh"].shape[1]
    layer = BLSTM(d, h, dtype, impl="auto")
    layer.load_state_dict(weights)
    layer = layer.to(dev).eval()
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    x = torch.randn((b, t, d), generator=gen, device=dev).to(dtype)
    with torch.no_grad():
        whole = layer(x)
        sharding.shard_params(layer, mesh, min_shard_dim)
        before = counters()
        with sharding.gathered(layer):
            got = layer(x)
        launches = _since(before)
    digest = hashlib.sha256(
        got.float().cpu().numpy().tobytes()).hexdigest()
    return {"equal": torch.equal(got, whole), "sha256": digest,
            "sharded": sorted(n for n, p in layer.named_parameters()
                              if sharding.column_shard(p) is not None),
            "launches": launches}


def mesh_view(mesh: sharding.Mesh, batch: int) -> dict:
    """This rank's place on the mesh and its rows of a global batch."""
    return {"rank": mesh.rank, "data_index": mesh.data_index,
            "model_index": mesh.model_index,
            "process_slice": sharding.process_batch_slice(batch),
            "rows": sharding.rows(batch, mesh)}


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
