"""Data parallelism: one process per card over ``torch.distributed``.

Port of ``robust_e2e_gan_tpu/parallel/sharding.py``. The JAX package runs
one program over a ``Mesh('data', 'model')`` and lets XLA place the
gradient all-reduces. Here each rank of the data axis is a process of its
own with its own device (``parallel/launcher.py`` starts them), and the
collectives are explicit:

* a batch is the GLOBAL batch on every rank (the same draws from the same
  seed, padded to the global batch's widths); a rank keeps rows
  ``[r * B / N, (r + 1) * B / N)`` (``shard_batch``), so its tensors are
  exactly rows of the single-process batch;
* parameters and optimizer state are broadcast from rank 0 once, at the
  start (``shard_params``, ``shard_train_state``); ``replicated`` is the
  name of that placement;
* inside a train or eval step (``data_parallel(mesh)``), each optimizer's
  gradient list is averaged over the ranks before the global-norm clip
  (``all_mean``, in buckets), and every loss term that divides by a count
  over the whole batch (valid tokens, valid frames) divides by that count
  summed over the ranks (``mean_denominator``): then the mean over ranks
  of each rank's loss is the single-process loss, and the mean of their
  gradients its gradient. Random draws of a step are drawn at the global
  batch's shape and sliced to the rank's rows (``rows_rand``), so dropout
  and scheduled sampling draw what one process would.

``make_mesh`` is a small record (world size, this rank, its device, its
process group); ``n_model > 1`` is not ported (ROADMAP queue 1, tensor
parallel), though the pure ``partition_rule`` is. The JAX package's
ambient kernel mesh (``set_kernel_mesh``, ``kernel_mesh``,
``local_kernel_batch``, ``sharded_kernel_call``) has no counterpart: in a
process per card, each kernel already sees only its rank's rows, and the
kernels' launch plans are made for that local batch.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

DATA_AXIS = "data"
MODEL_AXIS = "model"
# elements of one all-reduce of ``all_mean``: ~128 MiB of float32
BUCKET_ELEMENTS = 1 << 25

TENSOR_PARALLEL = ("tensor parallelism (mesh model axis > 1) is not ported "
                   "(ROADMAP queue 1, tensor parallel)")


@dataclasses.dataclass(frozen=True)
class Mesh:
    """The data axis as this process sees it.

    ``placement``: "cpu" (gloo ranks on the CPU), "cuda" (one card a rank:
    rank r on card r, NCCL) or "cuda:k" (every rank on card k, gloo).
    ``group`` is None until the ranks have joined (``launch``); a mesh of
    more than one rank runs its collectives only then."""

    n_data: int
    placement: str = "cuda"
    rank: int = 0
    group: Any = None

    @property
    def shape(self) -> Dict[str, int]:
        return {DATA_AXIS: self.n_data, MODEL_AXIS: 1}

    @property
    def device(self) -> torch.device:
        dev = torch.device(self.placement)
        if dev.type == "cuda" and dev.index is None:
            return torch.device("cuda", self.rank)
        return dev

    @property
    def backend(self) -> str:
        dev = torch.device(self.placement)
        return "nccl" if dev.type == "cuda" and dev.index is None else "gloo"

    @property
    def is_main(self) -> bool:
        return self.rank == 0


def make_mesh(n_data: Optional[int] = None, n_model: int = 1,
              device: str = "cuda") -> Mesh:
    """The (data, 1) mesh of ``n_data`` ranks on ``device`` ("cuda": one
    card each; "cuda:k": all on card k; "cpu").

    Outside ``launch`` it is the plan the launcher starts (rank 0, no
    group); inside a rank it is that rank's view of the joined group. With
    ``n_data=None`` every card goes to the data axis ("cuda"), else the
    joined group's size, else 1. One card a rank cannot exceed the cards
    present; CPU ranks and ranks sharing a card have no such limit, like
    the JAX package's virtual CPU devices."""
    if n_model > 1:
        raise NotImplementedError(f"mesh (., {n_model}): {TENSOR_PARALLEL}")
    dev = torch.device(device)
    per_card = dev.type == "cuda" and dev.index is None
    joined = dist.is_available() and dist.is_initialized()
    if n_data is None:
        n_data = (torch.cuda.device_count() if per_card
                  else dist.get_world_size() if joined else 1)
    if per_card:
        have = torch.cuda.device_count()
        if n_data * n_model > have:
            raise ValueError(f"mesh ({n_data},{n_model}) needs "
                             f"{n_data * n_model} devices, have {have}")
    if not joined:
        return Mesh(n_data, str(device))
    if dist.get_world_size() != n_data:
        raise ValueError(f"mesh ({n_data},{n_model}) needs {n_data} "
                         f"processes, have {dist.get_world_size()}")
    return Mesh(n_data, str(device), dist.get_rank(), dist.group.WORLD)


def _group(mesh: Mesh):
    if mesh.group is None and mesh.n_data > 1:
        raise RuntimeError(f"a mesh of {mesh.n_data} ranks runs its "
                           "collectives only inside parallel.launch")
    return mesh.group


def _joined(mesh: Optional[Mesh]) -> bool:
    """True where ``mesh`` has collectives to run (a joined group, even of
    one rank)."""
    return mesh is not None and _group(mesh) is not None


def partition_rule(shape: Tuple[int, ...], n_model: int,
                   min_shard_dim: int = 512) -> Tuple[Optional[str], ...]:
    """The JAX package's shape rule for tensor parallelism, as a tuple
    spec: 2-D+ weights whose last dim is at least ``min_shard_dim`` and
    divides by the model axis shard column-wise (``(None, ..., "model")``);
    everything else replicates (``()``). Applying it is not ported."""
    if (n_model > 1 and len(shape) >= 2 and shape[-1] >= min_shard_dim
            and shape[-1] % n_model == 0):
        return (None,) * (len(shape) - 1) + (MODEL_AXIS,)
    return ()


def process_batch_slice(global_batch: int) -> slice:
    """This process's rows of a globally indexed batch (the whole range
    outside a process group)."""
    joined = dist.is_available() and dist.is_initialized()
    n = dist.get_world_size() if joined else 1
    if global_batch % n:
        raise ValueError(f"global batch {global_batch} % processes {n} != 0")
    per = global_batch // n
    i = dist.get_rank() if joined else 0
    return slice(i * per, (i + 1) * per)


def local_batch_size(global_batch: int, mesh: Mesh) -> int:
    n = mesh.n_data
    if global_batch % n:
        raise ValueError(f"global batch {global_batch} % data axis {n} != 0")
    return global_batch // n


def rows(batch_size: int, mesh: Optional[Mesh]) -> slice:
    """The rank's rows of a global batch of ``batch_size`` (all of them
    without a mesh)."""
    if mesh is None:
        return slice(0, batch_size)
    per = batch_size // mesh.n_data
    return slice(mesh.rank * per, (mesh.rank + 1) * per)


def serving_split(batch_size: int, mesh: Optional[Mesh]
                  ) -> Tuple[Optional[Mesh], Optional[slice]]:
    """(the mesh a serving batch is split over, this rank's rows): the
    whole mesh where the batch divides over it; else, as the JAX CLIs
    place a ragged batch on one device, no mesh, all rows on rank 0 and
    none (None) on the others."""
    if mesh is not None and batch_size % mesh.n_data == 0:
        return mesh, rows(batch_size, mesh)
    if mesh is None or mesh.is_main:
        return None, slice(0, batch_size)
    return None, None


def shard_batch(batch: Dict[str, Any], mesh: Optional[Mesh]
                ) -> Dict[str, Any]:
    """This rank's rows of every array of a global batch (numpy arrays or
    tensors); raises where a leading dim does not divide over the data
    axis."""
    if mesh is None:
        return batch
    out = {}
    for k, x in batch.items():
        if x.ndim == 0 or x.shape[0] % mesh.n_data:
            raise ValueError(f"batch dim {tuple(x.shape)} not divisible by "
                             f"data axis {mesh.n_data}")
        out[k] = x[rows(x.shape[0], mesh)]
    return out


# --------------------------------------------------------------------------
# the active mesh of a step, and its collectives
# --------------------------------------------------------------------------

_ACTIVE: Optional[Mesh] = None


@contextlib.contextmanager
def data_parallel(mesh: Optional[Mesh]) -> Iterator[None]:
    """Run the block's losses, draws and optimizer updates over ``mesh``
    (nothing changes with None). The train and eval steps enter it."""
    global _ACTIVE
    prev, _ACTIVE = _ACTIVE, mesh
    try:
        yield
    finally:
        _ACTIVE = prev


def _buckets(tensors: Sequence[torch.Tensor]) -> List[List[int]]:
    """Indices of ``tensors`` in groups of one dtype and device, each at
    most ``BUCKET_ELEMENTS`` (a larger tensor alone)."""
    out, open_ = [], {}
    for i, t in enumerate(tensors):
        key = (t.dtype, t.device)
        idx, size = open_.get(key, ([], 0))
        if idx and size + t.numel() > BUCKET_ELEMENTS:
            out.append(idx)
            idx, size = [], 0
        open_[key] = (idx + [i], size + t.numel())
    return out + [idx for idx, _ in open_.values()]


def all_mean(tensors: Sequence[torch.Tensor],
             mesh: Optional[Mesh] = None) -> List[torch.Tensor]:
    """The mean over the ranks of each tensor (new tensors; the inputs
    themselves without a joined mesh), by one all-reduce a bucket.
    ``mesh`` defaults to the active one."""
    mesh = mesh or _ACTIVE
    out = list(tensors)
    if not _joined(mesh):
        return out
    for idx in _buckets(out):
        flat = torch.cat([out[i].detach().reshape(-1) for i in idx])
        dist.all_reduce(flat, group=mesh.group)
        flat.div_(mesh.n_data)
        off = 0
        for i in idx:
            n = out[i].numel()
            out[i] = flat[off:off + n].view_as(out[i])
            off += n
    return out


def mean_metrics(metrics: Dict[str, torch.Tensor]
                 ) -> Dict[str, torch.Tensor]:
    """Each metric's mean over the ranks of the active mesh: what one
    process would report over the global batch (every loss term of a step
    under the mesh is a rank's share of its global mean). A
    ``grad_norm*`` is already global and is kept as it is."""
    mesh = _ACTIVE
    keys = [k for k in metrics if not k.startswith("grad_norm")]
    if not _joined(mesh) or not keys:
        return metrics
    means = all_mean([torch.stack([metrics[k].float() for k in keys])],
                     mesh)[0]
    return {**metrics, **dict(zip(keys, means.unbind()))}


def mean_denominator(count: torch.Tensor, floor: float = 1.0
                     ) -> torch.Tensor:
    """``max(count, floor)`` with ``count`` summed over the ranks of the
    active mesh and divided by their number: the denominator that makes a
    rank's masked sum its share of the mean over the global batch (the
    mean over ranks of sum_r / d is sum / max(count, floor)). Without a
    mesh, ``max(count, floor)``."""
    mesh = _ACTIVE
    if not _joined(mesh):
        return torch.clamp_min(count, floor)
    total = count.detach().float().clone()
    dist.all_reduce(total, group=mesh.group)
    return torch.clamp_min(total, floor) / mesh.n_data


def rows_rand(shape: Sequence[int], generator: Optional[torch.Generator],
              device) -> torch.Tensor:
    """``torch.rand(shape)`` of the rank's rows of a global draw: under a
    mesh of N ranks the draw is (N * shape[0], ...) and the rank keeps its
    rows, so every rank's generator moves in step and the draws are those
    of one process over the global batch."""
    mesh = _ACTIVE
    if mesh is None or mesh.n_data == 1:
        return torch.rand(tuple(shape), generator=generator, device=device)
    full = torch.rand((shape[0] * mesh.n_data, *shape[1:]),
                      generator=generator, device=device)
    return full[rows(full.shape[0], mesh)]


def barrier(mesh: Optional[Mesh]) -> None:
    if _joined(mesh):
        dist.barrier(group=mesh.group)


def gather_rows(arrays: Sequence[np.ndarray], mesh: Optional[Mesh]
                ) -> Optional[List[np.ndarray]]:
    """Each numpy array's rows of every rank, concatenated in rank order on
    rank 0 (None on the others): hypotheses and features travel as host
    objects (gloo gathers no CUDA tensor)."""
    if not _joined(mesh):
        return list(arrays)
    parts = [None] * mesh.n_data if mesh.is_main else None
    dist.gather_object(list(arrays), parts, dst=0, group=mesh.group)
    if not mesh.is_main:
        return None
    return [np.concatenate([p[i] for p in parts]) for i in range(len(arrays))]


# --------------------------------------------------------------------------
# replicated state: broadcast from rank 0 once
# --------------------------------------------------------------------------


def shard_params(module: torch.nn.Module, mesh: Optional[Mesh]
                 ) -> torch.nn.Module:
    """Make every parameter and buffer of ``module`` rank 0's, in place."""
    if _joined(mesh):
        with torch.no_grad():
            for t in list(module.parameters()) + list(module.buffers()):
                dist.broadcast(t.data, src=0, group=mesh.group)
    return module


replicated = shard_params


def shard_train_state(state, mesh: Optional[Mesh]):
    """Make a ``train/steps.py::TrainState`` rank 0's, in place: both
    modules by broadcast, and the step, the optimizer states and the
    generators' states as one host object."""
    if not _joined(mesh):
        return state
    shard_params(state.model, mesh)
    shard_params(state.discriminator, mesh)
    from robust_e2e_gan_torch.utils.checkpoint import host_snapshot

    rest = [None]
    if mesh.is_main:
        saved = state.state_dict()
        rest = [host_snapshot({k: v for k, v in saved.items()
                               if k not in ("model", "discriminator")})]
    dist.broadcast_object_list(rest, src=0, group=mesh.group)
    if not mesh.is_main:
        saved = rest[0]
        state.opt_g.load_state_dict(saved["opt_g"])
        state.opt_d.load_state_dict(saved["opt_d"])
        for k, g in state.rngs.items():
            g.set_state(saved["rngs"][k])
        state.step = int(saved["step"])
    return state
