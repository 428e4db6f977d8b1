"""Data and tensor parallelism: one process per device over
``torch.distributed``.

Port of ``robust_e2e_gan_tpu/parallel/sharding.py``. The JAX package runs
one program over a ``Mesh('data', 'model')`` and lets XLA place the
collectives. Here each device of the mesh is a process of its own
(``parallel/launcher.py`` starts them): rank r sits at data index
``r // n_model`` and model index ``r % n_model``, the JAX grid's row-major
order, and the collectives are explicit.

The data axis:

* a batch is the GLOBAL batch on every rank (the same draws from the same
  seed, padded to the global batch's widths); a rank keeps rows
  ``[i * B / N, (i + 1) * B / N)`` of its data index i (``shard_batch``),
  so its tensors are exactly rows of the single-process batch;
* parameters and optimizer state are broadcast from rank 0 once, at the
  start (``shard_params``, ``shard_train_state``);
* inside a train or eval step (``data_parallel(mesh)``), each optimizer's
  gradient list is averaged over the ranks before the global-norm clip
  (``all_mean``, in buckets), and every loss term that divides by a count
  over the whole batch (valid tokens, valid frames) divides by that count
  summed over the data axis (``mean_denominator``): then the mean over
  the data axis of each rank's loss is the single-process loss, and the
  mean of their gradients its gradient. Random draws of a step are drawn
  at the global batch's shape and sliced to the rank's rows
  (``rows_rand``), so dropout and scheduled sampling draw what one
  process would.

The model axis (``n_model > 1``):

* after the broadcast, every parameter that ``partition_rule`` shards
  (``shard_params(..., min_shard_dim)``: the last dim, read in the flax
  layout, so a convolution kernel's output channels) keeps only its model
  index's slice, as a ``torch.nn.utils.parametrize`` parametrization of
  its module (``ColumnShard``): the optimizer updates the slice, and the
  module reads the full tensor, all-gathered over the model group. Its
  backward keeps the rank's columns of the full gradient with no
  collective: every model rank of a data index computes the same one;
* every step, eval and search runs inside ``gathered(modules)``, which
  gathers each shard once, at its start, in one order on every rank, and
  hands every read after it the gathered tensor: the kernels and products
  see the full weights, as the JAX kernels do at the ``shard_map``
  boundary;
* the optimizer averages a sharded leaf's gradient over the data group
  and every other leaf's over all ranks, which keeps the replicated
  leaves bit-equal on every rank whatever order a kernel sums in; the
  clip's global norm is the full gradient's (``global_norm``: the
  sharded leaves' squares summed over the model group);
* ``full_state_dict`` gathers a module's state in the single-process
  layout (the same keys, the full shapes), which is what a checkpoint
  holds: a run on a (2, 2) mesh resumes in one process and the reverse.

The JAX package's ambient kernel mesh (``set_kernel_mesh``,
``kernel_mesh``, ``local_kernel_batch``, ``sharded_kernel_call``) has no
counterpart: in a process per device, each kernel already sees only its
rank's rows, and the kernels' launch plans are made for that local batch.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch.nn.utils import parametrize

from robust_e2e_gan_torch.convert import is_conv_kernel

DATA_AXIS = "data"
MODEL_AXIS = "model"
# elements of one all-reduce of ``all_mean``: ~128 MiB of float32
BUCKET_ELEMENTS = 1 << 25


@dataclasses.dataclass(frozen=True)
class Mesh:
    """The (data, model) mesh as this process sees it.

    ``placement``: "cpu" (gloo ranks on the CPU), "cuda" (one card a rank:
    rank r on card r, NCCL) or "cuda:k" (every rank on card k, gloo).
    ``group`` holds every rank, ``data_group`` the ranks of this model
    index (its data axis), ``model_group`` the ranks of this data index
    (its model axis; None without one). They are None until the ranks have
    joined (``launch``); a mesh of more than one rank runs its collectives
    only then."""

    n_data: int
    n_model: int = 1
    placement: str = "cuda"
    rank: int = 0
    group: Any = None
    data_group: Any = None
    model_group: Any = None

    @property
    def shape(self) -> Dict[str, int]:
        return {DATA_AXIS: self.n_data, MODEL_AXIS: self.n_model}

    @property
    def size(self) -> int:
        return self.n_data * self.n_model

    @property
    def data_index(self) -> int:
        return self.rank // self.n_model

    @property
    def model_index(self) -> int:
        return self.rank % self.n_model

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


# the shape of the last mesh made in the joined process group
_JOINED_SHAPE: Optional[Tuple[int, int]] = None


def make_mesh(n_data: Optional[int] = None, n_model: int = 1,
              device: str = "cuda") -> Mesh:
    """The (n_data, n_model) mesh of ranks on ``device`` ("cuda": one card
    each; "cuda:k": all on card k; "cpu").

    Outside ``launch`` it is the plan the launcher starts (rank 0, no
    groups); inside a rank it is that rank's view of the joined group. On
    a model axis it makes the axis groups there, which is collective:
    every rank makes the mesh at the same point, as ``launch`` does. With
    ``n_data=None`` the data axis takes the cards ("cuda"), else the
    joined group's ranks, else one, divided by the model axis. One card a
    rank cannot exceed the cards present; CPU ranks and ranks sharing a
    card have no such limit, like the JAX package's virtual CPU
    devices."""
    global _JOINED_SHAPE
    dev = torch.device(device)
    per_card = dev.type == "cuda" and dev.index is None
    joined = dist.is_available() and dist.is_initialized()
    if n_data is None:
        have = (torch.cuda.device_count() if per_card
                else dist.get_world_size() if joined else n_model)
        if have % n_model:
            raise ValueError(f"{have} devices not divisible by "
                             f"model={n_model}")
        n_data = have // n_model
    need = n_data * n_model
    if per_card:
        have = torch.cuda.device_count()
        if need > have:
            raise ValueError(f"mesh ({n_data},{n_model}) needs {need} "
                             f"devices, have {have}")
    if not joined:
        return Mesh(n_data, n_model, str(device))
    if dist.get_world_size() != need:
        raise ValueError(f"mesh ({n_data},{n_model}) needs {need} "
                         f"processes, have {dist.get_world_size()}")
    data_group, model_group = _axis_groups(n_data, n_model)
    _JOINED_SHAPE = (n_data, n_model)
    return Mesh(n_data, n_model, str(device), dist.get_rank(),
                dist.group.WORLD, data_group, model_group)


def _axis_groups(n_data: int, n_model: int) -> Tuple[Any, Any]:
    """(this rank's data group, its model group). ``dist.new_group`` is
    collective, so every rank makes every group, in one order; an axis
    that spans every rank is the whole group."""
    world, rank = dist.group.WORLD, dist.get_rank()
    if n_model == 1:
        return world, None
    data = model = world
    for m in range(n_model):
        g = dist.new_group([d * n_model + m for d in range(n_data)])
        if rank % n_model == m:
            data = g
    if n_data > 1:
        for d in range(n_data):
            g = dist.new_group([d * n_model + m for m in range(n_model)])
            if rank // n_model == d:
                model = g
    return data, model


def _group(mesh: Mesh):
    if mesh.group is None and mesh.size > 1:
        raise RuntimeError(f"a mesh of {mesh.size} ranks runs its "
                           "collectives only inside parallel.launch")
    return mesh.group


def _joined(mesh: Optional[Mesh]) -> bool:
    """True where ``mesh`` has collectives to run (a joined group, even of
    one rank)."""
    return mesh is not None and _group(mesh) is not None


def _axis(mesh: Mesh, axis: Optional[str]) -> Tuple[Any, int]:
    """(group, ranks) of ``axis``: "data", "model", or None (every
    rank)."""
    if axis == DATA_AXIS:
        return mesh.data_group, mesh.n_data
    if axis == MODEL_AXIS:
        return mesh.model_group, mesh.n_model
    return mesh.group, mesh.size


def partition_rule(shape: Tuple[int, ...], n_model: int,
                   min_shard_dim: int = 512) -> Tuple[Optional[str], ...]:
    """The JAX package's shape rule for tensor parallelism, as a tuple
    spec: 2-D+ weights whose last dim is at least ``min_shard_dim`` and
    divides by the model axis shard column-wise (``(None, ..., "model")``);
    everything else replicates (``()``)."""
    if (n_model > 1 and len(shape) >= 2 and shape[-1] >= min_shard_dim
            and shape[-1] % n_model == 0):
        return (None,) * (len(shape) - 1) + (MODEL_AXIS,)
    return ()


def shard_dim(key: str, shape: Sequence[int], n_model: int,
              min_shard_dim: int = 512) -> Optional[int]:
    """The dim of state-dict leaf ``key`` that ``partition_rule`` shards,
    or None where the leaf replicates. The rule reads the flax layout: a
    convolution kernel, transposed by ``convert.from_flax``, has its flax
    last dim (the output channels) first."""
    conv = is_conv_kernel(key, len(shape))
    flax = (*shape[1:], shape[0]) if conv else tuple(shape)
    if not partition_rule(flax, n_model, min_shard_dim):
        return None
    return 0 if conv else len(shape) - 1


def local_shard(t: torch.Tensor, n_model: int, model_index: int,
                min_shard_dim: int = 512, key: str = "") -> torch.Tensor:
    """The slice of leaf ``t`` (state-dict key ``key``) that model index
    ``model_index`` keeps: JAX ``shard_params``'s shard on the devices of
    that model column; all of ``t`` where it replicates."""
    dim = shard_dim(key, t.shape, n_model, min_shard_dim)
    if dim is None:
        return t
    return t.chunk(n_model, dim)[model_index]


def process_batch_slice(global_batch: int) -> slice:
    """This process's rows of a globally indexed batch: its data index's
    share of the data axis of the joined mesh (the whole range outside a
    process group)."""
    joined = dist.is_available() and dist.is_initialized()
    n, n_model = (_JOINED_SHAPE or (dist.get_world_size(), 1)) if joined \
        else (1, 1)
    if global_batch % n:
        raise ValueError(f"global batch {global_batch} % processes {n} != 0")
    per = global_batch // n
    i = dist.get_rank() // n_model if joined else 0
    return slice(i * per, (i + 1) * per)


def local_batch_size(global_batch: int, mesh: Mesh) -> int:
    n = mesh.n_data
    if global_batch % n:
        raise ValueError(f"global batch {global_batch} % data axis {n} != 0")
    return global_batch // n


def rows(batch_size: int, mesh: Optional[Mesh]) -> slice:
    """The rank's rows of a global batch of ``batch_size``: its data
    index's (all of them without a mesh)."""
    if mesh is None:
        return slice(0, batch_size)
    per = batch_size // mesh.n_data
    return slice(mesh.data_index * per, (mesh.data_index + 1) * per)


def serving_split(batch_size: int, mesh: Optional[Mesh]
                  ) -> Tuple[Optional[Mesh], Optional[slice]]:
    """(the mesh a serving batch is split over, this rank's rows): the
    whole mesh where the batch divides over its data axis; else, as the
    JAX CLIs place a ragged batch on one device, no mesh, all rows on rank
    0 and none (None) on the others."""
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


def all_mean(tensors: Sequence[torch.Tensor], mesh: Optional[Mesh] = None,
             axis: Optional[str] = DATA_AXIS) -> List[torch.Tensor]:
    """The mean over the ranks of ``axis`` ("data", "model", or None:
    every rank) of each tensor (new tensors; the inputs themselves without
    a joined mesh), by one all-reduce a bucket. ``mesh`` defaults to the
    active one."""
    mesh = mesh or _ACTIVE
    out = list(tensors)
    if not _joined(mesh):
        return out
    group, n = _axis(mesh, axis)
    for idx in _buckets(out):
        flat = torch.cat([out[i].detach().reshape(-1) for i in idx])
        dist.all_reduce(flat, group=group)
        flat.div_(n)
        off = 0
        for i in idx:
            k = out[i].numel()
            out[i] = flat[off:off + k].view_as(out[i])
            off += k
    return out


def mean_metrics(metrics: Dict[str, torch.Tensor]
                 ) -> Dict[str, torch.Tensor]:
    """Each metric's mean over the data axis of the active mesh: what one
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
    """``max(count, floor)`` with ``count`` summed over the data axis of
    the active mesh and divided by its size: the denominator that makes a
    rank's masked sum its share of the mean over the global batch (the
    mean over the data axis of sum_r / d is sum / max(count, floor)).
    Without a mesh, ``max(count, floor)``."""
    mesh = _ACTIVE
    if not _joined(mesh):
        return torch.clamp_min(count, floor)
    total = count.detach().float().clone()
    dist.all_reduce(total, group=mesh.data_group)
    return torch.clamp_min(total, floor) / mesh.n_data


def rows_rand(shape: Sequence[int], generator: Optional[torch.Generator],
              device) -> torch.Tensor:
    """``torch.rand(shape)`` of the rank's rows of a global draw: under a
    data axis of N ranks the draw is (N * shape[0], ...) and the rank
    keeps its data index's rows, so every rank's generator moves in step
    and the draws are those of one process over the global batch."""
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
    """Each numpy array's rows of every data index, concatenated in order
    on rank 0 (None on the others), from the ranks of model index 0:
    hypotheses and features travel as host objects (gloo gathers no CUDA
    tensor)."""
    if not _joined(mesh):
        return list(arrays)
    if mesh.model_index:
        return None
    parts = [None] * mesh.n_data if mesh.is_main else None
    dist.gather_object(list(arrays), parts, dst=0, group=mesh.data_group)
    if not mesh.is_main:
        return None
    return [np.concatenate([p[i] for p in parts]) for i in range(len(arrays))]


# --------------------------------------------------------------------------
# state: broadcast from rank 0 once, then column shards on the model axis
# --------------------------------------------------------------------------


class _Gather(torch.autograd.Function):
    """The full tensor from the rank's slice; the backward keeps the
    rank's columns of the full gradient, with no collective (every model
    rank of a data index computes the same full gradient)."""

    @staticmethod
    def forward(ctx, local, shard):
        ctx.shard = shard
        return shard.gather(local)

    @staticmethod
    def backward(ctx, grad):
        return ctx.shard.right_inverse(grad), None


class ColumnShard(torch.nn.Module):
    """A parametrization of a model-sharded leaf: the module stores this
    rank's slice of dim ``dim`` (``right_inverse``), and reads the full
    tensor, all-gathered over the model group (inside ``gathered``, the
    tensor gathered at its start)."""

    def __init__(self, mesh: Mesh, dim: int):
        super().__init__()
        self.dim = dim
        self.n = mesh.n_model
        self.index = mesh.model_index
        self.group = mesh.model_group
        self.full: Optional[torch.Tensor] = None

    def forward(self, local: torch.Tensor) -> torch.Tensor:
        return _Gather.apply(local, self) if self.full is None else self.full

    def right_inverse(self, full: torch.Tensor) -> torch.Tensor:
        """This rank's slice, in storage of its own."""
        return full.chunk(self.n, self.dim)[self.index].clone(
            memory_format=torch.contiguous_format)

    def gather(self, local: torch.Tensor) -> torch.Tensor:
        """The full tensor of every model rank's ``local`` (collective
        over the model group), without autograd."""
        parts = [torch.empty_like(local) for _ in range(self.n)]
        dist.all_gather(parts, local.detach().contiguous(), group=self.group)
        return torch.cat(parts, self.dim)


def column_shard(p: torch.Tensor) -> Optional[ColumnShard]:
    """The ``ColumnShard`` of a model-sharded parameter, else None."""
    return getattr(p, "column_shard", None)


def _broadcast(module: torch.nn.Module, mesh: Optional[Mesh]) -> None:
    if _joined(mesh):
        with torch.no_grad():
            for t in list(module.parameters()) + list(module.buffers()):
                dist.broadcast(t.data, src=0, group=mesh.group)


def _shard_columns(module: torch.nn.Module, mesh: Optional[Mesh],
                   min_shard_dim: int) -> None:
    """Keep of each parameter ``partition_rule`` shards only this rank's
    slice (``ColumnShard``). The parameter keeps its identity, so an
    optimizer built over it updates the slice; it records its shard as
    ``column_shard``, and the module its single-process state-dict keys
    (``full_state_dict``)."""
    if mesh is None or mesh.n_model == 1 or not _joined(mesh):
        return
    keys = list(module.state_dict())
    for name, p in list(module.named_parameters()):
        dim = shard_dim(name, p.shape, mesh.n_model, min_shard_dim)
        if dim is None:
            continue
        owner, _, leaf = name.rpartition(".")
        shard = ColumnShard(mesh, dim)
        parametrize.register_parametrization(module.get_submodule(owner),
                                             leaf, shard, unsafe=True)
        p.column_shard = shard
    module.full_state_keys = keys


def shard_params(module: torch.nn.Module, mesh: Optional[Mesh],
                 min_shard_dim: int = 512) -> torch.nn.Module:
    """Make every parameter and buffer of ``module`` rank 0's, in place;
    on a model axis, keep of each parameter ``partition_rule`` shards
    (``min_shard_dim``, the JAX argument) only this rank's slice."""
    _broadcast(module, mesh)
    _shard_columns(module, mesh, min_shard_dim)
    return module


def shard_train_state(state, mesh: Optional[Mesh], min_shard_dim: int = 512):
    """Make a ``train/steps.py::TrainState`` rank 0's, in place: both
    modules by broadcast, and the step, the optimizer states and the
    generators' states as one host object; then, on a model axis, shard
    both modules' parameters (``shard_params``) and slice their optimizer
    states to the same columns."""
    if not _joined(mesh):
        return state
    _broadcast(state.model, mesh)
    _broadcast(state.discriminator, mesh)
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
    for module, opt in ((state.model, state.opt_g),
                        (state.discriminator, state.opt_d)):
        _shard_columns(module, mesh, min_shard_dim)
        opt.slice_state()
    return state


def full_state_dict(module: torch.nn.Module) -> Dict[str, torch.Tensor]:
    """``module.state_dict()`` in the single-process layout: each
    model-sharded leaf gathered to its full tensor under its own key, in
    the single-process order (collective over the model group: every rank
    of it calls). A module with no shard: its ``state_dict()``."""
    keys = getattr(module, "full_state_keys", None)
    saved = module.state_dict()
    if keys is None:
        return saved
    out = {}
    for k, v in saved.items():
        head, sep, rest = k.rpartition("parametrizations.")
        if sep and rest.endswith(".original"):
            name = rest[:-len(".original")]
            owner = module.get_submodule(head.rstrip("."))
            out[head + name] = owner.parametrizations[name][0].gather(v)
        else:
            out[k] = v
    return {k: out[k] for k in keys}


@contextlib.contextmanager
def gathered(*modules: torch.nn.Module) -> Iterator[None]:
    """Run the block on the full tensors of the modules' model-sharded
    leaves, each gathered once, at the block's start, in the grad mode
    there (so a gradient flows back to the slice) and in one order on
    every rank; every read of a leaf in the block takes its gathered
    tensor. Nothing changes for a module with no shard. An optimizer
    update in the block leaves the gathered tensors stale: a step gathers
    a module it updates in a block of its own before the update."""
    leaves = [(plist[0], plist.original) for mod in modules
              for m in mod.modules() if parametrize.is_parametrized(m)
              for plist in m.parametrizations.values()
              if isinstance(plist[0], ColumnShard)]
    prev = [shard.full for shard, _ in leaves]
    try:
        for shard, local in leaves:
            shard.full = _Gather.apply(local, shard)
        yield
    finally:
        for (shard, _), full in zip(leaves, prev):
            shard.full = full


def mean_grads(params: Sequence[torch.Tensor],
               grads: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """Each parameter's gradient averaged over the active mesh: a
    model-sharded leaf's (this model index's columns) over the data axis,
    every other leaf's over all ranks (the model ranks of a data index
    compute the same gradient, and the mean over every rank keeps the
    replicated leaves bit-equal on all of them)."""
    sharded = [column_shard(p) is not None for p in params]
    if not any(sharded):
        return all_mean(grads, axis=None)
    if not _joined(_ACTIVE):
        raise RuntimeError("a step on model-sharded parameters runs under "
                           "its mesh (the steps' mesh argument)")
    out = list(grads)
    for flag, axis in ((True, DATA_AXIS), (False, None)):
        idx = [i for i, s in enumerate(sharded) if s == flag]
        for i, g in zip(idx, all_mean([out[i] for i in idx], axis=axis)):
            out[i] = g
    return out


def global_norm(params: Sequence[torch.Tensor],
                grads: Sequence[torch.Tensor]) -> torch.Tensor:
    """The float32 global norm of the full gradient: with model-sharded
    leaves, their squares summed over the model group, then every other
    leaf's added."""
    shards = [column_shard(p) for p in params]
    local = [g for s, g in zip(shards, grads) if s is not None]
    if not local:
        return torch.sqrt(sum(torch.sum(g.float() ** 2) for g in grads))
    sq = sum(torch.sum(g.float() ** 2) for g in local)
    dist.all_reduce(sq, group=next(s for s in shards if s is not None).group)
    rest = [g for s, g in zip(shards, grads) if s is None]
    return torch.sqrt(sum((torch.sum(g.float() ** 2) for g in rest), sq))
