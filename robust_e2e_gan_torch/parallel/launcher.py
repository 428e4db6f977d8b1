"""Start the ranks of a (data, model) mesh: one spawned process each.

``launch(fn, mesh, *args)`` runs ``fn(rank_mesh, *args)`` in
``mesh.n_data * mesh.n_model`` processes started with
``torch.multiprocessing``'s "spawn", joined into one process group (and
its axis groups, made in every rank in one order by ``make_mesh``), and
returns each rank's result in rank order. ``fn`` must be importable by
name (a module-level function of the package), and ``args`` and results
must pickle.

* Rendezvous is a ``FileStore`` in a fresh temporary directory, so no
  port is taken and concurrent launches cannot meet; the group has a
  ``timeout`` of its own (``GROUP_TIMEOUT_S``), which also bounds every
  collective a rank waits in.
* Backends: NCCL for one card a rank ("cuda"; rank r calls
  ``torch.cuda.set_device(r)`` before anything runs), gloo for CPU ranks
  and for ranks sharing one card ("cuda:k": NCCL refuses two ranks on one
  GPU). Gloo collectives bind to the loopback interface unless
  ``GLOO_SOCKET_IFNAME`` says otherwise (every rank is on this host).
* Where the ranks run on a card, the kernel library is built here, in the
  parent, before any rank starts (``utils/build.py`` builds into one
  directory without a lock).
* Each rank takes this process's numerics settings (TF32 in matmuls and
  cuDNN, cuDNN's deterministic and benchmark modes, deterministic
  algorithms), so a rank computes what this process would.
* When a rank fails, the others are killed and the first failing rank's
  exception is raised again here, its traceback chained. Past
  ``limit_s`` seconds of wall clock (``DEFAULT_LIMIT_S`` when not given;
  None: no limit) every rank is killed and ``TimeoutError`` raised.
"""

from __future__ import annotations

import datetime
import multiprocessing.connection
import os
import pickle
import shutil
import sys
import tempfile
import time
import traceback
from typing import Any, Callable, List, Optional

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from robust_e2e_gan_torch.parallel.sharding import Mesh, make_mesh

DEFAULT_LIMIT_S: Optional[float] = None
GROUP_TIMEOUT_S = 1800.0


def _numerics() -> dict:
    """The settings of this process that change what a kernel computes."""
    return {"matmul_tf32": torch.backends.cuda.matmul.allow_tf32,
            "cudnn_tf32": torch.backends.cudnn.allow_tf32,
            "cudnn_deterministic": torch.backends.cudnn.deterministic,
            "cudnn_benchmark": torch.backends.cudnn.benchmark,
            "deterministic": torch.are_deterministic_algorithms_enabled(),
            "warn_only":
                torch.is_deterministic_algorithms_warn_only_enabled()}


def _set_numerics(n: dict) -> None:
    torch.backends.cuda.matmul.allow_tf32 = n["matmul_tf32"]
    torch.backends.cudnn.allow_tf32 = n["cudnn_tf32"]
    torch.backends.cudnn.deterministic = n["cudnn_deterministic"]
    torch.backends.cudnn.benchmark = n["cudnn_benchmark"]
    torch.use_deterministic_algorithms(n["deterministic"],
                                       warn_only=n["warn_only"])


class RankFailed(RuntimeError):
    """A rank's traceback, chained under the exception it raised."""


def launch(fn: Callable, mesh: Mesh, *args: Any,
           limit_s: Optional[float] = None) -> List[Any]:
    """``[fn(mesh_r, *args) for each rank r]``, each in its own process
    (CPU ranks share out this process's intra-op threads)."""
    world = mesh.size
    limit_s = DEFAULT_LIMIT_S if limit_s is None else limit_s
    num_threads = None
    if torch.device(mesh.placement).type == "cuda":
        from robust_e2e_gan_torch.utils.build import build

        build()
    else:
        num_threads = max(1, torch.get_num_threads() // world)
    work = tempfile.mkdtemp(prefix="rg_launch_")
    procs = []
    try:
        with open(os.path.join(work, "payload.pt"), "wb") as f:
            torch.save((fn, args, _numerics()), f)
        ctx = mp.get_context("spawn")
        for r in range(world):
            p = ctx.Process(target=_rank_main, daemon=True, args=(
                r, mesh.n_data, mesh.n_model, mesh.placement, work,
                num_threads))
            p.start()
            procs.append(p)
        _wait(procs, work, limit_s)
        results = []
        for r in range(world):
            with open(os.path.join(work, f"result_{r}.pt"), "rb") as f:
                results.append(torch.load(f, weights_only=False))
        return results
    finally:
        _kill(procs)
        shutil.rmtree(work, ignore_errors=True)


def _wait(procs, work: str, limit_s: Optional[float]) -> None:
    """Return when every rank exited 0; raise the first failure."""
    deadline = None if limit_s is None else time.monotonic() + limit_s
    running = {p.sentinel: (r, p) for r, p in enumerate(procs)}
    while running:
        left = None if deadline is None else deadline - time.monotonic()
        if left is not None and left <= 0:
            _kill(procs)
            raise TimeoutError(f"{len(running)} of {len(procs)} ranks still "
                               f"running after {limit_s:g} s; all killed")
        for s in multiprocessing.connection.wait(list(running), left):
            r, p = running.pop(s)
            p.join()
            if p.exitcode != 0:
                _kill(procs)
                _raise_rank_error(r, p.exitcode, work)


def _raise_rank_error(rank: int, code: int, work: str) -> None:
    path = os.path.join(work, f"error_{rank}.pkl")
    if not os.path.exists(path):
        raise RuntimeError(f"rank {rank} exited with code {code} and left "
                           "no error")
    with open(path, "rb") as f:
        exc_bytes, text = pickle.load(f)
    cause = RankFailed(f"rank {rank} failed:\n{text}")
    try:
        exc = pickle.loads(exc_bytes) if exc_bytes else None
    except Exception:  # an exception that does not unpickle
        exc = None
    raise (exc if isinstance(exc, BaseException) else cause) from cause


def _kill(procs) -> None:
    for p in procs:
        if p.is_alive():
            p.terminate()
    for p in procs:
        p.join(timeout=5.0)
        if p.is_alive():
            p.kill()
            p.join()


def _rank_main(rank: int, n_data: int, n_model: int, placement: str,
               work: str, num_threads: Optional[int]) -> None:
    """A rank: join the group, run the payload, write its result (or its
    error, then exit 1 without waiting for anything)."""
    try:
        os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
        if num_threads:
            torch.set_num_threads(num_threads)
        with open(os.path.join(work, "payload.pt"), "rb") as f:
            fn, args, numerics = torch.load(f, weights_only=False)
        _set_numerics(numerics)
        plan = Mesh(n_data, n_model, placement)
        world = plan.size
        if plan.device.type == "cuda":
            torch.cuda.set_device(Mesh(n_data, n_model, placement,
                                       rank).device)
        store = dist.FileStore(os.path.join(work, "store"), world)
        dist.init_process_group(
            plan.backend, store=store, rank=rank, world_size=world,
            timeout=datetime.timedelta(seconds=GROUP_TIMEOUT_S))
        result = fn(make_mesh(n_data, n_model, placement), *args)
        path = os.path.join(work, f"result_{rank}.pt")
        with open(path + ".tmp", "wb") as f:
            torch.save(result, f)
        os.replace(path + ".tmp", path)
        dist.destroy_process_group()
    except BaseException as e:
        text = traceback.format_exc()
        print(f"rank {rank} failed:\n{text}", file=sys.stderr, flush=True)
        try:
            exc_bytes = pickle.dumps(e)
        except Exception:
            exc_bytes = None
        with open(os.path.join(work, f"error_{rank}.pkl"), "wb") as f:
            pickle.dump((exc_bytes, text), f)
        sys.stdout.flush()
        os._exit(1)
