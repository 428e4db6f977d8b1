"""Atomic checkpoint save/restore with best and latest retention.

Port of ``robust_e2e_gan_tpu/utils/checkpoint.py`` in the port's own
format: ``ckpt_<step>.pt`` written with ``torch.save`` into a temporary
file and renamed into place (a save cut short never corrupts the latest
checkpoint), beside the same ``checkpoints.json`` sidecar (latest, best,
a bounded history, and the ``extra`` dict of the loop's schedule: epoch,
``epoch_complete``, ``best_acc``). What a checkpoint holds is the state's
own ``state_dict()`` / ``load_state_dict(saved, params_only)``: a
``train/steps.py::TrainState`` of the acoustic regimes keeps both
modules, both optimizer states, the step and its generators' states (a
resumed run continues the same random stream); a ``train/lm.py::LMState``
keeps the LM, its optimizer state and the step.

``AsyncCheckpointer`` saves off the training thread, as the JAX loop does:
the host snapshot (a copy of every tensor) is taken on the caller's
thread, and ``torch.save``, the rename, the sidecar and the prune run on
one worker, at most one save in flight.

An experiment directory of the JAX package names ``ckpt_<step>.msgpack``
files (flax msgpack, read by ``utils/flax_msgpack.py`` without flax).
Those restore params-only: the parameters of a JAX ``TrainState``
(``params_g``, ``params_d``) or ``LMState`` (``params``), mapped through
``convert.from_flax`` by the state's ``load_jax_params``. That serves
decoding, enhancing, LM fusion and a warm start. Resuming a JAX run
raises (``JAX_RESUME``). ``save_jax_checkpoint`` writes a port
``TrainState`` in the JAX layout, so that a JAX experiment can be built
where no JAX runs.
"""

from __future__ import annotations

import json
import os
import tempfile
import threading
from typing import Callable, Dict, List, Optional, Tuple

import torch

from robust_e2e_gan_torch.utils import flax_msgpack

_HISTORY_CAP = 200  # most recent save-history entries kept in the sidecar
SUFFIXES = (".pt", ".msgpack")  # the port's checkpoints, the JAX package's

JAX_RESUME = (
    "resuming a JAX run is not ported (ROADMAP 'Not to port'): its PRNG "
    "key and optax states cannot carry into torch generators and "
    "torch.optim, so the run's random streams would not continue; "
    "warm-start from it instead (init_from, train.cli --init-from)")


def save_checkpoint(ckpt_dir: str, state, step: int,
                    metric: Optional[float] = None, keep: int = 3,
                    best_mode: str = "max",
                    extra: Optional[Dict] = None) -> str:
    """Write ``ckpt_dir/ckpt_<step>.pt`` atomically; update latest and
    best (``metric``, e.g. dev accuracy); keep ``keep`` others. ``state``
    is a ``TrainState`` or an ``LMState``."""
    return _save_hosted(ckpt_dir, state.state_dict(), step, metric, keep,
                        best_mode, extra)


def _save_hosted(ckpt_dir: str, saved: dict, step: int,
                 metric: Optional[float] = None, keep: int = 3,
                 best_mode: str = "max",
                 extra: Optional[Dict] = None) -> str:
    """``save_checkpoint`` of a ``state_dict()`` already taken (the
    worker's half of ``AsyncCheckpointer.save``)."""
    return _write(ckpt_dir, step, ".pt", lambda f: torch.save(saved, f),
                  metric, keep, best_mode, extra)


def save_jax_checkpoint(ckpt_dir: str, state, step: int,
                        metric: Optional[float] = None, keep: int = 3,
                        best_mode: str = "max",
                        extra: Optional[Dict] = None) -> str:
    """Write a ``TrainState`` as the JAX package writes one:
    ``ckpt_<step>.msgpack`` holding ``state.jax_tree()`` (a JAX
    ``TrainState`` in the flax layout), with the same sidecar."""
    data = flax_msgpack.dumps(state.jax_tree())
    return _write(ckpt_dir, step, ".msgpack", lambda f: f.write(data),
                  metric, keep, best_mode, extra)


def _write(ckpt_dir: str, step: int, suffix: str, write: Callable,
           metric: Optional[float], keep: int, best_mode: str,
           extra: Optional[Dict]) -> str:
    os.makedirs(ckpt_dir, exist_ok=True)
    path = os.path.join(ckpt_dir, f"ckpt_{step}{suffix}")
    fd, tmp = tempfile.mkstemp(dir=ckpt_dir, suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            write(f)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)

    meta = _read_meta(ckpt_dir)
    meta["latest"] = {"step": step, "path": os.path.basename(path)}
    if extra is not None:
        meta["latest"]["extra"] = extra
    if metric is not None:
        best = meta.get("best")
        if (best is None or (best_mode == "max" and metric > best["metric"])
                or (best_mode == "min" and metric < best["metric"])):
            meta["best"] = {"step": step, "metric": float(metric),
                            "path": os.path.basename(path)}
    hist = meta.setdefault("history", [])
    hist.append({"step": step,
                 "metric": None if metric is None else float(metric)})
    del hist[:-_HISTORY_CAP]
    _write_meta(ckpt_dir, meta)
    _prune(ckpt_dir, meta, keep)
    return path


def host_snapshot(tree):
    """A copy on the host of a ``state_dict()`` tree: every tensor copied
    (a CUDA tensor by a synchronous device-to-host copy, a CPU one cloned:
    ``state_dict()`` returns references that the next in-place step would
    rewrite), the containers rebuilt, everything else as it is."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().to("cpu", copy=True)
    if isinstance(tree, dict):
        return {k: host_snapshot(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(host_snapshot(v) for v in tree)
    return tree


class AsyncCheckpointer:
    """``save_checkpoint`` off the training thread (JAX
    ``utils/checkpoint.py::AsyncCheckpointer``).

    ``save`` first waits for the save in flight, then takes the host
    snapshot on the caller's thread, so the next step may update the
    parameters in place; ``torch.save``, the atomic rename, the sidecar and
    the prune run on one worker thread. At most one save is in flight,
    which keeps the sidecar's order and one snapshot in host memory. A
    worker's error is raised again by the next ``save()`` or ``wait()``;
    leaving the ``with`` block waits for the worker.
    """

    def __init__(self):
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    def save(self, ckpt_dir: str, state, step: int, **kw) -> None:
        self.wait()
        saved = host_snapshot(state.state_dict())

        def work():
            try:
                _save_hosted(ckpt_dir, saved, step, **kw)
            except BaseException as e:  # raised again by save() or wait()
                self._error = e

        self._thread = threading.Thread(target=work, name="ckpt-writer",
                                        daemon=True)
        self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def __enter__(self) -> "AsyncCheckpointer":
        return self

    def __exit__(self, *exc) -> None:
        # drain the worker on every exit; its error is raised only where
        # the block is not raising already
        try:
            self.wait()
        except BaseException:
            if exc[0] is None:
                raise


def restore_checkpoint(ckpt_dir: str, state, which: str = "latest",
                       params_only: bool = False) -> Tuple[object, int]:
    """Load 'latest' or 'best' into ``state`` (a ``TrainState`` or an
    ``LMState``) in place; returns (state, step). ``params_only`` loads the
    modules alone (a warm start). A JAX checkpoint (``.msgpack``) loads
    params-only, and raises ``NotImplementedError`` (``JAX_RESUME``)
    without ``params_only``. Raises FileNotFoundError if absent."""
    entry = _read_meta(ckpt_dir).get(which)
    if not entry:
        raise FileNotFoundError(f"no '{which}' checkpoint in {ckpt_dir}")
    path = os.path.join(ckpt_dir, entry["path"])
    if path.endswith(".msgpack"):
        if not params_only:
            raise NotImplementedError(JAX_RESUME)
        state.load_jax_params(flax_msgpack.load(path))
        return state, int(entry["step"])
    # loaded to the host; each module and optimizer copies its tensors
    # onto its parameters' device
    saved = torch.load(path, map_location="cpu", weights_only=True)
    state.load_state_dict(saved, params_only)
    return state, int(entry["step"])


def is_jax_checkpoint(ckpt_dir: str, which: str = "latest") -> bool:
    """Whether ``which`` of ``ckpt_dir`` is a JAX package's checkpoint."""
    entry = _read_meta(ckpt_dir).get(which) or {}
    return entry.get("path", "").endswith(".msgpack")


def read_extra(ckpt_dir: str, which: str = "latest") -> Dict:
    """Sidecar ``extra`` dict saved with the checkpoint ({} if absent)."""
    entry = _read_meta(ckpt_dir).get(which) or {}
    return dict(entry.get("extra") or {})


def has_checkpoint(ckpt_dir: str, which: str = "latest") -> bool:
    entry = _read_meta(ckpt_dir).get(which)
    return bool(entry) and os.path.exists(os.path.join(ckpt_dir,
                                                       entry["path"]))


def _meta_path(ckpt_dir: str) -> str:
    return os.path.join(ckpt_dir, "checkpoints.json")


def _read_meta(ckpt_dir: str) -> Dict:
    p = _meta_path(ckpt_dir)
    if not os.path.exists(p):
        return {}
    with open(p) as f:
        return json.load(f)


def _write_meta(ckpt_dir: str, meta: Dict) -> None:
    fd, tmp = tempfile.mkstemp(dir=ckpt_dir, suffix=".tmp")
    try:
        with os.fdopen(fd, "w") as f:
            json.dump(meta, f, indent=2)
        os.replace(tmp, _meta_path(ckpt_dir))
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def _prune(ckpt_dir: str, meta: Dict, keep: int) -> None:
    protect = {e["path"] for e in (meta.get("latest"), meta.get("best")) if e}
    cands: List[Tuple[int, str]] = []
    for fn in os.listdir(ckpt_dir):
        stem, suffix = os.path.splitext(fn)
        if stem.startswith("ckpt_") and suffix in SUFFIXES \
                and fn not in protect:
            try:
                cands.append((int(stem[5:]), fn))
            except ValueError:
                pass
    cands.sort(reverse=True)
    for _, fn in cands[max(keep - 1, 0):]:
        os.unlink(os.path.join(ckpt_dir, fn))
