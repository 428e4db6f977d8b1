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
keeps the LM, its optimizer state and the step. Saves are synchronous.
Loading a JAX msgpack checkpoint is not ported yet.
"""

from __future__ import annotations

import json
import os
import tempfile
from typing import Dict, List, Optional, Tuple

import torch

_HISTORY_CAP = 200  # most recent save-history entries kept in the sidecar


def save_checkpoint(ckpt_dir: str, state, step: int,
                    metric: Optional[float] = None, keep: int = 3,
                    best_mode: str = "max",
                    extra: Optional[Dict] = None) -> str:
    """Write ``ckpt_dir/ckpt_<step>.pt`` atomically; update latest and
    best (``metric``, e.g. dev accuracy); keep ``keep`` others. ``state``
    is a ``TrainState`` or an ``LMState``."""
    os.makedirs(ckpt_dir, exist_ok=True)
    path = os.path.join(ckpt_dir, f"ckpt_{step}.pt")
    fd, tmp = tempfile.mkstemp(dir=ckpt_dir, suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            torch.save(state.state_dict(), f)
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


def restore_checkpoint(ckpt_dir: str, state, which: str = "latest",
                       params_only: bool = False) -> Tuple[object, int]:
    """Load 'latest' or 'best' into ``state`` (a ``TrainState`` or an
    ``LMState``) in place; returns (state, step). ``params_only`` loads the
    modules alone (a warm start). Raises FileNotFoundError if absent."""
    entry = _read_meta(ckpt_dir).get(which)
    if not entry:
        raise FileNotFoundError(f"no '{which}' checkpoint in {ckpt_dir}")
    # loaded to the host; each module and optimizer copies its tensors
    # onto its parameters' device
    saved = torch.load(os.path.join(ckpt_dir, entry["path"]),
                       map_location="cpu", weights_only=True)
    state.load_state_dict(saved, params_only)
    return state, int(entry["step"])


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
        if fn.startswith("ckpt_") and fn.endswith(".pt") and fn not in protect:
            try:
                cands.append((int(fn[5:-3]), fn))
            except ValueError:
                pass
    cands.sort(reverse=True)
    for _, fn in cands[max(keep - 1, 0):]:
        os.unlink(os.path.join(ckpt_dir, fn))
