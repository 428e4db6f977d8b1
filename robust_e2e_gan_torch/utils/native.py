"""The host library: the C++ batch loaders and edit distance of
``robust_e2e_gan_torch/csrc/host``, built with g++ and bound by ctypes.

Port of ``robust_e2e_gan_tpu/utils/native.py``: ``get_lib``,
``native_edit_distance``, ``native_edit_distance_corpus``,
``native_load_npy_batch`` and ``native_load_kaldi_feats_batch`` take the
same arguments, return the same values and raise the same ``IOError``
texts. What differs:

* The library is built at first use, on the CPU as on the machine with the
  card: ``g++ -O3 -std=c++17 -shared -fPIC -pthread`` over
  ``csrc/host/*.cpp`` into ``robust_e2e_gan_torch/_build/librg_host.so``,
  beside a stamp of the sources' hash, and rebuilt when a source changes.
  It is written to a temporary file and moved into place under an
  ``fcntl`` lock of ``_build/``, so that processes and threads that need
  it at once build it once. ``utils/build.py``'s kernel library (``nvcc``,
  ``csrc/*.cu``) is another library with a stamp of its own.
* There is no fallback: a build that fails raises ``RuntimeError`` with
  the g++ command and its stderr, and no entry point returns None. The
  Python versions (``data/dataset.py``'s ``*_plain`` readers,
  ``ops/editdistance.py::edit_distance_plain``) are the plain versions the
  tests hold the library against.
* The library is loaded with ``ctypes.CDLL``, which releases the GIL for
  the whole of every call: a batch collated on a ``Prefetcher`` thread
  leaves the training thread free to launch.
"""

from __future__ import annotations

import ctypes
import fcntl
import glob
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from typing import Dict, List, Sequence, Tuple

import numpy as np

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HOST_SRC = os.path.join(_PKG, "csrc", "host")
BUILD_DIR = os.path.join(_PKG, "_build")
LIB_PATH = os.path.join(BUILD_DIR, "librg_host.so")
GXX_FLAGS = ["-O3", "-std=c++17", "-shared", "-fPIC", "-pthread"]

_lock = threading.Lock()
_lib = None


def _sources() -> List[str]:
    return sorted(glob.glob(os.path.join(HOST_SRC, "*.cpp")))


def _source_hash() -> str:
    h = hashlib.sha256(" ".join(GXX_FLAGS).encode())
    for path in _sources():
        h.update(os.path.basename(path).encode())
        with open(path, "rb") as f:
            h.update(f.read())
    return h.hexdigest()


def _current(digest: str) -> bool:
    try:
        with open(LIB_PATH + ".srchash") as f:
            return f.read().strip() == digest and os.path.exists(LIB_PATH)
    except OSError:
        return False


def _gxx() -> str:
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError("g++ not found: the host library of "
                           "robust_e2e_gan_torch (csrc/host) is built with it")
    return gxx


def compiler_version() -> str:
    """The first line of ``g++ --version``."""
    out = subprocess.run([_gxx(), "--version"], capture_output=True,
                         text=True, check=True).stdout
    return out.splitlines()[0]


def _compile(cmd: List[str]) -> subprocess.CompletedProcess:
    return subprocess.run(cmd, capture_output=True, text=True)


def build() -> float:
    """Compile the host library unless the stamped build is current.

    Returns the seconds spent compiling (0.0 when the build was current,
    or another process built it while this one waited for the lock)."""
    digest = _source_hash()
    if _current(digest):
        return 0.0
    os.makedirs(BUILD_DIR, exist_ok=True)
    with open(os.path.join(BUILD_DIR, "librg_host.lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if _current(digest):
            return 0.0
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [_gxx(), *GXX_FLAGS, *_sources(), "-o", tmp]
        t0 = time.perf_counter()
        proc = _compile(cmd)
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            os.unlink(tmp)
            raise RuntimeError("the host library did not build: "
                               + " ".join(cmd) + "\n" + proc.stderr)
        os.replace(tmp, LIB_PATH)
        with open(LIB_PATH + ".srchash", "w") as f:
            f.write(digest)
    return seconds


def get_lib() -> ctypes.CDLL:
    """The loaded host library (built on first use)."""
    global _lib
    if _lib is not None:
        return _lib
    with _lock:
        if _lib is not None:
            return _lib
        build()
        lib = ctypes.CDLL(LIB_PATH)
        i32, i64 = ctypes.c_int32, ctypes.c_int64
        p32, p64 = ctypes.POINTER(i32), ctypes.POINTER(i64)
        pf, pc = ctypes.POINTER(ctypes.c_float), ctypes.POINTER(
            ctypes.c_char_p)
        for name, argtypes in (
                ("rg_edit_distance_i32", [p32, i64, p32, i64]),
                ("rg_edit_distance_corpus_i32",
                 [p32, p64, p32, p64, i64, p64, i32]),
                ("rg_load_npy_batch_f32", [pc, i64, pf, i64, p64, i32]),
                ("rg_load_kaldi_feats_batch_f32",
                 [pc, p64, i64, pf, i64, i64, p64, i32])):
            fn = getattr(lib, name)
            fn.restype = i64
            fn.argtypes = argtypes
        _lib = lib
        return _lib


def _threads(n_threads: int) -> int:
    return n_threads if n_threads > 0 else min(8, os.cpu_count() or 1)


def _to_ids(seqs: Sequence[Sequence], vocab: Dict) -> List[np.ndarray]:
    out = []
    for s in seqs:
        ids = np.empty(len(s), np.int32)
        for i, tok in enumerate(s):
            if tok not in vocab:
                vocab[tok] = len(vocab)
            ids[i] = vocab[tok]
        out.append(ids)
    return out


def native_edit_distance(ref: Sequence, hyp: Sequence) -> int:
    """Levenshtein distance of one pair of token sequences."""
    lib = get_lib()
    r, h = _to_ids([ref, hyp], {})
    p32 = ctypes.POINTER(ctypes.c_int32)
    return int(lib.rg_edit_distance_i32(r.ctypes.data_as(p32), len(r),
                                        h.ctypes.data_as(p32), len(h)))


def native_edit_distance_corpus(refs: Sequence[Sequence],
                                hyps: Sequence[Sequence], n_threads: int = 0
                                ) -> Tuple[np.ndarray, int]:
    """(each utterance's distance as int64, their total), the utterances
    split over ``n_threads`` threads (0: up to 8)."""
    lib = get_lib()
    vocab: Dict = {}
    r_ids, h_ids = _to_ids(refs, vocab), _to_ids(hyps, vocab)

    def flat(ids):
        off = np.zeros(len(ids) + 1, np.int64)
        np.cumsum([len(x) for x in ids], out=off[1:])
        return (np.concatenate(ids) if ids else np.empty(0, np.int32)), off

    (r_flat, r_off), (h_flat, h_off) = flat(r_ids), flat(h_ids)
    out = np.zeros(len(r_ids), np.int64)
    p32 = ctypes.POINTER(ctypes.c_int32)
    p64 = ctypes.POINTER(ctypes.c_int64)
    total = lib.rg_edit_distance_corpus_i32(
        r_flat.ctypes.data_as(p32), r_off.ctypes.data_as(p64),
        h_flat.ctypes.data_as(p32), h_off.ctypes.data_as(p64),
        len(r_ids), out.ctypes.data_as(p64), _threads(n_threads))
    return out, int(total)


def native_load_npy_batch(paths: Sequence[str], pad_to: int,
                          n_threads: int = 0
                          ) -> Tuple[np.ndarray, np.ndarray]:
    """1-D little-endian float32 or float64 C-order ``.npy`` files (or
    (N, 1) and (1, N) ones) into a zero-padded (N, pad_to) float32 batch,
    each cut at ``pad_to``: (batch, each file's true sample count as
    int64). Raises ``IOError`` naming the first file that is unreadable or
    of another dtype, order or shape."""
    lib = get_lib()
    n = len(paths)
    out = np.zeros((n, pad_to), np.float32)
    lens = np.zeros((n,), np.int64)
    arr = (ctypes.c_char_p * n)(*[p.encode() for p in paths])
    rc = lib.rg_load_npy_batch_f32(
        arr, n, out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), pad_to,
        lens.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        _threads(n_threads))
    if rc != 0:
        raise IOError(f"native npy batch load failed on {paths[int(-rc - 1)]}")
    return out, lens


def native_load_kaldi_feats_batch(entries: Sequence[Tuple[str, int]],
                                  pad_to: int, dim: int, n_threads: int = 0
                                  ) -> Tuple[np.ndarray, np.ndarray]:
    """Kaldi feature matrices (FM, DM and the CM, CM2 and CM3 compressed
    formats) at (ark path, byte offset) entries into a zero-padded (N,
    pad_to, dim) float32 batch, each cut at ``pad_to`` rows: (batch, each
    matrix's true row count as int64). Raises ``IOError`` naming the first
    entry that is unreadable or not ``dim`` wide."""
    lib = get_lib()
    n = len(entries)
    out = np.zeros((n, pad_to, dim), np.float32)
    lens = np.zeros((n,), np.int64)
    arr = (ctypes.c_char_p * n)(*[p.encode() for p, _ in entries])
    offs = np.asarray([o for _, o in entries], np.int64)
    rc = lib.rg_load_kaldi_feats_batch_f32(
        arr, offs.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), n,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), pad_to, dim,
        lens.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        _threads(n_threads))
    if rc != 0:
        raise IOError(
            f"native Kaldi feats batch load failed on {entries[int(-rc - 1)]}")
    return out, lens
