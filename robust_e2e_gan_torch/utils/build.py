"""Build the CUDA kernels of ``robust_e2e_gan_torch/csrc`` and load them.

One ``nvcc`` call compiles every ``csrc/*.cu`` into a shared library with
a plain C interface for ``sm_90a`` (a few seconds; no PyTorch headers are
included). The library lands in ``robust_e2e_gan_torch/_build/`` beside a
stamp of the sources' hash and is rebuilt when a source changes. It is
loaded with ``ctypes``; every pointer and the stream are ``c_void_p``.

The first kernel launch builds and loads the library; ``build()`` does it
ahead of time and says how long it took.
"""

from __future__ import annotations

import ctypes
import functools
import glob
import hashlib
import os
import shutil
import subprocess
import tempfile
import time

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
LIB_PATH = os.path.join(BUILD_DIR, "librg_kernels.so")
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# C entry points: name -> argtypes (every function returns cudaError_t)
SIGNATURES = {
    # gx, wh, lengths, out, B, T, H, rows_per_block, bf16, stream
    "blstm_recurrence": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    # feat, enc_proj, enc, dec, wloc, g, mask, ctx, att,
    # B, K, T, C, A, E, sharpening, bf16, stream
    "att_loc_step": [_P] * 9 + [_I] * 6 + [_F, _I, _P],
    # lpz, last_tok, lengths, r_n, r_b, psi, B, K, T, V, stream
    "ctc_prefix_psi": [_P] * 6 + [_I] * 4 + [_P],
    # lpz, tok, last_tok, lengths, r_n, r_b, rn_out, rb_out,
    # B, K, T, V, blank, stream
    "ctc_prefix_state": [_P] * 8 + [_I] * 5 + [_P],
}


def _sources():
    return sorted(glob.glob(os.path.join(CSRC, "*.cu"))
                  + glob.glob(os.path.join(CSRC, "*.cuh")))


def _source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in _sources():
        h.update(os.path.basename(path).encode())
        with open(path, "rb") as f:
            h.update(f.read())
    return h.hexdigest()


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    path = os.path.join(home, "bin", "nvcc")
    if os.path.exists(path):
        return path
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (set CUDA_HOME); the CUDA kernels of "
            "robust_e2e_gan_torch are built on the machine with the card"
        )
    return found


def build() -> float:
    """Compile the kernels unless the stamped build is current.

    Returns the seconds spent compiling (0.0 when the build was current).
    The compiler's resource report (-Xptxas -v) is kept beside the library
    as ``build.log``.
    """
    digest = _source_hash()
    stamp = LIB_PATH + ".srchash"
    if os.path.exists(LIB_PATH) and os.path.exists(stamp):
        with open(stamp) as f:
            if f.read().strip() == digest:
                return 0.0
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cu = [p for p in _sources() if p.endswith(".cu")]
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, *cu]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, stdout=subprocess.PIPE,
                          stderr=subprocess.STDOUT, text=True)
    seconds = time.perf_counter() - t0
    with open(os.path.join(BUILD_DIR, "build.log"), "w") as f:
        f.write(" ".join(cmd) + "\n" + proc.stdout)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stdout}")
    os.replace(tmp, LIB_PATH)
    with open(stamp, "w") as f:
        f.write(digest)
    return seconds


@functools.lru_cache(maxsize=None)
def kernels() -> ctypes.CDLL:
    """The loaded kernel library (built on first use)."""
    build()
    lib = ctypes.CDLL(LIB_PATH)
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def launch(name: str, *args) -> None:
    """Call C entry point ``name`` and raise if it reports a CUDA error."""
    lib = kernels()
    rc = getattr(lib, name)(*args)
    if rc != 0:
        raise RuntimeError(f"CUDA kernel {name} failed: cudaError {rc}")
