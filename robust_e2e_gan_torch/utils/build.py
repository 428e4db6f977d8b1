"""Build the CUDA kernels of ``robust_e2e_gan_torch/csrc`` and load them.

One ``nvcc`` process per ``csrc/*.cu``, all started together, compiles the
sources to objects for ``sm_90a`` (no PyTorch headers are included), and
one more links them into a shared library with a plain C interface. The
library lands in ``robust_e2e_gan_torch/_build/`` beside a stamp of the
sources' hash and is rebuilt when a source changes. It is loaded with
``ctypes``; every pointer and the stream are ``c_void_p``.

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
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_U = ctypes.c_uint
_L = ctypes.c_longlong
# C entry points: name -> argtypes (every function returns cudaError_t)
SIGNATURES = {
    # gx, wh, lengths, out, B, T, H, rows_per_block, bf16, stream
    "blstm_recurrence": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    # gx, packed wh, lengths, h scratch, out, the barrier counters, B, T,
    # H, units a block, resident k rows, chunks in flight, m16 tiles and
    # 16-column groups a warp, k slices, shared-memory bytes, the counters'
    # value, bf16, stream
    "blstm_gx_grid": [_P] * 6 + [_I] * 10 + [_U, _I, _P],
    # feat, enc_proj, enc, dec, wloc, g, mask, ctx, att,
    # B, K, T, C, A, E, sharpening, bf16, stream
    "att_loc_step": [_P] * 9 + [_I] * 6 + [_F, _I, _P],
    # the same pointers, B, K, T, C, A, E, chunk frames, column splits,
    # shared-memory bytes, sharpening, bf16, stream
    "att_loc_utt": [_P] * 9 + [_I] * 9 + [_F, _I, _P],
    # lpz, last_tok, lengths, r_n, r_b, psi, B, K, T, V, stream
    "ctc_prefix_psi": [_P] * 6 + [_I] * 4 + [_P],
    # lpz, tok, last_tok, lengths, r_n, r_b, rn_out, rb_out,
    # B, K, T, V, blank, stream
    "ctc_prefix_state": [_P] * 8 + [_I] * 5 + [_P],
    # lpz, last_tok, lengths, r_n, r_b, psi, B, K, T, V, blank, eos,
    # frame splits, chunk frames, stream
    "ctc_prefix_psi_utt": [_P] * 6 + [_I] * 8 + [_P],
    # lpz, k_idx (or null), tok, append (or null), last_tok, lengths, r_n,
    # r_b, rn_out, rb_out, B, K, T, V, blank, chunk frames, stream
    "ctc_prefix_state_utt": [_P] * 10 + [_I] * 6 + [_P],
    # gx, wh, lengths, out, y_ext, c_ext, B, T, H, rows_per_block, bf16,
    # stream
    "blstm_train_fwd": [_P] * 6 + [_I] * 5 + [_P],
    # gx, wh, wh_t, lengths, y_ext, c_ext, dy, dgates, B, T, H,
    # rows_per_block, bf16, stream
    "blstm_train_bwd": [_P] * 8 + [_I] * 5 + [_P],
    # gx, wh, lengths, out, y_ext, c_ext, count, B, T, H, n_u, bf16, stream
    "blstm_train_resident_fwd": [_P] * 7 + [_I] * 5 + [_P],
    # gx, wh, lengths, y_ext, c_ext, dy, dgates, part, count, B, T, H, n_u,
    # bf16, stream
    "blstm_train_resident_bwd": [_P] * 9 + [_I] * 5 + [_P],
    # A, B, C, bias, workspace, tickets, batch, M, N, K, KI, 12 element
    # strides (A: batch, m, k outer, k inner; B: batch, k outer, k inner,
    # n; C: batch, m, n; bias: batch), A's copy mode and k-contiguous
    # staging, B's, tf32, accumulate, k slices, chunks a slice,
    # shared-memory bytes, stream
    "gemm": [_P] * 6 + [_I] * 5 + [_L] * 12 + [_I] * 9 + [_P],
    # the SIMT kernel: A, B, C, bias, batch, M, N, K, KI, the 12 strides,
    # a_bf16, b_bf16, round_bf16, accumulate, stream
    "gemm_simt": [_P] * 4 + [_I] * 5 + [_L] * 12 + [_I] * 4 + [_P],
    # X, out, M, N, stream
    "colsum": [_P, _P, _I, _I, _P],
    # emit, alpha0, skip, pos, lens, hist (or null), afin, B, T, U, stream
    "ctc_alpha_fwd": [_P] * 7 + [_I] * 3 + [_P],
    # emit, skip, pos, lens, hist, dfin, demit, da0, B, T, U, stream
    "ctc_alpha_bwd": [_P] * 8 + [_I] * 3 + [_P],
    # logits, labels, logit_lens, label_lens, hist (or null), lse, nll, B,
    # T, V, U, blank, log_input, bf16, idx64, stream
    "ctc_nll_fwd": [_P] * 7 + [_I] * 8 + [_P],
    # logits, labels, logit_lens, label_lens, hist, lse, dnll, scratch,
    # dlogits, dnll_stride, B, T, V, U, blank, log_input, bf16, idx64,
    # stream
    "ctc_nll_bwd": [_P] * 9 + [_I] * 9 + [_P],
    # wav, n_valid, mcos, msin, fb, the "tc" route's packed bases, bands
    # and weights (null on "simt"), out, B, N, T, L, shift, F, M, the route
    # (tm frames a block, 0 for "simt"; nbins, copy16, shared-memory
    # bytes), log_floor, use_power, norm_var, eps, stream
    "fbank_fwd": [_P] * 9 + [_I] * 11 + [_F, _I, _I, _F, _P],
    # wav, n_valid, mcos, msin, fb, packed bases, bands, weights, mcos_t,
    # msin_t, fb_t, the frame pass's packed bases, bin bands and weights,
    # g, feats, dfeats, res, melr, dframes, dwav, B, N, T, L, shift, F, M,
    # the forward's route (tm, nbins, copy16, shared bytes), the frame
    # pass's shared bytes (0: route "simt"), log_floor, norm_var, eps,
    # stream
    "fbank_bwd": [_P] * 21 + [_I] * 12 + [_F, _I, _F, _P],
    # tok, emb, wx0, wxs, whs, bias, wout, bout, h_in, c_in, h_out, c_out,
    # logits, N, V, E, H, L, bf16, stream
    "lm_step": [_P] * 13 + [_I] * 6 + [_P],
    # the same 13 pointers, the scratch, the barrier counter, N, V, E, H,
    # L, rows a chunk, chunks in flight, grid, shared-memory bytes, the
    # counter's value, bf16, stream
    "lm_step_tile": [_P] * 15 + [_I] * 9 + [_U, _I, _P],
    # feat, enc_proj, enc, dec, wloc, g, mask, tok, emb, wx, wh, bias, wout,
    # bout, z_in, c_in, logits, att, z_out, c_out, B, K, T, C, A, E, V, EMB,
    # H, sharpening, bf16, stream
    "att_dec_step": [_P] * 20 + [_I] * 9 + [_F, _I, _P],
    # the same 20 pointers, xin and zq scratch, the barrier counter, B, K,
    # T, C, A, E, V, EMB, H, chunk frames, column splits, readout columns
    # a chunk, grid, shared-memory bytes, the counter's value, sharpening,
    # bf16, stream
    "att_dec_utt": [_P] * 23 + [_I] * 14 + [_U, _F, _I, _P],
    # lpz, last_tok, lengths, r_n, r_b, psi, B, K, T, V, blank, eos,
    # frame splits, chunk frames, stages, shared-memory bytes, stream
    "ctc_prefix_utt": [_P] * 6 + [_I] * 10 + [_P],
    # x, wx, wh, bias, lengths, out, B, T, D, DW (wx rows), H,
    # rows_per_block, bf16, mma, stream
    "blstm_infer": [_P] * 6 + [_I] * 8 + [_P],
    # x, x reversed per row, wx, wh, bias (packed), lengths, out, B, T,
    # DW, H, C (cluster size), R (rows a group), W_x resident, stream
    "blstm_infer_cluster": [_P] * 7 + [_I] * 7 + [_P],
    # C (cluster size), shared-memory bytes a block, out: clusters of C
    # blocks the card runs at once
    "blstm_infer_cluster_fit": [_I, _I, _P],
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
    nvcc = _nvcc()
    cu = [p for p in _sources() if p.endswith(".cu")]
    objs = [os.path.join(BUILD_DIR, os.path.basename(p)[:-3] + ".o")
            for p in cu]
    t0 = time.perf_counter()
    cmds = [[nvcc, *NVCC_FLAGS, "-c", "-o", o, p] for p, o in zip(cu, objs)]
    jobs = [(cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                   stderr=subprocess.STDOUT, text=True))
            for cmd in cmds]
    log, failed = [], []
    for cmd, proc in jobs:
        out, _ = proc.communicate()
        log.append(" ".join(cmd) + "\n" + out)
        if proc.returncode != 0:
            failed.append(out)
    if not failed:
        cmd = [nvcc, "-shared", "-o", tmp, *objs]
        proc = subprocess.run(cmd, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
        log.append(" ".join(cmd) + "\n" + proc.stdout)
        if proc.returncode != 0:
            failed.append(proc.stdout)
    seconds = time.perf_counter() - t0
    with open(os.path.join(BUILD_DIR, "build.log"), "w") as f:
        f.write("\n".join(log))
    if failed:
        os.unlink(tmp)
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
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
