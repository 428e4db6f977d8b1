"""Cycles in each phase of the per-utterance CTC prefix kernels.

    python -m robust_e2e_gan_torch.tools.ctc_prefix_phases

Needs the card and nvcc. It builds ``csrc/ctc_prefix.cu`` into a library
of its own with the ``PHASE`` marks defined as ``clock64()`` reads of
thread 0, without barriers of their own, so the state kernel's chain warp
and copy warps keep overlapping as in the library build. Thread 0 of
block 0 is the state kernel's chain thread of hypothesis 0 and the psi
kernel's lane (0, 0) of frame split 0; a phase that ends at a block
barrier counts the slowest warp's time. The kernels run through their C
entry points on inputs made as ``chip_smoke.py`` makes them, at the
flagship decode's shape (B=128, K=8, T=174, V=52; PERF.md §6 rows 3 and
4), with the plans of ``ops/ctc_prefix.py``, and the tool prints the
device clock's cycles of each phase beside the marked launch's time by
CUDA events.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys

import torch

from robust_e2e_gan_torch.ops import ctc_prefix
from robust_e2e_gan_torch.utils.build import (
    BUILD_DIR,
    CSRC,
    NVCC_FLAGS,
    SIGNATURES,
    _nvcc,
)

SHAPE = (128, 8, 174, 52)  # B, K, T, V
SMEM_OPTIN = 232_448
# PHASE(n) closes phase n; the state's 2 and 3 and psi's 1 and 2 are
# summed over the chunks
PHASES = {
    "state": [(0, "set-up: the hypotheses' parents and tokens"),
              (1, "stage chunk 0 (lpz rows, phi)"),
              (2, "chain (warp 0) while warps 1-7 copy"),
              (3, "wait at the chunk barrier"),
              (4, "write the last chunk")],
    "psi": [(0, "set-up"),
            (1, "stage a chunk (lpz rows, phi tables), barriers"),
            (2, "online log-sum-exp over the thread's frames"),
            (3, "combine the splits, write psi")],
}

PRELUDE = r'''
__device__ unsigned long long g_cycles[2][8];
#define PHASE_BEGIN long long cyc_[8] = {0, 0, 0, 0, 0, 0, 0, 0}; \
  long long t0_ = clock64();
#define PHASE(n) if (threadIdx.x == 0) { \
  const long long t1_ = clock64(); cyc_[n] += t1_ - t0_; t0_ = t1_; }
#define PHASE_END(kernel) if (threadIdx.x == 0 && blockIdx.x == 0) { \
  _Pragma("unroll") for (int i = 0; i < 8; ++i) g_cycles[kernel][i] = cyc_[i]; }
#include "ctc_prefix.cu"
extern "C" int ctc_prefix_cycles(unsigned long long* out) {
  return (int)cudaMemcpyFromSymbol(out, g_cycles, sizeof(g_cycles));
}
'''


def build() -> ctypes.CDLL:
    os.makedirs(BUILD_DIR, exist_ok=True)
    cu = os.path.join(BUILD_DIR, "ctc_prefix_phases.cu")
    lib = os.path.join(BUILD_DIR, "ctc_prefix_phases.so")
    with open(cu, "w") as f:
        f.write(PRELUDE)
    flags = [f for f in NVCC_FLAGS if f not in ("-Xptxas", "-v")]
    proc = subprocess.run([_nvcc(), *flags, "-shared", "-I", CSRC, "-o", lib,
                           cu], stdout=subprocess.PIPE,
                          stderr=subprocess.STDOUT, text=True)
    if proc.returncode:
        sys.exit("nvcc failed:\n" + proc.stdout)
    dll = ctypes.CDLL(lib)
    for name in ("ctc_prefix_state_utt", "ctc_prefix_psi_utt"):
        fn = getattr(dll, name)
        fn.argtypes = SIGNATURES[name]
        fn.restype = ctypes.c_int
    dll.ctc_prefix_cycles.argtypes = [ctypes.c_void_p]
    dll.ctc_prefix_cycles.restype = ctypes.c_int
    return dll


def inputs(b, k, t, v, dev):
    """Masked log-probs and parent states two tokens deep, as
    ``chip_smoke.py::ctc_inputs`` makes them."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    lpz = torch.log_softmax(3 * torch.randn((b, t, v), generator=gen,
                                            device=dev), -1)
    hl = torch.randint(t // 2, t + 1, (b,), generator=gen, device=dev)
    hl[0] = t
    pad = torch.full((v,), ctc_prefix.LOG_ZERO, device=dev)
    pad[0] = 0.0
    valid = torch.arange(t, device=dev)[None] < hl[:, None]
    lpz = torch.where(valid[..., None], lpz, pad).contiguous()
    r_b = torch.cumsum(lpz[:, :, 0], 1)[:, None].expand(b, k, t).contiguous()
    r_n = torch.full((b, k, t), ctc_prefix.LOG_ZERO, device=dev)
    last = torch.ones((b, k), dtype=torch.int32, device=dev)
    lens = torch.zeros((b, k), dtype=torch.int32, device=dev)
    for _ in range(2):
        tok = torch.randint(2, v, (b, k), generator=gen, device=dev,
                            dtype=torch.int32)
        r_n, r_b = ctc_prefix.prefix_state_plain(lpz, tok, last, lens, r_n,
                                                 r_b, 0)
        last, lens = tok, lens + 1
    tok = torch.randint(2, v, (b, k), generator=gen, device=dev,
                        dtype=torch.int32)
    return lpz, tok, last, lens, r_n, r_b


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("ctc_prefix_phases needs a CUDA device")
    dll = build()
    b, k, t, v = SHAPE
    dev = torch.device("cuda")
    lpz, tok, last, lens, r_n, r_b = inputs(b, k, t, v, dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    rn_out, rb_out = torch.empty_like(r_n), torch.empty_like(r_b)
    psi = torch.empty((b, k, v), device=dev)
    chunk = ctc_prefix.state_plan(k, t, v, SMEM_OPTIN)
    splits, psi_chunk = ctc_prefix.psi_plan(k, t, v, SMEM_OPTIN)
    calls = {
        "state": (f"chunk {chunk} frames, "
                  f"{ctc_prefix.state_smem(k, v, chunk)} shared bytes",
                  lambda: dll.ctc_prefix_state_utt(
                      lpz.data_ptr(), None, tok.data_ptr(), None,
                      last.data_ptr(), lens.data_ptr(), r_n.data_ptr(),
                      r_b.data_ptr(), rn_out.data_ptr(), rb_out.data_ptr(),
                      b, k, t, v, 0, chunk, stream)),
        "psi": (f"{splits} frame splits, chunk {psi_chunk} frames, "
                f"{ctc_prefix.psi_smem(k, v, splits, psi_chunk)} shared "
                "bytes",
                lambda: dll.ctc_prefix_psi_utt(
                    lpz.data_ptr(), last.data_ptr(), lens.data_ptr(),
                    r_n.data_ptr(), r_b.data_ptr(), psi.data_ptr(), b, k, t,
                    v, 0, 1, splits, psi_chunk, stream)),
    }
    cycles = (ctypes.c_ulonglong * 16)()
    for index, (name, (plan, call)) in enumerate(calls.items()):
        if call():
            sys.exit(f"ctc_prefix_{name}_utt failed")
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        call()
        end.record()
        end.synchronize()
        dll.ctc_prefix_cycles(cycles)
        row = cycles[8 * index:8 * index + 8]
        total = sum(row[n] for n, _ in PHASES[name])
        print(f"{name} B={b} K={k} T={t} V={v}: {plan}; marked launch "
              f"{start.elapsed_time(end):.4f} ms; block 0 {total} cycles")
        for n, label in PHASES[name]:
            print(f"  {n} {label}: {row[n]} ({row[n] / total:.1%})")


if __name__ == "__main__":
    main()
