"""Cycles in each phase of the per-utterance attention kernel.

    python -m robust_e2e_gan_torch.tools.att_utt_phases

Needs the card and nvcc. It builds ``csrc/att_loc_utt.cu`` into a library
of its own with the ``PHASE`` marks defined as ``clock64()`` reads after a
block barrier, so a phase's count is its slowest warp's; thread 0 of block
0 sums them over the chunks. The kernel runs through its C entry point on
random inputs at the flagship decode's shape (B=128, K=8, T=174, C=10,
A=E=256; PERF.md §6 row 2) in bfloat16 and float32, with the plan of
``ops/att.py::utt_plan``, and the tool prints the device clock's cycles of
each phase beside the marked launch's time by CUDA events. The barriers
the marks add are part of what they measure, so the marked kernel is a
little slower than the library's.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys

import torch

from robust_e2e_gan_torch.ops import att
from robust_e2e_gan_torch.utils.build import (
    BUILD_DIR,
    CSRC,
    NVCC_FLAGS,
    SIGNATURES,
    _nvcc,
)

# PHASE(n) closes phase n; 1-4, 7 and 8 are summed over the chunks
PHASES = [(0, "set-up: start the weights' and chunk 0's copies"),
          (1, "wait for a chunk's copies"),
          (2, "unpack weights, repack feat, reduce the previous chunk"),
          (3, "start the next chunk's copies"),
          (4, "score tiles (product, adds, tanhf, g)"),
          (5, "last chunk's reduce"),
          (6, "softmax"),
          (7, "wait for enc's chunks"),
          (8, "context"),
          (9, "write ctx")]

PRELUDE = r'''
__device__ unsigned long long g_cycles[16];
#define PHASE_BEGIN __shared__ unsigned long long cyc_[16]; long long t0_ = 0; \
  if (threadIdx.x == 0) { for (int i = 0; i < 16; ++i) cyc_[i] = 0; t0_ = clock64(); }
#define PHASE(n) __syncthreads(); if (threadIdx.x == 0) { \
  const long long t1_ = clock64(); cyc_[n] += t1_ - t0_; t0_ = t1_; }
#define PHASE_END if (threadIdx.x == 0 && blockIdx.x == 0) \
  for (int i = 0; i < 16; ++i) g_cycles[i] = cyc_[i];
#include "att_loc_utt.cu"
extern "C" int att_utt_cycles(unsigned long long* out) {
  return (int)cudaMemcpyFromSymbol(out, g_cycles, sizeof(g_cycles));
}
'''

SHAPE = (128, 8, 174, 10, 256, 256)  # B, K, T, C, A, E


def build() -> ctypes.CDLL:
    os.makedirs(BUILD_DIR, exist_ok=True)
    cu = os.path.join(BUILD_DIR, "att_utt_phases.cu")
    lib = os.path.join(BUILD_DIR, "att_utt_phases.so")
    with open(cu, "w") as f:
        f.write(PRELUDE)
    flags = [f for f in NVCC_FLAGS if f not in ("-Xptxas", "-v")]
    proc = subprocess.run([_nvcc(), *flags, "-shared", "-I", CSRC, "-o", lib,
                           cu], stdout=subprocess.PIPE,
                          stderr=subprocess.STDOUT, text=True)
    if proc.returncode:
        sys.exit("nvcc failed:\n" + proc.stdout)
    dll = ctypes.CDLL(lib)
    dll.att_loc_utt.argtypes = SIGNATURES["att_loc_utt"]
    dll.att_loc_utt.restype = ctypes.c_int
    dll.att_utt_cycles.argtypes = [ctypes.c_void_p]
    dll.att_utt_cycles.restype = ctypes.c_int
    return dll


def run(dll, dtype: torch.dtype) -> None:
    b, k, t, c, a, e = SHAPE
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)

    def rnd(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device=dev)
                * scale).to(dtype)

    args = (rnd(b, k, t, c, scale=0.05), rnd(b, t, a), rnd(b, t, e),
            rnd(b, k, a), rnd(c, a, scale=0.3), rnd(a, scale=0.1))
    mask = torch.ones((b, t), device=dev)
    ctx = torch.empty((b, k, e), device=dev)
    alig = torch.empty((b, k, t), device=dev)
    chunk, splits, smem = att.utt_plan(b, k, t, c, a, e, args[0].element_size(),
                                       232_448)
    stream = torch.cuda.current_stream(dev).cuda_stream

    def launch():
        rc = dll.att_loc_utt(*(x.data_ptr() for x in args), mask.data_ptr(),
                             ctx.data_ptr(), alig.data_ptr(), b, k, t, c, a,
                             e, chunk, splits, smem, 2.0,
                             int(dtype == torch.bfloat16), stream)
        if rc:
            sys.exit(f"att_loc_utt failed: cudaError {rc}")

    launch()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    launch()
    end.record()
    end.synchronize()
    cycles = (ctypes.c_ulonglong * 16)()
    dll.att_utt_cycles(cycles)
    total = sum(cycles[n] for n, _ in PHASES)
    print(f"{dtype} B={b} K={k} T={t} C={c} A={a} E={e}: chunk {chunk} "
          f"frames, {splits} column splits, {smem} shared bytes; marked "
          f"launch {start.elapsed_time(end):.4f} ms; block 0 {total} cycles")
    for n, name in PHASES:
        print(f"  {n} {name}: {cycles[n]} ({cycles[n] / total:.1%})")


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("att_utt_phases needs a CUDA device")
    dll = build()
    for dtype in (torch.bfloat16, torch.float32):
        run(dll, dtype)


if __name__ == "__main__":
    main()
