"""Cycles in each phase of the fused decoder step's "utt" route.

    python -m robust_e2e_gan_torch.tools.att_dec_phases

Needs the card and nvcc. It builds ``csrc/att_dec_utt.cu`` into a library
of its own with the ``DEC_PHASE`` marks defined as ``clock64()`` reads after
a block barrier, so a phase's count is its slowest warp's, and every block
keeps its own counts. The kernel runs through its C entry point on random
inputs, with the plan of ``ops/att_dec.py::utt_plan``, at the flagship's
decode shape in bfloat16 (B=128, K=8, T=174, C=10, A=E=EMB=H=256, V=52;
PERF.md §6 row 5) and at the decode CLI's model in float32 (A=E=EMB=H=512,
V=12, T=30, its task's longest utterance). The tool prints, for block 0
and as the mean and the largest over the blocks, the device clock's cycles
of the attention (phase A, with the lanes' rows), of each grid barrier's
arrive and wait (the second with Wout's staging), of the gate product
(phase B: the waits for a chunk's copies, the tile products with the next
copies' issue, the gates tile and the cell) and of the readout (phase C:
the lanes' rows staged, the slices' partial sums, their sum and the
logits), beside the marked launch's time by CUDA events. The barriers the
marks add are part of what they measure, so the marked kernel is a little
slower than the library's.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys

import torch

from robust_e2e_gan_torch.ops import att_dec
from robust_e2e_gan_torch.utils.build import (
    BUILD_DIR,
    CSRC,
    NVCC_FLAGS,
    SIGNATURES,
    _nvcc,
)
from robust_e2e_gan_torch.utils.impl import device_limits

# DEC_PHASE(n) closes phase n; 5 and 6 are summed over the gate product's
# chunks and tiles, 7, 8 and 4 over the readout's utterances
PHASES = [(0, "A: attention and the lanes' rows"),
          (1, "barrier 1: arrive and wait"),
          (5, "B: wait for a chunk's copies"),
          (6, "B: the chunk's tile products, start the next copies"),
          (2, "B: gates tile and cell"),
          (3, "barrier 2: arrive, stage Wout, wait"),
          (7, "C: stage the lanes' rows"),
          (8, "C: partial sums"),
          (4, "C: sum the slices, write the logits")]
MAX_BLOCKS = 1024

PRELUDE = r'''
__device__ unsigned long long g_cycles[1024][16];
#define DEC_PHASE_BEGIN long long t0_ = 0; if (threadIdx.x == 0) t0_ = clock64();
#define DEC_PHASE(n) __syncthreads(); if (threadIdx.x == 0) { \
  const long long t1_ = clock64(); g_cycles[blockIdx.x][n] += t1_ - t0_; t0_ = t1_; }
#define DEC_PHASE_END
#include "att_dec_utt.cu"
extern "C" int att_dec_cycles(unsigned long long* out) {
  return (int)cudaMemcpyFromSymbol(out, g_cycles, sizeof(g_cycles));
}
extern "C" int att_dec_cycles_reset() {
  static unsigned long long zero[1024][16];
  return (int)cudaMemcpyToSymbol(g_cycles, zero, sizeof(g_cycles));
}
'''

# name, B, K, T, C, A, E, EMB, H, V, dtype
SHAPES = [("flagship", 128, 8, 174, 10, 256, 256, 256, 256, 52, torch.bfloat16),
          ("decode CLI", 128, 8, 30, 10, 512, 512, 512, 512, 12, torch.float32)]


def build() -> ctypes.CDLL:
    os.makedirs(BUILD_DIR, exist_ok=True)
    cu = os.path.join(BUILD_DIR, "att_dec_phases.cu")
    lib = os.path.join(BUILD_DIR, "att_dec_phases.so")
    with open(cu, "w") as f:
        f.write(PRELUDE)
    flags = [f for f in NVCC_FLAGS if f not in ("-Xptxas", "-v")]
    proc = subprocess.run([_nvcc(), *flags, "-shared", "-I", CSRC, "-o", lib,
                           cu], stdout=subprocess.PIPE,
                          stderr=subprocess.STDOUT, text=True)
    if proc.returncode:
        sys.exit("nvcc failed:\n" + proc.stdout)
    dll = ctypes.CDLL(lib)
    dll.att_dec_utt.argtypes = SIGNATURES["att_dec_utt"]
    dll.att_dec_utt.restype = ctypes.c_int
    dll.att_dec_cycles.argtypes = [ctypes.c_void_p]
    dll.att_dec_cycles.restype = ctypes.c_int
    dll.att_dec_cycles_reset.restype = ctypes.c_int
    return dll


def run(dll, name, b, k, t, c, a, e, embd, h, v, dtype) -> None:
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    f32 = torch.float32

    def rnd(*shape, scale=1.0, dt=dtype):
        return (torch.randn(shape, generator=gen, device=dev) * scale).to(dt)

    ins = [rnd(b, k, t, c, scale=0.05), rnd(b, t, a), rnd(b, t, e),
           rnd(b, k, a), rnd(c, a, scale=0.3), rnd(a, scale=0.1),
           torch.ones((b, t), device=dev),
           torch.randint(0, v, (b, k), generator=gen, device=dev,
                         dtype=torch.int32),
           rnd(v, embd), rnd(embd + e, 4 * h, scale=(embd + e) ** -0.5),
           rnd(h, 4 * h, scale=h ** -0.5), rnd(4 * h, scale=0.1, dt=f32),
           rnd(h + e, v, scale=(h + e) ** -0.5), rnd(v, scale=0.1, dt=f32),
           rnd(b, k, h, scale=0.5, dt=f32), rnd(b, k, h, scale=0.5, dt=f32)]
    outs = [torch.empty(s, device=dev) for s in
            ((b, k, v), (b, k, t), (b, k, h), (b, k, h))]
    isz = ins[0].element_size()
    xin = torch.empty((b * k, att_dec.utt_row_width(embd, e, h, isz)),
                      dtype=dtype, device=dev)
    zq = torch.empty((b * k, h), dtype=dtype, device=dev)
    count = torch.zeros(1, dtype=torch.int32, device=dev)
    plan = att_dec.utt_plan(b, k, t, c, a, e, embd, h, v, isz,
                            *device_limits(dev.index or 0))
    if plan is None:
        sys.exit(f"{name}: the utt plan does not fit")
    chunk, splits, vc, grid, smem = plan
    stream = torch.cuda.current_stream(dev).cuda_stream
    launches = [0]

    def launch():
        rc = dll.att_dec_utt(*(x.data_ptr() for x in ins + outs),
                             xin.data_ptr(), zq.data_ptr(), count.data_ptr(),
                             b, k, t, c, a, e, v, embd, h, chunk, splits, vc,
                             grid, smem, (2 * grid * launches[0]) % 2**32,
                             2.0, int(dtype == torch.bfloat16), stream)
        if rc:
            sys.exit(f"att_dec_utt failed: cudaError {rc}")
        launches[0] += 1

    launch()
    torch.cuda.synchronize()
    dll.att_dec_cycles_reset()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    launch()
    end.record()
    end.synchronize()
    cycles = (ctypes.c_ulonglong * (MAX_BLOCKS * 16))()
    dll.att_dec_cycles(cycles)
    per_block = [[cycles[i * 16 + n] for n, _ in PHASES]
                 for i in range(grid)]
    total = sum(per_block[0])
    print(f"{name} {dtype} B={b} K={k} T={t} C={c} A={a} E={e} EMB={embd} "
          f"H={h} V={v}: plan (chunk frames, column splits, readout "
          f"columns, grid, shared bytes) {plan}; marked launch "
          f"{start.elapsed_time(end):.4f} ms; block 0 {total} cycles")
    for i, (n, label) in enumerate(PHASES):
        col = [row[i] for row in per_block]
        print(f"  {n} {label}: block 0 {col[0]} ({col[0] / total:.1%}), "
              f"mean {sum(col) / grid:.0f}, largest {max(col)}")


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("att_dec_phases needs a CUDA device")
    dll = build()
    for shape in SHAPES:
        run(dll, *shape)


if __name__ == "__main__":
    main()
