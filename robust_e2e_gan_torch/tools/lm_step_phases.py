"""Cycles in each phase of the RNNLM step's "tile" route.

    python -m robust_e2e_gan_torch.tools.lm_step_phases

Needs the card and nvcc. It builds ``csrc/lm_step_tile.cu`` into a library
of its own with the ``LM_PHASE`` marks defined as ``clock64()`` reads after
a block barrier, so a phase's count is its slowest warp's; thread 0 of
every block sums its counts in registers and writes them at the end. The
kernel runs through its C entry point on random inputs, with the plan of
``ops/lm_step.py::tile_plan``, at the clean decode's LM (``LMConfig()``:
N = 1,024 lanes, V=52, E=128, H=256, one layer) in float32 and in
bfloat16, with two layers, and at the decode CLI's widths (E=H=512,
V=12). The tool prints, for block 0 and as the mean and the largest over
the blocks, the device clock's cycles of the gate product (the waits for
a chunk's copies, the chunk's tile products with the next copies' issue,
the gates tile and the cell), of the grid barriers (after a layer; the
last with Wout's staging) and of the readout (the lanes' rows staged; the
products and the logits), beside the marked launch's time by CUDA events.
The barriers the marks add are part of what they measure, so the marked
kernel is a little slower than the library's.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys

import torch

from robust_e2e_gan_torch.ops import lm_step
from robust_e2e_gan_torch.utils.build import (
    BUILD_DIR,
    CSRC,
    NVCC_FLAGS,
    SIGNATURES,
    _nvcc,
)
from robust_e2e_gan_torch.utils.impl import device_limits

# LM_PHASE(n) closes phase n; 0-2 are summed over the chunks, tiles and
# layers, 3 over the layers before the last, 5 and 6 over the readout's
# lane groups
PHASES = [(0, "gates: wait for a chunk's copies"),
          (1, "gates: the chunk's tile products, start the next copies"),
          (2, "gates: gates tile and cell"),
          (3, "barrier after a layer: arrive and wait"),
          (4, "last barrier: arrive, stage Wout, wait"),
          (5, "readout: stage the lanes' rows"),
          (6, "readout: products and logits")]
MAX_BLOCKS = 1024

# thread 0 keeps its counts in registers (every mark's index is a constant)
# and writes them once at the end: a mark costs a block barrier and a clock
# read, not a global load
PRELUDE = r'''
__device__ unsigned long long g_cycles[1024][8];
#define LM_PHASE_BEGIN long long t0_ = 0, c_[8] = {0, 0, 0, 0, 0, 0, 0, 0}; \
  if (threadIdx.x == 0) t0_ = clock64();
#define LM_PHASE(n) __syncthreads(); if (threadIdx.x == 0) { \
  const long long t1_ = clock64(); c_[n] += t1_ - t0_; t0_ = t1_; }
#define LM_PHASE_END if (threadIdx.x == 0) { \
  _Pragma("unroll") for (int p_ = 0; p_ < 8; ++p_) g_cycles[blockIdx.x][p_] = c_[p_]; }
#include "lm_step_tile.cu"
extern "C" int lm_cycles(unsigned long long* out) {
  return (int)cudaMemcpyFromSymbol(out, g_cycles, sizeof(g_cycles));
}
extern "C" int lm_cycles_reset() {
  static unsigned long long zero[1024][8];
  return (int)cudaMemcpyToSymbol(g_cycles, zero, sizeof(g_cycles));
}
'''

# name, N, V, E, H, L, dtype
SHAPES = [("LMConfig", 1024, 52, 128, 256, 1, torch.float32),
          ("LMConfig", 1024, 52, 128, 256, 1, torch.bfloat16),
          ("2 layers", 1024, 52, 128, 256, 2, torch.float32),
          ("decode CLI widths", 1024, 12, 512, 512, 1, torch.float32)]


def build() -> ctypes.CDLL:
    os.makedirs(BUILD_DIR, exist_ok=True)
    cu = os.path.join(BUILD_DIR, "lm_step_phases.cu")
    lib = os.path.join(BUILD_DIR, "lm_step_phases.so")
    with open(cu, "w") as f:
        f.write(PRELUDE)
    flags = [f for f in NVCC_FLAGS if f not in ("-Xptxas", "-v")]
    proc = subprocess.run([_nvcc(), *flags, "-shared", "-I", CSRC, "-o", lib,
                           cu], stdout=subprocess.PIPE,
                          stderr=subprocess.STDOUT, text=True)
    if proc.returncode:
        sys.exit("nvcc failed:\n" + proc.stdout)
    dll = ctypes.CDLL(lib)
    dll.lm_step_tile.argtypes = SIGNATURES["lm_step_tile"]
    dll.lm_step_tile.restype = ctypes.c_int
    dll.lm_cycles.argtypes = [ctypes.c_void_p]
    dll.lm_cycles.restype = ctypes.c_int
    dll.lm_cycles_reset.restype = ctypes.c_int
    return dll


def run(dll, name, n, v, e, h, layers, dtype) -> None:
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    f32 = torch.float32

    def rnd(*shape, scale=1.0, dt=dtype):
        return (torch.randn(shape, generator=gen, device=dev) * scale).to(dt)

    wx_rest = (rnd(layers - 1, h, 4 * h, scale=h ** -0.5) if layers > 1
               else rnd(1, 16))
    ins = [torch.randint(0, v, (n,), generator=gen, device=dev,
                         dtype=torch.int32),
           rnd(v, e, scale=e ** -0.5), rnd(e, 4 * h, scale=e ** -0.5),
           wx_rest, rnd(layers, h, 4 * h, scale=h ** -0.5),
           rnd(layers, 4 * h, scale=0.1, dt=f32), rnd(h, v, scale=h ** -0.5),
           rnd(v, scale=0.1, dt=f32), rnd(layers, n, h, scale=0.5, dt=f32),
           rnd(layers, n, h, scale=0.5, dt=f32)]
    outs = [torch.empty((layers, n, h), device=dev),
            torch.empty((layers, n, h), device=dev),
            torch.empty((n, v), device=dev)]
    scratch = torch.empty((min(layers, 2), n, h), dtype=dtype, device=dev)
    count = torch.zeros(1, dtype=torch.int32, device=dev)
    plan = lm_step.tile_plan(n, v, e, h, layers, dtype.itemsize,
                             *device_limits(dev.index or 0))
    if plan is None:
        sys.exit(f"{name}: the tile plan does not fit")
    kc, stages, grid, smem = plan
    stream = torch.cuda.current_stream(dev).cuda_stream
    launches = [0]

    def launch():
        rc = dll.lm_step_tile(*(x.data_ptr() for x in ins + outs),
                              scratch.data_ptr(), count.data_ptr(), n, v, e,
                              h, layers, kc, stages, grid, smem,
                              (layers * grid * launches[0]) % 2**32,
                              int(dtype == torch.bfloat16), stream)
        if rc:
            sys.exit(f"lm_step_tile failed: cudaError {rc}")
        launches[0] += 1

    launch()
    torch.cuda.synchronize()
    dll.lm_cycles_reset()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    launch()
    end.record()
    end.synchronize()
    cycles = (ctypes.c_ulonglong * (MAX_BLOCKS * 8))()
    dll.lm_cycles(cycles)
    per_block = [[cycles[i * 8 + p] for p, _ in PHASES] for i in range(grid)]
    total = sum(per_block[0])
    print(f"{name} {dtype} N={n} V={v} E={e} H={h} L={layers}: plan (rows a "
          f"chunk, chunks in flight, grid, shared bytes) {plan}; marked "
          f"launch {start.elapsed_time(end):.4f} ms; block 0 {total} cycles")
    for i, (p, label) in enumerate(PHASES):
        col = [row[i] for row in per_block]
        print(f"  {p} {label}: block 0 {col[0]} ({col[0] / total:.1%}), "
              f"mean {sum(col) / grid:.0f}, largest {max(col)}")


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("lm_step_phases needs a CUDA device")
    dll = build()
    for shape in SHAPES:
        run(dll, *shape)


if __name__ == "__main__":
    main()
