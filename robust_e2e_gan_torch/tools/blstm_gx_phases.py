"""Cycles per frame in each phase of the gate-stream BLSTM's "grid" route.

    python -m robust_e2e_gan_torch.tools.blstm_gx_phases

Needs the card and nvcc. It builds ``csrc/blstm_gx_grid.cu`` into a library
of its own with the ``GX_PHASE`` marks defined as ``clock64()`` reads after
a block barrier, so a phase's count is its slowest warp's; thread 0 of
every block sums its counts in registers and writes them at the end. The
kernel runs through its C entry point on random inputs, every row at full
length, with the plan of ``ops/blstm.py::gx_plan`` and W_h packed by
``gx_pack``, at row 1b's shape (the enhancer layer: bf16, B=128, T=694,
H=256), at the wide encoder layer (B=128, T=174, H=1,024) in float32 and
bfloat16, and at its B=16 float32 slice. The tool prints, for block 0 and
as the mean and the largest over the blocks, the device clock's cycles a
frame of the barrier wait, the h staging (waits for a chunk's copies), the
products (with the next chunk's copies issued), the k slices' sums, cell
and stores, and the arrive with the next frame's gx copies, beside the
marked launch's time by CUDA events; then the products' ceiling at this
card's ``mma.sync`` rate: the same warp tiles' products on registers alone
(no shared-memory loads), cycles a k step on every SM at once, times the
frame's k steps. The barriers the marks add are part of what they
measure, so the marked kernel is a little slower than the library's.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys

import torch

from robust_e2e_gan_torch.ops import blstm
from robust_e2e_gan_torch.utils.build import (
    BUILD_DIR,
    CSRC,
    NVCC_FLAGS,
    SIGNATURES,
    _nvcc,
)
from robust_e2e_gan_torch.utils.impl import device_limits

# GX_PHASE(n) closes phase n; 0-4 are summed over the frames (1 and 2 over
# each frame's chunks), 5 and 6 happen once
PHASES = [(0, "barrier wait"),
          (1, "h staging: wait for a chunk's copies"),
          (2, "products (and the next chunk's copies issued)"),
          (3, "k-slice sums, cell and stores"),
          (4, "arrive, next frame's gx copies issued"),
          (5, "set-up: lengths, W_h's resident rows (once)"),
          (6, "pad frames' zeros (once)")]
PER_FRAME = 5
MAX_BLOCKS = 256

PRELUDE = r'''
__device__ unsigned long long g_cycles[256][8];
#define GX_PHASE_BEGIN long long t0_ = 0, c_[8] = {0, 0, 0, 0, 0, 0, 0, 0}; \
  if (threadIdx.x == 0) t0_ = clock64();
#define GX_PHASE(n) __syncthreads(); if (threadIdx.x == 0) { \
  const long long t1_ = clock64(); c_[n] += t1_ - t0_; t0_ = t1_; }
#define GX_PHASE_END if (threadIdx.x == 0) { \
  _Pragma("unroll") for (int p_ = 0; p_ < 8; ++p_) \
    g_cycles[blockIdx.y * gridDim.x + blockIdx.x][p_] = c_[p_]; }
#include "blstm_gx_grid.cu"
extern "C" int gx_cycles(unsigned long long* out) {
  return (int)cudaMemcpyFromSymbol(out, g_cycles, sizeof(g_cycles));
}
extern "C" int gx_cycles_reset() {
  static unsigned long long zero[256][8];
  return (int)cudaMemcpyToSymbol(g_cycles, zero, sizeof(g_cycles));
}

// The products of a frame's k steps on registers alone: each of the 8 warps
// MW m16 tiles by NW 16-column groups (two n8 tiles each), as
// chunk_products issues them (bfloat16: two m16n8k16 a tile and group;
// float32: the A and B splits, three m16n8k8 a tile and n8 tile into the
// step's own sums, added to the running sums). Thread 0 of each block
// writes the cycles of `steps` k steps.
template <typename W, int MW, int NW>
__global__ void __launch_bounds__(256, 1) ceiling_kernel(int steps, float* sink,
                                                       long long* cycles) {
  const int lane = threadIdx.x % 32;
  float acc[MW][2 * NW][4] = {};
  uint32_t a[4], b[2 * NW][2];
  for (int e = 0; e < 4; ++e) a[e] = __float_as_uint(0.001f * (lane + e));
  for (int n = 0; n < 2 * NW; ++n) b[n][0] = b[n][1] = __float_as_uint(0.002f * (lane + n));
  __syncthreads();
  const long long t0 = clock64();
  for (int s = 0; s < steps; ++s) {
    if constexpr (kB16<W>) {
#pragma unroll
      for (int i = 0; i < MW; ++i) {
#pragma unroll
        for (int n = 0; n < 2 * NW; ++n) rg::mma16816(acc[i][n], a, b[n][0], b[n][1]);
      }
    } else {
      uint32_t bh[2 * NW][2], bl[2 * NW][2], ah[MW][4], al[MW][4];
#pragma unroll
      for (int n = 0; n < 2 * NW; ++n) {
        rg::split_tf32(__uint_as_float(b[n][0]), bh[n][0], bl[n][0]);
        rg::split_tf32(__uint_as_float(b[n][1]), bh[n][1], bl[n][1]);
      }
#pragma unroll
      for (int i = 0; i < MW; ++i) {
#pragma unroll
        for (int e = 0; e < 4; ++e) rg::split_tf32(__uint_as_float(a[e] + i), ah[i][e], al[i][e]);
      }
      float d[MW][2 * NW][4] = {};
#pragma unroll
      for (int i = 0; i < MW; ++i) {
#pragma unroll
        for (int n = 0; n < 2 * NW; ++n) rg::mma1688(d[i][n], al[i], bh[n][0], bh[n][1]);
      }
#pragma unroll
      for (int i = 0; i < MW; ++i) {
#pragma unroll
        for (int n = 0; n < 2 * NW; ++n) rg::mma1688(d[i][n], ah[i], bl[n][0], bl[n][1]);
      }
#pragma unroll
      for (int i = 0; i < MW; ++i) {
#pragma unroll
        for (int n = 0; n < 2 * NW; ++n) rg::mma1688(d[i][n], ah[i], bh[n][0], bh[n][1]);
      }
#pragma unroll
      for (int i = 0; i < MW; ++i) {
#pragma unroll
        for (int n = 0; n < 2 * NW; ++n) {
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[i][n][e] += d[i][n][e];
        }
      }
    }
    a[0] ^= (unsigned)s & 1u;  // a loop-carried operand: no hoisting
  }
  __syncthreads();
  if (threadIdx.x == 0) cycles[blockIdx.x] = clock64() - t0;
  float sum = 0.f;
  for (int i = 0; i < MW; ++i)
    for (int n = 0; n < 2 * NW; ++n)
      for (int e = 0; e < 4; ++e) sum += acc[i][n][e];
  sink[blockIdx.x * 256 + threadIdx.x] = sum;
}

template <typename W>
void ceiling(int mw, int nw, dim3 g, int steps, float* sink, long long* cycles) {
  const dim3 t(256);
  if (nw == 2) ceiling_kernel<W, 2, 2><<<g, t>>>(steps, sink, cycles);
  else if (mw == 1) ceiling_kernel<W, 1, 1><<<g, t>>>(steps, sink, cycles);
  else if (mw == 2) ceiling_kernel<W, 2, 1><<<g, t>>>(steps, sink, cycles);
  else ceiling_kernel<W, 4, 1><<<g, t>>>(steps, sink, cycles);
}

extern "C" int gx_ceiling(int bf16, int mw, int nw, int blocks, int steps, float* sink,
                          long long* cycles) {
  if (bf16)
    ceiling<__nv_bfloat16>(mw, nw, dim3(blocks), steps, sink, cycles);
  else
    ceiling<float>(mw, nw, dim3(blocks), steps, sink, cycles);
  return (int)cudaGetLastError();
}
'''

# name, B, T, H, dtype
SHAPES = [("row 1b (enhancer layer)", 128, 694, 256, torch.bfloat16),
          ("wide encoder layer", 128, 174, 1024, torch.float32),
          ("wide encoder layer", 128, 174, 1024, torch.bfloat16),
          ("wide encoder, B=16 slice", 16, 174, 1024, torch.float32)]


def build() -> ctypes.CDLL:
    os.makedirs(BUILD_DIR, exist_ok=True)
    cu = os.path.join(BUILD_DIR, "blstm_gx_phases.cu")
    lib = os.path.join(BUILD_DIR, "blstm_gx_phases.so")
    with open(cu, "w") as f:
        f.write(PRELUDE)
    flags = [f for f in NVCC_FLAGS if f not in ("-Xptxas", "-v")]
    proc = subprocess.run([_nvcc(), *flags, "-shared", "-I", CSRC, "-o", lib,
                           cu], stdout=subprocess.PIPE,
                          stderr=subprocess.STDOUT, text=True)
    if proc.returncode:
        sys.exit("nvcc failed:\n" + proc.stdout)
    dll = ctypes.CDLL(lib)
    dll.blstm_gx_grid.argtypes = SIGNATURES["blstm_gx_grid"]
    dll.blstm_gx_grid.restype = ctypes.c_int
    dll.gx_cycles.argtypes = [ctypes.c_void_p]
    dll.gx_cycles.restype = ctypes.c_int
    dll.gx_cycles_reset.restype = ctypes.c_int
    dll.gx_ceiling.argtypes = [ctypes.c_int] * 5 + [ctypes.c_void_p] * 2
    dll.gx_ceiling.restype = ctypes.c_int
    return dll


def ceiling(dll, dtype, mw: int, nw: int, h: int, n_blocks: int) -> float:
    """Cycles of one frame's products on registers alone: the cycles a k
    step of warp tiles of ``mw`` m16 tiles by ``nw`` 16-column groups, 8
    warps a block on ``n_blocks`` SMs at once, times the H / k k steps of
    a frame."""
    dev = torch.device("cuda")
    steps = 4096
    sink = torch.empty(n_blocks * 256, device=dev)
    cycles = torch.zeros(n_blocks, dtype=torch.int64, device=dev)
    bf16 = int(dtype == torch.bfloat16)
    for _ in range(2):  # warm-up, then the reading
        rc = dll.gx_ceiling(bf16, mw, nw, n_blocks, steps, sink.data_ptr(),
                            cycles.data_ptr())
        if rc:
            sys.exit(f"gx_ceiling failed: cudaError {rc}")
        torch.cuda.synchronize()
    per_step = cycles.double().mean().item() / steps
    return per_step * h / (16 if bf16 else 8)


def run(dll, name, b, t, h, dtype) -> None:
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    gx = torch.randn((b, t, 2, 4 * h), generator=gen, device=dev)
    wh = (torch.randn((2, h, 4 * h), generator=gen, device=dev)
          / h ** 0.5).to(dtype)
    lengths = torch.full((b,), t, dtype=torch.int32, device=dev)
    plan = blstm.gx_plan(b, h, dtype.itemsize,
                         *device_limits(dev.index or 0))
    if plan is None:
        print(f"{name} {dtype} B={b} H={h}: the grid plan does not fit")
        return
    wp = blstm.gx_pack(wh, plan.units)
    hbuf = torch.empty((2, 2, b, h), dtype=dtype, device=dev)
    out = torch.empty((b, t, 2 * h), dtype=dtype, device=dev)
    count = torch.zeros(64, dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    launches = [0]

    def launch():
        rc = dll.blstm_gx_grid(
            gx.data_ptr(), wp.data_ptr(), lengths.data_ptr(), hbuf.data_ptr(),
            out.data_ptr(), count.data_ptr(), b, t, h, plan.units,
            plan.resident, plan.stages, plan.m_tiles, plan.col_groups,
            plan.k_splits, plan.smem, (t * plan.blocks * launches[0]) % 2**32,
            int(dtype == torch.bfloat16), stream)
        if rc:
            sys.exit(f"blstm_gx_grid failed: cudaError {rc}")
        launches[0] += 1

    launch()
    torch.cuda.synchronize()
    dll.gx_cycles_reset()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    launch()
    end.record()
    end.synchronize()
    want = blstm.blstm_recurrence_plain(gx, wh, lengths, round_h=True)
    err = (out.float() - want.float()).abs().max().item()
    grid = 2 * plan.blocks
    cycles = (ctypes.c_ulonglong * (MAX_BLOCKS * 8))()
    dll.gx_cycles(cycles)
    per_block = [[cycles[i * 8 + p] for p, _ in PHASES] for i in range(grid)]
    frame = sum(per_block[0][:PER_FRAME]) / t
    print(f"{name} {dtype} B={b} T={t} H={h}: plan {tuple(plan)}; marked "
          f"launch {start.elapsed_time(end):.4f} ms (max |err| against the "
          f"plain version {err:.3e}); block 0 {frame:.0f} cycles a frame")
    for i, (p, label) in enumerate(PHASES):
        col = [row[i] for row in per_block]
        div = t if i < PER_FRAME else 1
        unit = "a frame" if i < PER_FRAME else "once"
        share = (f" ({col[0] / t / frame:.1%})" if i < PER_FRAME else "")
        print(f"  {p} {label}: block 0 {col[0] / div:.0f}{share}, mean "
              f"{sum(col) / grid / div:.0f}, largest {max(col) / div:.0f} "
              f"cycles {unit}")
    # the 8 warps of a block are its k slices' warp tiles: each slice runs
    # 1 / k_splits of the frame's k steps
    top = ceiling(dll, dtype, plan.m_tiles, plan.col_groups, h,
                  grid) / plan.k_splits
    print(f"  products' ceiling on registers alone: {top:.0f} cycles a frame "
          f"({top / frame:.1%} of block 0's frame) at warp tiles of "
          f"{plan.m_tiles} m16 tiles by {plan.col_groups} column groups, "
          f"{plan.k_splits} k slices, {grid} blocks at once")


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("blstm_gx_phases needs a CUDA device")
    props = torch.cuda.get_device_properties(0)
    print(f"{props.name}, {props.multi_processor_count} SMs")
    dll = build()
    for shape in SHAPES:
        run(dll, *shape)


if __name__ == "__main__":
    main()
