"""Cycles in each phase of the fused log-mel forward, on both routes.

    python -m robust_e2e_gan_torch.tools.fbank_phases

Needs the card and nvcc. It builds ``csrc/fbank.cu`` into a library of its
own with the ``FB_PHASE`` marks defined as ``clock64()`` reads after a
block barrier, so a phase's count is its slowest warp's; thread 0 of every
block sums its counts in registers and writes them at the end. The forward
runs through its C entry point (``fbank_fwd``: the log-mel kernel, then
``cmvn_kernel``) at the clean decode's shape (B = 128 clean synthetic
utterances padded to 111,360 samples, 694 frames, L = 400, shift = 160,
80 mels) and at the train step's (B = 32, 46,080 samples, 286 frames), on
route "tc" (``logmel_tc_kernel``, with the plan of
``ops/fbank_fused.py::fbank_plan``) and route "simt" (``logmel_kernel``).
For each it prints the marked launch's time by CUDA events and, as the
mean and the largest over the blocks that ran the DFT (the tiles wholly
past an utterance's frames write zeros and are counted apart), the device
clock's cycles of

  0. the frames: "tc" the span's copy wait and its tf32 split; "simt" the
     transposed frame tile's loads;
  1. the DFT products;
  2. "tc" power and the banded mel into shared memory; "simt" power;
  3. "tc" log, mask and store; "simt" the dense mel, log, mask and store;

and the cycles of each CMVN block (one an utterance). The barriers the
marks add are part of what they measure.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys

import numpy as np
import torch

from robust_e2e_gan_torch.config import FrontendConfig
from robust_e2e_gan_torch.data.synthetic import SyntheticConfig, make_batch
from robust_e2e_gan_torch.ops import fbank_fused as ff
from robust_e2e_gan_torch.ops.fbank import num_frames
from robust_e2e_gan_torch.utils.build import (
    BUILD_DIR,
    CSRC,
    NVCC_FLAGS,
    SIGNATURES,
    _nvcc,
)

PHASES = {"tc": ["the span: copy wait and tf32 split",
                 "DFT products (3xTF32 mma.sync)",
                 "power and the banded mel",
                 "log, mask and store"],
          "simt": ["the frame tile: loads",
                   "DFT products (float32 FMAs)",
                   "power",
                   "dense mel, log, mask and store"]}
MAX_BLOCKS = 4096

PRELUDE = r'''
__device__ unsigned long long g_cycles[4096][4];
__device__ unsigned long long g_cmvn[4096];
#define FB_PHASE_BEGIN long long t0_ = 0, c_[4] = {0, 0, 0, 0}; \
  if (threadIdx.x == 0) t0_ = clock64();
#define FB_PHASE(n) __syncthreads(); if (threadIdx.x == 0) { \
  const long long t1_ = clock64(); c_[n] += t1_ - t0_; t0_ = t1_; }
#define FB_PHASE_END if (threadIdx.x == 0) { \
  const int blk_ = blockIdx.y * gridDim.x + blockIdx.x; \
  if (blk_ < 4096) { _Pragma("unroll") for (int p_ = 0; p_ < 4; ++p_) \
    g_cycles[blk_][p_] = c_[p_]; } }
#define FB_CMVN_BEGIN long long tc0_ = 0; \
  if (threadIdx.x == 0) tc0_ = clock64();
#define FB_CMVN_END __syncthreads(); \
  if (threadIdx.x == 0 && blockIdx.x < 4096) \
    g_cmvn[blockIdx.x] = clock64() - tc0_;
#include "fbank.cu"
// the DFT loop's products alone, as a ceiling: the same warps, m16 and n8
// tiles and three passes a k8 step, on registers only; each step's sums
// added apart (APART, the kernel's) or every pass into the running sums,
// with or without the B operand's tf32 splits (SPLIT, 16 a lane a step)
template <int APART, int SPLIT>
__global__ void __launch_bounds__(256, 1) mma_ceiling_kernel(float* out,
    unsigned long long* cycles, int steps) {
  const long long c0 = clock64();
  uint32_t a[4], bh[8][2], bl[8][2];
  float braw[8][2];
  for (int i = 0; i < 4; ++i) a[i] = rg::tf32(threadIdx.x * 0.37f + i);
  for (int nt = 0; nt < 8; ++nt) {
    braw[nt][0] = nt * 0.11f - threadIdx.x, braw[nt][1] = nt + 0.5f;
    for (int h = 0; h < 2; ++h) rg::split_tf32(braw[nt][h], bh[nt][h], bl[nt][h]);
  }
  float acc[4][8][4] = {};
  for (int s = 0; s < steps; ++s) {
#pragma unroll
    for (int mt = 0; mt < 4; ++mt) {
      uint32_t am[4];  // an A operand of its own each m16 tile
      for (int i = 0; i < 4; ++i) am[i] = a[i] + mt * 0x2000u;
      if (APART) {
        float d[8][4] = {};
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) rg::mma1688(d[nt], am, bh[nt][0], bh[nt][1]);
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) rg::mma1688(d[nt], am, bl[nt][0], bl[nt][1]);
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) rg::mma1688(d[nt], am, bh[nt][0], bh[nt][1]);
#pragma unroll
        for (int nt = 0; nt < 8; ++nt)
          for (int e = 0; e < 4; ++e) acc[mt][nt][e] += d[nt][e];
      } else {
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) rg::mma1688(acc[mt][nt], am, bh[nt][0], bh[nt][1]);
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) rg::mma1688(acc[mt][nt], am, bl[nt][0], bl[nt][1]);
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) rg::mma1688(acc[mt][nt], am, bh[nt][0], bh[nt][1]);
      }
    }
    if (SPLIT) {
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        braw[nt][0] += 1.f, braw[nt][1] -= 1.f;
        for (int h = 0; h < 2; ++h) rg::split_tf32(braw[nt][h], bh[nt][h], bl[nt][h]);
      }
    }
    a[0] ^= s;  // a new A operand each step
  }
  float sum = 0.f;
  for (int mt = 0; mt < 4; ++mt)
    for (int nt = 0; nt < 8; ++nt)
      for (int e = 0; e < 4; ++e) sum += acc[mt][nt][e];
  out[blockIdx.x * blockDim.x + threadIdx.x] = sum;
  __syncthreads();
  if (threadIdx.x == 0) cycles[blockIdx.x] = clock64() - c0;
}
extern "C" int fb_mma_ceiling(float* out, unsigned long long* cycles, int blocks,
                              int steps, int variant, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  if (variant == 0)
    mma_ceiling_kernel<1, 0><<<blocks, 256, 0, s>>>(out, cycles, steps);
  else if (variant == 1)
    mma_ceiling_kernel<1, 1><<<blocks, 256, 0, s>>>(out, cycles, steps);
  else
    mma_ceiling_kernel<0, 0><<<blocks, 256, 0, s>>>(out, cycles, steps);
  return (int)cudaGetLastError();
}
extern "C" int fb_cycles(unsigned long long* out, unsigned long long* cmvn) {
  cudaError_t err = cudaMemcpyFromSymbol(out, g_cycles, sizeof(g_cycles));
  if (err != cudaSuccess) return (int)err;
  return (int)cudaMemcpyFromSymbol(cmvn, g_cmvn, sizeof(g_cmvn));
}
extern "C" int fb_cycles_reset() {
  static unsigned long long zero[4096][4];
  cudaError_t err = cudaMemcpyToSymbol(g_cycles, zero, sizeof(g_cycles));
  if (err != cudaSuccess) return (int)err;
  return (int)cudaMemcpyToSymbol(g_cmvn, zero, sizeof(g_cmvn));
}
'''

# name, B, utterances' synthetic config (chip_smoke.py's decode and train
# traffic)
SHAPES = [("clean decode", 128, SyntheticConfig(vocab_size=52, min_tokens=48,
                                                max_tokens=58)),
          ("train step", 32, SyntheticConfig(vocab_size=52, min_tokens=20,
                                             max_tokens=24))]


def build() -> ctypes.CDLL:
    os.makedirs(BUILD_DIR, exist_ok=True)
    cu = os.path.join(BUILD_DIR, "fbank_phases.cu")
    lib = os.path.join(BUILD_DIR, "fbank_phases.so")
    with open(cu, "w") as f:
        f.write(PRELUDE)
    flags = [f for f in NVCC_FLAGS if f not in ("-Xptxas", "-v")]
    proc = subprocess.run([_nvcc(), *flags, "-shared", "-I", CSRC, "-o", lib,
                           cu], stdout=subprocess.PIPE,
                          stderr=subprocess.STDOUT, text=True)
    if proc.returncode:
        sys.exit("nvcc failed:\n" + proc.stdout)
    dll = ctypes.CDLL(lib)
    dll.fbank_fwd.argtypes = SIGNATURES["fbank_fwd"]
    dll.fbank_fwd.restype = ctypes.c_int
    dll.fb_cycles.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    dll.fb_cycles.restype = ctypes.c_int
    dll.fb_cycles_reset.restype = ctypes.c_int
    dll.fb_mma_ceiling.argtypes = [ctypes.c_void_p] * 2 + [
        ctypes.c_int] * 3 + [ctypes.c_void_p]
    dll.fb_mma_ceiling.restype = ctypes.c_int
    return dll


def mma_ceiling(dll, steps: int = 400) -> None:
    """The DFT loop's products alone, on registers (one 8-warp block an SM,
    4 x 8 tiles a warp, 3 passes a k8 step): each step's sums added apart
    as the kernel adds them, the same with the B operand's tf32 splits, and
    every pass into the running sums. The ceilings of this mma.sync
    pattern, in SM cycles a k8 step (beside the DFT phase's cycles /
    (L / 8)) and in TFLOP/s of tf32 products."""
    dev = torch.device("cuda")
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    out = torch.empty(n_sm * 256, device=dev)
    cycles = torch.zeros(n_sm, dtype=torch.int64, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    for variant, how in enumerate(("each k8 step added apart",
                                   "added apart, with the B splits",
                                   "passes into the running sums")):
        def launch():
            if dll.fb_mma_ceiling(out.data_ptr(), cycles.data_ptr(), n_sm,
                                  steps, variant, stream):
                sys.exit("fb_mma_ceiling failed")
        launch()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        launch()
        end.record()
        end.synchronize()
        ms = start.elapsed_time(end)
        # a warp's k8 step: 4 m16 x 8 n8 tiles x 3 passes of 16 x 8 x 8
        flops = n_sm * 8 * steps * 4 * 8 * 3 * 2 * 16 * 8 * 8
        print(f"mma.sync m16n8k8 tf32 ceiling, {how}: "
              f"{cycles.double().mean().item() / steps:.0f} cycles a k8 "
              f"step an SM, {flops / ms / 1e9:.1f} TFLOP/s of tf32 products "
              f"({flops / ms / 1e9 / 495:.1%} of 495; {ms:.4f} ms)")


def run(dll, name, b, synth, route) -> None:
    cfg = FrontendConfig()
    dev = torch.device("cuda")
    data = make_batch(b, synth, np.random.default_rng(0))
    wav = torch.from_numpy(data["clean_wav"]).to(dev).contiguous()
    lens = torch.from_numpy(data["wav_lengths"]).to(dev)
    n = wav.shape[1]
    t = num_frames(n, cfg)
    n_valid = ff.valid_frames(wav, cfg, lens).contiguous()
    with ff._force_fbank_route(route):
        plan = ff._route_plan(wav, cfg)
    bases, args = ff._logmel_args(wav, cfg, plan)
    out = torch.empty((b, t, cfg.n_mels), device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream

    def launch():
        rc = dll.fbank_fwd(wav.data_ptr(), n_valid.data_ptr(), *bases,
                           out.data_ptr(), b, n, t, cfg.frame_length,
                           cfg.frame_shift, cfg.n_freqs, cfg.n_mels, *args,
                           cfg.log_floor, int(cfg.use_power), 1, 1e-8,
                           stream)
        if rc:
            sys.exit(f"fbank_fwd ({route}) failed: cudaError {rc}")

    launch()
    torch.cuda.synchronize()
    if dll.fb_cycles_reset():
        sys.exit("fb_cycles_reset failed")
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    launch()
    end.record()
    end.synchronize()
    cycles = (ctypes.c_ulonglong * (MAX_BLOCKS * 4))()
    cmvn = (ctypes.c_ulonglong * MAX_BLOCKS)()
    if dll.fb_cycles(cycles, cmvn):
        sys.exit("fb_cycles failed")
    tm = plan.tm if plan else ff.TT
    blocks = -(-t // tm) * b
    rows = np.frombuffer(cycles, dtype=np.uint64).reshape(MAX_BLOCKS, 4)
    rows = rows[:blocks].astype(np.float64)
    ran = rows[rows.sum(1) > 0]
    total = ran.sum(1).mean()
    cm = np.frombuffer(cmvn, dtype=np.uint64)[:b].astype(np.float64)
    print(f"{name} B={b} N={n} T={t} ({int(n_valid.sum())} valid frames), "
          f"route {route}: plan {plan}; marked launch (log-mel + CMVN) "
          f"{start.elapsed_time(end):.4f} ms; {len(ran)} of {blocks} blocks "
          f"ran the DFT, {total:.0f} cycles each on the mean")
    for p, label in enumerate(PHASES[route]):
        col = ran[:, p]
        print(f"  {p} {label}: mean {col.mean():.0f} "
              f"({col.mean() / total:.1%}), largest {col.max():.0f}"
              + (f"; {col.mean() / (cfg.frame_length // 8):.0f} a k8 step"
                 if p == 1 else ""))
    print(f"  CMVN, a block an utterance: mean {cm.mean():.0f}, largest "
          f"{cm.max():.0f} cycles")


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("fbank_phases needs a CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], stdout=subprocess.PIPE,
                         stderr=subprocess.STDOUT, text=True)
    print(smi.stdout.strip().splitlines()[0])
    dll = build()
    mma_ceiling(dll)
    for name, b, synth in SHAPES:
        for route in ("tc", "simt"):
            run(dll, name, b, synth, route)


if __name__ == "__main__":
    main()
