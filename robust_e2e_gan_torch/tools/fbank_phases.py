"""Cycles in each phase of the fused log-mel forward, on both routes, and
of the backward's frame pass on route "tc".

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

Then the backward at phase 3's row-9 inputs (the train step's shape,
noisy synthetic utterances): the device time of its four
launches (the log-mel recompute, ``cmvn_bwd_kernel``, the frame pass,
``overlap_add_kernel``) from ``torch.profiler`` over calls of the library
build's ``fbank_fused_bwd``, with the frame pass on each route; and the
``FB_BWD_PHASE`` marks of ``dframes_tc_kernel`` in the marked build:

  0. the A operand's build: the spectra's copy wait, dmel, dpower, A's
     tf32 split;
  1. the transposed DFT's products (3xTF32 mma.sync);
  2. the store of dframes;

beside the register-only ceiling of its products' mma.sync pattern (2 m16
x 7 n8 tiles a warp). Last, the backward's accuracy at the train step's
shape on noisy and on clean synthetic speech (whose near-silent frames
put mel energies just above the log floor, where dmel = dfeats / mel is
large; it counts those within 1e-3 of the floor): |dwav - ref| /
max|ref| of each frame-pass route and of the plain version, against the
plain version and against a float64 evaluation of the same chain.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys

import numpy as np
import torch
import torch.nn.functional as F

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

BWD_PHASES = ["the A operand: copy wait, dmel, dpower, tf32 split",
              "transposed DFT products (3xTF32 mma.sync)",
              "store of dframes"]
# the backward's four launches, by kernel name
BWD_KERNELS = ("logmel_tc_kernel", "cmvn_bwd_kernel", "dframes_tc_kernel",
               "dframes_kernel", "overlap_add_kernel")

PRELUDE = r'''
__device__ unsigned long long g_cycles[4096][4];
__device__ unsigned long long g_cmvn[4096];
__device__ unsigned long long g_bwd[4096][3];
#define FB_BWD_BEGIN long long tb0_ = 0, cb_[3] = {0, 0, 0}; \
  if (threadIdx.x == 0) tb0_ = clock64();
#define FB_BWD_PHASE(n) __syncthreads(); if (threadIdx.x == 0) { \
  const long long t1_ = clock64(); cb_[n] += t1_ - tb0_; tb0_ = t1_; }
#define FB_BWD_END if (threadIdx.x == 0) { \
  const int blk_ = blockIdx.y * gridDim.x + blockIdx.x; \
  if (blk_ < 4096) { _Pragma("unroll") for (int p_ = 0; p_ < 3; ++p_) \
    g_bwd[blk_][p_] = cb_[p_]; } }
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
// a DFT loop's products alone, as a ceiling: the same warps, MT m16 and NT
// n8 tiles a warp and three passes a k8 step, on registers only; each
// step's sums added apart (APART, the kernels') or every pass into the
// running sums, with or without the B operand's tf32 splits (SPLIT, 2 NT a
// lane a step). The forward's DFT: MT = 4, NT = 8; the frame pass's
// transposed one: MT = 2, NT = 7
template <int MT, int NT, int APART, int SPLIT>
__global__ void __launch_bounds__(256, 1) mma_ceiling_kernel(float* out,
    unsigned long long* cycles, int steps) {
  const long long c0 = clock64();
  uint32_t a[4], bh[NT][2], bl[NT][2];
  float braw[NT][2];
  for (int i = 0; i < 4; ++i) a[i] = rg::tf32(threadIdx.x * 0.37f + i);
  for (int nt = 0; nt < NT; ++nt) {
    braw[nt][0] = nt * 0.11f - threadIdx.x, braw[nt][1] = nt + 0.5f;
    for (int h = 0; h < 2; ++h) rg::split_tf32(braw[nt][h], bh[nt][h], bl[nt][h]);
  }
  float acc[MT][NT][4] = {};
  for (int s = 0; s < steps; ++s) {
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      uint32_t am[4];  // an A operand of its own each m16 tile
      for (int i = 0; i < 4; ++i) am[i] = a[i] + mt * 0x2000u;
      if (APART) {
        float d[NT][4] = {};
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) rg::mma1688(d[nt], am, bh[nt][0], bh[nt][1]);
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) rg::mma1688(d[nt], am, bl[nt][0], bl[nt][1]);
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) rg::mma1688(d[nt], am, bh[nt][0], bh[nt][1]);
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
          for (int e = 0; e < 4; ++e) acc[mt][nt][e] += d[nt][e];
      } else {
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) rg::mma1688(acc[mt][nt], am, bh[nt][0], bh[nt][1]);
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) rg::mma1688(acc[mt][nt], am, bl[nt][0], bl[nt][1]);
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) rg::mma1688(acc[mt][nt], am, bh[nt][0], bh[nt][1]);
      }
    }
    if (SPLIT) {
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        braw[nt][0] += 1.f, braw[nt][1] -= 1.f;
        for (int h = 0; h < 2; ++h) rg::split_tf32(braw[nt][h], bh[nt][h], bl[nt][h]);
      }
    }
    a[0] ^= s;  // a new A operand each step
  }
  float sum = 0.f;
  for (int mt = 0; mt < MT; ++mt)
    for (int nt = 0; nt < NT; ++nt)
      for (int e = 0; e < 4; ++e) sum += acc[mt][nt][e];
  out[blockIdx.x * blockDim.x + threadIdx.x] = sum;
  __syncthreads();
  if (threadIdx.x == 0) cycles[blockIdx.x] = clock64() - c0;
}
extern "C" int fb_mma_ceiling(float* out, unsigned long long* cycles, int blocks,
                              int steps, int variant, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  if (variant == 0)
    mma_ceiling_kernel<4, 8, 1, 0><<<blocks, 256, 0, s>>>(out, cycles, steps);
  else if (variant == 1)
    mma_ceiling_kernel<4, 8, 1, 1><<<blocks, 256, 0, s>>>(out, cycles, steps);
  else if (variant == 2)
    mma_ceiling_kernel<4, 8, 0, 0><<<blocks, 256, 0, s>>>(out, cycles, steps);
  else
    mma_ceiling_kernel<2, 7, 1, 1><<<blocks, 256, 0, s>>>(out, cycles, steps);
  return (int)cudaGetLastError();
}
extern "C" int fb_cycles(unsigned long long* out, unsigned long long* cmvn,
                         unsigned long long* bwd) {
  cudaError_t err = cudaMemcpyFromSymbol(out, g_cycles, sizeof(g_cycles));
  if (err != cudaSuccess) return (int)err;
  if ((err = cudaMemcpyFromSymbol(bwd, g_bwd, sizeof(g_bwd))) != cudaSuccess) return (int)err;
  return (int)cudaMemcpyFromSymbol(cmvn, g_cmvn, sizeof(g_cmvn));
}
extern "C" int fb_cycles_reset() {
  static unsigned long long zero[4096][4];
  cudaError_t err = cudaMemcpyToSymbol(g_cycles, zero, sizeof(g_cycles));
  if (err != cudaSuccess) return (int)err;
  if ((err = cudaMemcpyToSymbol(g_bwd, zero, sizeof(g_bwd))) != cudaSuccess) return (int)err;
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
    for name in ("fbank_fwd", "fbank_bwd"):
        getattr(dll, name).argtypes = SIGNATURES[name]
        getattr(dll, name).restype = ctypes.c_int
    dll.fb_cycles.argtypes = [ctypes.c_void_p] * 3
    dll.fb_cycles.restype = ctypes.c_int
    dll.fb_cycles_reset.restype = ctypes.c_int
    dll.fb_mma_ceiling.argtypes = [ctypes.c_void_p] * 2 + [
        ctypes.c_int] * 3 + [ctypes.c_void_p]
    dll.fb_mma_ceiling.restype = ctypes.c_int
    return dll


def mma_ceiling(dll, steps: int = 400) -> None:
    """The DFT loops' products alone, on registers (one 8-warp block an SM,
    3 passes a k8 step). The forward's 4 x 8 tiles a warp: each step's
    sums added apart as the kernel adds them, the same with the B
    operand's tf32 splits, and every pass into the running sums; the
    frame pass's 2 x 7 tiles a warp, apart and split, as it runs. The
    ceilings of these mma.sync patterns, in SM cycles a k8 step (beside
    the DFT phases' cycles a k8 step) and in TFLOP/s of tf32 products."""
    dev = torch.device("cuda")
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    out = torch.empty(n_sm * 256, device=dev)
    cycles = torch.zeros(n_sm, dtype=torch.int64, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    for variant, (how, tiles) in enumerate((
            ("each k8 step added apart", 4 * 8),
            ("added apart, with the B splits", 4 * 8),
            ("passes into the running sums", 4 * 8),
            ("the frame pass's 2 x 7 tiles, apart, with the B splits",
             2 * 7))):
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
        # a warp's k8 step: its m16 x n8 tiles x 3 passes of 16 x 8 x 8
        flops = n_sm * 8 * steps * tiles * 3 * 2 * 16 * 8 * 8
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
    bwd = (ctypes.c_ulonglong * (MAX_BLOCKS * 3))()
    if dll.fb_cycles(cycles, cmvn, bwd):
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


def _train_batch(dev):
    """Phase 3's row 9 inputs: the train step's shape, noisy synthetic
    utterances (seed 3), their frame counts and a random cotangent."""
    cfg = FrontendConfig()
    name, b, synth = SHAPES[1]
    data = make_batch(b, synth, np.random.default_rng(3))
    wav = torch.from_numpy(data["noisy_wav"]).to(dev).contiguous()
    lens = torch.from_numpy(data["wav_lengths"]).to(dev)
    n_valid = ff.valid_frames(wav, cfg, lens).contiguous()
    t = num_frames(wav.shape[1], cfg)
    gen = torch.Generator(device=dev).manual_seed(3)
    g = torch.randn((b, t, cfg.n_mels), generator=gen, device=dev)
    return cfg, name, wav, n_valid, g


def bwd_split(reps: int = 20) -> None:
    """The backward's four launches at the train step's shape, by the
    profiler's device time per call, with the frame pass on each route
    (the library build, no marks)."""
    from torch.profiler import DeviceType, ProfilerActivity, profile

    dev = torch.device("cuda")
    cfg, name, wav, n_valid, g = _train_batch(dev)
    for route in ("tc", "simt"):
        def call():
            with ff._force_fbank_bwd_route(route):
                return ff.fbank_fused_bwd(wav, n_valid, g, cfg)
        call()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                call()
            torch.cuda.synchronize()
        rows = [e for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA]
        split = {k: sum(e.self_device_time_total for e in rows
                        if k in e.key) / 1e3 / reps for k in BWD_KERNELS}
        total = sum(e.self_device_time_total for e in rows) / 1e3 / reps
        print(f"{name} backward, frame pass on {route}: {total:.4f} ms of "
              f"device time a call ({int(n_valid.sum())} valid frames): "
              + ", ".join(f"{k} {v:.4f}" for k, v in split.items() if v)
              + f"; other {total - sum(split.values()):.4f}")


def bwd_float64(wav, n_valid, g, cfg):
    """``fbank_fused_bwd_plain``'s chain in float64 (normalised variance),
    the DFT bases folded and kept in float64: the yardstick of the float32
    versions' accuracy. Returns (dwav, the valid frames' mel)."""
    n = cfg.frame_length
    ang = (-2.0 * np.pi / cfg.n_fft) * np.outer(np.arange(n),
                                               np.arange(cfg.n_freqs))
    t_pre = ff._preprocess_matrix(cfg).T
    m_cos, m_sin = (torch.from_numpy(t_pre @ f(ang)).to(wav.device)
                    for f in (np.cos, np.sin))
    fb = torch.from_numpy(ff.fbank_ref.mel_filterbank(cfg).astype(np.float64)
                          ).to(wav.device)
    frames = ff.fbank_ref.frame_signal(wav.double(), cfg)
    re, im = frames @ m_cos, frames @ m_sin
    mel = (re * re + im * im) @ fb
    t = mel.shape[1]
    valid = ff._mask(n_valid, t)[..., None] > 0
    feats = torch.where(valid, torch.log(torch.clamp_min(mel, cfg.log_floor)),
                        0.0)
    denom = torch.clamp_min(n_valid.double(), 1.0)[:, None, None]
    c = torch.where(valid, feats - feats.sum(dim=1, keepdim=True) / denom,
                    0.0)
    dfeats = ff.cmvn_transpose(c, g.double(), valid, denom, True, 1e-8)
    dmel = torch.where(mel > cfg.log_floor,
                       dfeats / torch.clamp_min(mel, cfg.log_floor), 0.0)
    dpower = dmel @ fb.t()
    dframes = (2.0 * re * dpower) @ m_cos.t() + (2.0 * im * dpower) @ m_sin.t()
    covered = (t - 1) * cfg.frame_shift + n
    dwav = F.fold(dframes.transpose(1, 2), output_size=(1, covered),
                  kernel_size=(1, n), stride=(1, cfg.frame_shift))
    return F.pad(dwav.reshape(wav.shape[0], covered),
                 (0, wav.shape[1] - covered)), mel[valid[..., 0]]


def bwd_accuracy() -> None:
    """Each frame-pass route and the plain version against the plain
    version and against float64, on phase 3's noisy batch and on the same
    utterances' clean speech."""
    def err(v, w):
        return (v.double() - w).abs().max().item() / w.abs().max().item()

    dev = torch.device("cuda")
    cfg, name, wav, n_valid, g = _train_batch(dev)
    data = make_batch(wav.shape[0], SHAPES[1][2], np.random.default_rng(3))
    for kind, x in (("noisy", wav), ("clean", torch.from_numpy(
            data["clean_wav"]).to(dev).contiguous())):
        plain = ff.fbank_fused_bwd_plain(x, n_valid, g, cfg)
        ref, mel = bwd_float64(x, n_valid, g, cfg)
        # mel energies within 1e-3 of the log floor, relative: which side
        # of it they fall on decides dmel (0 or dfeats / mel)
        near = ((mel - cfg.log_floor).abs() < 1e-3 * cfg.log_floor).sum()
        got = {"plain": plain}
        for route in ("tc", "simt"):
            with ff._force_fbank_bwd_route(route):
                got[route] = ff.fbank_fused_bwd(x, n_valid, g, cfg)
        print(f"{name} backward accuracy, {kind} speech ({int(near)} of "
              f"{mel.numel()} valid mel energies within 1e-3 of the log "
              f"floor): max|plain| {plain.abs().max().item():.4g}; "
              "|dwav - plain| / max|plain|: "
              + ", ".join(f"{r} {err(v, plain.double()):.2e}"
                          for r, v in got.items() if r != "plain")
              + "; |dwav - float64| / max|float64|: "
              + ", ".join(f"{r} {err(v, ref):.2e}" for r, v in got.items()))


def run_bwd(dll) -> None:
    """The marked frame pass (route "tc") at the train step's shape: the
    backward's C entry point of the marked build, its marked launch's time
    and each phase's cycles over the blocks that ran the products."""
    dev = torch.device("cuda")
    cfg, name, wav, n_valid, g = _train_batch(dev)
    b, n = wav.shape
    t = num_frames(n, cfg)
    plan = ff._route_plan(wav, cfg)
    bplan = ff._bwd_route_plan(wav, cfg, plan)
    bases, args = ff._logmel_args(wav, cfg, plan)
    transposed = [x.data_ptr() for x in ff.device_bases(cfg, dev)[3:]]
    frame_pass = [x.data_ptr() for x in ff.tc_bwd_bases(cfg, dev)]
    feats, dfeats = torch.empty_like(g), torch.empty_like(g)
    res = torch.empty((b, t, 2 * bplan.nbins), device=dev)
    melr = torch.empty_like(g)
    dframes = torch.empty((b, t, cfg.frame_length), device=dev)
    dwav = torch.empty_like(wav)
    stream = torch.cuda.current_stream(dev).cuda_stream

    def launch():
        rc = dll.fbank_bwd(wav.data_ptr(), n_valid.data_ptr(), *bases,
                           *transposed, *frame_pass, g.data_ptr(),
                           feats.data_ptr(), dfeats.data_ptr(),
                           res.data_ptr(), melr.data_ptr(),
                           dframes.data_ptr(), dwav.data_ptr(), b, n, t,
                           cfg.frame_length, cfg.frame_shift, cfg.n_freqs,
                           cfg.n_mels, *args, bplan.smem, cfg.log_floor, 1,
                           1e-8, stream)
        if rc:
            sys.exit(f"fbank_bwd (tc) failed: cudaError {rc}")

    launch()
    torch.cuda.synchronize()
    want = ff.fbank_fused_bwd_plain(wav, n_valid, g, cfg)
    err = ((dwav - want).abs().max() / want.abs().max()).item()
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
    bwd = (ctypes.c_ulonglong * (MAX_BLOCKS * 3))()
    if dll.fb_cycles(cycles, cmvn, bwd):
        sys.exit("fb_cycles failed")
    blocks = -(-t // ff.DT_TM) * b
    rows = np.frombuffer(bwd, dtype=np.uint64).reshape(MAX_BLOCKS, 3)
    rows = rows[:blocks].astype(np.float64)
    ran = rows[rows.sum(1) > 0]
    total = ran.sum(1).mean()
    steps = 2 * bplan.nbins // 8
    print(f"{name} backward B={b} N={n} T={t} ({int(n_valid.sum())} valid "
          f"frames), frame pass on tc: plan {bplan}; marked launch (all "
          f"four kernels) {start.elapsed_time(end):.4f} ms, |err| / "
          f"max|plain| {err:.2e}; {len(ran)} of {blocks} blocks ran the "
          f"products, {total:.0f} cycles each on the mean")
    for p, label in enumerate(BWD_PHASES):
        col = ran[:, p]
        print(f"  {p} {label}: mean {col.mean():.0f} "
              f"({col.mean() / total:.1%}), largest {col.max():.0f}"
              + (f"; {col.mean() / steps:.0f} a k8 step" if p == 1 else ""))


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
    bwd_split()
    run_bwd(dll)
    bwd_accuracy()


if __name__ == "__main__":
    main()
