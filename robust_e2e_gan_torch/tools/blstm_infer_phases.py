"""Cycles per frame and per chunk in each phase of the cluster BLSTM kernel.

    python -m robust_e2e_gan_torch.tools.blstm_infer_phases

Needs the card and nvcc. It builds ``csrc/blstm_infer_cluster.cu`` with its
``PHASE`` marks defined as ``clock64()`` reads after a CTA barrier, so a
phase's count is its slowest warp's. Thread 0 of every block sums the marks
in shared memory, and block (0, 0, 0) reports them. A small harness runs
the kernel on random inputs (x serves both directions), every row at full
length, at the shapes of the
flagship's BLSTM layers (PERF.md §6 row 1a and its neighbours), and prints
the device clock's cycles per frame of each frame phase and per chunk of
each projection phase, beside the launch's time by CUDA events. B=128
takes 32-row groups, as the plan does on an H100 (15 clusters of 8 at
once), and once 16-row ones, whose 16th cluster runs after the first 15;
B=32 16-row ones. The
barriers the marks add are part of what they measure, so the marked
kernel is slower than the library's.
"""

from __future__ import annotations

import os
import subprocess
import sys

from robust_e2e_gan_torch.utils.build import BUILD_DIR, CSRC, _nvcc

SOURCE = os.path.join(CSRC, "blstm_infer_cluster.cu")

# PHASE(n) closes phase n: 0 the set-up; per chunk (summed over its
# slices) 1-3 and 8; per frame (summed over its m-tiles) 4-7
CHUNK_PHASES = [(1, "wait for copies"), (2, "projection"),
                (3, "start copies (x/W_x staging)"), (8, "gx epilogue")]
FRAME_PHASES = [(7, "wait for the peers' h"), (4, "product"),
                (5, "cell update"), (6, "DSMEM push + output")]

PRELUDE = r'''
__device__ unsigned long long g_cycles[16];
#define PHASE_BEGIN __shared__ unsigned long long cyc_[16]; long long t0_ = 0; \
  if (threadIdx.x == 0) { for (int i = 0; i < 16; ++i) cyc_[i] = 0; t0_ = clock64(); }
#define PHASE(n) __syncthreads(); if (threadIdx.x == 0) { \
  const long long t1_ = clock64(); cyc_[n] += t1_ - t0_; t0_ = t1_; }
#define PHASE_END if (threadIdx.x == 0 && blockIdx.x == 0 && blockIdx.y == 0 && \
  blockIdx.z == 0) for (int i = 0; i < 16; ++i) g_cycles[i] = cyc_[i];
#include "blstm_infer_cluster.cu"
'''

HARNESS = r'''
#include <cstdio>
#include <vector>
template <typename W> void fill(W* d, size_t n, float scale, unsigned seed) {
  std::vector<W> h(n);
  for (size_t i = 0; i < n; ++i) {
    seed = seed * 1664525u + 1013904223u;
    h[i] = (W)(((seed >> 8) / 16777216.f - 0.5f) * scale);
  }
  cudaMemcpy(d, h.data(), n * sizeof(W), cudaMemcpyHostToDevice);
}
void run(const char* tag, int B, int T, int DW, int H, int C, int R, int resident) {
  const size_t G = 4 * (size_t)H;
  __nv_bfloat16 *x, *wx, *wh, *out;
  float* bias;
  int* len;
  cudaMalloc(&x, (size_t)B * T * DW * 2);
  cudaMalloc(&wx, 2 * G * DW * 2);
  cudaMalloc(&wh, 2 * G * H * 2);
  cudaMalloc(&bias, 2 * G * 4);
  cudaMalloc(&out, (size_t)B * T * 2 * H * 2);
  cudaMalloc(&len, B * 4);
  std::vector<int> lens(B, T);
  cudaMemcpy(len, lens.data(), B * 4, cudaMemcpyHostToDevice);
  fill(x, (size_t)B * T * DW, 2.f, 1);
  fill(wx, 2 * G * DW, 0.1f, 2);
  fill(wh, 2 * G * H, 0.1f, 3);
  fill(bias, 2 * G, 0.5f, 4);
  cudaEvent_t a, b;
  cudaEventCreate(&a);
  cudaEventCreate(&b);
  const int F = 128 / R, chunks = (T + F - 1) / F;
  for (int rep = 0; rep < 3; ++rep) {
    unsigned long long cyc[16];
    cudaEventRecord(a);
    const int e1 = blstm_infer_cluster(x, x, wx, wh, bias, len, out, B, T, DW, H, C, R,
                                       resident, 0);
    cudaEventRecord(b);
    cudaEventSynchronize(b);
    float ms;
    cudaEventElapsedTime(&ms, a, b);
    cudaMemcpyFromSymbol(cyc, g_cycles, sizeof(cyc));
    const int e2 = (int)cudaDeviceSynchronize();
    if (e1 || e2) { printf("%s: CUDA error %d %d\n", tag, e1, e2); return; }
    if (rep == 0) continue;  // warm-up
    printf("%s run %d: %.4f ms (CUDA events, marked kernel); set-up %llu cycles\n", tag,
           rep, ms, cyc[0]);
    printf("  per chunk of %d frames (%d chunks):", F, chunks);
    for (int i = 0; i < %NC%; ++i)
      printf(" %s %.0f;", CHUNK[i], cyc[CHUNK_AT[i]] / (double)chunks);
    printf("\n  per frame (%d frames):", T);
    for (int i = 0; i < %NF%; ++i) printf(" %s %.0f;", FRAME[i], cyc[FRAME_AT[i]] / (double)T);
    printf("\n");
  }
  cudaFree(x); cudaFree(wx); cudaFree(wh); cudaFree(bias); cudaFree(out); cudaFree(len);
}
int main() {
  int khz;
  cudaDeviceGetAttribute(&khz, cudaDevAttrClockRate, 0);
  printf("SM clock %d kHz\n", khz);
  run("row 1a shape (enhancer layer 0: bf16 B=128 T=694 D=257 H=256, C=8 R=32, W_x resident)",
      128, 694, 272, 256, 8, 32, 1);
  run("row 1a shape with R=16: 16 clusters, one more than an H100 runs at once",
      128, 694, 272, 256, 8, 16, 1);
  run("enhancer layer 1 (B=128 T=694 D=512, R=32, W_x streamed)", 128, 694, 512, 256, 8, 32, 0);
  run("encoder layer 0 (B=128 T=174 D=2560, R=32, W_x streamed)", 128, 174, 2560, 256, 8, 32, 0);
  run("D-step enhancer layer 0 (B=32 T=286 D=257, W_x resident)", 32, 286, 272, 256, 8, 16, 1);
  return 0;
}
'''


def instrumented() -> str:
    """The marks' definitions, the kernel source and the harness."""
    names = "".join(
        f"static const char* {tag}[] = {{"
        + ", ".join(f'"{n}"' for _, n in phases)
        + f"}};\nstatic const int {tag}_AT[] = {{"
        + ", ".join(str(i) for i, _ in phases) + "};\n"
        for tag, phases in (("CHUNK", CHUNK_PHASES), ("FRAME", FRAME_PHASES)))
    harness = HARNESS.replace("%NC%", str(len(CHUNK_PHASES))).replace(
        "%NF%", str(len(FRAME_PHASES)))
    return PRELUDE + names + harness


def main() -> int:
    work = os.path.join(BUILD_DIR, "infer_phases")
    os.makedirs(work, exist_ok=True)
    cu = os.path.join(work, "phases.cu")
    exe = os.path.join(work, "phases")
    with open(cu, "w") as f:
        f.write(instrumented())
    cmd = [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
           "-I", CSRC, "-o", exe, cu]
    subprocess.run(cmd, check=True)
    return subprocess.run([exe], timeout=300).returncode


if __name__ == "__main__":
    sys.exit(main())
