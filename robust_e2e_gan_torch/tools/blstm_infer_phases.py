"""Cycles per frame and per chunk in each phase of the cluster BLSTM kernel.

    python -m robust_e2e_gan_torch.tools.blstm_infer_phases

Needs the card and nvcc. It builds ``csrc/blstm_infer_cluster.cu`` three
times with a small harness that runs the kernel on random inputs (x serves
both directions), every row at full length:

1. With its ``PHASE`` marks defined as ``clock64()`` reads after a CTA
   barrier, so a phase's count is its slowest warp's. Thread 0 of every
   block sums the marks in shared memory, and block (0, 0, 0) reports
   them. At the shapes of the flagship's BLSTM layers (PERF.md §6 row 1a
   and its neighbours) and of the reference model's (H=512 over clusters
   of 16 blocks), it prints the device clock's cycles per frame of each
   frame phase and per chunk of each projection phase, beside the
   launch's time by CUDA events. The barriers the marks add are part of
   what they measure, so the marked kernel is slower than the library's.
2. The same with ``PHASE_SPLIT`` set, at the H=512 shapes only: the
   frame's product from W_h's rows in registers and from its rows in
   shared memory, which the library interleaves, run one after the other
   with a mark between them.
3. Without marks (the library's kernel), the times by CUDA events of R=32
   against R=16 row groups, taken in turns (A, B, B, A): at the flagship's
   enhancer layer 0 (B=128: 8 clusters of 32 rows, one wave, against 16 of
   16 rows, one more than an H100 runs at once) and at the reference
   model's decode layers (B=64: 4 clusters of 16 blocks and 32 rows
   against 8 of 16 rows, one more than the 7 it runs at once).
"""

from __future__ import annotations

import os
import subprocess
import sys

from robust_e2e_gan_torch.utils.build import BUILD_DIR, CSRC, _nvcc

SOURCE = os.path.join(CSRC, "blstm_infer_cluster.cu")

# PHASE(n) closes phase n: 0 the set-up; per chunk (summed over its
# slices) 1-3 and 8; per frame (summed over its m-tiles) 4-7 and, in the
# split build, 9
CHUNK_PHASES = [(1, "wait for copies"), (2, "projection"),
                (3, "start copies (x/W_x staging)"), (8, "gx epilogue")]
FRAME_PHASES = [(7, "wait for the peers' h"), (4, "product"),
                (5, "cell update"), (6, "DSMEM push + output")]
SPLIT_PHASES = [(7, "wait for the peers' h"),
                (4, "product, W_h rows 0-255 in registers"),
                (9, "product, W_h rows 256-511 in shared memory"),
                (5, "cell update"), (6, "DSMEM push + output")]

MARKS = r'''
__device__ unsigned long long g_cycles[16];
#define PHASE_BEGIN __shared__ unsigned long long cyc_[16]; long long t0_ = 0; \
  if (threadIdx.x == 0) { for (int i = 0; i < 16; ++i) cyc_[i] = 0; t0_ = clock64(); }
#define PHASE(n) __syncthreads(); if (threadIdx.x == 0) { \
  const long long t1_ = clock64(); cyc_[n] += t1_ - t0_; t0_ = t1_; }
#define PHASE_END if (threadIdx.x == 0 && blockIdx.x == 0 && blockIdx.y == 0 && \
  blockIdx.z == 0) for (int i = 0; i < 16; ++i) g_cycles[i] = cyc_[i];
'''

HARNESS = r'''
#include "blstm_infer_cluster.cu"
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
struct Layer {
  __nv_bfloat16 *x, *wx, *wh, *out;
  float* bias;
  int* len;
  int B, T, DW, H, C;
  Layer(int B_, int T_, int DW_, int H_, int C_) : B(B_), T(T_), DW(DW_), H(H_), C(C_) {
    const size_t G = 4 * (size_t)H;
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
  }
  ~Layer() { cudaFree(x); cudaFree(wx); cudaFree(wh); cudaFree(bias); cudaFree(out); cudaFree(len); }
  int launch(int R, int resident) {
    return blstm_infer_cluster(x, x, wx, wh, bias, len, out, B, T, DW, H, C, R, resident, 0);
  }
};
#if MARKED
void run(const char* tag, int B, int T, int DW, int H, int C, int R, int resident) {
  Layer L(B, T, DW, H, C);
  cudaEvent_t a, b;
  cudaEventCreate(&a);
  cudaEventCreate(&b);
  const int F = (H > 256 ? 64 : 128) / R, chunks = (T + F - 1) / F;
  for (int rep = 0; rep < 3; ++rep) {
    unsigned long long cyc[16];
    cudaEventRecord(a);
    const int e1 = L.launch(R, resident);
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
}
#else
// mean ms of `reps` launches after one, by CUDA events
float time_ms(Layer& L, int R, int resident, int reps) {
  cudaEvent_t a, b;
  cudaEventCreate(&a);
  cudaEventCreate(&b);
  if (L.launch(R, resident)) return -1.f;
  cudaEventRecord(a);
  for (int i = 0; i < reps; ++i) L.launch(R, resident);
  cudaEventRecord(b);
  cudaEventSynchronize(b);
  float ms;
  cudaEventElapsedTime(&ms, a, b);
  if (cudaDeviceSynchronize() != cudaSuccess) return -1.f;
  return ms / reps;
}
void in_turns(const char* tag, int B, int T, int DW, int H, int C, int resident) {
  Layer L(B, T, DW, H, C);
  const float a1 = time_ms(L, 32, resident, 5), b1 = time_ms(L, 16, resident, 5);
  const float b2 = time_ms(L, 16, resident, 5), a2 = time_ms(L, 32, resident, 5);
  printf("%s: ms in turns (library kernel): R=32 %.4f, R=16 %.4f\n", tag, (a1 + a2) / 2,
         (b1 + b2) / 2);
}
#endif
int main() {
  int khz;
  cudaDeviceGetAttribute(&khz, cudaDevAttrClockRate, 0);
  printf("SM clock %d kHz; build: %s\n", khz, BUILD_NAME);
#if MARKED && !PHASE_SPLIT
  run("row 1a shape (enhancer layer 0: bf16 B=128 T=694 D=257 H=256, C=8 R=32, W_x resident)",
      128, 694, 272, 256, 8, 32, 1);
  run("row 1a shape with R=16: 16 clusters, one more than an H100 runs at once",
      128, 694, 272, 256, 8, 16, 1);
  run("enhancer layer 1 (B=128 T=694 D=512, R=32, W_x streamed)", 128, 694, 512, 256, 8, 32, 0);
  run("encoder layer 0 (B=128 T=174 D=2560, R=32, W_x streamed)", 128, 174, 2560, 256, 8, 32, 0);
  run("D-step enhancer layer 0 (B=32 T=286 D=257, W_x resident)", 32, 286, 272, 256, 8, 16, 1);
#endif
#if MARKED
  run("reference encoder layer 0 (bf16 B=64 T=70 D=2560 H=512, C=16 R=32)",
      64, 70, 2560, 512, 16, 32, 0);
  run("reference encoder layer 0 with R=16: 8 clusters, one more than an H100 runs at once",
      64, 70, 2560, 512, 16, 16, 0);
  run("reference encoder layer 1 (B=64 T=70 D=512, R=32)", 64, 70, 512, 512, 16, 32, 0);
  run("reference enhancer layer 0 (B=64 T=279 D=257, R=32)", 64, 279, 272, 512, 16, 32, 0);
  run("reference D-step enhancer layer 0 (B=32 T=279 D=257, R=16)", 32, 279, 272, 512, 16, 16, 0);
#else
  in_turns("flagship enhancer layer 0 (B=128 T=694 D=257 H=256, C=8, W_x resident)", 128, 694,
           272, 256, 8, 1);
  in_turns("reference enhancer layer 0 (B=64 T=279 D=257 H=512, C=16)", 64, 279, 272, 512, 16, 0);
  in_turns("reference enhancer layer 1 (B=64 T=279 D=1024)", 64, 279, 1024, 512, 16, 0);
  in_turns("reference encoder layer 0 (B=64 T=70 D=2560)", 64, 70, 2560, 512, 16, 0);
  in_turns("reference encoder layer 1 (B=64 T=70 D=512)", 64, 70, 512, 512, 16, 0);
#endif
  return 0;
}
'''

# (name, macros, marks, frame phases)
BUILDS = [("marked", ["-DMARKED=1"], True, FRAME_PHASES),
          ("split", ["-DMARKED=1", "-DPHASE_SPLIT=1"], True, SPLIT_PHASES),
          ("times", ["-DMARKED=0"], False, None)]


def instrumented(marks: bool, frame_phases) -> str:
    """The marks' definitions (where ``marks``), the kernel source and the
    harness."""
    if not marks:
        return HARNESS
    names = "".join(
        f"static const char* {tag}[] = {{"
        + ", ".join(f'"{n}"' for _, n in phases)
        + f"}};\nstatic const int {tag}_AT[] = {{"
        + ", ".join(str(i) for i, _ in phases) + "};\n"
        for tag, phases in (("CHUNK", CHUNK_PHASES), ("FRAME", frame_phases)))
    harness = HARNESS.replace("%NC%", str(len(CHUNK_PHASES))).replace(
        "%NF%", str(len(frame_phases)))
    i = harness.index("#include <cstdio>")
    return MARKS + harness[:i] + names + harness[i:]


def main() -> int:
    work = os.path.join(BUILD_DIR, "infer_phases")
    os.makedirs(work, exist_ok=True)
    exes = []
    for name, macros, marks, frame_phases in BUILDS:
        cu = os.path.join(work, f"phases_{name}.cu")
        exe = os.path.join(work, f"phases_{name}")
        with open(cu, "w") as f:
            f.write(instrumented(marks, frame_phases))
        cmd = [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
               "-std=c++17", "-O3", "-I", CSRC, *macros,
               f'-DBUILD_NAME="{name}"', "-o", exe, cu]
        exes.append(subprocess.Popen(cmd))
    if any(p.wait() for p in exes):
        return 1
    rc = 0
    for name, *_ in BUILDS:
        rc |= subprocess.run([os.path.join(work, f"phases_{name}")],
                             timeout=300).returncode
    return rc


if __name__ == "__main__":
    sys.exit(main())
