"""Cycles per frame step in each phase of the resident training BLSTM loops.

    python -m robust_e2e_gan_torch.tools.blstm_train_phases

Needs the card and nvcc. It copies ``csrc/blstm_train_resident.cu`` with a
``clock64()`` mark at each phase boundary of both kernels. Thread 0 of every
block sums the marks in shared memory, and block (0, 0) reports them, so a
mark costs a few cycles. It builds the copy with a small harness, runs both
kernels at two shapes, and prints the device clock's cycles per step of
each phase. The shapes are rows 6 and 7 of PERF.md §6: bf16 B=32 T=286 H=256
and f32 B=16 T=72 H=512, random inputs, every row at full length. A mark
sits after a CTA barrier (some added for the marks), so a phase's count is
its slowest warp's. The copy is patched at exact lines of the source
(``PATCHES``); when the source changes, fix them here.
"""

from __future__ import annotations

import os
import subprocess
import sys

from robust_e2e_gan_torch.utils.build import BUILD_DIR, CSRC, _nvcc

SOURCE = os.path.join(CSRC, "blstm_train_resident.cu")

# (text of the source, the same text with marks): MARK(n) closes phase n
# of the forward (0-5) or the backward (10-17); 30 and 31 end the set-up
PATCHES = [
    ('#include "common.cuh"\n', '#include "common.cuh"\n%PRELUDE%'),
    # forward
    ("  for (int s = 0; s < steps; ++s) {\n",
     "  for (int s = 0; s < steps; ++s) {\n    if (s == 0) { MARK(30) }\n"),
    ("u0);\n      cp_async_commit();\n    }\n    if (s > 0) grid_wait(count + z * LINE,"
     " (unsigned)s * P);\n",
     "u0);\n      cp_async_commit();\n    }\n    __syncthreads(); MARK(0)\n"
     "    if (s > 0) grid_wait(count + z * LINE, (unsigned)s * P);\n    MARK(1)\n"),
    ("      cp_async_wait<0>();\n    __syncthreads();\n    gate_product(sm.h, sm.w, gate,"
     " B, H, C);\n    __syncthreads();\n",
     "      cp_async_wait<0>();\n    __syncthreads(); MARK(2)\n    gate_product(sm.h, sm.w,"
     " gate, B, H, C);\n    __syncthreads(); MARK(3)\n"),
    ("      c_ext[row] = cn;\n    }\n    grid_arrive(count + z * LINE);\n  }\n",
     "      c_ext[row] = cn;\n    }\n    __syncthreads(); MARK(4)\n"
     "    grid_arrive(count + z * LINE);\n    MARK(5)\n  }\n  MARKS_END\n"),
    # backward
    ("  for (int s = steps - 1; s >= 0; --s) {\n",
     "  for (int s = steps - 1; s >= 0; --s) {\n    if (s == steps - 1) { MARK(31) }\n"),
    ("    if (s > 0)\n      cp_async_wait<1>();  // this step's copies",
     "    __syncthreads(); MARK(10)\n    if (s > 0)\n      cp_async_wait<1>();  // this"
     " step's copies"),
    ("      cp_async_wait<0>();\n    __syncthreads();\n    gate_product(sm.hb + (s & 1) * B"
     " * H, sm.w, gate, B, H, C);\n",
     "      cp_async_wait<0>();\n    __syncthreads(); MARK(11)\n    gate_product(sm.hb + (s"
     " & 1) * B * H, sm.w, gate, B, H, C);\n    __syncthreads(); MARK(12)\n"),
    ("      grid_wait(count + z * LINE, (unsigned)(steps - 1 - s) * P);\n",
     "      grid_wait(count + z * LINE, (unsigned)(steps - 1 - s) * P);\n      MARK(13)\n"),
    ("u0);\n    }\n    __syncthreads();\n", "u0);\n    }\n    __syncthreads(); MARK(14)\n"),
    ("      *dc = gf * dc_new;  // dc carried to the step before\n    }\n"
     "    __syncthreads();\n",
     "      *dc = gf * dc_new;  // dc carried to the step before\n    }\n"
     "    __syncthreads(); MARK(15)\n"),
    ("               C);\n    grid_arrive(count + z * LINE);\n  }\n",
     "               C);\n    __syncthreads(); MARK(16)\n    grid_arrive(count + z * LINE);"
     "\n    MARK(17)\n  }\n  MARKS_END\n"),
]
FWD_NAMES = ["issue gx copies", "wait", "stage_h", "gate_product", "cell update",
             "arrive"]
BWD_NAMES = ["issue copies (+ bf16 dy)", "wait for copies", "gate_product", "wait",
             "dh_sums", "adjoint", "dh_product", "arrive"]

PRELUDE = r'''
__device__ unsigned long long g_cycles[32];
#define MARK(n) if (threadIdx.x == 0) { const long long t1_ = clock64(); \
  cyc_[n] += t1_ - t0_; t0_ = t1_; }
#define MARKS_BEGIN __shared__ unsigned long long cyc_[32]; long long t0_ = 0; \
  if (threadIdx.x == 0) { for (int i = 0; i < 32; ++i) cyc_[i] = 0; t0_ = clock64(); }
#define MARKS_END if (threadIdx.x == 0 && blockIdx.x == 0 && blockIdx.y == 0) \
  for (int i = 0; i < 32; ++i) g_cycles[i] = cyc_[i];
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
template <typename W> void run(const char* tag, int B, int T, int H, int NU, int bf16) {
  const size_t G = 4 * (size_t)H;
  const int P = (H + NU - 1) / NU;
  float *gx, *c_ext, *dgates, *part;
  W *wh, *out, *y_ext, *dy;
  int* len;
  unsigned* count;
  cudaMalloc(&gx, (size_t)B * T * 2 * G * 4);
  cudaMalloc(&wh, 2 * H * G * sizeof(W));
  cudaMalloc(&out, (size_t)B * T * 2 * H * sizeof(W));
  cudaMalloc(&y_ext, (size_t)2 * B * (T + 1) * H * sizeof(W));
  cudaMalloc(&c_ext, (size_t)2 * B * (T + 1) * H * 4);
  cudaMalloc(&dy, (size_t)B * T * 2 * H * sizeof(W));
  cudaMalloc(&dgates, (size_t)B * T * 2 * G * 4);
  cudaMalloc(&part, (size_t)4 * P * B * H * 4);
  cudaMalloc(&len, B * 4);
  cudaMalloc(&count, 64 * 4);
  std::vector<int> lens(B, T);
  cudaMemcpy(len, lens.data(), B * 4, cudaMemcpyHostToDevice);
  fill(gx, (size_t)B * T * 2 * G, 2.f, 1);
  fill(wh, 2 * H * G, 0.1f, 2);
  fill(dy, (size_t)B * T * 2 * H, 1.f, 3);
  cudaEvent_t a, b;
  cudaEventCreate(&a);
  cudaEventCreate(&b);
  for (int rep = 0; rep < 3; ++rep) {
    unsigned long long f[32], k[32];
    cudaMemset(count, 0, 256);
    cudaEventRecord(a);
    const int e1 = blstm_train_resident_fwd(gx, wh, len, out, y_ext, c_ext, count, B, T, H,
                                            NU, bf16, 0);
    cudaEventRecord(b);
    cudaEventSynchronize(b);
    float fms, bms;
    cudaEventElapsedTime(&fms, a, b);
    cudaMemcpyFromSymbol(f, g_cycles, sizeof(f));
    cudaMemset(count, 0, 256);
    cudaEventRecord(a);
    const int e2 = blstm_train_resident_bwd(gx, wh, len, y_ext, c_ext, dy, dgates, part,
                                            count, B, T, H, NU, bf16, 0);
    cudaEventRecord(b);
    cudaEventSynchronize(b);
    cudaEventElapsedTime(&bms, a, b);
    cudaMemcpyFromSymbol(k, g_cycles, sizeof(k));
    const int e3 = (int)cudaDeviceSynchronize();
    if (e1 || e2 || e3) { printf("%s: CUDA error %d %d %d\n", tag, e1, e2, e3); return; }
    if (rep == 0) continue;  // warm-up
    printf("%s run %d: forward %.4f ms, backward %.4f ms (CUDA events)\n", tag, rep, fms,
           bms);
    printf("  forward cycles/step:");
    for (int i = 0; i < %NF%; ++i) printf(" %s %.0f;", FWD[i], f[i] / (double)T);
    printf("\n  backward cycles/step:");
    for (int i = 0; i < %NB%; ++i) printf(" %s %.0f;", BWD[i], k[10 + i] / (double)T);
    printf("\n");
  }
}
int main() {
  int khz;
  cudaDeviceGetAttribute(&khz, cudaDevAttrClockRate, 0);
  printf("SM clock %d kHz\n", khz);
  run<__nv_bfloat16>("row 6 shape (bf16 B=32 T=286 H=256, n_u=4)", 32, 286, 256, 4, 1);
  run<float>("row 7 shape (f32 B=16 T=72 H=512, n_u=8)", 16, 72, 512, 8, 0);
  return 0;
}
'''


def instrumented() -> str:
    """The kernel source with the marks and the harness appended."""
    with open(SOURCE) as f:
        src = f.read()
    for old, new in PATCHES:
        if src.count(old) != 1:
            raise SystemExit(f"not found once in {SOURCE}, fix PATCHES:\n{old}")
        src = src.replace(old, new.replace("%PRELUDE%", PRELUDE))
    begin = "  const Smem<W> sm = carve<W>(smem_raw, B, H, NU);\n"
    if src.count(begin) != 2:
        raise SystemExit(f"not found twice in {SOURCE}, fix the tool:\n{begin}")
    src = src.replace(begin, "  MARKS_BEGIN\n" + begin)
    names = ("static const char* FWD[] = {" + ", ".join(f'"{n}"' for n in FWD_NAMES)
             + "};\nstatic const char* BWD[] = {"
             + ", ".join(f'"{n}"' for n in BWD_NAMES) + "};\n")
    harness = HARNESS.replace("%NF%", str(len(FWD_NAMES))).replace(
        "%NB%", str(len(BWD_NAMES)))
    return src + names + harness


def main() -> int:
    work = os.path.join(BUILD_DIR, "phases")
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
