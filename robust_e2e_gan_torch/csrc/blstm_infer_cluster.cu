// Masked bidirectional LSTM forward for inference, from the raw input, with
// W_h split over a thread-block cluster: the "cluster" route of
// ops/blstm.py::blstm_infer.
//
// Replaces robust_e2e_gan_tpu/ops/blstm_pallas.py::blstm_infer in its
// W_x-resident variant (_fused_kernel :90, pallas_call :403) wherever
// ops/blstm.py::cluster_plan fits (bfloat16, H a multiple of 16 with at
// most 32 hidden units a block); csrc/blstm_infer.cu, the "row-tiled"
// route, takes the other layers. The contract is that kernel's: x
// (B, T, D) rounded to bfloat16, x W_x + b accumulated in float32, h
// rounded to bfloat16 for the recurrent product, the gates in float32,
// out (B, T, 2H) bfloat16 with exact zeros on pad frames.
//
// What bounds it on Hopper: the chain of T dependent frames. The JAX
// kernel keeps W_x and W_h in VMEM for the whole sequence; the row-tiled
// route cannot (W_h is 512 KB a direction at H = 256), so each of its
// blocks re-reads all of W_h from L2 in every frame. Here W_h never
// leaves the SMs: a cluster of C blocks shares it.
//
// Design. The grid is (C, ceil(B / R), 2 directions), one cluster of C
// blocks per (row group, direction). Block j of a cluster owns the NU =
// H / C hidden units [j NU, (j+1) NU), i.e. N = 4 NU gate columns, for
// the group's R = 16 MT rows. R is 32 where the clusters of 16-row groups
// would not all run at once (an H100 holds 15 clusters of 8 at one block
// an SM, not the 16 that B = 128 needs). Warp w of the 8 owns units
// 4w .. 4w + 3, i.e. 16 gate columns ordered (i0 f0 i1 f1 i2 f2 i3 f3 |
// g0 o0 g1 o1 g2 o2 g3 o3), which the wrapper packs, so the accumulators
// of an m16n8 tile pair give lane (g, t) all four gates of unit t for rows
// g and g + 8 of each m-tile, and the cell update (c in registers) needs
// no shared-memory round trip. The warp keeps its W_h columns in registers
// as mma B fragments (64 a lane at H = 256) from the first frame to the
// last.
//
// A frame runs m-tile by m-tile: the group's 16-row halves are
// independent recurrences, so one half's h travels to the peers while the
// other half computes. For an m-tile: wait on its mbarrier until the
// peers' rows of h_{t-1} have landed; the product h_{t-1} W_h[:, cols]
// (16 x H times H x 16 a warp) with mma.sync m16n8k16 bfloat16 -> float32,
// A read by ldmatrix one k-step ahead; the cell update (the reciprocals of
// the sigmoids by Newton's iteration on the FMA pipes, the exponentials on
// the special function unit); h_t rounded to bfloat16 into the block's
// slice of the next h buffer. The h buffers are laid out by block (C
// slices of R rows of NU + 8 units; the padding puts a matrix's eight rows
// on distinct banks), so an m-tile's rows of a slice are one contiguous
// run: lane 0 of warp j sends them to block j with one bulk copy from
// shared memory to its shared memory (distributed shared memory), which
// that block's mbarrier counts in (complete_tx). Other threads write the
// rows that are valid at this frame to the output. No frame crosses a
// cluster-wide barrier, and nothing on the serial chain goes through L2 or
// device memory except the output write. The h buffers and their
// mbarriers are double-buffered by frame parity: a peer writes the buffer
// this block read one frame earlier, which it can only do once it has
// this block's h of that frame, sent after the read.
//
// A chunk of F = 8 / MT frames starts with the projection of the group's
// R x F (row, frame) pairs onto the block's N columns (M = 128, N, K = D
// padded to DW, a multiple of 16) on the tensor cores, in slices of 64
// input columns. The copy engine (TMA) brings each slice: one box of the
// group's R rows at the chunk's F frames from x, mapped as (columns, rows,
// frames) so that it lands frame-major (the backward direction reads a
// copy of x reversed per row by the wrapper, so its frames are one box
// too), and W_x's slice of the block's columns where it streams (D = 512,
// 2,560); where the plan fits it (D = 257), all of W_x's columns stay
// resident.
// Boxes land 128-byte swizzled (a row's 16-byte chunk c at c ^ (row % 8)),
// so ldmatrix reads them without bank conflicts. Slices are staged two
// ahead, across chunk ends, so the next chunk's first slices land during
// this chunk's frames. The 8 warps tile the projection 4 x 2 (32 pairs by
// 64 columns) and leave gx + b in shared memory in the lane layout of the
// frames' accumulators. The projection still runs between the frames;
// overlapping it with them would take its time off the chain.
//
// Lengths: a cluster runs to the longest length among its own rows. A row
// past its length keeps computing on whatever its frames hold but writes
// nothing, and every block takes part in every frame. Pad frames are
// written as zeros at the end. A cluster barrier after the set-up (every
// mbarrier is initialised before a peer signals it) and one before exit,
// after the last frame's rows from the peers have landed (no block's
// shared memory is freed while a peer may write it), are the only ones.
//
// Why not more: starting a copy engine (TMA) copy holds the warp about as
// long as the copy takes (some 40 bytes a cycle an SM on an H100), and
// the per-slice block barrier then waits for that warp; a producer warp
// that starts the copies instead costs the computing warps registers (168
// a thread at 9 warps, with spills) and ran no faster, and multicasting
// each x box to the cluster ran slower (PERF.md has the numbers).

#include "common.cuh"

#include <cuda.h>
#include <cudaTypedefs.h>

#include <cstdint>

// clock64() marks for robust_e2e_gan_torch/tools/blstm_infer_phases.py,
// which defines them; empty in the library build.
#ifndef PHASE_BEGIN
#define PHASE_BEGIN
#define PHASE(n)
#define PHASE_END
#endif

namespace {

using bf16 = __nv_bfloat16;
using rg::ldsm_x4;
using rg::mma16816;
using rg::smem_addr;

constexpr int NT = 256;     // threads per block: 8 warps
constexpr int PAIRS = 128;  // (row, frame) pairs of a chunk: R * F
constexpr int DS = 64;      // input columns per projection slice (128 bytes)
constexpr int PAD = 8;      // bf16 elements of padding of an h slice row
constexpr int KMAX = 16;    // k-steps of the recurrent product: H <= 256

// Dynamic shared memory of one block (ops/blstm.py::cluster_smem computes
// the same): two x stages (PAIRS, DS), W_x's columns resident (ceil(DW /
// DS), N, DS) or two staged slices (2, N, DS), all bfloat16 and 1024-byte
// aligned for the swizzle; the chunk's gx (PAIRS, N) float32; two h
// buffers (2, C, R, NU + PAD) bfloat16; R int32 lengths; seven 8-byte
// mbarriers; 1 KB to align the base.
size_t smem_bytes(int H, int C, int R, int DW, bool resident) {
  const size_t N = 4 * (size_t)(H / C), nsl = (DW + DS - 1) / DS;
  const size_t elems = 2 * (size_t)PAIRS * DS + (resident ? nsl : 2) * N * DS +
                       2 * (size_t)C * R * (H / C + PAD);
  return 1024 + elems * sizeof(bf16) + PAIRS * N * sizeof(float) + (size_t)R * sizeof(int) +
         7 * sizeof(uint64_t);
}

__device__ __forceinline__ unsigned cluster_rank() {
  unsigned r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

// The shared::cluster address of the same location in block `rank`.
__device__ __forceinline__ unsigned map_rank(unsigned addr, unsigned rank) {
  unsigned r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(r) : "r"(addr), "r"(rank));
  return r;
}

__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n"
               "barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}

// One arrival on the local mbarrier, which then expects `bytes` more
// bytes of complete_tx in its current phase.
__device__ __forceinline__ void mbar_expect(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

// Wait until the phase of the given parity of the local mbarrier has
// completed; what the copies it counted wrote is then visible.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  const unsigned addr = smem_addr(bar);
  unsigned done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  }
}

// A box of a tensor map into this block's shared memory by the copy
// engine; the local mbarrier `bar` counts its bytes in.
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, int c0, int c1,
                                            uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3}], [%4];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(smem_addr(bar))
      : "memory");
}

__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map, int c0, int c1,
                                            int c2, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(smem_addr(bar))
      : "memory");
}

// `bytes` of this block's shared memory into block `rank`'s at the same
// place by the copy engine; that block's mbarrier at `bar`'s place counts
// them in.
__device__ __forceinline__ void dsmem_copy(const void* src, unsigned bytes, unsigned rank,
                                           const uint64_t* bar) {
  const unsigned s = smem_addr(src);
  asm volatile(
      "cp.async.bulk.shared::cluster.shared::cta.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(map_rank(s, rank)),
      "r"(s), "r"(bytes), "r"(map_rank(smem_addr(bar), rank))
      : "memory");
}

// 1 / d for d >= 1 by Newton's iteration from a bit-level first guess: the
// cell update's reciprocals on the FMA pipes, which leaves the special
// function unit its exponentials.
__device__ __forceinline__ float rcp_newton(float d) {
  d = fminf(d, 1e30f);
  float y = __int_as_float(0x7EF311C3 - __float_as_int(d));
#pragma unroll
  for (int i = 0; i < 3; ++i) y = y * fmaf(-d, y, 2.f);
  return y;
}

__device__ __forceinline__ float sigmoid_fast(float x) { return rcp_newton(1.f + __expf(-x)); }

__device__ __forceinline__ float tanh_fast(float x) {
  return 2.f * sigmoid_fast(2.f * x) - 1.f;
}

// Element offset of (row, column) in a 128-byte-swizzled box of 64-column
// bfloat16 rows: 16-byte chunk c of a row sits at c ^ (row % 8).
__device__ __forceinline__ int swz(int row, int col) {
  return row * DS + ((((col >> 3) ^ row) & 7) << 3) + (col & 7);
}

template <int MT, bool RES, bool FULL>
__global__ void __launch_bounds__(NT, 1)
blstm_infer_cluster_kernel(const __grid_constant__ CUtensorMap x_fwd,  // (B, T, DW)
                           const __grid_constant__ CUtensorMap x_bwd,  // reversed per row
                           const __grid_constant__ CUtensorMap wx_map,  // (2 C N, DW)
                           const bf16* __restrict__ wh,      // (2, C, N, H) packed
                           const float* __restrict__ bias,   // (2, C, N) packed
                           const int* __restrict__ lengths,  // (B,)
                           bf16* __restrict__ out,           // (B, T, 2H)
                           int B, int T, int DW, int H, int NU) {
  constexpr int R = 16 * MT;  // rows of a group
  constexpr int F = 8 / MT;   // frames of a chunk: R * F = PAIRS
  extern __shared__ unsigned char smem_raw[];
  const int N = 4 * NU, SR = NU + PAD, nsl = (DW + DS - 1) / DS;
  bf16* xs = reinterpret_cast<bf16*>((reinterpret_cast<uintptr_t>(smem_raw) + 1023) &
                                     ~uintptr_t(1023));  // (2, PAIRS, DS)
  bf16* wxs = xs + 2 * PAIRS * DS;                       // (nsl or 2, N, DS)
  float* gxs = reinterpret_cast<float*>(wxs + (RES ? nsl : 2) * N * DS);  // (8, NU/4, 32, 8)
  bf16* hb = reinterpret_cast<bf16*>(gxs + PAIRS * N);   // (2, C, R, SR)
  int* len_s = reinterpret_cast<int*>(hb + 2 * gridDim.x * R * SR);  // (R,)
  uint64_t* bar = reinterpret_cast<uint64_t*>(len_s + R);  // (MT, 2) h by m-tile, parity
  uint64_t* full = bar + 2 * MT;                           // (2,) x stages
  uint64_t* wbar = full + 2;                               // resident W_x

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int C = gridDim.x;
  const unsigned rank = cluster_rank();
  const int z = blockIdx.z, row0 = blockIdx.y * R;
  const int wrow = (z * C + rank) * N;  // the block's first row of wx_map
  const CUtensorMap* xmap = z == 0 ? &x_fwd : &x_bwd;
  PHASE_BEGIN
  if (tid == 0) {
    asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(xmap))
                 : "memory");
    asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(&wx_map))
                 : "memory");
  }

  // ---- set-up: the group's lengths, h_{-1} = 0, the mbarriers, W_x's
  // columns where resident
  if (tid < R) {
    const int b = row0 + tid;
    len_s[tid] = b < B ? min(max(lengths[b], 0), T) : 0;
  }
  for (int i = tid; i < C * R * SR; i += NT) hb[i] = __float2bfloat16(0.f);
  if (tid == 0) {
    for (int i = 0; i < 2 * MT; ++i) mbar_init(bar + i, 1);
    mbar_init(full, 1);
    mbar_init(full + 1, 1);
    mbar_init(wbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (RES && tid == 0) {
    mbar_expect(wbar, nsl * N * DS * 2);
    for (int sl = 0; sl < nsl; ++sl) tma_load_2d(wxs + sl * N * DS, &wx_map, sl * DS, wrow, wbar);
  }
  int steps = 0;
#pragma unroll
  for (int r = 0; r < R; ++r) steps = max(steps, len_s[r]);

  // lane (g, t) of warp `warp`: unit 4 warp + t of the block, rows g and
  // g + 8 of each m-tile
  const bool active = warp * 4 < NU;
  const int g = lane >> 2, t4 = lane & 3;
  const int ul = warp * 4 + t4;  // the unit within the block's slice
  // the warp's W_h columns as mma B fragments, in registers for the whole
  // launch: k-step kk, n-tile j: W_h[k = 16 kk + 2 t (+8)][n = 16 warp + 8 j + g]
  const int ksteps = FULL ? KMAX : H / 16;
  uint32_t wb[KMAX][4];
  {
    const bf16* whz = wh + (size_t)wrow * H;
#pragma unroll
    for (int kk = 0; kk < KMAX; ++kk) {
#pragma unroll
      for (int e = 0; e < 4; ++e) wb[kk][e] = 0;
      if (active && (FULL || kk < ksteps)) {
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const bf16* col = whz + (size_t)(warp * 16 + 8 * j + g) * H + kk * 16 + 2 * t4;
          wb[kk][2 * j] = *reinterpret_cast<const uint32_t*>(col);
          wb[kk][2 * j + 1] = *reinterpret_cast<const uint32_t*>(col + 8);
        }
      }
    }
  }

  // ldmatrix: A (16 rows by 16 columns) lane l -> row l % 16, column
  // (l / 16) * 8; B (two 8-column tiles by 16) -> gate column (l / 16) * 8
  // + l % 8 of the tile pair, k (l / 8 % 2) * 8
  const int a_row = lane & 15, a_col = (lane >> 4) * 8;
  const int b_n = (lane >> 4) * 8 + (lane & 7), b_k = ((lane >> 3) & 1) * 8;
  // the projection's warp tile: m-tiles 2 pm, 2 pm + 1 (32 pairs), column
  // groups 4 pn .. 4 pn + 3 (64 gate columns)
  const int pm = warp & 3, pn = warp >> 2;
  // the frame's A: row a_row of m-tile m at k = 16 kk + a_col lies in
  // block k / NU's slice, unit k % NU
  auto h_at = [&](int buf, int m, int kk) -> const bf16* {
    const int k = 16 * kk + a_col;
    const int j = FULL ? kk >> 1 : k / NU, u = FULL ? (kk & 1) * 16 + a_col : k % NU;
    return hb + ((buf * C + j) * R + m * 16 + a_row) * SR + u;
  };
  // the block's slice of h buffer `buf`: R rows of SR, contiguous, an
  // m-tile's 16 rows of it one run of tile_bytes
  auto slice = [&](int buf) { return hb + (buf * C + rank) * R * SR; };
  const unsigned tile_bytes = 16 * SR * 2;

  // every block of the cluster has started and set up its mbarriers
  // before any peer signals them
  cluster_sync();
  PHASE(0)

  float c[MT][2];
#pragma unroll
  for (int m = 0; m < MT; ++m) c[m][0] = c[m][1] = 0.f;
  const int nslices = (steps + F - 1) / F * nsl;
  // stage global slice gs (chunk gs / nsl, input columns of slice gs %
  // nsl) into buffer gs % 2: one box of the group's R rows at the chunk's
  // F frames (the map walks rows inside frames, so pair p = f R + r; rows
  // past B or T arrive as zeros), started by lane 0 of warp 0, which arms
  // the mbarrier, and, where streamed, W_x's box of the block's columns,
  // started by lane 0 of warp 1: a warp waits on one copy
  auto stage = [&](int gs) {
    if (lane != 0 || warp > 1 || gs >= nslices) return;
    const int s0 = gs / nsl * F, d0 = gs % nsl * DS, buf = gs & 1;
    if (warp == 0) {
      mbar_expect(full + buf, (PAIRS + (RES ? 0 : N)) * DS * 2);
      tma_load_3d(xs + buf * PAIRS * DS, xmap, d0, row0, s0, full + buf);
    } else if (!RES) {
      tma_load_2d(wxs + buf * N * DS, &wx_map, d0, wrow, full + buf);
    }
  };
  stage(0);
  stage(1);
  if (RES) mbar_wait(wbar, 0);

  int gs = 0;
  for (int s0 = 0; s0 < steps; s0 += F) {
    // ---- the chunk's projection gx = x W_x[:, cols] + b for its 128
    // pairs: this warp's tile, then into gxs in the lane layout of the
    // frames' accumulators
    float acc[2][8][4];
#pragma unroll
    for (int m = 0; m < 2; ++m) {
#pragma unroll
      for (int n = 0; n < 8; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[m][n][e] = 0.f;
      }
    }
    const int groups = FULL ? 4 : min(4, NU / 4 - 4 * pn);  // this warp's column groups
    for (int sl = 0; sl < nsl; ++sl, ++gs) {
      mbar_wait(full + (gs & 1), (gs >> 1) & 1);  // slice gs has landed
      PHASE(1)
      if (groups > 0) {
        const int kd = min(DS, DW - sl * DS);
        const bf16* xa = xs + (gs & 1) * PAIRS * DS;
        const bf16* wbx = wxs + (RES ? sl : gs & 1) * N * DS;
        auto kstep = [&](int k) {
          uint32_t a[2][4];
#pragma unroll
          for (int m = 0; m < 2; ++m)
            ldsm_x4(a[m], xa + swz(pm * 32 + m * 16 + a_row, k + a_col));
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            if (FULL || j < groups) {
              uint32_t bw[4];
              ldsm_x4(bw, wbx + swz(pn * 64 + j * 16 + b_n, k + b_k));
#pragma unroll
              for (int m = 0; m < 2; ++m) {
                mma16816(acc[m][2 * j], a[m], bw[0], bw[1]);
                mma16816(acc[m][2 * j + 1], a[m], bw[2], bw[3]);
              }
            }
          }
        };
        if (kd == DS) {
#pragma unroll
          for (int k = 0; k < DS; k += 16) kstep(k);
        } else {
          for (int k = 0; k < kd; k += 16) kstep(k);
        }
      }
      __syncthreads();  // the buffer may be restaged
      PHASE(2)
      stage(gs + 2);
      PHASE(3)
    }
    {
      const float* bz = bias + wrow;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (FULL || j < groups) {
          const int gq = 4 * pn + j;
          const float b0 = __ldg(bz + gq * 16 + 2 * t4), b1 = __ldg(bz + gq * 16 + 2 * t4 + 1);
          const float b2 = __ldg(bz + gq * 16 + 8 + 2 * t4);
          const float b3 = __ldg(bz + gq * 16 + 9 + 2 * t4);
#pragma unroll
          for (int m = 0; m < 2; ++m) {
            float4* dst = reinterpret_cast<float4*>(
                gxs + (((2 * pm + m) * (NU / 4) + gq) * 32 + lane) * 8);
            const float* v = acc[m][2 * j];
            const float* u = acc[m][2 * j + 1];
            dst[0] = make_float4(v[0] + b0, v[1] + b1, v[2] + b0, v[3] + b1);
            dst[1] = make_float4(u[0] + b2, u[1] + b3, u[2] + b2, u[3] + b3);
          }
        }
      }
    }
    __syncthreads();  // gxs holds the chunk

    PHASE(8)

    // ---- the chunk's frames: the serial chain, m-tile by m-tile (the
    // group's 16-row halves are independent recurrences, so one half's h
    // travels to the peers while the other half computes)
#pragma unroll 1
    for (int f = 0; f < F; ++f) {
      const int s = s0 + f;
      if (s >= steps) break;
      const int cur = s & 1, nxt = cur ^ 1;
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        // the peers' rows of this m-tile of h_{s-1}: the ((s - 1) / 2)-th
        // phase of its mbarrier
        if (C > 1 && s > 0) mbar_wait(bar + 2 * m + cur, ((s - 1) >> 1) & 1);
        PHASE(7)
        bf16* hn = slice(nxt) + m * 16 * SR;
        if (active) {
          float pr[2][4] = {};  // n-tile
          uint32_t a[2][4];     // A of k-steps kk and kk + 1
          ldsm_x4(a[0], h_at(cur, m, 0));
#pragma unroll
          for (int kk = 0; kk < KMAX; ++kk) {
            if (FULL || kk < ksteps) {
              if (kk + 1 < KMAX && (FULL || kk + 1 < ksteps))
                ldsm_x4(a[(kk + 1) & 1], h_at(cur, m, kk + 1));
              mma16816(pr[0], a[kk & 1], wb[kk][0], wb[kk][1]);
              mma16816(pr[1], a[kk & 1], wb[kk][2], wb[kk][3]);
            }
          }
          PHASE(4)
          // the cell update of unit `ul`, rows g + 8 hf of the m-tile
          const float4* gp = reinterpret_cast<const float4*>(
              gxs + (((f * MT + m) * (NU / 4) + warp) * 32 + lane) * 8);
          const float4 u = gp[0], v = gp[1];
          const float gxv[2][4] = {{u.x, u.y, v.x, v.y}, {u.z, u.w, v.z, v.w}};
#pragma unroll
          for (int hf = 0; hf < 2; ++hf) {
            const float gi = gxv[hf][0] + pr[0][2 * hf];
            const float gf = gxv[hf][1] + pr[0][2 * hf + 1];
            const float gg = gxv[hf][2] + pr[1][2 * hf];
            const float go = gxv[hf][3] + pr[1][2 * hf + 1];
            const float cn = sigmoid_fast(gf) * c[m][hf] + sigmoid_fast(gi) * tanh_fast(gg);
            c[m][hf] = cn;
            hn[(g + 8 * hf) * SR + ul] = __float2bfloat16(sigmoid_fast(go) * tanh_fast(cn));
          }
          // the copy engine reads these rows next
          asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        } else {
          PHASE(4)
        }
        __syncthreads();  // the block's rows of this m-tile of h_t are complete
        PHASE(5)
        // send them to the peers (lane 0 of warp j to block j) and write
        // them out
        if (C > 1) {
          if (tid == 0) mbar_expect(bar + 2 * m + nxt, (C - 1) * tile_bytes);
          if (lane == 0 && warp < C && warp != (int)rank)
            dsmem_copy(hn, tile_bytes, warp, bar + 2 * m + nxt);
        }
        if (tid < 16 * (NU / 8)) {
          const int r = tid / (NU / 8), l = len_s[m * 16 + r];
          if (s < l) {
            const int t = z == 0 ? s : l - 1 - s;
            *reinterpret_cast<uint4*>(out + ((size_t)(row0 + m * 16 + r) * T + t) * 2 * H +
                                      z * H + rank * NU + (tid % (NU / 8)) * 8) =
                *reinterpret_cast<const uint4*>(hn + r * SR + (tid % (NU / 8)) * 8);
          }
        }
        PHASE(6)
      }
    }
  }
  // the peers' last rows have landed before this block's shared memory
  // may go
  if (C > 1 && steps > 0) {
#pragma unroll
    for (int m = 0; m < MT; ++m) mbar_wait(bar + 2 * m + (steps & 1), ((steps - 1) >> 1) & 1);
  }

  // pad frames of this direction and the block's units: exact zeros
  const int segs = NU / 8;
  for (int i = tid; i < R * T * segs; i += NT) {
    const int rt = i / segs, r = rt / T, t = rt % T;
    if (row0 + r < B && t >= len_s[r])
      *reinterpret_cast<uint4*>(out + ((size_t)(row0 + r) * T + t) * 2 * H + z * H +
                                rank * NU + (i % segs) * 8) = make_uint4(0, 0, 0, 0);
  }
  PHASE_END
  // no block's shared memory is freed while a peer may still write it
  cluster_sync();
}

// cuTensorMapEncodeTiled, looked up through the CUDA runtime (the library
// links the runtime only).
PFN_cuTensorMapEncodeTiled_v12000 encode_tiled() {
  static PFN_cuTensorMapEncodeTiled_v12000 fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found) ==
            cudaSuccess &&
        found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(p);
  }
  return fn;
}

// A tensor map of bfloat16 `dims` (innermost first; byte strides of the
// outer ones) read in boxes of `box`, 128-byte swizzled; rows outside the
// tensor arrive as zeros.
template <int RANK>
bool tensor_map(CUtensorMap* map, const void* base, const cuuint64_t (&dims)[RANK],
                const cuuint64_t (&strides)[RANK - 1], const cuuint32_t (&box)[RANK]) {
  const auto fn = encode_tiled();
  if (fn == nullptr) return false;
  cuuint32_t estr[RANK];
  for (int i = 0; i < RANK; ++i) estr[i] = 1;
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, RANK, const_cast<void*>(base), dims,
            const_cast<cuuint64_t*>(strides), box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int MT, bool RES, bool FULL>
cudaError_t launch_kernel(const CUtensorMap& xf, const CUtensorMap& xb, const CUtensorMap& wm,
                          const bf16* wh, const float* bias, const int* lengths, bf16* out,
                          int B, int T, int DW, int H, int C, cudaStream_t stream) {
  constexpr auto kernel = blstm_infer_cluster_kernel<MT, RES, FULL>;
  const int R = 16 * MT, NU = H / C;
  const size_t smem = smem_bytes(H, C, R, DW, RES);
  cudaError_t err = rg::reserve_smem<kernel>(smem);
  if (err != cudaSuccess) {
    cudaGetLastError();
    return err;
  }
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(C, (B + R - 1) / R, 2);
  cfg.blockDim = dim3(NT);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  // a cluster of C blocks with this much shared memory must fit the card
  // at all; asked once per cluster size and shared-memory size
  static size_t checked[9] = {};
  if (smem > checked[C]) {
    int clusters = 0;
    err = cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg);
    if (err != cudaSuccess) {
      cudaGetLastError();
      return err;
    }
    if (clusters < 1) return cudaErrorInvalidConfiguration;
    checked[C] = smem;
  }
  err = cudaLaunchKernelEx(&cfg, kernel, xf, xb, wm, wh, bias, lengths, out, B, T, DW, H, NU);
  if (err != cudaSuccess) {
    cudaGetLastError();  // a refused launch leaves nothing for the next check
    return err;
  }
  return cudaGetLastError();
}

}  // namespace

// x (B, T, DW) bf16 (columns past D zero) and x_rev, each row's first len
// frames of x in reverse order (the backward direction's input in its
// order), wx (2, C, N, DW), wh (2, C, N, H) bf16 and bias (2, C, N) f32
// packed by ops/blstm.py::_cluster_pack, lengths (B,) int32, out (B, T, 2H)
// bf16. C blocks a cluster, R = 16 or 32 rows a group, W_x resident or
// streamed: ops/blstm.py::cluster_plan. Every pointer 16-byte aligned.
extern "C" int blstm_infer_cluster(const void* x, const void* x_rev, const void* wx,
                                   const void* wh, const void* bias, const void* lengths,
                                   void* out, int B, int T, int DW, int H, int C, int R,
                                   int resident, void* stream) {
  if (B < 1 || T < 1 || DW < 16 || DW % 16 != 0 || H < 16 || H % 16 != 0)
    return (int)cudaErrorInvalidValue;
  if (C != 1 && C != 2 && C != 4 && C != 8) return (int)cudaErrorInvalidValue;
  if (R != 16 && R != 32) return (int)cudaErrorInvalidValue;
  const int NU = H / C;
  if (H % C != 0 || NU % 8 != 0 || NU > 32) return (int)cudaErrorInvalidValue;
  const int N = 4 * NU;
  CUtensorMap xf, xb, wm;
  // x as (columns, rows, frames): a box of R rows at F frames lands
  // frame-major, pair p = f R + r
  const cuuint64_t xdims[3] = {(cuuint64_t)DW, (cuuint64_t)B, (cuuint64_t)T};
  const cuuint64_t xstrides[2] = {(cuuint64_t)T * DW * 2, (cuuint64_t)DW * 2};
  const cuuint32_t xbox[3] = {DS, (cuuint32_t)R, (cuuint32_t)(PAIRS / R)};
  const cuuint64_t wdims[2] = {(cuuint64_t)DW, (cuuint64_t)2 * C * N};
  const cuuint64_t wstrides[1] = {(cuuint64_t)DW * 2};
  const cuuint32_t wbox[2] = {DS, (cuuint32_t)N};
  if (!tensor_map<3>(&xf, x, xdims, xstrides, xbox) ||
      !tensor_map<3>(&xb, x_rev, xdims, xstrides, xbox) ||
      !tensor_map<2>(&wm, wx, wdims, wstrides, wbox))
    return (int)cudaErrorInvalidValue;
  const auto* whp = static_cast<const bf16*>(wh);
  const auto* bp = static_cast<const float*>(bias);
  const auto* lp = static_cast<const int*>(lengths);
  auto* op = static_cast<bf16*>(out);
  const auto s = static_cast<cudaStream_t>(stream);
  // the flagship's layers (H = 256 over 8 blocks) take an instantiation
  // with the product's k-steps and the projection's column groups fixed
  const bool full = H == 256 && NU == 32;
#define RG_LAUNCH(MT, RES, FULL) \
  launch_kernel<MT, RES, FULL>(xf, xb, wm, whp, bp, lp, op, B, T, DW, H, C, s)
  cudaError_t err;
  if (R == 16) {
    err = resident ? (full ? RG_LAUNCH(1, true, true) : RG_LAUNCH(1, true, false))
                   : (full ? RG_LAUNCH(1, false, true) : RG_LAUNCH(1, false, false));
  } else {
    err = resident ? (full ? RG_LAUNCH(2, true, true) : RG_LAUNCH(2, true, false))
                   : (full ? RG_LAUNCH(2, false, true) : RG_LAUNCH(2, false, false));
  }
#undef RG_LAUNCH
  return (int)err;
}

// How many clusters of C blocks, one block an SM, the card runs at once
// (cudaOccupancyMaxActiveClusters): ops/blstm.py::cluster_plan takes 32-row
// groups where the 16-row ones would not all fit.
extern "C" int blstm_infer_cluster_fit(int C, void* clusters) {
  if (C != 1 && C != 2 && C != 4 && C != 8) return (int)cudaErrorInvalidValue;
  constexpr auto kernel = blstm_infer_cluster_kernel<1, false, true>;
  const size_t smem = smem_bytes(256, 8, 16, 64, false);  // over half an SM's
  cudaError_t err = rg::reserve_smem<kernel>(smem);
  if (err != cudaSuccess) {
    cudaGetLastError();
    return err;
  }
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(C, 1, 1);
  cfg.blockDim = dim3(NT);
  cfg.dynamicSmemBytes = smem;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaOccupancyMaxActiveClusters(static_cast<int*>(clusters), kernel, &cfg);
  if (err != cudaSuccess) cudaGetLastError();
  return (int)err;
}
