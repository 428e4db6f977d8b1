// Masked bidirectional LSTM forward for inference, from the raw input, with
// W_h split over a thread-block cluster: the "cluster" route of
// ops/blstm.py::blstm_infer.
//
// Replaces robust_e2e_gan_tpu/ops/blstm_pallas.py::blstm_infer in its
// W_x-resident variant (_fused_kernel :90, pallas_call :403) wherever
// ops/blstm.py::cluster_plan fits (bfloat16, H a multiple of 16 with at
// most 32 hidden units a block, up to H = 512 over 16 blocks);
// csrc/blstm_infer.cu, the "row-tiled" route, takes the other layers. The
// contract is that kernel's: x (B, T, D) rounded to bfloat16, x W_x + b
// accumulated in float32, h rounded to bfloat16 for the recurrent
// product, the gates in float32, out (B, T, 2H) bfloat16 with exact zeros
// on pad frames.
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
// no shared-memory round trip. The warp keeps the first 256 rows of its
// W_h columns in registers as mma B fragments (64 a lane) from the first
// frame to the last.
//
// H = 512 (the WIDE instantiation: 16 blocks of 32 units, a cluster size
// past the portable 8 that an H100 allows on request). A warp's columns
// are 512 rows, 128 registers a lane as fragments, which the 239 the
// kernel already takes leave no room for: rows 256-511 of the block's 128
// columns (64 KB) are loaded into shared memory once, 128-byte swizzled,
// and read by ldmatrix in each frame's product as a second chain of
// k-steps beside the registers' (two sums, added before the cell). To
// leave room for them a chunk stages 64 (row, frame) pairs, not 128,
// which halves gx and the x stages, and W_x always streams.
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
// run: lane l of warp j sends them to block j + 8 l with one bulk copy
// from shared memory to its shared memory (distributed shared memory),
// which that block's mbarrier counts in (complete_tx). Other threads write
// the rows that are valid at this frame to the output. No frame crosses a
// cluster-wide barrier, and nothing on the serial chain goes through L2 or
// device memory except the output write. The h buffers and their
// mbarriers are double-buffered by frame parity: a peer writes the buffer
// this block read one frame earlier, which it can only do once it has
// this block's h of that frame, sent after the read.
//
// A chunk of F = P / R frames (P = 128 pairs, 64 where WIDE) starts with
// the projection of the group's R x F (row, frame) pairs onto the block's
// N columns (M = P, N, K = D padded to DW, a multiple of 16) on the
// tensor cores, in slices of 64 input columns. The copy engine (TMA)
// brings each slice: one box of the group's R rows at the chunk's F frames
// from x, mapped as (columns, rows, frames) so that it lands frame-major
// (the backward direction reads a copy of x reversed per row by the
// wrapper, so its frames are one box too), and W_x's slice of the block's
// columns where it streams (D = 512, 2,560, and every D where WIDE); where
// the plan fits it (D = 257), all of W_x's columns stay resident.
// Boxes land 128-byte swizzled (a row's 16-byte chunk c at c ^ (row % 8)),
// so ldmatrix reads them without bank conflicts. Slices are staged two
// ahead, across chunk ends, so the next chunk's first slices land during
// this chunk's frames. The 8 warps tile the projection P / 32 by 256 / P
// (32 pairs by 4 N / (256 / P) columns each) and leave gx + b in shared
// memory in the lane layout of the frames' accumulators. The projection
// still runs between the frames; overlapping it with them would take its
// time off the chain.
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
// 1 in the tool's second build: the H = 512 product's two chains of
// k-steps run one after the other, with a mark between them
#ifndef PHASE_SPLIT
#define PHASE_SPLIT 0
#endif

namespace {

using bf16 = __nv_bfloat16;
using rg::ldsm_x4;
using rg::mma16816;
using rg::smem_addr;

constexpr int NT = 256;  // threads per block: 8 warps
constexpr int DS = 64;   // input columns per projection slice (128 bytes)
constexpr int PAD = 8;   // bf16 elements of padding of an h slice row
constexpr int KMAX = 16; // k-steps of W_h a warp holds in registers: 256 rows
constexpr int KW = 256;  // rows of W_h in shared memory where WIDE (H = 512)

// (row, frame) pairs of a chunk, R * F: 64 where part of W_h takes shared
// memory (H past the registers' 256 rows)
__host__ __device__ constexpr int pairs_for(bool wide) { return wide ? 64 : 128; }

// Dynamic shared memory of one block (ops/blstm.py::cluster_smem computes
// the same): two x stages (P, DS), W_x's columns resident (ceil(DW / DS),
// N, DS) or two staged slices (2, N, DS), all bfloat16 and 1024-byte
// aligned for the swizzle; the chunk's gx (P, N) float32; where H > 256,
// W_h's rows past 256 of the block's columns (N, H - 256) bfloat16; two h
// buffers (2, C, R, NU + PAD) bfloat16; R int32 lengths; seven 8-byte
// mbarriers; 1 KB to align the base.
size_t smem_bytes(int H, int C, int R, int DW, bool resident) {
  const bool wide = H > 16 * KMAX;
  const size_t P = pairs_for(wide), N = 4 * (size_t)(H / C), nsl = (DW + DS - 1) / DS;
  const size_t elems = 2 * P * DS + (resident ? nsl : 2) * N * DS +
                       (wide ? N * (H - 16 * KMAX) : 0) + 2 * (size_t)C * R * (H / C + PAD);
  return 1024 + elems * sizeof(bf16) + P * N * sizeof(float) + (size_t)R * sizeof(int) +
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

template <int MT, bool RES, bool FULL, bool WIDE>
__global__ void __launch_bounds__(NT, 1)
blstm_infer_cluster_kernel(const __grid_constant__ CUtensorMap x_fwd,  // (B, T, DW)
                           const __grid_constant__ CUtensorMap x_bwd,  // reversed per row
                           const __grid_constant__ CUtensorMap wx_map,  // (2 C N, DW)
                           const bf16* __restrict__ wh,      // (2, C, N, H) packed
                           const float* __restrict__ bias,   // (2, C, N) packed
                           const int* __restrict__ lengths,  // (B,)
                           bf16* __restrict__ out,           // (B, T, 2H)
                           int B, int T, int DW, int H, int NU) {
  static_assert(!WIDE || (FULL && !RES), "H = 512: 32 units a block, W_x streamed");
  constexpr int P = pairs_for(WIDE);  // (row, frame) pairs of a chunk
  constexpr int R = 16 * MT;          // rows of a group
  constexpr int F = P / R;            // frames of a chunk
  // the projection's warp grid: PM groups of 32 pairs by PN column splits
  // of GQ 16-column groups (at 32 units a block)
  constexpr int PM = P / 32, PN = 8 / PM, GQ = 8 / PN;
  constexpr bool kSplit = WIDE && PHASE_SPLIT;
  extern __shared__ unsigned char smem_raw[];
  const int N = 4 * NU, SR = NU + PAD, nsl = (DW + DS - 1) / DS;
  bf16* xs = reinterpret_cast<bf16*>((reinterpret_cast<uintptr_t>(smem_raw) + 1023) &
                                     ~uintptr_t(1023));  // (2, P, DS)
  bf16* wxs = xs + 2 * P * DS;                           // (nsl or 2, N, DS)
  float* gxs = reinterpret_cast<float*>(wxs + (RES ? nsl : 2) * N * DS);  // (P/16, NU/4, 32, 8)
  bf16* whs = reinterpret_cast<bf16*>(gxs + P * N);      // WIDE: (N, KW) swizzled
  bf16* hb = whs + (WIDE ? N * KW : 0);                  // (2, C, R, SR)
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
  if (WIDE) {
    // W_h rows KMAX * 16 .. H - 1 of the block's columns, a 16-byte chunk
    // c of column n's row at chunk c ^ (n % 8) (ldmatrix's eight rows on
    // distinct banks)
    const bf16* src = wh + (size_t)wrow * H + 16 * KMAX;
    for (int i = tid; i < N * (KW / 8); i += NT) {
      const int n = i / (KW / 8), ch = i % (KW / 8);
      *reinterpret_cast<uint4*>(whs + n * KW + ((ch ^ (n & 7)) << 3)) =
          *reinterpret_cast<const uint4*>(src + (size_t)n * H + ch * 8);
    }
  }
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
  // the first 256 rows of the warp's W_h columns as mma B fragments, in
  // registers for the whole launch (where WIDE, shared memory holds the
  // rest): k-step kk, n-tile j: W_h[k = 16 kk + 2 t (+8)][n = 16 warp + 8 j + g]
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
  // groups GQ pn .. GQ pn + GQ - 1 (16 GQ gate columns)
  const int pm = warp % PM, pn = warp / PM;
  // WIDE: the warp's columns' rows of W_h in shared memory, read as
  // ldmatrix B fragments like W_x's (k-step kk at rows 16 kk + b_k)
  const bf16* whw = whs + (warp * 16 + b_n) * KW;
  auto wh_at = [&](int kk) { return whw + (((2 * kk + (b_k >> 3)) ^ (lane & 7)) << 3); };
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
      mbar_expect(full + buf, (P + (RES ? 0 : N)) * DS * 2);
      tma_load_3d(xs + buf * P * DS, xmap, d0, row0, s0, full + buf);
    } else if (!RES) {
      tma_load_2d(wxs + buf * N * DS, &wx_map, d0, wrow, full + buf);
    }
  };
  stage(0);
  stage(1);
  if (RES) mbar_wait(wbar, 0);

  int gs = 0;
  for (int s0 = 0; s0 < steps; s0 += F) {
    // ---- the chunk's projection gx = x W_x[:, cols] + b for its P
    // pairs: this warp's tile, then into gxs in the lane layout of the
    // frames' accumulators
    float acc[2][2 * GQ][4];
#pragma unroll
    for (int m = 0; m < 2; ++m) {
#pragma unroll
      for (int n = 0; n < 2 * GQ; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[m][n][e] = 0.f;
      }
    }
    const int groups = FULL ? GQ : min(GQ, NU / 4 - GQ * pn);  // this warp's column groups
    for (int sl = 0; sl < nsl; ++sl, ++gs) {
      mbar_wait(full + (gs & 1), (gs >> 1) & 1);  // slice gs has landed
      PHASE(1)
      if (groups > 0) {
        const int kd = min(DS, DW - sl * DS);
        const bf16* xa = xs + (gs & 1) * P * DS;
        const bf16* wbx = wxs + (RES ? sl : gs & 1) * N * DS;
        auto kstep = [&](int k) {
          uint32_t a[2][4];
#pragma unroll
          for (int m = 0; m < 2; ++m)
            ldsm_x4(a[m], xa + swz(pm * 32 + m * 16 + a_row, k + a_col));
#pragma unroll
          for (int j = 0; j < GQ; ++j) {
            if (FULL || j < groups) {
              uint32_t bw[4];
              ldsm_x4(bw, wbx + swz(pn * 16 * GQ + j * 16 + b_n, k + b_k));
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
      for (int j = 0; j < GQ; ++j) {
        if (FULL || j < groups) {
          const int gq = GQ * pn + j;
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
          float ps[2][4] = {};  // WIDE: the same over W_h's rows in shared memory
          uint32_t a[2][4];     // A of k-steps kk and kk + 1
          uint32_t as[2][4], bs[2][4];  // WIDE: A and B of k-steps KMAX + kk, + 1
          // WIDE: k-step KMAX + kk, B from shared memory, the next one's
          // fragments loaded first
          auto smem_step = [&](int kk) {
            if (kk + 1 < KMAX) {
              ldsm_x4(as[(kk + 1) & 1], h_at(cur, m, KMAX + kk + 1));
              ldsm_x4(bs[(kk + 1) & 1], wh_at(kk + 1));
            }
            mma16816(ps[0], as[kk & 1], bs[kk & 1][0], bs[kk & 1][1]);
            mma16816(ps[1], as[kk & 1], bs[kk & 1][2], bs[kk & 1][3]);
          };
          ldsm_x4(a[0], h_at(cur, m, 0));
          if (WIDE) {
            ldsm_x4(as[0], h_at(cur, m, KMAX));
            ldsm_x4(bs[0], wh_at(0));
          }
          // the registers' chain, and where WIDE the shared memory's
          // interleaved with it: two independent sums
#pragma unroll
          for (int kk = 0; kk < KMAX; ++kk) {
            if (FULL || kk < ksteps) {
              if (kk + 1 < KMAX && (FULL || kk + 1 < ksteps))
                ldsm_x4(a[(kk + 1) & 1], h_at(cur, m, kk + 1));
              mma16816(pr[0], a[kk & 1], wb[kk][0], wb[kk][1]);
              mma16816(pr[1], a[kk & 1], wb[kk][2], wb[kk][3]);
              if (WIDE && !kSplit) smem_step(kk);
            }
          }
          if (kSplit) {
            PHASE(4)
#pragma unroll
            for (int kk = 0; kk < KMAX; ++kk) smem_step(kk);
          }
          if (WIDE) {
#pragma unroll
            for (int j = 0; j < 2; ++j) {
#pragma unroll
              for (int e = 0; e < 4; ++e) pr[j][e] += ps[j][e];
            }
          }
          if (kSplit) {
            PHASE(9)
          } else {
            PHASE(4)
          }
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
          if (kSplit) {
            PHASE(9)
          }
        }
        __syncthreads();  // the block's rows of this m-tile of h_t are complete
        PHASE(5)
        // send them to the peers (lane l of warp j to block j + 8 l) and
        // write them out
        if (C > 1) {
          if (tid == 0) mbar_expect(bar + 2 * m + nxt, (C - 1) * tile_bytes);
          const int peer = warp + 8 * lane;
          if (lane < 2 && peer < C && peer != (int)rank)
            dsmem_copy(hn, tile_bytes, peer, bar + 2 * m + nxt);
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

// Lets Kernel take `smem` bytes of dynamic shared memory and clusters
// past the portable 8 blocks (16 on an H100), before any occupancy query
// or launch; the second attribute is set once per kernel and process.
template <auto Kernel>
cudaError_t prepare(size_t smem) {
  static const cudaError_t wide =
      cudaFuncSetAttribute(Kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  cudaError_t err = wide != cudaSuccess ? wide : rg::reserve_smem<Kernel>(smem);
  if (err != cudaSuccess) cudaGetLastError();
  return err;
}

// A launch of (C, rows, 2) blocks in clusters of C along x. `attr` must
// outlive the configuration.
cudaLaunchConfig_t cluster_config(cudaLaunchAttribute* attr, int C, int rows, size_t smem,
                                  cudaStream_t stream) {
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = C;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(C, rows, 2);
  cfg.blockDim = dim3(NT);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

template <int MT, bool RES, bool FULL, bool WIDE>
cudaError_t launch_kernel(const CUtensorMap& xf, const CUtensorMap& xb, const CUtensorMap& wm,
                          const bf16* wh, const float* bias, const int* lengths, bf16* out,
                          int B, int T, int DW, int H, int C, cudaStream_t stream) {
  constexpr auto kernel = blstm_infer_cluster_kernel<MT, RES, FULL, WIDE>;
  const int R = 16 * MT, NU = H / C;
  const size_t smem = smem_bytes(H, C, R, DW, RES);
  cudaError_t err = prepare<kernel>(smem);
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = cluster_config(&attr, C, (B + R - 1) / R, smem, stream);
  // a cluster of C blocks with this much shared memory must fit the card
  // at all; asked once per cluster size (1 .. 16) and shared-memory size
  static size_t checked[17] = {};
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
// streamed: ops/blstm.py::cluster_plan. H past 256 only as H = 512 over 16
// blocks with W_x streamed. Every pointer 16-byte aligned.
extern "C" int blstm_infer_cluster(const void* x, const void* x_rev, const void* wx,
                                   const void* wh, const void* bias, const void* lengths,
                                   void* out, int B, int T, int DW, int H, int C, int R,
                                   int resident, void* stream) {
  if (B < 1 || T < 1 || DW < 16 || DW % 16 != 0 || H < 16 || H % 16 != 0)
    return (int)cudaErrorInvalidValue;
  if (C != 1 && C != 2 && C != 4 && C != 8 && C != 16) return (int)cudaErrorInvalidValue;
  if (R != 16 && R != 32) return (int)cudaErrorInvalidValue;
  const int NU = H / C;
  if (H % C != 0 || NU % 8 != 0 || NU > 32) return (int)cudaErrorInvalidValue;
  const bool wide = H > 16 * KMAX;
  if (wide && (H != 2 * KW || NU != 32 || resident)) return (int)cudaErrorInvalidValue;
  const int N = 4 * NU, P = pairs_for(wide);
  CUtensorMap xf, xb, wm;
  // x as (columns, rows, frames): a box of R rows at F frames lands
  // frame-major, pair p = f R + r
  const cuuint64_t xdims[3] = {(cuuint64_t)DW, (cuuint64_t)B, (cuuint64_t)T};
  const cuuint64_t xstrides[2] = {(cuuint64_t)T * DW * 2, (cuuint64_t)DW * 2};
  const cuuint32_t xbox[3] = {DS, (cuuint32_t)R, (cuuint32_t)(P / R)};
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
  // the flagship's layers (H = 256 over 8 blocks) and H = 512 over 16 take
  // instantiations with the product's k-steps and the projection's column
  // groups fixed
  const bool full = (H == 256 || wide) && NU == 32;
#define RG_LAUNCH(MT, RES, FULL, WIDE) \
  launch_kernel<MT, RES, FULL, WIDE>(xf, xb, wm, whp, bp, lp, op, B, T, DW, H, C, s)
  cudaError_t err;
  if (wide) {
    err = R == 16 ? RG_LAUNCH(1, false, true, true) : RG_LAUNCH(2, false, true, true);
  } else if (R == 16) {
    err = resident ? (full ? RG_LAUNCH(1, true, true, false) : RG_LAUNCH(1, true, false, false))
                   : (full ? RG_LAUNCH(1, false, true, false) : RG_LAUNCH(1, false, false, false));
  } else {
    err = resident ? (full ? RG_LAUNCH(2, true, true, false) : RG_LAUNCH(2, true, false, false))
                   : (full ? RG_LAUNCH(2, false, true, false) : RG_LAUNCH(2, false, false, false));
  }
#undef RG_LAUNCH
  return (int)err;
}

// How many clusters of C blocks with `smem` bytes of shared memory each,
// one block an SM, the card runs at once (cudaOccupancyMaxActiveClusters;
// C = 16 asks the H = 512 instantiation, smaller C the flagship's):
// ops/blstm.py::cluster_plan takes 32-row groups where the 16-row ones
// would not all fit.
extern "C" int blstm_infer_cluster_fit(int C, int smem, void* clusters) {
  if (C != 1 && C != 2 && C != 4 && C != 8 && C != 16) return (int)cudaErrorInvalidValue;
  if (smem < 1) return (int)cudaErrorInvalidValue;
  constexpr auto flagship = blstm_infer_cluster_kernel<1, false, true, false>;
  constexpr auto wide = blstm_infer_cluster_kernel<1, false, true, true>;
  cudaError_t err = C == 16 ? prepare<wide>(smem) : prepare<flagship>(smem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t cfg = cluster_config(&attr, C, 1, smem, nullptr);
  err = C == 16 ? cudaOccupancyMaxActiveClusters(static_cast<int*>(clusters), wide, &cfg)
                : cudaOccupancyMaxActiveClusters(static_cast<int*>(clusters), flagship, &cfg);
  if (err != cudaSuccess) cudaGetLastError();
  return (int)err;
}
