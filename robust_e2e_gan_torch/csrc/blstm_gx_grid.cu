// Masked bidirectional LSTM recurrence for inference on a co-resident grid:
// the "grid" route of ops/blstm.py::blstm_recurrence.
//
// Replaces robust_e2e_gan_tpu/ops/blstm_pallas.py::blstm_infer in its
// gate-stream variant (_gx_kernel :210, pallas_call :455) wherever
// ops/blstm.py::gx_plan fits; csrc/blstm.cu (route "row_tiled") takes the
// other shapes. The contract is blstm.cu's: gx (B, T, 2, 4H) float32 (the
// input projection of both directions, computed outside), W_h of each
// direction in the compute type T (float or bfloat16), lengths (B,) ->
// out (B, T, 2H) in T, exact zeros on pad frames; per frame
//   gates = gx_t + T(h_{t-1}) @ W_h  ->  i, f, g, o  ->  c_t, h_t
// with h_{t-1} rounded to T for the recurrent product (the TPU kernel's
// h_prev.astype(cdtype)), float32 sums and cell; the backward direction
// walks t = len-1 ... 0 per row.
//
// What bounds it on Hopper: a chain of T dependent frames, each a
// (B x H) @ (H x 4H) product per direction (8.4 MFLOP a row at H = 1,024).
// blstm.cu gives each block a few rows and all of W_h, which it reads from
// L2 in every frame: at H = 1,024 f32, B = 128 that is 2 GB of L2 reads a
// frame, so the L2 and not the chain binds it.
//
// Design: each direction gets P blocks (grid (P, 2), launched together by
// cudaLaunchCooperativeKernel, which refuses a grid that cannot be
// co-resident). Block p owns NU hidden units, i.e. their 4 NU gate columns
// of W_h, for all B rows, so each W_h element is read by one block:
// 1. W_h is packed on the host (ops/blstm.py::gx_pack) as (2, P, H,
//    4 NU + 8): block p's columns, 16 per group of 4 units, (i f) of each
//    unit then (g o) of each unit, so that lane (g, t) of an m16n8 tile
//    pair holds i, f, g, o of one unit for rows g and g + 8 and the cell
//    needs no shared-memory round trip; 8 zero columns pad each row as the
//    shared-memory rows are padded. The first KR rows of the slice stay in
//    shared memory from the first frame to the last (all H where the plan
//    fits them: every bfloat16 layer up to H = 1,024 at B = 128); the
//    other rows are streamed from L2 in every frame, through the h ring.
// 2. The recurrent product h_{t-1} (M = B rounded up to 16 rows) @
//    W_h[:, cols] on the tensor cores: bfloat16 mma.sync m16n8k16 with
//    float32 sums (ldmatrix, ldmatrix.trans); float32 as 3xTF32 mma.sync
//    m16n8k8, each operand split into tf32 hi + lo, each k8 step's lo hi +
//    hi lo + hi hi summed apart and added to the running sums by a float32
//    add (the tensor cores' own float32 sums round toward zero). A warp
//    owns MW m16 tiles by NW 16-column groups (4 x 1 becomes 2 x 2 where
//    the groups pair up: each A fragment and its tf32 split serve two
//    groups); where the warp tiles are fewer than the 8 warps, KSPLIT warp
//    groups split the k8/k16 steps and their sums meet in shared memory in
//    a fixed order.
// 3. h is exchanged through L2: each block writes its units' h_t, rounded
//    to T, into a (2 parity, 2, H / KC, B, KC) buffer of 32-column chunks
//    (16-byte pieces swizzled by row, see swz), then arrives at a
//    generation-counter barrier (one counter per direction, LINE apart;
//    the wrapper passes its value, each launch adds T x P). After the wait
//    every block stages all of h_{t-1}, a chunk at a time, each chunk one
//    bulk copy by the copy engine (TMA) counted in by the stage's
//    mbarrier, NS chunks in flight against the products. (Per-thread
//    cp.async staging moved ~4.4 bytes a cycle into each SM whatever the
//    shape, well under the L2's rate.)
// 4. gx of frame s + 1 (the block's columns, every row) is copied into
//    shared memory by cp.async during frame s, after the cell, under the
//    barrier and the next frame's staging.
// 5. The loop runs to the batch's longest length: every block passes the
//    same barriers; rows past their length do no cell work and write
//    nothing (their product rows, from stale h, are discarded). Pad frames
//    are written as zeros at the end, and the counter is advanced to T
//    arrivals a block.
// The partition is fixed and every sum runs in a fixed order, so reruns
// are bit-identical. As measured (PERF.md row 1b, tools/blstm_gx_phases.py,
// NVIDIA H100 80GB HBM3): the products take ~75% of a float32 frame at
// H = 1,024 (~1.5x their register-only ceiling), ~45% of a bfloat16 one,
// where the staging waits take ~30%; the barrier, the cell and the arrive
// take ~2-5 k cycles a frame.

#include "common.cuh"

#include <type_traits>

// clock64() marks for robust_e2e_gan_torch/tools/blstm_gx_phases.py, which
// defines them; empty in the library build.
#ifndef GX_PHASE_BEGIN
#define GX_PHASE_BEGIN
#define GX_PHASE(n)
#define GX_PHASE_END
#endif

namespace {

using bf16 = __nv_bfloat16;

constexpr int NT = 256;        // threads of a block: 8 warps
constexpr int NWARP = NT / 32;
constexpr int KC = 32;         // k rows of h and W_h a chunk
constexpr int MW_MAX = 4;      // m16 tiles of a warp at most (1, 2 or 4)
constexpr int MAX_STAGES = 8;  // chunks in flight at most
constexpr int LINE = 32;       // unsigned ints between the two directions' counters

template <typename T> constexpr bool kB16 = std::is_same<T, bf16>::value;
template <typename T> constexpr int kPiece = 16 / (int)sizeof(T);

__host__ __device__ inline size_t r16(size_t x) { return (x + 15) & ~size_t(15); }

// Byte offsets of the dynamic shared memory (ops/blstm.py::gx_smem computes
// the same total), each part rounded up to 16 bytes: the KR resident rows
// of W_h's slice (rows of WS = 4 NU + 8 elements, as packed: ldmatrix.trans's
// eight rows and the float32 B fragments' four rows fall on distinct
// banks); NS h stages of MA rows of KC elements (M = B rounded up to 16,
// then to whole warp tiles of MW m16 tiles; the rows past B are zeros;
// 16-byte pieces swizzled, see swz); where KR < H, NS W_h stages of KC
// rows; gx of a frame, M rows of 4 NU + 4 floats; the k-split sums,
// (KSPLIT - 1) x groups x MW x NW x 32 lanes x 8 floats; M + 1 ints, the
// clamped lengths and the step count; NS 8-byte mbarriers, one a stage.
struct Layout {
  size_t w_res, a_st, w_st, gx, red, len, bar, total;
  int ws, gxs, ma;
};

__host__ __device__ inline Layout gx_layout(int B, int H, int NU, int isz, int KR, int NS,
                                            int MW, int NW, int KSPLIT) {
  const int M = (B + 15) / 16 * 16, N = 4 * NU, MT = M / 16;
  const int MB = (MT + MW - 1) / MW, groups = MB * (NU / 4 / NW);
  Layout L;
  L.ws = N + 8;
  L.gxs = N + 4;
  L.ma = MB * MW * 16;
  L.w_res = 0;
  L.a_st = L.w_res + r16((size_t)KR * L.ws * isz);
  L.w_st = L.a_st + r16((size_t)NS * L.ma * KC * isz);
  L.gx = L.w_st + (KR < H ? r16((size_t)NS * KC * L.ws * isz) : 0);
  L.red = L.gx + r16((size_t)M * L.gxs * 4);
  L.len = L.red + r16((size_t)(KSPLIT - 1) * groups * MW * NW * 32 * 8 * 4);
  L.bar = L.len + r16((size_t)(M + 1) * 4);
  L.total = L.bar + r16((size_t)NS * 8);
  return L;
}

// The 16-byte pieces of row r of an h chunk (KC elements: 4 pieces in
// bfloat16, 8 in float32) are stored at piece ^ swz(r), in device memory
// and in the stages alike, so that the eight rows an ldmatrix reads at one
// piece fall on eight distinct bank groups without padding (the copy
// engine moves a chunk as one contiguous block).
template <typename W>
__device__ __forceinline__ int swz(int r) {
  return kB16<W> ? (r >> 1) & 3 : r & 7;
}

// Orders this thread's generic accesses of device memory with the copy
// engine's (the async proxy's): h written by st.global is read by bulk
// copies in other blocks after the grid barrier.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.global;\n" ::: "memory");
}

// One chunk's products of a warp: its m16 tiles mt0 .. mt0 + MW - 1 of
// the staged h rows (as, KC elements a row, pieces swizzled) times its
// 16-column groups np0 .. np0 + NW - 1 (ws, KC rows WS apart), the k steps
// step0 + kk with (step0 + kk) % KSPLIT == ks, into acc[m tile][n8
// tile][fragment]. MW and NW are constants, so the tiles' loads and
// products interleave; each A fragment (and, in float32, its split) serves
// NW groups, each B fragment MW tiles.
template <typename W, int MW, int NW>
__device__ __forceinline__ void chunk_products(float (&acc)[MW][2 * NW][4], const W* as,
                                               const W* ws, int WS, int mt0, int np0, int step0,
                                               int ks, int KSPLIT, int lane) {
  constexpr int P16 = kPiece<W>;
  if constexpr (kB16<W>) {
#pragma unroll
    for (int kk = 0; kk < KC / 16; ++kk) {
      if (((step0 + kk) & (KSPLIT - 1)) != ks) continue;
      uint32_t bw[NW][4], af[MW][4];
#pragma unroll
      for (int w = 0; w < NW; ++w)
        rg::ldsm_x4_trans(bw[w], ws + (kk * 16 + lane % 16) * WS + (np0 + w) * 16 + (lane / 16) * 8);
#pragma unroll
      for (int i = 0; i < MW; ++i) {
        const int r = (mt0 + i) * 16 + lane % 16;
        rg::ldsm_x4(af[i], as + r * KC + ((kk * 2 + lane / 16) ^ swz<W>(r)) * P16);
      }
#pragma unroll
      for (int i = 0; i < MW; ++i) {
#pragma unroll
        for (int w = 0; w < NW; ++w) {
          rg::mma16816(acc[i][2 * w], af[i], bw[w][0], bw[w][1]);
          rg::mma16816(acc[i][2 * w + 1], af[i], bw[w][2], bw[w][3]);
        }
      }
    }
  } else {
    const int gq = lane / 4, tq = lane % 4;
#pragma unroll
    for (int kk = 0; kk < KC / 8; ++kk) {
      if (((step0 + kk) & (KSPLIT - 1)) != ks) continue;
      // B: b0 row t, b1 row t + 4, column g of each n8 tile
      uint32_t bh[2 * NW][2], bl[2 * NW][2];
#pragma unroll
      for (int n = 0; n < 2 * NW; ++n) {
        const float* wq = ws + (kk * 8 + tq) * WS + np0 * 16 + n * 8 + gq;
        rg::split_tf32(wq[0], bh[n][0], bl[n][0]);
        rg::split_tf32(wq[4 * WS], bh[n][1], bl[n][1]);
      }
      // A: ldmatrix on 32-bit elements gives the tf32 fragment (a0 row g,
      // col t; a1 row g + 8; a2, a3 col t + 4)
      uint32_t ah[MW][4], al[MW][4];
#pragma unroll
      for (int i = 0; i < MW; ++i) {
        const int r = (mt0 + i) * 16 + lane % 16;
        uint32_t q[4];
        rg::ldsm_x4(q, reinterpret_cast<const bf16*>(
                           as + r * KC + ((kk * 2 + lane / 16) ^ swz<W>(r)) * P16));
#pragma unroll
        for (int e = 0; e < 4; ++e) rg::split_tf32(__uint_as_float(q[e]), ah[i][e], al[i][e]);
      }
      // lo hi, hi lo, hi hi into this step's own sums, each a pass over the
      // warp's tiles (a tile's three products 2 MW NW apart), then one
      // float32 add each
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
  }
}

template <typename W, int MW, int NW>
__global__ void __launch_bounds__(NT, 1)
blstm_gx_grid_kernel(const float* __restrict__ gx,      // (B, T, 2, 4H)
                     const W* __restrict__ wp,          // (2, P, H, 4 NU + 8) packed W_h
                     const int* __restrict__ lengths,   // (B,)
                     W* hbuf,                           // (2 parity, 2, H / KC, B, KC) scratch
                     W* __restrict__ out,               // (B, T, 2H)
                     unsigned* count,                   // the barrier counters
                     int B, int T, int H, int NU, int KR, int NS, int KSPLIT,
                     unsigned base) {
  extern __shared__ __align__(16) char smem[];
  GX_PHASE_BEGIN
  constexpr int P16 = kPiece<W>;  // elements of a 16-byte piece
  constexpr int KSTEPS = KC / (kB16<W> ? 16 : 8);
  const Layout Lo = gx_layout(B, H, NU, sizeof(W), KR, NS, MW, NW, KSPLIT);
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int gq = lane / 4, tq = lane % 4;
  const int z = blockIdx.y, p = blockIdx.x, P = gridDim.x, u0 = p * NU;
  const int M = (B + 15) / 16 * 16, MT = M / 16, N = 4 * NU, G = 4 * H, nk = H / KC;
  const int WS = Lo.ws, GXS = Lo.gxs, MA = Lo.ma;
  const int MB = (MT + MW - 1) / MW, groups = MB * (NU / 4 / NW);
  W* w_res = reinterpret_cast<W*>(smem + Lo.w_res);
  W* a_st = reinterpret_cast<W*>(smem + Lo.a_st);
  W* w_st = reinterpret_cast<W*>(smem + Lo.w_st);
  float* gx_s = reinterpret_cast<float*>(smem + Lo.gx);
  float* red = reinterpret_cast<float*>(smem + Lo.red);
  int* len_s = reinterpret_cast<int*>(smem + Lo.len);
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem + Lo.bar);
  unsigned* cnt = count + z * LINE;
  const W* wblk = wp + ((size_t)z * P + p) * H * WS;  // the block's (H, WS) slice
  const size_t chunk_elems = (size_t)B * KC;          // one chunk of h, all rows
  // the warp's tile: group gi of k slice ks, i.e. 16-column groups np0
  // .. np0 + NW - 1 and m16 tiles mt0 .. mt0 + MW - 1 (those past MT read
  // zero rows); a lane's cells are units (np0 + w) * 4 + t of the tiles'
  // rows g and g + 8
  const int per_slice = NWARP / KSPLIT;
  const int ks = warp / per_slice, gi = warp % per_slice;
  const bool active = gi < groups;
  const int np0 = gi / MB * NW, mt0 = (gi % MB) * MW;

  // set-up: the clamped lengths and the step count, the mbarriers, zeros
  // in the stages' rows past B (the copies write rows 0 .. B - 1), the
  // resident rows of the W_h slice, gx of frame 0
  if (tid == 0) {
    len_s[M] = 0;
    for (int i = 0; i < NS; ++i) rg::mbar_init(bar + i);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  for (int i = tid; i < NS * (MA - B) * KC / P16; i += NT) {
    const int st = i / ((MA - B) * KC / P16), e = i % ((MA - B) * KC / P16);
    *reinterpret_cast<uint4*>(a_st + ((size_t)st * MA + B) * KC + e * P16) =
        make_uint4(0u, 0u, 0u, 0u);
  }
  __syncthreads();
  for (int b = tid; b < M; b += NT) {
    const int l = b < B ? min(max(lengths[b], 0), T) : 0;
    len_s[b] = l;
    if (l > 0) atomicMax(&len_s[M], l);
  }
  for (int i = tid; i < KR * WS / P16; i += NT)
    rg::cp_async16(w_res + i * P16, wblk + (size_t)i * P16);
  __syncthreads();  // the lengths are in
  const int steps = len_s[M];

  // gx of frame s for the block's columns of every row with work, into
  // gx_s as (row, gate, unit)
  auto prefetch_gx = [&](int s) {
    const int pu = NU / 4;  // 16-byte pieces of a gate's units
    for (int i = tid; i < B * 4 * pu; i += NT) {
      const int b = i / (4 * pu), g = i / pu % 4, q = i % pu;
      const int l = len_s[b];
      if (s >= l) continue;
      const int t = z == 0 ? s : l - 1 - s;
      rg::cp_async16(gx_s + b * GXS + g * NU + 4 * q,
                     gx + (((size_t)b * T + t) * 2 + z) * G + g * H + u0 + 4 * q);
    }
  };
  // (thread 0) chunk kc of frame s into stage buf: h_{s-1} of rows 0 .. B-1
  // (rows past their length hold stale values, which only their own rows of
  // the products read) and W_h's rows where not resident, as two bulk
  // copies counted in by the stage's mbarrier
  auto load_chunk = [&](int kc, int buf, int s) {
    const bool stream_w = kc * KC >= KR;
    const unsigned a_bytes = (unsigned)(chunk_elems * sizeof(W));
    const unsigned w_bytes = stream_w ? (unsigned)(KC * WS * sizeof(W)) : 0u;
    rg::mbar_expect(bar + buf, a_bytes + w_bytes);
    rg::bulk_load(a_st + (size_t)buf * MA * KC,
                  hbuf + ((size_t)(((s - 1) & 1) * 2 + z) * nk + kc) * chunk_elems, a_bytes,
                  bar + buf);
    if (stream_w)
      rg::bulk_load(w_st + (size_t)buf * KC * WS, wblk + (size_t)kc * KC * WS, w_bytes, bar + buf);
  };

  if (steps > 0) prefetch_gx(0);
  rg::cp_async_commit();
  rg::cp_async_wait<0>();
  __syncthreads();  // W_h's resident rows and frame 0's gx have landed
  GX_PHASE(5)

  unsigned phase = 0;  // bit i: the parity of stage i's next fill
  W hv[MW][NW][2];     // the lane's h_t, stored to out after the arrive
  float c[MW][NW][2];
#pragma unroll
  for (int i = 0; i < MW; ++i) {
#pragma unroll
    for (int w = 0; w < NW; ++w) c[i][w][0] = c[i][w][1] = 0.f;
  }
  for (int s = 0; s < steps; ++s) {
    float acc[MW][2 * NW][4];
#pragma unroll
    for (int i = 0; i < MW; ++i) {
#pragma unroll
      for (int n = 0; n < 2 * NW; ++n) acc[i][n][0] = acc[i][n][1] = acc[i][n][2] = acc[i][n][3] = 0.f;
    }
    if (s > 0) {
      rg::grid_wait(cnt, base + (unsigned)s * (unsigned)P);
      GX_PHASE(0)
      // NS - 1 chunks ahead
      if (tid == 0) {
        fence_proxy_async();
        for (int c0 = 0; c0 < NS - 1 && c0 < nk; ++c0) load_chunk(c0, c0, s);
      }
      for (int kc = 0; kc < nk; ++kc) {
        const int buf = kc % NS;
        const bool refill = kc + NS - 1 < nk;
        rg::mbar_wait(bar + buf, (phase >> buf) & 1u);
        phase ^= 1u << buf;
        // where chunk kc - 1's stage is refilled, every warp has read it
        // first; where every chunk of the frame is in flight, the warps run
        // on without a block barrier
        if (refill) __syncthreads();
        GX_PHASE(1)
        if (tid == 0 && refill) load_chunk(kc + NS - 1, (kc + NS - 1) % NS, s);
        const W* wsrc = kc * KC < KR ? w_res + (size_t)kc * KC * WS : w_st + (size_t)buf * KC * WS;
        if (active)
          chunk_products<W, MW, NW>(acc, a_st + (size_t)buf * MA * KC, wsrc, WS, mt0, np0,
                                    kc * KSTEPS, ks, KSPLIT, lane);
        GX_PHASE(2)
      }
    }
    rg::cp_async_wait<0>();  // this frame's gx (copied during the frame before)
    // where slice q's sums of the warp tile's i-th m tile and w-th column
    // group go
    auto slot = [&](int q, int i, int w) {
      return reinterpret_cast<float4*>(
          red + (((((size_t)(q - 1) * groups + gi) * MW + i) * NW + w) * 32 + lane) * 8);
    };
    if (KSPLIT > 1 && s > 0 && ks > 0 && active) {  // slices 1.. hand their sums over
#pragma unroll
      for (int i = 0; i < MW; ++i) {
#pragma unroll
        for (int w = 0; w < NW; ++w) {
          float4* d = slot(ks, i, w);
          const float* a = acc[i][2 * w];
          const float* b = acc[i][2 * w + 1];
          d[0] = make_float4(a[0], a[1], a[2], a[3]);
          d[1] = make_float4(b[0], b[1], b[2], b[3]);
        }
      }
    }
    __syncthreads();  // gx and the slices' sums are in
    // the cell: lane (g, t) of slice 0's warps, units (np0 + w) * 4 + t of
    // rows 16 (mt0 + i) + g (+ 8): i, f from the group's first n8 tile, g,
    // o from its second; the slices' sums added in slice order first
    if (ks == 0 && active) {
      if (KSPLIT > 1 && s > 0) {
        for (int q = 1; q < KSPLIT; ++q) {
#pragma unroll
          for (int i = 0; i < MW; ++i) {
#pragma unroll
            for (int w = 0; w < NW; ++w) {
              const float4* d = slot(q, i, w);
              const float4 a = d[0], b = d[1];
              float* x = acc[i][2 * w];
              float* y = acc[i][2 * w + 1];
              x[0] += a.x;
              x[1] += a.y;
              x[2] += a.z;
              x[3] += a.w;
              y[0] += b.x;
              y[1] += b.y;
              y[2] += b.z;
              y[3] += b.w;
            }
          }
        }
      }
#pragma unroll
      for (int w = 0; w < NW; ++w) {
        // unit u of the block's group np0 + w, and where it sits in a chunk
        // row: chunk, swizzled piece, element
        const int uj = (np0 + w) * 4 + tq, u = u0 + uj;
        const int kc = u / KC, piece = u % KC / P16, e = u % P16;
        W* hdst = hbuf + ((size_t)((s & 1) * 2 + z) * nk + kc) * chunk_elems;
#pragma unroll
        for (int i = 0; i < MW; ++i) {
#pragma unroll
          for (int hr = 0; hr < 2; ++hr) {
            const int r = (mt0 + i) * 16 + gq + 8 * hr;
            if (r >= B || s >= len_s[r]) continue;
            const float* gr = gx_s + r * GXS + uj;
            const float* a = acc[i][2 * w];
            const float* b = acc[i][2 * w + 1];
            const float gi_ = gr[0] + a[2 * hr];
            const float gf = gr[NU] + a[2 * hr + 1];
            const float gg = gr[2 * NU] + b[2 * hr];
            const float go = gr[3 * NU] + b[2 * hr + 1];
            const float cn = rg::sigmoid(gf) * c[i][w][hr] + rg::sigmoid(gi_) * tanhf(gg);
            c[i][w][hr] = cn;
            hv[i][w][hr] = rg::from_f<W>(rg::sigmoid(go) * tanhf(cn));
            hdst[(size_t)r * KC + (piece ^ swz<W>(r)) * P16 + e] = hv[i][w][hr];
          }
        }
      }
      fence_proxy_async();  // the copy engine reads these h next
    }
    GX_PHASE(3)
    rg::grid_arrive(cnt);
    if (s + 1 < steps) prefetch_gx(s + 1);  // gx_s is read: the next frame's copies may start
    rg::cp_async_commit();
    // the outputs, off the exchange's path: no other block reads them
    if (ks == 0 && active) {
#pragma unroll
      for (int w = 0; w < NW; ++w) {
        const int u = u0 + (np0 + w) * 4 + tq;
#pragma unroll
        for (int i = 0; i < MW; ++i) {
#pragma unroll
          for (int hr = 0; hr < 2; ++hr) {
            const int r = (mt0 + i) * 16 + gq + 8 * hr;
            if (r >= B) continue;
            const int l = len_s[r];
            if (s >= l) continue;
            const int t = z == 0 ? s : l - 1 - s;
            out[((size_t)r * T + t) * 2 * H + z * H + u] = hv[i][w][hr];
          }
        }
      }
    }
    GX_PHASE(4)
  }

  // pad frames of the block's units: exact zeros
  for (int b = warp; b < B; b += NWARP) {
    const int l = len_s[b];
    for (int e = lane; e < (T - l) * NU; e += 32) {
      const int t = l + e / NU, j = e % NU;
      out[((size_t)b * T + t) * 2 * H + z * H + u0 + j] = rg::from_f<W>(0.f);
    }
  }
  // T arrivals a block in all: the counter moves by T x P whatever the
  // lengths (no wait of this launch is left to release)
  if (tid == 0 && steps < T)
    asm volatile("red.release.gpu.global.add.u32 [%0], %1;" ::"l"(cnt), "r"((unsigned)(T - steps))
                 : "memory");
  GX_PHASE(6)
  GX_PHASE_END
}

// A refused launch (a grid that cannot be co-resident) is returned to the
// wrapper, which raises; the runtime also keeps it as its last error, which
// is cleared here so that the next kernel's launch check does not read it.
cudaError_t launched(cudaError_t err) {
  if (err != cudaSuccess) cudaGetLastError();
  return err;
}

template <typename W, int MW, int NW>
cudaError_t launch_mw(const float* gx, const W* wp, const int* lengths, W* hbuf, W* out,
                      unsigned* count, int B, int T_, int H, int NU, int KR, int NS, int KSPLIT,
                      size_t smem, unsigned base, cudaStream_t stream) {
  const cudaError_t err = rg::reserve_smem<blstm_gx_grid_kernel<W, MW, NW>>(smem);
  if (err != cudaSuccess) return launched(err);
  void* args[] = {&gx, &wp, &lengths, &hbuf, &out, &count, &B, &T_,
                  &H,  &NU, &KR,      &NS,   &KSPLIT, &base};
  return launched(cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(blstm_gx_grid_kernel<W, MW, NW>), dim3(H / NU, 2), dim3(NT),
      args, smem, stream));
}

template <typename W>
cudaError_t launch(const float* gx, const W* wp, const int* lengths, W* hbuf, W* out,
                   unsigned* count, int B, int T_, int H, int NU, int KR, int NS, int MW,
                   int NW, int KSPLIT, size_t smem, unsigned base, cudaStream_t stream) {
  // the warp tiles compiled: 1, 2 or 4 m16 tiles by one 16-column group,
  // and 2 by 2
  const bool tile = NW == 1 ? (MW == 1 || MW == 2 || MW == MW_MAX) : (NW == 2 && MW == 2);
  if (B < 1 || T_ < 1 || H < KC || H % KC || NU < 4 || NU % (4 * NW) || H % NU || KR < 0 ||
      KR > H || KR % KC || NS < 2 || NS > MAX_STAGES || !tile)
    return cudaErrorInvalidValue;
  if (KSPLIT != 1 && KSPLIT != 2 && KSPLIT != 4 && KSPLIT != 8) return cudaErrorInvalidValue;
  const int MT = (B + 15) / 16, groups = (MT + MW - 1) / MW * (NU / 4 / NW);
  const uintptr_t any = reinterpret_cast<uintptr_t>(gx) | reinterpret_cast<uintptr_t>(wp) |
                        reinterpret_cast<uintptr_t>(hbuf);
  if (groups * KSPLIT > NWARP || (any & 15) ||
      gx_layout(B, H, NU, sizeof(W), KR, NS, MW, NW, KSPLIT).total != smem)
    return cudaErrorInvalidValue;
  if (NW == 2)
    return launch_mw<W, 2, 2>(gx, wp, lengths, hbuf, out, count, B, T_, H, NU, KR, NS, KSPLIT,
                              smem, base, stream);
  switch (MW) {
    case 1:
      return launch_mw<W, 1, 1>(gx, wp, lengths, hbuf, out, count, B, T_, H, NU, KR, NS, KSPLIT,
                                smem, base, stream);
    case 2:
      return launch_mw<W, 2, 1>(gx, wp, lengths, hbuf, out, count, B, T_, H, NU, KR, NS, KSPLIT,
                                smem, base, stream);
    default:
      return launch_mw<W, MW_MAX, 1>(gx, wp, lengths, hbuf, out, count, B, T_, H, NU, KR, NS,
                                     KSPLIT, smem, base, stream);
  }
}

}  // namespace

// The plan's fields from ops/blstm.py::gx_plan: NU units a block, KR
// resident rows of W_h's slice, NS chunks in flight, MW m16 tiles by NW
// 16-column groups a warp, KSPLIT k slices, the shared-memory bytes (a plan that disagrees with the
// kernel's layout is refused before the launch). wp is W_h packed by
// ops/blstm.py::gx_pack; hbuf (2, 2, H / KC, B, KC) scratch in the compute
// type; count the two directions' barrier counters (LINE apart) and base
// their value before this launch, which adds T x H / NU to each.
extern "C" int blstm_gx_grid(const void* gx, const void* wp, const void* lengths, void* hbuf,
                             void* out, void* count, int B, int T, int H, int NU, int KR, int NS,
                             int MW, int NW, int KSPLIT, int smem, unsigned base, int bf16,
                             void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* g = static_cast<const float*>(gx);
  const auto* l = static_cast<const int*>(lengths);
  auto* n = static_cast<unsigned*>(count);
  if (bf16)
    return (int)launch(g, static_cast<const __nv_bfloat16*>(wp), l,
                       static_cast<__nv_bfloat16*>(hbuf), static_cast<__nv_bfloat16*>(out), n, B,
                       T, H, NU, KR, NS, MW, NW, KSPLIT, (size_t)smem, base, s);
  return (int)launch(g, static_cast<const float*>(wp), l, static_cast<float*>(hbuf),
                     static_cast<float*>(out), n, B, T, H, NU, KR, NS, MW, NW, KSPLIT,
                     (size_t)smem, base, s);
}
