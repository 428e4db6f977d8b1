// RNNLM beam step for shallow fusion on a co-resident grid: the "tile"
// route of ops/lm_step.py::lm_step.
//
// Replaces robust_e2e_gan_tpu/ops/lm_step_pallas.py::lm_step_fused (:104,
// pallas_call :180, body _kernel :38) wherever ops/lm_step.py::tile_plan
// fits; csrc/lm_step.cu (route "lane", 8 lanes a block through the whole
// step) takes the other shapes. The contract and the rounding points are
// those of the plain version (ops/lm_step.py::lm_step_plain):
//   x_0      = emb[clamp(tok, 0, V - 1)]                (table rows, in T)
//   gates_l  = [x_l | T(h_in[l])] @ [Wx_l; Wh_l] + bias_l
//   c'       = sigmoid(f) * c + sigmoid(i) * tanh(g);  h' = sigmoid(o) * tanh(c')
//   x_{l+1}  = T(h'_l)
//   logits   = x_L @ Wout + bout
// in the order i, f, g, o, with T() the rounding to the compute type (float
// or bfloat16), float32 carries and sums, float32 logits. The gate product
// is one sum over the D = D_x + H rows, where the plain version adds the
// input and the recurrent products: the same terms in another order.
//
// What bounds it on Hopper: at the clean decode's LM (N = 1,024 lanes,
// E = 128, H = 256, V = 52, one layer, float32) a step is ~0.83 GFLOP of
// float32 products, ~12 us at the CUDA cores' float32 peak; its 1.6 MB of
// weights stay in L2. The TPU kernel holds every weight in VMEM once for
// all N lanes; csrc/lm_step.cu reads them again in each of its 128 blocks
// (~200 MB of L2 reads a step). As measured (PERF.md, row 11;
// tools/lm_step_phases.py; NVIDIA H100 80GB HBM3), this kernel takes ~0.031
// ms there, ~55% of it in the 3xTF32 products: ~2.3 k cycles a chunk for
// its 768 mma.sync an SM and the operands' splits (integer operations on
// the bits), under which the chunk's copies (24 KB an SM) run; the cell,
// the barrier with Wout's staging and the readout take ~13%, ~6% and ~14%.
//
// Design: one cooperative launch (a grid that cannot be co-resident is
// refused; at most one block an SM), L + 1 phases separated by L grid
// barriers (common.cuh's generation counter).
// 1. Layer l: the gate product over all N lanes, in tiles of TM = 64 lanes
//    by the 4 TU = 128 gate columns of TU = 32 hidden units (the four gates
//    of a unit in one tile, so the cell stays in the block), tile t = i,
//    i + grid, ... Each weight element is read once a lane tile. The
//    reduction rows are [x_l | T(h_in[l])]: layer 0's x the embedding rows,
//    copied straight from the table; a deeper layer's x the T(h') of layer
//    l - 1, from a global scratch written before the barrier (copies that
//    bypass L1). Chunks of KC rows of the lanes' rows and of [Wx; Wh]'s
//    tile columns go into shared memory by cp.async, NS chunks in flight,
//    zero-filled past N, D and H. bfloat16 multiplies on the tensor cores
//    (mma.sync m16n8k16, ldmatrix and ldmatrix.trans); float32 as 3xTF32
//    on the tensor cores (mma.sync m16n8k8 tf32): each operand x split into
//    hi = tf32(x) and lo = tf32(x - hi), and lo hi + hi lo + hi hi summed
//    in float32, which keeps the products at float32 accuracy (TF32 alone
//    stays off). 8 warps as 2 x 4 tiles of 32 lanes by 32 columns (WM x 4
//    warps, MT m16 tiles each).
// 2. The sums meet in a shared (TM, 4 TU) float32 tile; the cell adds the
//    bias and writes h_out[l], c_out[l] and T(h') to the scratch (two
//    buffers by layer parity: layer l + 1 reads layer l's while it writes
//    its own).
// 3. After the last barrier, block i takes lane groups i, i + grid, ...:
//    the readout of RL lanes. Wout is staged in shared memory once, between
//    the last barrier's arrive and its wait (it needs no other block's
//    work); bfloat16 on the tensor cores (a warp a 16-column pair and a
//    slice of the rows, the slices summed in a fixed order), float32 on the
//    CUDA cores (a thread a (slice of the rows, token) for the RL lanes,
//    the slices summed in a fixed order).
// The partition is fixed and every sum runs in a fixed order, so reruns are
// bit-identical. The barrier counter is never reset: the wrapper passes its
// value before the launch (`base`), and each launch adds L x grid.

#include "common.cuh"

#include <type_traits>

// clock64() marks for robust_e2e_gan_torch/tools/lm_step_phases.py, which
// defines them; empty in the library build.
#ifndef LM_PHASE_BEGIN
#define LM_PHASE_BEGIN
#define LM_PHASE(n)
#define LM_PHASE_END
#endif

namespace {

using bf16 = __nv_bfloat16;

constexpr int NT = 256;     // threads of a block: 8 warps
constexpr int TM = 64;      // lanes of a tile
constexpr int TU = 32;      // hidden units of a tile
constexpr int TN = 4 * TU;  // its gate columns: i, f, g, o of each unit
// the warps' tiles of a gate tile: WM x 4 warps, each MT m16 tiles of lanes
// by 32 columns
constexpr int WM = NT / 32 / 4;
constexpr int MT = TM / 16 / WM;
constexpr int WS = TN + 8;  // elements between the rows of a W buffer
constexpr int GS = TN + 4;  // floats between the rows of the gates tile
constexpr int NS = 4;       // chunks in flight (buffers)

template <typename T> constexpr bool kB16 = std::is_same<T, bf16>::value;
// rows of [x | h] and of [Wx; Wh] a chunk, by compute type
template <typename T> constexpr int kChunk = kB16<T> ? 64 : 32;
// elements of a 16-byte copy
template <typename T> constexpr int kPiece = 16 / (int)sizeof(T);
// lanes of a readout group: one m16 tile in bfloat16
template <typename T> constexpr int kReadLanes = kB16<T> ? 16 : 8;

__host__ __device__ inline size_t r16(size_t x) { return (x + 15) & ~size_t(15); }
__host__ __device__ inline int r16e(int x) { return (x + 15) / 16 * 16; }
__host__ __device__ inline size_t max3(size_t a, size_t b, size_t c) {
  const size_t m = a > b ? a : b;
  return m > c ? m : c;
}

// Byte offsets of the dynamic shared memory (ops/lm_step.py::tile_smem
// computes the same total). The gate product: NS A buffers of TM lane rows
// of KC + piece elements from 0, then NS W buffers of KC rows of WS
// elements from w0 (rows 16 and 16-32 bytes longer than their data: the
// eight rows ldmatrix reads at once, and the float32 B fragments' four
// rows, fall on distinct banks); the (TM, GS) float32 gates tile over them
// once a tile's chunks are read. The readout, over them too once the
// block's last tile is done: the lanes' rows from 0, Wout's copy from wout,
// the partial sums from part, each part rounded up to 16 bytes:
//   bfloat16: the lanes as (16, Hp + 8), Wout as (Hp, Vp + 8), H and V
//     rounded up to 16 (Hp, Vp) and zero past them, then 16 max(NT / 2, Vp)
//     float32 partial sums;
//   float32: the lanes as (8, H), Wout as (H, V), then 8 NT float32
//     partial sums.
struct Layout {
  size_t a_buf, w_buf, w0, wout, part, total;
};

__host__ __device__ inline Layout lm_layout(int H, int V, int isz) {
  const int kc = isz == 2 ? 64 : 32, piece = 16 / isz;
  Layout L;
  L.a_buf = (size_t)TM * (kc + piece) * isz;
  L.w_buf = (size_t)kc * WS * isz;
  L.w0 = NS * L.a_buf;
  size_t read_end;
  if (isz == 2) {
    const size_t hp = r16e(H), vp = r16e(V);
    L.wout = r16(16 * (hp + 8) * 2);
    L.part = L.wout + r16(hp * (vp + 8) * 2);
    read_end = L.part + 4 * 16 * (vp > NT / 2 ? vp : NT / 2);
  } else {
    L.wout = r16((size_t)8 * H * 4);
    L.part = L.wout + r16((size_t)H * V * 4);
    read_end = L.part + 4 * 8 * NT;
  }
  L.total = max3(NS * (L.a_buf + L.w_buf), (size_t)TM * GS * 4, read_end);
  return L;
}

__device__ __forceinline__ void zero16(void* dst) {
  *reinterpret_cast<uint4*>(dst) = make_uint4(0u, 0u, 0u, 0u);
}

// One chunk of a tile's products: warp (wm, wn) adds the chunk's KC rows of
// its lanes 16 MT wm .. 16 MT (wm + 1) - 1 (as, (TM, AS)) times its columns
// 32 wn .. 32 wn + 31 (ws, (KC, WS)) into acc[m16 tile][n8 tile].
template <typename T>
__device__ __forceinline__ void chunk_products(float (&acc)[MT][4][4], const T* as,
                                               const T* ws, int wm, int wn, int lane) {
  constexpr int KC = kChunk<T>, AS = KC + kPiece<T>;
  if constexpr (kB16<T>) {
#pragma unroll
    for (int ks = 0; ks < KC / 16; ++ks) {
      uint32_t af[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
        rg::ldsm_x4(af[mt], as + ((wm * MT + mt) * 16 + lane % 16) * AS + ks * 16 + (lane / 16) * 8);
#pragma unroll
      for (int j2 = 0; j2 < 2; ++j2) {
        uint32_t bw[4];
        rg::ldsm_x4_trans(bw, ws + (ks * 16 + lane % 16) * WS + wn * 32 + j2 * 16 +
                                  (lane / 16) * 8);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          rg::mma16816(acc[mt][2 * j2], af[mt], bw[0], bw[1]);
          rg::mma16816(acc[mt][2 * j2 + 1], af[mt], bw[2], bw[3]);
        }
      }
    }
  } else {
    const int gq = lane / 4, tq = lane % 4;
#pragma unroll
    for (int ks = 0; ks < KC / 8; ++ks) {
      // A: ldmatrix on 32-bit elements gives the tf32 fragment (a0: row g,
      // col t; a1: row g + 8; a2, a3: col t + 4)
      uint32_t ah[MT][4], al[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        uint32_t r[4];
        rg::ldsm_x4(r, reinterpret_cast<const bf16*>(
                           as + ((wm * MT + mt) * 16 + lane % 16) * AS + ks * 8 + (lane / 16) * 4));
#pragma unroll
        for (int i = 0; i < 4; ++i) rg::split_tf32(__uint_as_float(r[i]), ah[mt][i], al[mt][i]);
      }
      // B: b0 row t, b1 row t + 4, column g
      uint32_t bh[4][2], bl[4][2];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float* wp = ws + (ks * 8 + tq) * WS + wn * 32 + j * 8 + gq;
        rg::split_tf32(wp[0], bh[j][0], bl[j][0]);
        rg::split_tf32(wp[4 * WS], bh[j][1], bl[j][1]);
      }
      // lo hi, hi lo, then hi hi: each a pass over the eight accumulators,
      // so that an accumulator's three products are eight apart
#pragma unroll
      for (int j = 0; j < 4; ++j) {
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) rg::mma1688(acc[mt][j], al[mt], bh[j][0], bh[j][1]);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) rg::mma1688(acc[mt][j], ah[mt], bl[j][0], bl[j][1]);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) rg::mma1688(acc[mt][j], ah[mt], bh[j][0], bh[j][1]);
      }
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(NT, 1)
lm_step_tile_kernel(const int* __restrict__ tok,      // (N,)
                    const T* __restrict__ emb,        // (V, E)
                    const T* __restrict__ wx0,        // (E, 4H)
                    const T* __restrict__ wxs,        // (L-1, H, 4H)
                    const T* __restrict__ whs,        // (L, H, 4H)
                    const float* __restrict__ bias,   // (L, 4H)
                    const T* __restrict__ wout,       // (H, V)
                    const float* __restrict__ bout,   // (V,)
                    const float* __restrict__ h_in,   // (L, N, H)
                    const float* __restrict__ c_in,   // (L, N, H)
                    float* __restrict__ h_out,        // (L, N, H)
                    float* __restrict__ c_out,        // (L, N, H)
                    float* __restrict__ logits,       // (N, V)
                    T* xs,                            // (min(L, 2), N, H) scratch
                    unsigned* count,                  // the barrier counter
                    int N, int V, int E, int H, int L, unsigned base) {
  constexpr int KC = kChunk<T>, P = kPiece<T>, AS = KC + P;
  constexpr int AP = KC / P;  // pieces a lane row of a chunk
  constexpr int WP = TU / P;  // pieces a gate's stripe of a W row
  constexpr int AQ = TM * AP / NT;  // lane pieces a thread copies a chunk
  static_assert(TM * AP % NT == 0 && WM * MT * 16 == TM, "whole pieces and tiles a thread");
  static_assert(KC * 4 * WP % NT == 0, "whole W pieces a thread");
  static_assert(NT % TU == 0 && TM * TU % NT == 0, "a cell thread keeps its unit");
  extern __shared__ __align__(16) char smem[];
  LM_PHASE_BEGIN
  const Layout Lo = lm_layout(H, V, sizeof(T));
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int wm = warp % WM, wn = warp / WM, gq = lane / 4, tq = lane % 4;
  const int grid = gridDim.x, G = 4 * H;
  const int n_lt = (N + TM - 1) / TM, n_ut = (H + TU - 1) / TU;
  auto a_s = [&](int buf) { return reinterpret_cast<T*>(smem + buf * Lo.a_buf); };
  auto w_s = [&](int buf) { return reinterpret_cast<T*>(smem + Lo.w0 + buf * Lo.w_buf); };
  float* gs = reinterpret_cast<float*>(smem);  // over the buffers, after a tile's last chunk

  // ---- the layers: gates over all lanes, tile by tile, and the cell
  for (int l = 0; l < L; ++l) {
    const int DX = l == 0 ? E : H, D = DX + H, nk = (D + KC - 1) / KC;
    const T* wx = l == 0 ? wx0 : wxs + (size_t)(l - 1) * H * G;
    const T* wh = whs + (size_t)l * H * G;
    const float* hl = h_in + (size_t)l * N * H;
    const float* cl = c_in + (size_t)l * N * H;
    const float* bl = bias + (size_t)l * G;
    T* x_next = xs + (size_t)(l & 1) * N * H;
    for (int tile = blockIdx.x; tile < n_lt * n_ut; tile += grid) {
      const int n0 = (tile % n_lt) * TM, u0 = (tile / n_lt) * TU;
      // the lanes whose pieces this thread copies, the same in every chunk:
      // their x rows (null past N) and h_in rows
      const T* xrow[AQ];
      const float* hrow[AQ];
#pragma unroll
      for (int q = 0; q < AQ; ++q) {
        const int n = n0 + tid / AP + q * (NT / AP);
        xrow[q] = nullptr;
        hrow[q] = hl + (size_t)n * H;
        if (n < N) {
          xrow[q] = l == 0 ? emb + (size_t)min(max(tok[n], 0), V - 1) * E
                           : xs + (size_t)((l - 1) & 1) * N * H + (size_t)n * H;
        }
      }
      // chunk kc of the tile's lane rows and weight columns into buffer
      // buf; zeros past N, D and H
      auto load = [&](int kc, int buf) {
        const int k = kc * KC + (tid % AP) * P;
#pragma unroll
        for (int q = 0; q < AQ; ++q) {
          T* dst = a_s(buf) + (tid / AP + q * (NT / AP)) * AS + (tid % AP) * P;
          if (xrow[q] == nullptr || k >= D) {
            zero16(dst);
          } else if (k < DX) {
            rg::cp_async16(dst, xrow[q] + k);
          } else if constexpr (!kB16<T>) {
            rg::cp_async16(dst, hrow[q] + (k - DX));
          } else {  // T(h_in): eight floats rounded to one 16-byte piece
            const float4* src = reinterpret_cast<const float4*>(hrow[q] + (k - DX));
            const float4 f0 = __ldg(src), f1 = __ldg(src + 1);
            const __nv_bfloat162 p0 = __floats2bfloat162_rn(f0.x, f0.y);
            const __nv_bfloat162 p1 = __floats2bfloat162_rn(f0.z, f0.w);
            const __nv_bfloat162 p2 = __floats2bfloat162_rn(f1.x, f1.y);
            const __nv_bfloat162 p3 = __floats2bfloat162_rn(f1.z, f1.w);
            *reinterpret_cast<uint4*>(dst) =
                make_uint4(*reinterpret_cast<const uint32_t*>(&p0),
                           *reinterpret_cast<const uint32_t*>(&p1),
                           *reinterpret_cast<const uint32_t*>(&p2),
                           *reinterpret_cast<const uint32_t*>(&p3));
          }
        }
#pragma unroll
        for (int q = 0; q < KC * 4 * WP / NT; ++q) {
          const int i = tid + q * NT;
          const int kr = i / (4 * WP), gt = i / WP % 4, p = i % WP;
          const int r = kc * KC + kr, u = u0 + p * P;
          T* dst = w_s(buf) + kr * WS + gt * TU + p * P;
          const T* src = r < DX ? wx + (size_t)r * G : wh + (size_t)(r - DX) * G;
          if (r < D && u < H)
            rg::cp_async16(dst, src + gt * H + u);
          else
            zero16(dst);
        }
      };
      float acc[MT][4][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[mt][j][0] = acc[mt][j][1] = acc[mt][j][2] = acc[mt][j][3] = 0.f;
      }
      // NS - 1 chunks ahead; a commit group an iteration, empty past nk
      for (int c0 = 0; c0 < NS - 1; ++c0) {
        if (c0 < nk) load(c0, c0);
        rg::cp_async_commit();
      }
      for (int kc = 0; kc < nk; ++kc) {
        rg::cp_async_wait<NS - 2>();
        __syncthreads();  // chunk kc has landed; chunk kc - 1's buffer is free
        LM_PHASE(0)
        if (kc + NS - 1 < nk) load(kc + NS - 1, (kc + NS - 1) % NS);
        rg::cp_async_commit();
        chunk_products<T>(acc, a_s(kc % NS), w_s(kc % NS), wm, wn, lane);
        LM_PHASE(1)
      }
      rg::cp_async_wait<0>();
      __syncthreads();  // every chunk is read: the buffers are free
      // the sums into the gates tile: rows 16 (MT wm + mt) + g (+ 8),
      // columns 32 wn + 8 j + 2 t (+ 1)
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float* o = gs + ((wm * MT + mt) * 16 + gq) * GS + wn * 32 + j * 8 + 2 * tq;
          *reinterpret_cast<float2*>(o) = make_float2(acc[mt][j][0], acc[mt][j][1]);
          *reinterpret_cast<float2*>(o + 8 * GS) = make_float2(acc[mt][j][2], acc[mt][j][3]);
        }
      }
      __syncthreads();
      // the cell: thread (lane tid / TU + j NT / TU, unit tid % TU), its
      // bias and c loads issued before any of its cells
      {
        constexpr int PASSES = TM * TU / NT;
        const int u = tid % TU, unit = u0 + u;
        float b4[4] = {0.f, 0.f, 0.f, 0.f}, cv[PASSES];
        if (unit < H) {
#pragma unroll
          for (int g = 0; g < 4; ++g) b4[g] = bl[g * H + unit];
        }
#pragma unroll
        for (int j = 0; j < PASSES; ++j) {
          const int n = n0 + tid / TU + j * (NT / TU);
          cv[j] = n < N && unit < H ? cl[(size_t)n * H + unit] : 0.f;
        }
#pragma unroll
        for (int j = 0; j < PASSES; ++j) {
          const int m = tid / TU + j * (NT / TU), n = n0 + m;
          if (n >= N || unit >= H) continue;
          const float* gr = gs + m * GS + u;
          const float gi = gr[0] + b4[0];
          const float gf = gr[TU] + b4[1];
          const float gg = gr[2 * TU] + b4[2];
          const float go = gr[3 * TU] + b4[3];
          const float cn = rg::sigmoid(gf) * cv[j] + rg::sigmoid(gi) * tanhf(gg);
          const float hn = rg::sigmoid(go) * tanhf(cn);
          const size_t o = (size_t)n * H + unit;
          h_out[(size_t)l * N * H + o] = hn;
          c_out[(size_t)l * N * H + o] = cn;
          x_next[o] = rg::from_f<T>(hn);
        }
      }
      __syncthreads();  // the gates tile is read: the next tile's copies may start
      LM_PHASE(2)
    }
    if (l < L - 1) {
      rg::grid_arrive(count);
      rg::grid_wait(count, base + (unsigned)(l + 1) * (unsigned)grid);
      LM_PHASE(3)
    }
  }

  // ---- the readout: lane groups of RL, group g = i, i + grid, ...
  constexpr int RL = kReadLanes<T>;
  const int groups = (N + RL - 1) / RL;
  const T* x_last = xs + (size_t)((L - 1) & 1) * N * H;
  T* wo_s = reinterpret_cast<T*>(smem + Lo.wout);
  const int Hp = r16e(H), Vp = r16e(V);
  const int LS = kB16<T> ? Hp + 8 : H;  // elements between staged lane rows
  const int WC = kB16<T> ? Vp + 8 : V;  // elements between staged Wout rows
  rg::grid_arrive(count);
  // Wout needs no other block's work: its copy runs before the wait
  if ((int)blockIdx.x < groups) {
    if constexpr (kB16<T>) {
      for (int i = tid; i < Hp * WC / P; i += NT) zero16(wo_s + i * P);
      __syncthreads();  // the zeros are in before the data
      for (int i = tid; i < H * V; i += NT) wo_s[i / V * WC + i % V] = wout[i];
    } else {
      const int nv = H * V / 4;
      const float4* src = reinterpret_cast<const float4*>(wout);
#pragma unroll 4
      for (int i = tid; i < nv; i += NT) reinterpret_cast<float4*>(wo_s)[i] = __ldg(src + i);
      for (int i = nv * 4 + tid; i < H * V; i += NT) wo_s[i] = wout[i];
    }
  }
  rg::grid_wait(count, base + (unsigned)L * (unsigned)grid);
  LM_PHASE(4)
  T* l_s = reinterpret_cast<T*>(smem);
  for (int g = blockIdx.x; g < groups; g += grid) {
    const int n0 = g * RL;
    // the group's lane rows T(h'_L), written by other blocks before the
    // barrier: 16-byte loads past L1, zeros past N (and past H in bfloat16)
    for (int i = tid; i < RL * LS / P; i += NT) {
      const int r = i / (LS / P), k = i % (LS / P) * P, n = n0 + r;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (n < N && k < H) v = __ldcg(reinterpret_cast<const uint4*>(x_last + (size_t)n * H + k));
      *reinterpret_cast<uint4*>(l_s + r * LS + k) = v;
    }
    __syncthreads();  // the lanes' rows (and Wout's copy) are staged
    LM_PHASE(5)
    if constexpr (kB16<T>) {
      // (column pair, slice) work items over the warps; the slices' sums
      // in part, then added in order
      float* part = reinterpret_cast<float*>(smem + Lo.part);
      const int npairs = Vp / 16, nks = Hp / 16;
      const int splits = max(1, min(NT / 32 / npairs, nks)), KS = (nks + splits - 1) / splits;
      for (int it = warp; it < npairs * splits; it += NT / 32) {
        const int pr = it % npairs, sl = it / npairs;
        float a[2][4] = {};
        for (int ks = sl * KS; ks < min(nks, (sl + 1) * KS); ++ks) {
          uint32_t af[4], bw[4];
          rg::ldsm_x4(af, l_s + (lane % 16) * LS + ks * 16 + (lane / 16) * 8);
          rg::ldsm_x4_trans(bw, wo_s + (ks * 16 + lane % 16) * WC + pr * 16 + (lane / 16) * 8);
          rg::mma16816(a[0], af, bw[0], bw[1]);
          rg::mma16816(a[1], af, bw[2], bw[3]);
        }
#pragma unroll
        for (int j = 0; j < 2; ++j) {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            float* o = part + (size_t)(sl * 16 + gq + 8 * h) * Vp + pr * 16 + j * 8 + 2 * tq;
            o[0] = a[j][2 * h];
            o[1] = a[j][2 * h + 1];
          }
        }
      }
      __syncthreads();  // the slices' sums are in
      for (int i = tid; i < RL * V; i += NT) {
        const int r = i / V, v = i % V, n = n0 + r;
        if (n >= N) continue;
        float s = 0.f;
        for (int sl = 0; sl < splits; ++sl) s += part[(size_t)(sl * 16 + r) * Vp + v];
        logits[(size_t)n * V + v] = s + bout[v];
      }
    } else {
      // thread (slice, token v): the RL lanes' products with column v over
      // the slice's rows, four rows at a time; the slices' sums in part,
      // then added in order (one slice, where V >= NT: straight out)
      float* part = reinterpret_cast<float*>(smem + Lo.part);
      const float* xf = reinterpret_cast<const float*>(l_s);
      const float* wf = reinterpret_cast<const float*>(wo_s);
      const int splits = max(1, min(NT / V, H / 4)), J = (H / 4 + splits - 1) / splits * 4;
      for (int t = tid; t < splits * V; t += NT) {
        const int sl = t / V, v = t % V, k1 = min(H, (sl + 1) * J);
        float a[RL];
#pragma unroll
        for (int r = 0; r < RL; ++r) a[r] = 0.f;
        for (int k = sl * J; k < k1; k += 4) {
          const float w0 = wf[k * V + v], w1 = wf[(k + 1) * V + v];
          const float w2 = wf[(k + 2) * V + v], w3 = wf[(k + 3) * V + v];
#pragma unroll
          for (int r = 0; r < RL; ++r) {
            const float4 x = *reinterpret_cast<const float4*>(xf + r * H + k);
            a[r] = fmaf(x.w, w3, fmaf(x.z, w2, fmaf(x.y, w1, fmaf(x.x, w0, a[r]))));
          }
        }
#pragma unroll
        for (int r = 0; r < RL; ++r) {
          if (splits > 1)
            part[(sl * RL + r) * V + v] = a[r];
          else if (n0 + r < N)
            logits[(size_t)(n0 + r) * V + v] = a[r] + bout[v];
        }
      }
      if (splits > 1) {
        __syncthreads();  // the slices' sums are in
        for (int i = tid; i < RL * V; i += NT) {
          const int r = i / V, v = i % V, n = n0 + r;
          if (n >= N) continue;
          float s = 0.f;
          for (int sl = 0; sl < splits; ++sl) s += part[(sl * RL + r) * V + v];
          logits[(size_t)n * V + v] = s + bout[v];
        }
      }
    }
    __syncthreads();  // the lanes' rows and the sums are read
    LM_PHASE(6)
  }
  LM_PHASE_END
}

// A refused launch (a grid that cannot be co-resident) is returned to the
// wrapper, which raises; the runtime also keeps it as its last error, which
// is cleared here so that the next kernel's launch check does not read it.
cudaError_t launched(cudaError_t err) {
  if (err != cudaSuccess) cudaGetLastError();
  return err;
}

template <typename T>
cudaError_t launch(const void* const* p, float* h_out, float* c_out, float* logits, void* xs_v,
                   unsigned* count, int N, int V, int E, int H, int L, int KC, int ns, int grid,
                   size_t smem, unsigned base, cudaStream_t stream) {
  constexpr int P = kPiece<T>;
  // the pointers read in 16-byte pieces: emb, wx0, wxs, whs, wout, h_in, xs
  const void* pieces[] = {p[1], p[2], p[3], p[4], p[6], p[8], xs_v};
  uintptr_t any = 0;
  for (const void* q : pieces) any |= reinterpret_cast<uintptr_t>(q);
  if (KC != kChunk<T> || ns != NS || E % P || H % P || grid < 1 || (any & 15) ||
      lm_layout(H, V, sizeof(T)).total != smem)
    return cudaErrorInvalidValue;
  const cudaError_t err = rg::reserve_smem<lm_step_tile_kernel<T>>(smem);
  if (err != cudaSuccess) return launched(err);
  const int* tok = static_cast<const int*>(p[0]);
  const T* emb = static_cast<const T*>(p[1]);
  const T* wx0 = static_cast<const T*>(p[2]);
  const T* wxs = static_cast<const T*>(p[3]);
  const T* whs = static_cast<const T*>(p[4]);
  const float* bias = static_cast<const float*>(p[5]);
  const T* wout = static_cast<const T*>(p[6]);
  const float* bout = static_cast<const float*>(p[7]);
  const float* h_in = static_cast<const float*>(p[8]);
  const float* c_in = static_cast<const float*>(p[9]);
  T* xs = static_cast<T*>(xs_v);
  void* args[] = {&tok,  &emb,   &wx0,    &wxs, &whs,   &bias, &wout, &bout, &h_in,
                  &c_in, &h_out, &c_out, &logits, &xs, &count, &N,    &V,    &E,
                  &H,    &L,     &base};
  return launched(cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(lm_step_tile_kernel<T>), dim3(grid), dim3(NT), args, smem,
      stream));
}

}  // namespace

// KC rows a chunk, NS chunks in flight, the grid and the shared-memory bytes
// from ops/lm_step.py::tile_plan: a plan that disagrees with the kernel's
// constants or layout is refused before the launch. xs (min(L, 2), N, H) is
// scratch in the compute type; count is the barrier counter and base its
// value before this launch, which adds L x grid to it.
extern "C" int lm_step_tile(const void* tok, const void* emb, const void* wx0, const void* wxs,
                            const void* whs, const void* bias, const void* wout,
                            const void* bout, const void* h_in, const void* c_in, void* h_out,
                            void* c_out, void* logits, void* xs, void* count, int N, int V,
                            int E, int H, int L, int KC, int ns, int grid, int smem,
                            unsigned base, int bf16, void* stream) {
  if (N < 1 || V < 1 || E < 1 || H < 1 || L < 1) return (int)cudaErrorInvalidValue;
  const void* in[] = {tok, emb, wx0, wxs, whs, bias, wout, bout, h_in, c_in};
  const auto s = static_cast<cudaStream_t>(stream);
  auto* ho = static_cast<float*>(h_out);
  auto* co = static_cast<float*>(c_out);
  auto* lg = static_cast<float*>(logits);
  auto* n = static_cast<unsigned*>(count);
  if (bf16)
    return (int)launch<__nv_bfloat16>(in, ho, co, lg, xs, n, N, V, E, H, L, KC, ns, grid,
                                      (size_t)smem, base, s);
  return (int)launch<float>(in, ho, co, lg, xs, n, N, V, E, H, L, KC, ns, grid, (size_t)smem,
                            base, s);
}
