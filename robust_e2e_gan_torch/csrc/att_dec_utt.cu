// One beam step of the attention decoder in one cooperative launch: the
// "utt" route of ops/att_dec.py::att_dec_step.
//
// Replaces robust_e2e_gan_tpu/ops/att_pallas.py::att_dec_step_fused (:416,
// pallas_call :530, body _kernel_step :296) wherever ops/att_dec.py::utt_plan
// fits; csrc/att_dec.cu (route "hyp", one block an utterance for the whole
// step) takes the other shapes. The contract and the rounding points are
// att_dec.cu's and the plain version's (ops/att_dec.py::att_dec_step_plain):
//   ctx, att = the attention step of att_utt_body.cuh
//   gates    = ([emb[tok] | T(ctx) | T(z)] @ [Wx; Wh]) + bias
//   c'       = sigmoid(f) * c + sigmoid(i) * tanh(g);  z' = sigmoid(o) * tanh(c')
//   logits   = (T(z') @ Wout[:H] + T(ctx) @ Wout[H:]) + bout
// in the order i, f, g, o, with T() the rounding to the compute type (float
// or bfloat16), products of T operands and float32 sums. The gate product
// is one sum over the D = EMB + E + H rows, where the plain version adds
// gx and gh: the same terms in another order.
//
// What bounds it on Hopper, as measured (PERF.md, row 5;
// tools/att_dec_phases.py; NVIDIA H100 80GB HBM3). At the flagship's decode
// shapes (B = 128, K = 8, T = 174, A = E = EMB = H = 256, V = 52, bfloat16;
// 0.119 ms a launch) the attention takes ~72% of the cycles: it is
// att_loc_utt.cu's step, issue-bound on its accurate tanhf. The gate
// product takes ~15%: 1.6 GFLOP, ~2 us at the tensor cores' peak, under
// its copies, 24 KB an SM a chunk from L2, whose cp.async issue holds the
// warps about as long as the copy takes. The two barriers, the readout
// and its staging take the rest. At the decode CLI's float32 model (A = E
// = EMB = H = 512, V = 12, T = 30; 0.359 ms) the gate product takes ~66%:
// 6.4 GFLOP on the CUDA cores (TF32 stays off), at about half their FMA
// issue rate beside the copies' issue.
//
// Design: three phases separated by two grid barriers (common.cuh's
// generation counter; the launch is cooperative, so a grid that cannot be
// co-resident is refused, and the grid is at most one block per SM).
// A. Block i runs utterances b = i, i + grid, ...: the attention exactly as
//    att_loc_utt.cu (att_utt_body), and the K lanes' cell inputs
//    [emb[tok] | T(ctx) | T(z)] (zero-padded to Dp, a multiple of the
//    chunk) in a global scratch xin (B K, Dp) in T.
// B. The gate product over all N = B K lanes, in tiles of TM = 64 lanes by
//    the 4 TU = 128 gate columns of TU = 32 hidden units (the four gates of
//    a unit in one tile), tile t = i, i + grid, ... Each weight element is
//    read once a lane tile. Chunks of KC rows of [Wx; Wh] and of the lanes'
//    rows are copied into shared memory by cp.async, NS chunks in flight;
//    bfloat16 multiplies on the tensor cores (mma.sync m16n8k16, 16 warps
//    as 4 x 4 tiles of 16 lanes by 32 columns, ldmatrix and ldmatrix.trans),
//    float32 on the CUDA cores (8 warps, a thread 8 lanes by 4 columns in
//    registers). The sums meet in a shared (TM, 4 TU) tile, and the cell
//    writes z', c' and T(z') (a second scratch zq (B K, H)).
// C. Block i again takes utterances i, i + grid, ...: the readout of its K
//    lanes. Wout is staged in shared memory in chunks of VC columns (once,
//    where VC = V, between the second barrier's arrive and its wait: it
//    needs no other block's work), then the lanes' [T(z') | T(ctx)] rows;
//    the products are summed over slices of the rows, the z' and the
//    context rows apart, then the slices in a fixed order: bfloat16 on
//    the tensor cores (a warp a 16-column pair and slice), float32 on the
//    CUDA cores (a thread a column and slice).
// The partition is fixed and every sum runs in a fixed order, so reruns
// are bit-identical. The barrier counter is never reset: the wrapper passes
// its value before the launch (`base`), and each launch adds 2 x grid.

#include "att_utt_body.cuh"

// clock64() marks for robust_e2e_gan_torch/tools/att_dec_phases.py, which
// defines them; empty in the library build.
#ifndef DEC_PHASE_BEGIN
#define DEC_PHASE_BEGIN
#define DEC_PHASE(n)
#define DEC_PHASE_END
#endif

namespace {

constexpr int TM = 64;       // lanes of a gate-product tile
constexpr int TU = 32;       // hidden units of a tile
constexpr int TN = 4 * TU;   // its gate columns: i, f, g, o of each unit
constexpr int GS = TN + 4;   // floats between the rows of the shared gates tile
constexpr int NS = 4;        // chunks in flight (buffers) in the gate product

// rows of [Wx; Wh] and of the lane rows a chunk, by compute type
template <typename T> constexpr int kChunk = std::is_same<T, bf16>::value ? 64 : 32;
// elements of a 16-byte copy
template <typename T> constexpr int kPiece = 16 / (int)sizeof(T);

__host__ __device__ inline size_t max3(size_t a, size_t b, size_t c) {
  const size_t m = a > b ? a : b;
  return m > c ? m : c;
}

// Byte offsets of the dynamic shared memory (ops/att_dec.py::utt_smem
// computes the same total). Phase A takes att_loc_utt.cu's layout; phase
// B NS A buffers of TM lane rows of KC + piece elements and NS W buffers
// of KC rows of TN + piece elements (rows 16 bytes longer than their data,
// so that ldmatrix reads eight rows on distinct banks), then, over them,
// the (TM, GS) float32 gates tile; phase C the lanes' [T(z') | T(ctx)]
// rows, a chunk of Wout's columns and the float32 partial sums (2,
// splits, K, columns), each part rounded up to 16 bytes:
//   bfloat16 (the products on the tensor cores): [T(z') | 0 | T(ctx) | 0]
//     as (16, KW + 8) with KW = Hp + Ep, H and E rounded up to 16, then
//     the chunk as (KW, Vp + 8), VC rounded up to 16 (Vp), in bfloat16,
//     zero past its data; at most 2 K 16 max(16 warps, Vp / 16) sums;
//   float32: (K, HEp), HEp = H + E rounded up to 4, then (HEp, VC), zero
//     past H + E; at most 2 K max(threads, VC) sums.
struct DecLayout {
  size_t a_buf, w_buf, w0, lanes, wout, part, total;
};

__host__ __device__ inline int r16e(int x) { return (x + 15) / 16 * 16; }

__host__ __device__ inline DecLayout dec_layout(int K, int Tn, int C, int A, int E, int H,
                                                int F, int S, int VC, int isz) {
  const int kc = isz == 2 ? 64 : 32, piece = 16 / isz, nt = isz == 2 ? 512 : 256;
  const size_t hep = (size_t)(H + E + 3) / 4 * 4;
  DecLayout L;
  L.a_buf = (size_t)TM * (kc + piece) * isz;
  L.w_buf = (size_t)kc * (TN + piece) * isz;
  L.w0 = NS * L.a_buf;
  const size_t b_end = NS * (L.a_buf + L.w_buf), gates_end = (size_t)TM * GS * 4;
  L.lanes = 0;
  size_t part;
  if (isz == 2) {
    const size_t kw = r16e(H) + r16e(E), vp = r16e(VC);
    L.wout = r16(16 * (kw + 8) * 2);
    L.part = L.wout + r16(kw * (vp + 8) * 2);
    part = (size_t)2 * K * 16 * (vp / 16 > 16 ? vp / 16 : 16) * 4;
  } else {
    L.wout = r16((size_t)K * hep * 4);
    L.part = L.wout + r16(hep * VC * 4);
    part = (size_t)2 * K * (nt > VC ? nt : VC) * 4;
  }
  const size_t c_end = L.part + part;
  const size_t b_or_c = max3(b_end, gates_end, c_end);
  const size_t a_end = layout(K, Tn, C, A, E, F, S, isz).total;
  L.total = a_end > b_or_c ? a_end : b_or_c;
  return L;
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void zero16(void* dst) {
  *reinterpret_cast<uint4*>(dst) = make_uint4(0u, 0u, 0u, 0u);
}

// Thread (sl, v) of the float32 readout: the products of rows [j0, j1) of
// the lanes' [z' | ctx] (l_s, (K, HEp)) with column v of the Wout chunk
// (w_s, (HEp, vn)), four rows at a time, the z' rows (below H) and the
// context rows summed apart into part, for KR >= K lanes.
template <int KR>
__device__ __forceinline__ void readout_f32(const float* l_s, const float* w_s, float* part,
                                            int K, int H, int HEp, int vn, int splits, int sl,
                                            int v, int j0, int j1) {
  float pz[KR], pc[KR];
#pragma unroll
  for (int r = 0; r < KR; ++r) pz[r] = pc[r] = 0.f;
  auto rows = [&](float(&p)[KR], int ja, int jb) {
    for (int j = ja; j < jb; j += 4) {
      const float w0 = w_s[j * vn + v], w1 = w_s[(j + 1) * vn + v];
      const float w2 = w_s[(j + 2) * vn + v], w3 = w_s[(j + 3) * vn + v];
#pragma unroll
      for (int r = 0; r < KR; ++r) {
        if (r < K) {
          const float4 x = *reinterpret_cast<const float4*>(l_s + r * HEp + j);
          p[r] = fmaf(x.w, w3, fmaf(x.z, w2, fmaf(x.y, w1, fmaf(x.x, w0, p[r]))));
        }
      }
    }
  };
  rows(pz, j0, min(j1, H));
  rows(pc, max(j0, H), j1);
#pragma unroll
  for (int r = 0; r < KR; ++r) {
    if (r < K) {
      part[((size_t)sl * K + r) * vn + v] = pz[r];
      part[((size_t)(splits + sl) * K + r) * vn + v] = pc[r];
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads<T>, 1)
att_dec_utt_kernel(const T* __restrict__ feat,      // (B, K, Tn, C)
                   const T* __restrict__ enc_proj,  // (B, Tn, A)
                   const T* __restrict__ enc,       // (B, Tn, E)
                   const T* __restrict__ dec,       // (B, K, A)
                   const T* __restrict__ wloc,      // (C, A)
                   const T* __restrict__ g,         // (A,)
                   const float* __restrict__ mask,  // (B, Tn)
                   const int* __restrict__ tok,     // (B, K)
                   const T* __restrict__ emb,       // (V, EMB)
                   const T* __restrict__ wx,        // (EMB + E, 4H)
                   const T* __restrict__ wh,        // (H, 4H)
                   const float* __restrict__ bias,  // (4H,)
                   const T* __restrict__ wout,      // (H + E, V)
                   const float* __restrict__ bout,  // (V,)
                   const float* __restrict__ z_in,  // (B, K, H)
                   const float* __restrict__ c_in,  // (B, K, H)
                   float* __restrict__ logits,      // (B, K, V)
                   float* __restrict__ att,         // (B, K, Tn)
                   float* __restrict__ z_out,       // (B, K, H)
                   float* __restrict__ c_out,       // (B, K, H)
                   T* xin,                          // (B K, Dp) scratch
                   T* zq,                           // (B K, H) scratch
                   unsigned* count,                 // the barrier counter
                   int B, int K, int Tn, int C, int A, int E, int V, int EMB, int H, int F,
                   int S, int VC, unsigned base, float sharpening) {
  constexpr bool kB16 = std::is_same<T, bf16>::value;
  constexpr int NT = kThreads<T>;
  constexpr int KC = kChunk<T>, P = kPiece<T>;
  constexpr int AS = KC + P, WS = TN + P;  // elements between rows of the A and W buffers
  extern __shared__ __align__(16) char smem[];
  DEC_PHASE_BEGIN
  const DecLayout L = dec_layout(K, Tn, C, A, E, H, F, S, VC, sizeof(T));
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int grid = gridDim.x;
  const int DX = EMB + E, D = DX + H, Dp = (D + KC - 1) / KC * KC, G = 4 * H;
  const int N = B * K;

  // ---- A: the attention, an utterance at a time, and the lanes' rows
  for (int b = blockIdx.x; b < B; b += grid) {
    if (b != (int)blockIdx.x) __syncthreads();  // the last utterance's shared reads are done
    // the embedding, recurrent and pad columns; the body writes the context's
    const int W = Dp - E;
    for (int i = tid; i < K * W; i += NT) {
      const int r = i / W, j0 = i % W, j = j0 < EMB ? j0 : j0 + E;
      const size_t n = (size_t)b * K + r;
      T v;
      if (j < EMB) {
        const int t = min(max(tok[n], 0), V - 1);
        v = emb[(size_t)t * EMB + j];
      } else {
        v = rg::from_f<T>(j < D ? z_in[n * H + (j - DX)] : 0.f);
      }
      xin[n * Dp + j] = v;
    }
    T* ctx_rows = xin + (size_t)b * K * Dp + EMB;
    att_utt_body<T>(feat, enc_proj, enc, dec, wloc, g, mask, att, b, K, Tn, C, A, E, F, S,
                    sharpening, smem, [=](int i, float v) {
                      ctx_rows[(size_t)(i / E) * Dp + i % E] = rg::from_f<T>(v);
                    });
  }
  DEC_PHASE(0)
  rg::grid_arrive(count);
  rg::grid_wait(count, base + (unsigned)grid);
  DEC_PHASE(1)

  // ---- B: gates over all lanes, tile by tile, and the cell
  {
    const int n_lt = (N + TM - 1) / TM, n_ut = (H + TU - 1) / TU, nk = Dp / KC;
    auto a_s = [&](int buf) { return reinterpret_cast<T*>(smem + buf * L.a_buf); };
    auto w_s = [&](int buf) { return reinterpret_cast<T*>(smem + L.w0 + buf * L.w_buf); };
    float* gs = reinterpret_cast<float*>(smem);  // over the buffers, after the last chunk
    for (int tile = blockIdx.x; tile < n_lt * n_ut; tile += grid) {
      const int n0 = (tile % n_lt) * TM, u0 = (tile / n_lt) * TU;
      // chunk kc of the tile's lane rows and weight columns into buffer buf;
      // zeros past N, D and H
      auto load = [&](int kc, int buf) {
        const int k0 = kc * KC;
        constexpr int AP = KC / P;  // pieces a lane row
        for (int i = tid; i < TM * AP; i += NT) {
          const int m = i / AP, p = i % AP;
          T* dst = a_s(buf) + m * AS + p * P;
          if (n0 + m < N)
            cp_async16(dst, xin + (size_t)(n0 + m) * Dp + k0 + p * P);
          else
            zero16(dst);
        }
        constexpr int WP = TU / P;  // pieces a gate's stripe of a row
        for (int i = tid; i < KC * 4 * WP; i += NT) {
          const int kr = i / (4 * WP), gt = i / WP % 4, p = i % WP;
          const int r = k0 + kr, u = u0 + p * P;
          T* dst = w_s(buf) + kr * WS + gt * TU + p * P;
          const T* src = r < DX ? wx + (size_t)r * G : wh + (size_t)(r - DX) * G;
          if (r < D && u < H)
            cp_async16(dst, src + gt * H + u);
          else
            zero16(dst);
        }
      };
      float acc[kB16 ? 4 : 8][4];
#pragma unroll
      for (int j = 0; j < (kB16 ? 4 : 8); ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
      // NS - 1 chunks ahead; a commit group an iteration, empty past nk
      for (int c0 = 0; c0 < NS - 1; ++c0) {
        if (c0 < nk) load(c0, c0);
        cp_async_commit();
      }
      for (int kc = 0; kc < nk; ++kc) {
        cp_async_wait<NS - 2>();
        __syncthreads();  // chunk kc has landed; chunk kc - 1's buffer is free
        DEC_PHASE(5)
        if (kc + NS - 1 < nk) load(kc + NS - 1, (kc + NS - 1) % NS);
        cp_async_commit();
        const T* as = a_s(kc % NS);
        const T* ws = w_s(kc % NS);
        if constexpr (kB16) {
          // warp (wm, wn): lanes 16 wm .. 16 wm + 15, columns 32 wn .. 32 wn + 31
          const int wm = warp & 3, wn = warp >> 2;
#pragma unroll
          for (int ks = 0; ks < KC / 16; ++ks) {
            uint32_t af[4];
            rg::ldsm_x4(af, as + (wm * 16 + lane % 16) * AS + ks * 16 + (lane / 16) * 8);
#pragma unroll
            for (int j2 = 0; j2 < 2; ++j2) {
              uint32_t bw[4];
              rg::ldsm_x4_trans(bw, ws + (ks * 16 + lane % 16) * WS + wn * 32 + j2 * 16 +
                                        (lane / 16) * 8);
              rg::mma16816(acc[2 * j2], af, bw[0], bw[1]);
              rg::mma16816(acc[2 * j2 + 1], af, bw[2], bw[3]);
            }
          }
        } else {
          // thread (warp, lane): lanes 8 warp .. 8 warp + 7, columns 4 lane .. 4 lane + 3
#pragma unroll 2
          for (int k = 0; k < KC; k += 4) {
            float4 a4[8];
#pragma unroll
            for (int r = 0; r < 8; ++r)
              a4[r] = *reinterpret_cast<const float4*>(as + (warp * 8 + r) * AS + k);
#pragma unroll
            for (int kk = 0; kk < 4; ++kk) {
              const float4 w = *reinterpret_cast<const float4*>(ws + (k + kk) * WS + lane * 4);
#pragma unroll
              for (int r = 0; r < 8; ++r) {
                const float x = kk == 0 ? a4[r].x : kk == 1 ? a4[r].y : kk == 2 ? a4[r].z : a4[r].w;
                acc[r][0] = fmaf(x, w.x, acc[r][0]);
                acc[r][1] = fmaf(x, w.y, acc[r][1]);
                acc[r][2] = fmaf(x, w.z, acc[r][2]);
                acc[r][3] = fmaf(x, w.w, acc[r][3]);
              }
            }
          }
        }
        DEC_PHASE(6)
      }
      cp_async_wait<0>();
      __syncthreads();  // every chunk is read: the buffers are free
      // the sums into the gates tile (over the buffers, which are free)
      if constexpr (kB16) {
        const int wm = warp & 3, wn = warp >> 2, gq = lane / 4, tq = lane % 4;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float* o = gs + (wm * 16 + gq) * GS + wn * 32 + j * 8 + 2 * tq;
          *reinterpret_cast<float2*>(o) = make_float2(acc[j][0], acc[j][1]);
          *reinterpret_cast<float2*>(o + 8 * GS) = make_float2(acc[j][2], acc[j][3]);
        }
      } else {
#pragma unroll
        for (int r = 0; r < 8; ++r)
          *reinterpret_cast<float4*>(gs + (warp * 8 + r) * GS + lane * 4) =
              make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
      }
      __syncthreads();
      // the cell: a (lane, unit) a thread
      for (int i = tid; i < TM * TU; i += NT) {
        const int m = i / TU, u = i % TU, n = n0 + m, unit = u0 + u;
        if (n >= N || unit >= H) continue;
        const float* gr = gs + m * GS + u;
        const float gi = gr[0] + bias[unit];
        const float gf = gr[TU] + bias[H + unit];
        const float gg = gr[2 * TU] + bias[2 * H + unit];
        const float go = gr[3 * TU] + bias[3 * H + unit];
        const size_t o = (size_t)n * H + unit;
        const float cn = rg::sigmoid(gf) * c_in[o] + rg::sigmoid(gi) * tanhf(gg);
        const float zn = rg::sigmoid(go) * tanhf(cn);
        z_out[o] = zn;
        c_out[o] = cn;
        zq[o] = rg::from_f<T>(zn);
      }
      __syncthreads();  // the gates tile is read: the next tile's copies may start
    }
  }
  // ---- C: the readout, an utterance at a time. The products of the K
  // lanes' rows with a chunk of Wout's columns are summed over slices of
  // the rows (the z' rows and the context rows apart), then the slices'
  // sums in a fixed order: bfloat16 on the tensor cores, a warp an (n16
  // column pair, slice); float32 on the CUDA cores, a thread a (slice,
  // column).
  const int HE = H + E, HEp = (HE + 3) / 4 * 4;
  const int Hp = r16e(H), KW = Hp + r16e(E), LS = KW + 8;  // bfloat16 layout
  const int zw = kB16 ? Hp : H;       // the staged rows' first context column
  const int LW = kB16 ? KW : HEp;     // a staged row's columns
  const int LR = kB16 ? LS : HEp;     // elements between staged rows
  T* l_s = reinterpret_cast<T*>(smem + L.lanes);
  T* w_s = reinterpret_cast<T*>(smem + L.wout);
  float* part = reinterpret_cast<float*>(smem + L.part);
  // columns v0 .. v0 + vn - 1 of Wout, in the layout of the compute type:
  // row j < H of Wout at row j, row H + j at row zw + j, zeros elsewhere
  auto stage_wout = [&](int v0, int vn) {
    const int WC = kB16 ? r16e(vn) + 8 : vn;  // elements between rows
    const int rows = kB16 ? KW : HEp;
    const int n16 = rows * WC * (int)sizeof(T) / 16;
    for (int i = tid; i < n16; i += NT) zero16(reinterpret_cast<uint4*>(w_s) + i);
    for (int i = n16 * P + tid; i < rows * WC; i += NT) w_s[i] = rg::from_f<T>(0.f);
    __syncthreads();  // the zeros are in before the data
    auto put = [&](int j, int v, T x) { w_s[(j < H ? j : zw + j - H) * WC + v] = x; };
    if (vn == V) {  // the whole of Wout, flat, 16 bytes a load
      const int n = HE * V, nv = n / P;
      const uint4* src = reinterpret_cast<const uint4*>(wout);
      for (int i0 = tid; i0 < nv; i0 += 4 * NT) {
        uint4 r[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) r[q] = i0 + q * NT < nv ? __ldg(src + i0 + q * NT) : uint4{};
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          if (i0 + q * NT >= nv) continue;
          const T* e = reinterpret_cast<const T*>(&r[q]);
          int j = (i0 + q * NT) * P / V, v = (i0 + q * NT) * P - j * V;
#pragma unroll
          for (int x = 0; x < P; ++x) {
            put(j, v, e[x]);
            if (++v == V) v = 0, ++j;
          }
        }
      }
      for (int i = nv * P + tid; i < n; i += NT) put(i / V, i % V, wout[i]);
    } else {
      for (int i = tid; i < HE * vn; i += NT) {
        const int j = i / vn, v = i % vn;
        put(j, v, wout[(size_t)j * V + v0 + v]);
      }
    }
  };
  DEC_PHASE(2)
  rg::grid_arrive(count);
  // Wout needs no other block's work: its copy runs before the wait
  if ((int)blockIdx.x < B) stage_wout(0, min(VC, V));
  rg::grid_wait(count, base + 2u * (unsigned)grid);
  DEC_PHASE(3)
  if ((int)blockIdx.x < B) {
    for (int v0 = 0; v0 < V; v0 += VC) {
      const int vn = min(VC, V - v0);
      if (v0 > 0) stage_wout(v0, vn);  // the last chunk's reads are done
      // bfloat16: (column pair, slice) work items over the warps
      const int Vp = r16e(vn), npairs = Vp / 16, nks = KW / 16;
      const int splits = kB16 ? max(1, min(NT / 32 / npairs, nks)) : max(1, min(NT / vn, HEp / 4));
      const int PS = kB16 ? Vp : vn;  // elements between rows of the sums
      for (int b = blockIdx.x; b < B; b += grid) {
        // the lanes' rows, eight loads in flight a thread (padding reads
        // a valid address and drops it)
        for (int i0 = tid; i0 < K * LW; i0 += 8 * NT) {
          float r[8];
#pragma unroll
          for (int q = 0; q < 8; ++q) {
            const int i = i0 + q * NT, row = i / LW, j = i % LW;
            const size_t n = (size_t)b * K + row;
            const bool in_z = j < H, in_c = j >= zw && j < zw + E;
            const bool ok = i < K * LW && (in_z || in_c);
            const T* src = !ok ? zq : in_z ? zq + n * H + j : xin + n * Dp + EMB + (j - zw);
            const float x = rg::ld_cg(src);
            r[q] = ok ? x : 0.f;
          }
#pragma unroll
          for (int q = 0; q < 8; ++q) {
            const int i = i0 + q * NT;
            if (i < K * LW) l_s[i / LW * LR + i % LW] = rg::from_f<T>(r[q]);
          }
        }
        __syncthreads();  // the lanes' rows and the Wout chunk are staged
        DEC_PHASE(7)
        if constexpr (kB16) {
          const int WC = Vp + 8, nkz = Hp / 16, KS = (nks + splits - 1) / splits;
          const int gq = lane / 4, tq = lane % 4;
          for (int it = warp; it < npairs * splits; it += NT / 32) {
            const int pr = it % npairs, sl = it / npairs;
            float az[2][4] = {}, ac[2][4] = {};
            for (int ks = sl * KS; ks < min(nks, (sl + 1) * KS); ++ks) {
              uint32_t af[4], bw[4];
              rg::ldsm_x4(af, l_s + (lane % 16) * LS + ks * 16 + (lane / 16) * 8);
              rg::ldsm_x4_trans(bw, w_s + (ks * 16 + lane % 16) * WC + pr * 16 + (lane / 16) * 8);
              if (ks < nkz) {
                rg::mma16816(az[0], af, bw[0], bw[1]);
                rg::mma16816(az[1], af, bw[2], bw[3]);
              } else {
                rg::mma16816(ac[0], af, bw[0], bw[1]);
                rg::mma16816(ac[1], af, bw[2], bw[3]);
              }
            }
            // the tile's rows are lanes gq and gq + 8: keep those below K
#pragma unroll
            for (int j = 0; j < 2; ++j) {
              const int col = pr * 16 + j * 8 + 2 * tq;
#pragma unroll
              for (int h = 0; h < 2; ++h) {
                const int r = gq + 8 * h;
                if (r >= K) continue;
                float* pz = part + ((size_t)sl * K + r) * PS + col;
                float* pc = part + ((size_t)(splits + sl) * K + r) * PS + col;
                pz[0] = az[j][2 * h];
                pz[1] = az[j][2 * h + 1];
                pc[0] = ac[j][2 * h];
                pc[1] = ac[j][2 * h + 1];
              }
            }
          }
        } else {
          const int J = (HEp / 4 + splits - 1) / splits * 4;  // rows a slice
          for (int t = tid; t < splits * vn; t += NT) {
            const int sl = t / vn, v = t % vn, j0 = sl * J, j1 = min(HEp, j0 + J);
            const float* lf = reinterpret_cast<const float*>(l_s);
            const float* wf = reinterpret_cast<const float*>(w_s);
            if (K <= 4)
              readout_f32<4>(lf, wf, part, K, H, HEp, vn, splits, sl, v, j0, j1);
            else if (K <= 8)
              readout_f32<8>(lf, wf, part, K, H, HEp, vn, splits, sl, v, j0, j1);
            else
              readout_f32<KMAX>(lf, wf, part, K, H, HEp, vn, splits, sl, v, j0, j1);
          }
        }
        __syncthreads();  // the slices' sums are in
        DEC_PHASE(8)
        for (int i = tid; i < K * vn; i += NT) {
          const int r = i / vn, v = i % vn;
          float az = 0.f, ac = 0.f;
          for (int sl = 0; sl < splits; ++sl) {
            az += part[((size_t)sl * K + r) * PS + v];
            ac += part[((size_t)(splits + sl) * K + r) * PS + v];
          }
          logits[((size_t)b * K + r) * V + v0 + v] = (az + ac) + bout[v0 + v];
        }
        __syncthreads();  // the lanes' rows, the chunk and the sums are read
      }
    }
  }
  DEC_PHASE(4)
  DEC_PHASE_END
}

// A refused launch (a grid that cannot be co-resident) is returned to the
// wrapper, which raises; the runtime also keeps it as its last error, which
// is cleared here so that the next kernel's launch check does not read it.
cudaError_t launched(cudaError_t err) {
  if (err != cudaSuccess) cudaGetLastError();
  return err;
}

template <typename T>
cudaError_t launch(const void* const* p, float* logits, float* att, float* z_out, float* c_out,
                   void* xin_v, void* zq_v, unsigned* count, int B, int K, int Tn, int C, int A,
                   int E, int V, int EMB, int H, int F, int S, int VC, int grid, size_t smem,
                   unsigned base, float sharpening, cudaStream_t stream) {
  constexpr int NW = kThreads<T> / 32;
  const bool aligned = ((reinterpret_cast<uintptr_t>(p[9]) | reinterpret_cast<uintptr_t>(p[10]) |
                         reinterpret_cast<uintptr_t>(p[12]) | reinterpret_cast<uintptr_t>(xin_v)) &
                        15) == 0;
  if (S < 1 || NW % S || F != 16 * (NW / S) || VC < 1 || VC > V || grid < 1 || H % 8 ||
      !aligned || dec_layout(K, Tn, C, A, E, H, F, S, VC, sizeof(T)).total != smem)
    return cudaErrorInvalidValue;
  const cudaError_t err = rg::reserve_smem<att_dec_utt_kernel<T>>(smem);
  if (err != cudaSuccess) return launched(err);
  const T* feat = static_cast<const T*>(p[0]);
  const T* enc_proj = static_cast<const T*>(p[1]);
  const T* enc = static_cast<const T*>(p[2]);
  const T* dec = static_cast<const T*>(p[3]);
  const T* wloc = static_cast<const T*>(p[4]);
  const T* g = static_cast<const T*>(p[5]);
  const float* mask = static_cast<const float*>(p[6]);
  const int* tok = static_cast<const int*>(p[7]);
  const T* emb = static_cast<const T*>(p[8]);
  const T* wx = static_cast<const T*>(p[9]);
  const T* wh = static_cast<const T*>(p[10]);
  const float* bias = static_cast<const float*>(p[11]);
  const T* wout = static_cast<const T*>(p[12]);
  const float* bout = static_cast<const float*>(p[13]);
  const float* z_in = static_cast<const float*>(p[14]);
  const float* c_in = static_cast<const float*>(p[15]);
  T* xin = static_cast<T*>(xin_v);
  T* zq = static_cast<T*>(zq_v);
  void* args[] = {&feat, &enc_proj, &enc,   &dec,    &wloc,  &g,     &mask,  &tok,
                  &emb,  &wx,       &wh,    &bias,   &wout,  &bout,  &z_in,  &c_in,
                  &logits, &att,    &z_out, &c_out,  &xin,   &zq,    &count, &B,
                  &K,    &Tn,       &C,     &A,      &E,     &V,     &EMB,   &H,
                  &F,    &S,        &VC,    &base,   &sharpening};
  return launched(cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(att_dec_utt_kernel<T>),
                                              dim3(grid), dim3(kThreads<T>), args, smem, stream));
}

}  // namespace

// F frames a chunk and S column splits of the attention, VC readout columns a
// chunk, the grid and the shared-memory bytes from ops/att_dec.py::utt_plan:
// a plan that disagrees with the kernel's layout is refused before the
// launch. xin (B K, Dp) and zq (B K, H) are scratch in the compute type;
// count is the barrier counter and base its value before this launch, which
// adds 2 x grid to it.
extern "C" int att_dec_utt(const void* feat, const void* enc_proj, const void* enc,
                           const void* dec, const void* wloc, const void* g, const void* mask,
                           const void* tok, const void* emb, const void* wx, const void* wh,
                           const void* bias, const void* wout, const void* bout,
                           const void* z_in, const void* c_in, void* logits, void* att,
                           void* z_out, void* c_out, void* xin, void* zq, void* count, int B,
                           int K, int Tn, int C, int A, int E, int V, int EMB, int H, int F,
                           int S, int VC, int grid, int smem, unsigned base, float sharpening,
                           int bf16, void* stream) {
  if (B < 1 || K < 1 || K > KMAX || Tn < 1 || C < 1 || C > CMAX || A < 1 || E < 1 || V < 1 ||
      EMB < 1 || H < 1)
    return (int)cudaErrorInvalidValue;
  const void* in[] = {feat, enc_proj, enc, dec, wloc, g, mask, tok,
                      emb,  wx,       wh,  bias, wout, bout, z_in, c_in};
  const auto s = static_cast<cudaStream_t>(stream);
  auto* lg = static_cast<float*>(logits);
  auto* at = static_cast<float*>(att);
  auto* zo = static_cast<float*>(z_out);
  auto* co = static_cast<float*>(c_out);
  auto* n = static_cast<unsigned*>(count);
  if (bf16)
    return (int)launch<__nv_bfloat16>(in, lg, at, zo, co, xin, zq, n, B, K, Tn, C, A, E, V, EMB,
                                      H, F, S, VC, grid, (size_t)smem, base, sharpening, s);
  return (int)launch<float>(in, lg, at, zo, co, xin, zq, n, B, K, Tn, C, A, E, V, EMB, H, F, S,
                            VC, grid, (size_t)smem, base, sharpening, s);
}
