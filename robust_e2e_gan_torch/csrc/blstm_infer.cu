// Masked bidirectional LSTM forward for inference, from the raw input.
//
// Replaces robust_e2e_gan_tpu/ops/blstm_pallas.py::blstm_infer in its
// W_x-resident variant (_fused_kernel, pallas_call :403): one launch per
// layer takes the input frames x (B, T, D) and writes the hidden states
// (B, T, 2H). The input projection x_t W_x + b is computed inside, a chunk
// of frames at a time, so no (B, T, 2, 4H) float32 gate tensor goes
// through device memory (csrc/blstm.cu, the gate-stream variant, reads
// one).
//
// What bounds it on Hopper: the serial chain of T frames, as in blstm.cu,
// and the projection's reads of W_x. "Resident" means L2-resident here:
// W_x (D x 4H per direction: 0.5 MB in bf16 at D=257, H=256; 5 MB at
// D=2,560) and W_h (0.5 MB at H=256) exceed one SM's 227 KB, so every
// block re-reads W_x from the 50 MB L2 once per chunk of F frames
// (D * 4H * itemsize bytes per chunk and block) and W_h once per frame.
// The projection's 2 * D * 4H operations per row and frame are off the
// serial chain's dependences but not off its time: a block projects a
// chunk, then walks the chunk's frames.
//
// Design: the grid of blstm.cu, (2 directions, ceil(B / ROWS) row tiles),
// KS threads per hidden unit u (KS * H <= 1024). A chunk is P (row, frame)
// pairs, F = P / ROWS frames of each of the block's rows. At the start of
// a chunk the block accumulates gx_s (P, 4H) float32 = x W_x over slices
// of the input columns:
//  - in bfloat16 with H a multiple of 16, on the tensor cores: P = 32 or
//    16 pairs (32 where the plan fits: it halves the W_x reads). Each
//    slice's DS rows of W_x (64, 32 or 16, the longest that fits) are
//    copied to shared memory with cp.async, all in flight at once, beside
//    the pairs' DS input columns; each warp then owns strips of 16 gate
//    columns and runs WMMA m16n16k16 tiles with a float32 accumulator
//    from shared memory. The wrapper zero-pads W_x's rows to a multiple of
//    16. At the flagship (H=256, B=128): P = 32, F = 16, DS = 32, 222 KB
//    of shared memory.
//  - otherwise with FMAs: P = 16 (8 where 16 do not fit, H above ~768),
//    64 input columns a slice, a thread per gate column with the P sums in
//    registers, W_x read from L2.
// Then the chunk's F frames run blstm.cu's serial step: thread (q, u)
// sums its slice q of h_{t-1} W_h for the four gate columns of unit u, the
// q = 0 threads add the other slices' partial sums and apply
//   gates = (gx_s + b) + h_{t-1} W_h -> i, f, g, o -> c_t, h_t
// with c in registers. h_{t-1} is kept in shared memory rounded to the
// compute type, which is what the recurrent product reads (the TPU
// kernel's h_prev.astype(cdtype)); the output is h_t written in the
// compute type. The backward direction walks t = len-1 ... 0 directly, so
// there is no flipped copy of x and no reversed write; frames at or past a
// row's length are exact zeros and leave the state alone. This is the
// "row-tiled" route of ops/blstm.py::blstm_infer: the layers that
// cluster_plan fits (bfloat16, H a multiple of 16 that splits into at
// most 32 hidden units a block) take csrc/blstm_infer_cluster.cu, which
// splits W_h over a thread-block cluster and exchanges h through
// distributed shared memory; this kernel takes the rest (float32, other
// H).

#include "common.cuh"

#include <mma.h>

#include <type_traits>

namespace {

constexpr int FDS = 64;                // input columns per slice, FMA path
constexpr size_t SMEM_LIMIT = 232448;  // bytes a block may take (sm_90)

// Shared-memory plan. Rows of the tensor-core operands are padded by 16
// bytes (x_s, w_s) and gx_s rows by 16 bytes so that the 16 rows of a tile
// do not fall on the same banks.
size_t smem_bytes(bool mma, int p, int ds, int rows, int h, int ks) {
  const size_t g = 4 * (size_t)h;
  const size_t staged = mma ? (size_t)p * (ds + 8) * 2 + (size_t)ds * (g + 8) * 2
                            : (size_t)FDS * p * sizeof(float);
  return staged + (p * (g + 4) + rows * h + (ks - 1) * rows * 4 * h + rows) * sizeof(float);
}

// 16 bytes global -> shared without passing through registers (sm_80+).
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
}

template <typename W, int ROWS, int P, bool MMA>
__global__ void __launch_bounds__(1024)
blstm_infer_kernel(const W* __restrict__ x,          // (B, T, D)
                   const W* __restrict__ wx,         // (2, DW, 4H), rows >= D zero
                   const W* __restrict__ wh,         // (2, H, 4H)
                   const float* __restrict__ bias,   // (2, 4H)
                   const int* __restrict__ lengths,  // (B,)
                   W* __restrict__ out,              // (B, T, 2H)
                   int B, int T, int D, int DW, int H, int KS, int DS) {
  static_assert(!MMA || (std::is_same<W, __nv_bfloat16>::value && P % 16 == 0),
                "the tensor-core projection takes bfloat16 pairs in 16s");
  constexpr int F = P / ROWS;  // frames per chunk
  extern __shared__ __align__(128) float smem[];
  const int G = 4 * H;
  const int GS = G + 4;  // gx_s row stride
  // staged inputs: MMA x_s (P, DS + 8) and the W_x slice w_s (DS, 4H + 8)
  // in W; FMA x_s (FDS, P) float
  W* xw = reinterpret_cast<W*>(smem);
  W* w_s = xw + P * (DS + 8);
  float* gx_s = MMA ? reinterpret_cast<float*>(w_s + DS * (G + 8)) : smem + FDS * P;
  float* h_s = gx_s + P * GS;      // (ROWS, H): h_{t-1} rounded to W
  float* part_s = h_s + ROWS * H;  // (KS-1, ROWS, 4, H): partial gate sums
  int* len_s = reinterpret_cast<int*>(part_s + (KS - 1) * ROWS * 4 * H);  // (ROWS,)
  const int tid = threadIdx.x, nthreads = blockDim.x;
  const int z = blockIdx.x;
  const int row0 = blockIdx.y * ROWS;
  const int u = tid % H;
  const int q = tid / H;
  const int kc = (H + KS - 1) / KS;
  const int k0 = q * kc, k1 = min(H, k0 + kc);
  const W* wxz = wx + (size_t)z * DW * G;
  const W* w = wh + (size_t)z * H * G + u;
  float bz[4];
#pragma unroll
  for (int g = 0; g < 4; ++g) bz[g] = bias[z * G + g * H + u];

  float c[ROWS];
  int len[ROWS];
  int steps = 0;
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    const int b = row0 + r;
    const int l = b < B ? min(max(lengths[b], 0), T) : 0;
    len[r] = l;
    c[r] = 0.f;
    if (q == 0) h_s[r * H + u] = 0.f;
    if (tid == 0) len_s[r] = l;
    steps = max(steps, l);
  }
  __syncthreads();

  // the input value of pair p = r * F + f at column d: zero past D and for
  // a frame at or past its row's length
  auto x_at = [&](int p, int d, int s0) -> float {
    const int r = p / F, s = s0 + p % F;
    if (d >= D || s >= len_s[r]) return 0.f;
    const int t = z == 0 ? s : len_s[r] - 1 - s;
    return rg::to_f(x[((size_t)(row0 + r) * T + t) * D + d]);
  };

  for (int s0 = 0; s0 < steps; s0 += F) {
    // ---- the chunk's input projection gx_s = x W_x, a slice of columns
    // of x (rows of W_x) at a time
    if constexpr (MMA) {
      using namespace nvcuda;
      constexpr int MT = P / 16;  // 16-pair tiles
      const int warp = tid >> 5, nwarps = nthreads >> 5;
      for (int d0 = 0; d0 < DW; d0 += DS) {
        const int kd = min(DS, DW - d0);  // a multiple of 16
        // W_x rows [d0, d0 + kd) into w_s, all in flight at once
        const int pieces = G / 8;  // 16-byte pieces per row
        for (int i = tid; i < kd * pieces; i += nthreads) {
          const int row = i / pieces, col = (i % pieces) * 8;
          cp_async16(w_s + row * (G + 8) + col, wxz + (size_t)(d0 + row) * G + col);
        }
        for (int i = tid; i < P * DS; i += nthreads) {
          const int p = i / DS, dd = i % DS;
          xw[p * (DS + 8) + dd] = rg::from_f<W>(x_at(p, d0 + dd, s0));
        }
        cp_async_wait_all();
        __syncthreads();
        for (int n0 = warp * 16; warp < nwarps && n0 < G; n0 += nwarps * 16) {
          wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[MT];
#pragma unroll
          for (int m = 0; m < MT; ++m) {
            if (d0 == 0) {
              wmma::fill_fragment(acc[m], 0.f);
            } else {
              wmma::load_matrix_sync(acc[m], gx_s + m * 16 * GS + n0, GS,
                                     wmma::mem_row_major);
            }
          }
          for (int k = 0; k < kd; k += 16) {
            wmma::fragment<wmma::matrix_b, 16, 16, 16, W, wmma::row_major> bw;
            wmma::load_matrix_sync(bw, w_s + k * (G + 8) + n0, G + 8);
#pragma unroll
            for (int m = 0; m < MT; ++m) {
              wmma::fragment<wmma::matrix_a, 16, 16, 16, W, wmma::row_major> a;
              wmma::load_matrix_sync(a, xw + m * 16 * (DS + 8) + k, DS + 8);
              wmma::mma_sync(acc[m], a, bw, acc[m]);
            }
          }
#pragma unroll
          for (int m = 0; m < MT; ++m)
            wmma::store_matrix_sync(gx_s + m * 16 * GS + n0, acc[m], GS,
                                    wmma::mem_row_major);
        }
        __syncthreads();  // gx_s holds this slice; x_s and w_s may be restaged
      }
    } else {
      for (int d0 = 0; d0 < D; d0 += FDS) {
        for (int i = tid; i < P * FDS; i += nthreads) {
          const int p = i / FDS, dd = i % FDS;
          smem[dd * P + p] = x_at(p, d0 + dd, s0);
        }
        __syncthreads();
        const int nd = min(FDS, D - d0);
        for (int col = tid; col < G; col += nthreads) {
          float acc[P];
#pragma unroll
          for (int p = 0; p < P; ++p) acc[p] = 0.f;
          const W* wc = wxz + (size_t)d0 * G + col;
#pragma unroll 4
          for (int dd = 0; dd < nd; ++dd) {
            const float wv = rg::to_f(wc[(size_t)dd * G]);
            const float4* xv = reinterpret_cast<const float4*>(smem + dd * P);
#pragma unroll
            for (int p4 = 0; p4 < P / 4; ++p4) {
              const float4 v = xv[p4];
              acc[4 * p4] = fmaf(v.x, wv, acc[4 * p4]);
              acc[4 * p4 + 1] = fmaf(v.y, wv, acc[4 * p4 + 1]);
              acc[4 * p4 + 2] = fmaf(v.z, wv, acc[4 * p4 + 2]);
              acc[4 * p4 + 3] = fmaf(v.w, wv, acc[4 * p4 + 3]);
            }
          }
          float* gc = gx_s + col;
#pragma unroll
          for (int p = 0; p < P; ++p) gc[p * GS] = d0 == 0 ? acc[p] : gc[p * GS] + acc[p];
        }
        __syncthreads();  // gx_s holds this slice; x_s may be restaged
      }
    }

    // ---- the chunk's frames: the serial chain
    const int nf = min(F, steps - s0);
    for (int f = 0; f < nf; ++f) {
      const int s = s0 + f;
      float acc[ROWS][4];
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
#pragma unroll
        for (int g = 0; g < 4; ++g) acc[r][g] = 0.f;
      }
#pragma unroll 8
      for (int k = k0; k < k1; ++k) {
        const W* wk = w + (size_t)k * G;
        const float w0 = rg::to_f(wk[0]);
        const float w1 = rg::to_f(wk[H]);
        const float w2 = rg::to_f(wk[2 * H]);
        const float w3 = rg::to_f(wk[3 * H]);
#pragma unroll
        for (int r = 0; r < ROWS; ++r) {
          const float hk = h_s[r * H + k];
          acc[r][0] = fmaf(hk, w0, acc[r][0]);
          acc[r][1] = fmaf(hk, w1, acc[r][1]);
          acc[r][2] = fmaf(hk, w2, acc[r][2]);
          acc[r][3] = fmaf(hk, w3, acc[r][3]);
        }
      }
      if (q > 0) {
#pragma unroll
        for (int r = 0; r < ROWS; ++r) {
#pragma unroll
          for (int g = 0; g < 4; ++g)
            part_s[(((q - 1) * ROWS + r) * 4 + g) * H + u] = acc[r][g];
        }
      }
      __syncthreads();  // every thread has read h_{t-1}; partial sums are in
      if (q == 0) {
#pragma unroll
        for (int r = 0; r < ROWS; ++r) {
          if (s >= len[r]) continue;
          for (int p = 0; p < KS - 1; ++p) {
#pragma unroll
            for (int g = 0; g < 4; ++g) acc[r][g] += part_s[((p * ROWS + r) * 4 + g) * H + u];
          }
          const float* gt = gx_s + (r * F + f) * GS + u;
          const float gi = (gt[0] + bz[0]) + acc[r][0];
          const float gf = (gt[H] + bz[1]) + acc[r][1];
          const float gg = (gt[2 * H] + bz[2]) + acc[r][2];
          const float go = (gt[3 * H] + bz[3]) + acc[r][3];
          const float cn = rg::sigmoid(gf) * c[r] + rg::sigmoid(gi) * tanhf(gg);
          const float hn = rg::sigmoid(go) * tanhf(cn);
          c[r] = cn;
          h_s[r * H + u] = rg::rnd<W>(hn);
          const int t = z == 0 ? s : len[r] - 1 - s;
          out[((size_t)(row0 + r) * T + t) * 2 * H + z * H + u] = rg::from_f<W>(hn);
        }
      }
      __syncthreads();  // h_t is complete before the next frame reads it
    }
  }

  // pad frames of this direction: exact zeros, written by all KS slices
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    const int b = row0 + r;
    if (b >= B) continue;
    for (int t = len[r] + q; t < T; t += KS)
      out[((size_t)b * T + t) * 2 * H + z * H + u] = rg::from_f<W>(0.f);
  }
}

template <typename W, int ROWS, int P, bool MMA>
cudaError_t launch_kernel(const W* x, const W* wx, const W* wh, const float* bias,
                          const int* lengths, W* out, int B, int T, int D, int DW, int H,
                          int ds, cudaStream_t stream) {
  const int ks = max(1, min(4, 1024 / H));
  const dim3 grid(2, (B + ROWS - 1) / ROWS);
  const size_t smem = smem_bytes(MMA, P, ds, ROWS, H, ks);
  const cudaError_t err = rg::reserve_smem<blstm_infer_kernel<W, ROWS, P, MMA>>(smem);
  if (err != cudaSuccess) return err;
  blstm_infer_kernel<W, ROWS, P, MMA><<<grid, ks * H, smem, stream>>>(
      x, wx, wh, bias, lengths, out, B, T, D, DW, H, ks, ds);
  return cudaGetLastError();
}

// The tensor-core projection where asked for (bfloat16, H a multiple of
// 16): the first plan that fits of 32 or 16 pairs per chunk and 64, 32 or
// 16 W_x rows per slice (more pairs read W_x less often; longer slices wait
// on L2 less often). Otherwise FMAs with 16 pairs, or 8 where 16 do not
// fit (H above ~768).
template <typename W, int ROWS>
cudaError_t launch_rows(const W* x, const W* wx, const W* wh, const float* bias,
                        const int* lengths, W* out, int B, int T, int D, int DW, int H,
                        bool mma, cudaStream_t stream) {
  const int ks = max(1, min(4, 1024 / H));
  if constexpr (std::is_same<W, __nv_bfloat16>::value) {
    if (mma) {
      for (const int p : {32, 16}) {
        for (const int ds : {64, 32, 16}) {
          if (smem_bytes(true, p, ds, ROWS, H, ks) > SMEM_LIMIT) continue;
          if (p == 32)
            return launch_kernel<W, ROWS, 32, true>(x, wx, wh, bias, lengths, out, B, T,
                                                    D, DW, H, ds, stream);
          return launch_kernel<W, ROWS, 16, true>(x, wx, wh, bias, lengths, out, B, T, D,
                                                  DW, H, ds, stream);
        }
      }
    }
  }
  if (smem_bytes(false, 16, 0, ROWS, H, ks) <= SMEM_LIMIT)
    return launch_kernel<W, ROWS, 16, false>(x, wx, wh, bias, lengths, out, B, T, D, DW,
                                             H, 0, stream);
  return launch_kernel<W, ROWS, 8, false>(x, wx, wh, bias, lengths, out, B, T, D, DW, H,
                                          0, stream);
}

template <typename W>
cudaError_t launch_typed(const void* x, const void* wx, const void* wh, const void* bias,
                         const void* lengths, void* out, int B, int T, int D, int DW,
                         int H, int rows, bool mma, cudaStream_t stream) {
  const auto* xp = static_cast<const W*>(x);
  const auto* wxp = static_cast<const W*>(wx);
  const auto* whp = static_cast<const W*>(wh);
  const auto* bp = static_cast<const float*>(bias);
  const auto* lp = static_cast<const int*>(lengths);
  auto* op = static_cast<W*>(out);
  switch (rows) {
    case 2: return launch_rows<W, 2>(xp, wxp, whp, bp, lp, op, B, T, D, DW, H, mma, stream);
    case 4: return launch_rows<W, 4>(xp, wxp, whp, bp, lp, op, B, T, D, DW, H, mma, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" int blstm_infer(const void* x, const void* wx, const void* wh, const void* bias,
                           const void* lengths, void* out, int B, int T, int D, int DW,
                           int H, int rows, int bf16, int mma, void* stream) {
  if (H < 1 || H > 1024 || B < 1 || T < 1 || D < 1 || DW < D)
    return (int)cudaErrorInvalidValue;
  if (mma && (!bf16 || H % 16 != 0 || DW % 16 != 0)) return (int)cudaErrorInvalidValue;
  const auto s = static_cast<cudaStream_t>(stream);
  if (bf16)
    return (int)launch_typed<__nv_bfloat16>(x, wx, wh, bias, lengths, out, B, T, D, DW, H,
                                            rows, mma != 0, s);
  return (int)launch_typed<float>(x, wx, wh, bias, lengths, out, B, T, D, DW, H, rows,
                                  false, s);
}
