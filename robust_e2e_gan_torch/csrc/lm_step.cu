// RNNLM beam step for shallow fusion: embedding row, L stacked LSTM cells,
// vocabulary readout, for N hypothesis lanes at once.
//
// Replaces robust_e2e_gan_tpu/ops/lm_step_pallas.py::lm_step_fused. The TPU
// kernel pads V, E and H to 128 lanes and gathers the embedding with a
// one-hot matmul (Mosaic has no gather); here a block reads each lane's
// table row directly and nothing is padded.
//
// What bounds it on Hopper: at the decode's shapes (N = 1,024 lanes, E =
// 128, H = 256, V = 52, one layer) a step is ~0.83 GFLOP of float32 FMAs
// against ~6 MB of state and weights, so the CUDA cores' float32 rate
// bounds it (~12 us); in practice the weights are re-read from L2 by every
// block, and one launch per beam step costs as much as the work.
//
// Design: lanes are independent, so a block owns ROWS lanes through every
// layer and the readout, and no block waits for another. As in blstm.cu, a
// block has KS threads per hidden unit u (KS * H <= 1024); thread (q, u)
// accumulates the four gate columns u, H+u, 2H+u, 3H+u of its ROWS lanes
// over its slice q of the input and recurrent rows, reading the weights
// from global memory (they stay in L2) and the lanes' inputs from shared
// memory. The q = 0 threads add the other slices' partial sums in a fixed
// order, apply the cell and publish h as the next layer's input. Numerics
// are the TPU kernel's: float32 carries and sums, h rounded to the compute
// type W for the recurrent product, each layer's output rounded to W as the
// next input, float32 logits.

#include "common.cuh"

namespace {

constexpr int ROWS = 8;  // lanes per block

template <typename W>
__global__ void __launch_bounds__(1024)
lm_step_kernel(const int* __restrict__ tok,      // (N,)
               const W* __restrict__ emb,        // (V, E)
               const W* __restrict__ wx0,        // (E, 4H)
               const W* __restrict__ wxs,        // (L-1, H, 4H)
               const W* __restrict__ whs,        // (L, H, 4H)
               const float* __restrict__ bias,   // (L, 4H)
               const W* __restrict__ wout,       // (H, V)
               const float* __restrict__ bout,   // (V,)
               const float* __restrict__ h_in,   // (L, N, H)
               const float* __restrict__ c_in,   // (L, N, H)
               float* __restrict__ h_out,        // (L, N, H)
               float* __restrict__ c_out,        // (L, N, H)
               float* __restrict__ logits,       // (N, V)
               int N, int V, int E, int H, int L, int KS) {
  extern __shared__ float smem[];
  const int d_max = max(E, H);
  float* x_s = smem;                    // (ROWS, D): the layer's input
  float* h_s = x_s + ROWS * d_max;      // (ROWS, H): h_{t-1}, rounded to W
  float* part_s = h_s + ROWS * H;       // (KS-1, ROWS, 4, H): partial sums
  const int row0 = blockIdx.x * ROWS;
  const int u = threadIdx.x % H;
  const int q = threadIdx.x / H;
  const int G = 4 * H;

  // layer 0's input: each lane's embedding row
  for (int i = threadIdx.x; i < ROWS * E; i += blockDim.x) {
    const int r = i / E, k = i % E, n = row0 + r;
    float x = 0.f;
    if (n < N) {
      const int t = min(max(tok[n], 0), V - 1);
      x = rg::to_f(emb[(size_t)t * E + k]);
    }
    x_s[r * E + k] = x;
  }

  for (int li = 0; li < L; ++li) {
    const int D = li == 0 ? E : H;
    const W* wx = li == 0 ? wx0 : wxs + (size_t)(li - 1) * H * G;
    const W* wh = whs + (size_t)li * H * G;
    for (int i = threadIdx.x; i < ROWS * H; i += blockDim.x) {
      const int r = i / H, n = row0 + r;
      h_s[i] = n < N ? rg::rnd<W>(h_in[((size_t)li * N + n) * H + i % H]) : 0.f;
    }
    __syncthreads();  // x_s and h_s are complete

    float acc[ROWS][4];
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
#pragma unroll
      for (int g = 0; g < 4; ++g) acc[r][g] = 0.f;
    }
    const int kx = (D + KS - 1) / KS;
#pragma unroll 4
    for (int k = q * kx; k < min(D, (q + 1) * kx); ++k) {
      const W* wk = wx + (size_t)k * G + u;
      const float w0 = rg::to_f(wk[0]), w1 = rg::to_f(wk[H]);
      const float w2 = rg::to_f(wk[2 * H]), w3 = rg::to_f(wk[3 * H]);
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        const float xk = x_s[r * D + k];
        acc[r][0] = fmaf(xk, w0, acc[r][0]);
        acc[r][1] = fmaf(xk, w1, acc[r][1]);
        acc[r][2] = fmaf(xk, w2, acc[r][2]);
        acc[r][3] = fmaf(xk, w3, acc[r][3]);
      }
    }
    const int kh = (H + KS - 1) / KS;
#pragma unroll 4
    for (int k = q * kh; k < min(H, (q + 1) * kh); ++k) {
      const W* wk = wh + (size_t)k * G + u;
      const float w0 = rg::to_f(wk[0]), w1 = rg::to_f(wk[H]);
      const float w2 = rg::to_f(wk[2 * H]), w3 = rg::to_f(wk[3 * H]);
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
    __syncthreads();  // partial sums are in; x_s and h_s are read
    if (q == 0) {
      const float* b = bias + (size_t)li * G;
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        const int n = row0 + r;
        float hn = 0.f;
        if (n < N) {
          for (int p = 0; p < KS - 1; ++p) {
#pragma unroll
            for (int g = 0; g < 4; ++g) acc[r][g] += part_s[((p * ROWS + r) * 4 + g) * H + u];
          }
          const size_t o = ((size_t)li * N + n) * H + u;
          const float gi = acc[r][0] + b[u];
          const float gf = acc[r][1] + b[H + u];
          const float gg = acc[r][2] + b[2 * H + u];
          const float go = acc[r][3] + b[3 * H + u];
          const float cn = rg::sigmoid(gf) * c_in[o] + rg::sigmoid(gi) * tanhf(gg);
          hn = rg::sigmoid(go) * tanhf(cn);
          h_out[o] = hn;
          c_out[o] = cn;
        }
        x_s[r * H + u] = rg::rnd<W>(hn);  // the next layer's (or readout's) input
      }
    }
    __syncthreads();  // the layer's output is complete
  }

  // readout: logits = h_L @ W_out + b_out, one (lane, token) per thread
  for (int i = threadIdx.x; i < ROWS * V; i += blockDim.x) {
    const int r = i / V, v = i % V, n = row0 + r;
    if (n >= N) continue;
    float acc = 0.f;
    for (int k = 0; k < H; ++k) acc = fmaf(x_s[r * H + k], rg::to_f(wout[(size_t)k * V + v]), acc);
    logits[(size_t)n * V + v] = acc + bout[v];
  }
}

template <typename W>
cudaError_t launch_kernel(const int* tok, const W* emb, const W* wx0, const W* wxs, const W* whs,
                          const float* bias, const W* wout, const float* bout,
                          const float* h_in, const float* c_in, float* h_out, float* c_out,
                          float* logits, int N, int V, int E, int H, int L,
                          cudaStream_t stream) {
  const int ks = max(1, min(4, 1024 / H));
  const size_t smem =
      (size_t)(ROWS * (max(E, H) + H) + (ks - 1) * ROWS * 4 * H) * sizeof(float);
  const cudaError_t err = rg::reserve_smem<lm_step_kernel<W>>(smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((N + ROWS - 1) / ROWS);
  lm_step_kernel<W><<<grid, ks * H, smem, stream>>>(tok, emb, wx0, wxs, whs, bias, wout, bout,
                                                    h_in, c_in, h_out, c_out, logits, N, V, E,
                                                    H, L, ks);
  return cudaGetLastError();
}

}  // namespace

extern "C" int lm_step(const void* tok, const void* emb, const void* wx0, const void* wxs,
                       const void* whs, const void* bias, const void* wout, const void* bout,
                       const void* h_in, const void* c_in, void* h_out, void* c_out,
                       void* logits, int N, int V, int E, int H, int L, int bf16,
                       void* stream) {
  if (N < 1 || V < 1 || E < 1 || H < 1 || H > 1024 || L < 1) return (int)cudaErrorInvalidValue;
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* t = static_cast<const int*>(tok);
  const auto* b = static_cast<const float*>(bias);
  const auto* bo = static_cast<const float*>(bout);
  const auto* hi = static_cast<const float*>(h_in);
  const auto* ci = static_cast<const float*>(c_in);
  auto* ho = static_cast<float*>(h_out);
  auto* co = static_cast<float*>(c_out);
  auto* lg = static_cast<float*>(logits);
  if (bf16) {
    using B = __nv_bfloat16;
    return (int)launch_kernel(t, static_cast<const B*>(emb), static_cast<const B*>(wx0),
                              static_cast<const B*>(wxs), static_cast<const B*>(whs), b,
                              static_cast<const B*>(wout), bo, hi, ci, ho, co, lg, N, V, E, H,
                              L, s);
  }
  return (int)launch_kernel(t, static_cast<const float*>(emb), static_cast<const float*>(wx0),
                            static_cast<const float*>(wxs), static_cast<const float*>(whs), b,
                            static_cast<const float*>(wout), bo, hi, ci, ho, co, lg, N, V, E, H,
                            L, s);
}
