// Strided batched matrix product with float32 accumulation, and a column
// sum: the products the TPU training BLSTM computes in its kernel bodies.
//
// Replaces the in-kernel matmuls of robust_e2e_gan_tpu/ops/
// blstm_train_pallas.py::blstm_train (:624): the chunk input projections
// x W_x + b (:150-158), and the backward's dx = dgates W_x^T,
// dW_x = x^T dgates, dW_h = h_prev^T dgates and dbias = sum dgates
// (:346-359); for blstm_train_gx (:1050) only dW_h (:902-907).
//
// What bounds it on Hopper: at the train shapes (M = B*T ~ 9,000 rows, N, K
// up to 2,560) these are compute-bound products; this first version is a
// plain shared-memory tiled product on the CUDA cores (no wgmma / TMA). On
// an H100 it reaches ~5% of the CUDA cores' f32 peak: the weight-gradient
// products (M, N <= 2,560 x 1,024, K = B*T) give as few as 64 blocks for
// 132 SMs, each walking all of K, and every load divides for the two-level
// k index. Split-K and incremental indices come before tensor-core tiles.
//
// Design: 64 x 64 output tile per block of 256 threads, 4 x 4 outputs per
// thread, K in steps of 16 staged through shared memory. Operands are read
// through explicit element strides, so transposed and interleaved views
// (a direction's slice of the (B, T, 2, 4H) gate stream, W_x^T) need no
// copy; the reduction index k splits as (k / KI, k % KI) with a stride for
// each part, which walks the (row, frame) pairs of a padded (B, T+1, H)
// residual. Each operand is float32 or bfloat16, optionally rounded to
// bfloat16 on load (the compute-type rounding of dgates). The result is
// float32: written, or added to what is there, plus an optional bias per
// column. Rows and columns past the edge are masked.

#include "common.cuh"

namespace {

constexpr int BM = 64, BN = 64, BK = 16;

struct Strides {
  long long ab, am, ak1, ak0;  // A: batch, m, k outer, k inner
  long long bb, bk1, bk0, bn;  // B: batch, k outer, k inner, n
  long long cb, cm, cn;        // C: batch, m, n
  long long biasb;             // bias: batch
};

template <typename TA, typename TB>
__global__ void __launch_bounds__(256)
gemm_kernel(const TA* __restrict__ A, const TB* __restrict__ B, float* __restrict__ C,
            const float* __restrict__ bias, int M, int N, int K, int KI, Strides s,
            int round_bf16, int accumulate) {
  __shared__ float As[BK][BM + 4];
  __shared__ float Bs[BK][BN + 4];
  const int z = blockIdx.z;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;
  A += z * s.ab;
  B += z * s.bb;
  C += z * s.cb;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  }

  for (int k0 = 0; k0 < K; k0 += BK) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int idx = tid + i * 256;
      // A tile: 64 rows x 16 k; B tile: 16 k x 64 columns
      {
        const int mm = idx / BK, kk = idx % BK;
        const int m = m0 + mm, k = k0 + kk;
        float v = 0.f;
        if (m < M && k < K)
          v = rg::to_f(A[m * s.am + (long long)(k / KI) * s.ak1 + (long long)(k % KI) * s.ak0]);
        if (round_bf16) v = rg::rnd<__nv_bfloat16>(v);
        As[kk][mm] = v;
      }
      {
        const int kk = idx / BN, nn = idx % BN;
        const int k = k0 + kk, n = n0 + nn;
        float v = 0.f;
        if (k < K && n < N)
          v = rg::to_f(B[(long long)(k / KI) * s.bk1 + (long long)(k % KI) * s.bk0 + n * s.bn]);
        if (round_bf16) v = rg::rnd<__nv_bfloat16>(v);
        Bs[kk][nn] = v;
      }
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = As[kk][ty * 4 + i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = Bs[kk][tx * 4 + j];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty * 4 + i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx * 4 + j;
      if (n >= N) continue;
      float v = acc[i][j];
      if (bias != nullptr) v += bias[z * s.biasb + n];
      float* c = C + m * s.cm + n * s.cn;
      *c = accumulate ? *c + v : v;
    }
  }
}

// out[n] = sum over m of X[m, n]: a block of 32 x 32 threads per 32 columns
__global__ void __launch_bounds__(1024)
colsum_kernel(const float* __restrict__ X, float* __restrict__ out, int M, int N) {
  __shared__ float part[32][33];
  const int n = blockIdx.x * 32 + threadIdx.x;
  float acc = 0.f;
  if (n < N) {
    for (int m = threadIdx.y; m < M; m += 32) acc += X[(size_t)m * N + n];
  }
  part[threadIdx.y][threadIdx.x] = acc;
  __syncthreads();
  if (threadIdx.y == 0 && n < N) {
    float v = 0.f;
    for (int r = 0; r < 32; ++r) v += part[r][threadIdx.x];
    out[n] = v;
  }
}

template <typename TA, typename TB>
cudaError_t launch(const void* A, const void* B, float* C, const float* bias, int batch, int M,
                   int N, int K, int KI, const Strides& s, int round_bf16, int accumulate,
                   cudaStream_t stream) {
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM, batch);
  gemm_kernel<TA, TB><<<grid, 256, 0, stream>>>(static_cast<const TA*>(A),
                                                static_cast<const TB*>(B), C, bias, M, N, K,
                                                KI, s, round_bf16, accumulate);
  return cudaGetLastError();
}

}  // namespace

extern "C" int gemm(const void* A, const void* B, void* C, const void* bias, int batch, int M,
                    int N, int K, int KI, long long sab, long long sam, long long sak1,
                    long long sak0, long long sbb, long long sbk1, long long sbk0,
                    long long sbn, long long scb, long long scm, long long scn,
                    long long sbias, int a_bf16, int b_bf16, int round_bf16, int accumulate,
                    void* stream) {
  if (batch < 1 || M < 0 || N < 0 || K < 0 || KI < 1 || batch > 65535)
    return (int)cudaErrorInvalidValue;
  if (M == 0 || N == 0) return 0;
  const Strides s{sab, sam, sak1, sak0, sbb, sbk1, sbk0, sbn, scb, scm, scn, sbias};
  const auto st = static_cast<cudaStream_t>(stream);
  auto c = static_cast<float*>(C);
  auto b = static_cast<const float*>(bias);
  using bf = __nv_bfloat16;
  if (a_bf16 && b_bf16)
    return (int)launch<bf, bf>(A, B, c, b, batch, M, N, K, KI, s, round_bf16, accumulate, st);
  if (a_bf16)
    return (int)launch<bf, float>(A, B, c, b, batch, M, N, K, KI, s, round_bf16, accumulate,
                                  st);
  if (b_bf16)
    return (int)launch<float, bf>(A, B, c, b, batch, M, N, K, KI, s, round_bf16, accumulate,
                                  st);
  return (int)launch<float, float>(A, B, c, b, batch, M, N, K, KI, s, round_bf16, accumulate,
                                   st);
}

extern "C" int colsum(const void* X, void* out, int M, int N, void* stream) {
  if (M < 0 || N < 1) return (int)cudaErrorInvalidValue;
  colsum_kernel<<<(N + 31) / 32, dim3(32, 32), 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(X), static_cast<float*>(out), M, N);
  return (int)cudaGetLastError();
}
