// CTC alpha recursion and its adjoint: the loss's forward algorithm from
// the first frame's alpha0 to the final (frozen) alpha, and the gradient
// back to the emission scores and alpha0.
//
// Replaces robust_e2e_gan_tpu/ops/ctc_pallas.py::ctc_alpha_final (:296):
// _fwd_kernel (with the alpha history, for training), _fwd_only_kernel (no
// history, for no-grad calls) and _bwd_kernel (the hand-derived adjoint of
// the log-sum-exp recursion).
//
// What bounds it on Hopper: the serial chain over T frames of tiny
// (U = 2S+1 lanes) log-sum-exp steps; bytes and operations are negligible.
//
// Design: one block per utterance, one thread per extended-label position
// u, the frame loop inside the kernel with alpha in shared memory. The
// two shifts (alpha[u-1], alpha[u-2]) are indexed shared-memory loads --
// exact in float32, so the HIGHEST-precision shift-matrix products of the
// TPU kernel have no counterpart. The training forward writes the (T, B, U)
// history (row 0 = alpha0); the no-grad forward writes none. The backward
// walks t descending, recomputes the path weights w0, w1, w2 from the
// stored history, and applies the transposed shifts as indexed loads of
// the neighbours' weighted adjoints. Sentinels and clamps are the
// reference's: -1e30 for log 0, -5e29 as the compare threshold, sums
// clamped at 1e-37.

#include "common.cuh"

namespace {

constexpr float NEG_INF = -1e30f;
constexpr float NEG_THRESH = -5e29f;

// emit (B, T, U), alpha0/skip/pos (B, U), lens (B,); hist (T, B, U) or
// null; afin (B, U)
__global__ void fwd_kernel(const float* __restrict__ emit, const float* __restrict__ alpha0,
                           const float* __restrict__ skip, const float* __restrict__ pos,
                           const int* __restrict__ lens, float* __restrict__ hist,
                           float* __restrict__ afin, int B, int T, int U) {
  extern __shared__ float alpha[];
  const int b = blockIdx.x;
  const int u = threadIdx.x;
  const float a0 = alpha0[(size_t)b * U + u];
  const float sk = skip[(size_t)b * U + u];
  const float ps = pos[(size_t)b * U + u];
  const int len = lens[b];
  alpha[u] = a0;
  if (hist != nullptr) hist[(size_t)b * U + u] = a0;
  __syncthreads();
  float a = a0;
  for (int t = 1; t < T; ++t) {
    const float sh1 = u >= 1 ? alpha[u - 1] : NEG_INF;
    const float sh2 = (u >= 2 ? alpha[u - 2] : NEG_INF) + sk;
    const float m = fmaxf(fmaxf(a, sh1), sh2);
    const float safe = m <= NEG_THRESH ? 0.f : m;
    const float summed = fmaxf(expf(a - safe) + expf(sh1 - safe) + expf(sh2 - safe), 1e-37f);
    float na = (m <= NEG_THRESH ? NEG_INF : safe + logf(summed)) +
               emit[((size_t)b * T + t) * U + u] + ps;
    na = fmaxf(na, NEG_INF);
    const float next = t < len ? na : a;
    __syncthreads();  // every thread has read alpha_{t-1}
    alpha[u] = next;
    a = next;
    if (hist != nullptr) hist[((size_t)t * B + b) * U + u] = next;
    __syncthreads();
  }
  afin[(size_t)b * U + u] = a;
}

// dfin (B, U) -> demit (B, T, U) (row t = 0 zero) and da0 (B, U)
__global__ void bwd_kernel(const float* __restrict__ emit, const float* __restrict__ skip,
                           const float* __restrict__ pos, const int* __restrict__ lens,
                           const float* __restrict__ hist, const float* __restrict__ dfin,
                           float* __restrict__ demit, float* __restrict__ da0, int B, int T,
                           int U) {
  extern __shared__ float sm[];
  float* v1 = sm;      // w1 * dpre of each position
  float* v2 = sm + U;  // w2 * dpre
  const int b = blockIdx.x;
  const int u = threadIdx.x;
  const float sk = skip[(size_t)b * U + u];
  const float ps = pos[(size_t)b * U + u];
  const int len = lens[b];
  float da = dfin[(size_t)b * U + u];
  demit[(size_t)b * T * U + u] = 0.f;
  for (int t = T - 1; t >= 1; --t) {
    const float* prev = hist + ((size_t)(t - 1) * B + b) * U;
    const float a_prev = prev[u];
    const float a_new = hist[((size_t)t * B + b) * U + u];
    const bool active = t < len;
    const float da_na = active ? da : 0.f;
    const float da_pass = active ? 0.f : da;
    const float e = emit[((size_t)b * T + t) * U + u];
    const float pre = a_new - e - ps;
    const float dpre = (active && a_new > NEG_THRESH) ? da_na : 0.f;
    demit[((size_t)b * T + t) * U + u] = dpre;
    const float sh1 = u >= 1 ? prev[u - 1] : NEG_INF;
    const float sh2 = (u >= 2 ? prev[u - 2] : NEG_INF) + sk;
    const float safe_pre = pre <= NEG_THRESH ? 0.f : pre;
    const float w0 = expf(fmaxf(a_prev - safe_pre, NEG_INF));
    const float w1 = expf(fmaxf(sh1 - safe_pre, NEG_INF));
    const float w2 = expf(fmaxf(sh2 - safe_pre, NEG_INF));
    v1[u] = w1 * dpre;
    v2[u] = w2 * dpre;
    __syncthreads();
    const float g1 = u + 1 < U ? v1[u + 1] : 0.f;
    const float g2 = u + 2 < U ? v2[u + 2] : 0.f;
    da = w0 * dpre + g1 + g2 + da_pass;
    __syncthreads();  // v1/v2 are rewritten next frame
  }
  da0[(size_t)b * U + u] = da;
}

}  // namespace

extern "C" int ctc_alpha_fwd(const void* emit, const void* alpha0, const void* skip,
                             const void* pos, const void* lens, void* hist, void* afin, int B,
                             int T, int U, void* stream) {
  if (B < 1 || T < 1 || U < 1 || U > 1024) return (int)cudaErrorInvalidValue;
  fwd_kernel<<<B, U, U * sizeof(float), static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(emit), static_cast<const float*>(alpha0),
      static_cast<const float*>(skip), static_cast<const float*>(pos),
      static_cast<const int*>(lens), static_cast<float*>(hist), static_cast<float*>(afin), B,
      T, U);
  return (int)cudaGetLastError();
}

extern "C" int ctc_alpha_bwd(const void* emit, const void* skip, const void* pos,
                             const void* lens, const void* hist, const void* dfin, void* demit,
                             void* da0, int B, int T, int U, void* stream) {
  if (B < 1 || T < 1 || U < 1 || U > 1024) return (int)cudaErrorInvalidValue;
  bwd_kernel<<<B, U, 2 * U * sizeof(float), static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(emit), static_cast<const float*>(skip),
      static_cast<const float*>(pos), static_cast<const int*>(lens),
      static_cast<const float*>(hist), static_cast<const float*>(dfin),
      static_cast<float*>(demit), static_cast<float*>(da0), B, T, U);
  return (int)cudaGetLastError();
}
