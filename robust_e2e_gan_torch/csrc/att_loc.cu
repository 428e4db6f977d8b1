// One beam step of location-aware attention (AttLoc) for every hypothesis.
//
// Replaces robust_e2e_gan_tpu/ops/att_pallas.py::att_loc_fused. For
// hypothesis (b, k) and frame t:
//   loc[a] = sum_c feat[b,k,t,c] * wloc[c,a]                (rounded to T)
//   pre[a] = (enc_proj[b,t,a] + loc[a]) + dec[b,k,a]        (rounded to T)
//   e[t]   = sum_a g[a] * tanh(pre[a])                      (tanh rounded to T)
// then e *= sharpening, frames with mask 0 get -1e9, a softmax over T with
// the hypothesis' own max, att = softmax * mask renormalised by
// max(sum, 1e-8), and ctx[e] = sum_t att[t] * enc[b,t,e]. T is the compute
// type (float or bfloat16); the rounding points are those of the plain
// version (the XLA beam branch of models/attention.py::AttLoc), all sums are
// float32.
//
// What bounds it on Hopper: the reads of enc_proj and enc (B x T x A and
// B x T x E), once per hypothesis, and the T x A tanh evaluations. The
// (B, K, T, A) location projection, which the plain version writes to and
// reads back from device memory, never leaves the SM here.
//
// Design: one block per hypothesis (B*K blocks). wloc, the hypothesis' dec
// row and g sit in shared memory; each warp scores whole frames (lanes over
// A, a shuffle reduction), so no block-wide barrier is needed per frame.
// The scores stay in shared memory for the softmax and the context, where
// threads run over E with coalesced reads of enc. The K hypotheses of one
// utterance read the same enc_proj and enc rows, which L2 serves.

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxC = 32;
constexpr float kMaskMin = -1e9f;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Block-wide reduction; every thread gets the result.
template <bool kMax>
__device__ float block_reduce(float v, float* red) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  v = kMax ? warp_max(v) : warp_sum(v);
  __syncthreads();  // red is free
  if (lane == 0) red[warp] = v;
  __syncthreads();
  v = lane < kWarps ? red[lane] : (kMax ? -CUDART_INF_F : 0.f);
  return kMax ? warp_max(v) : warp_sum(v);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
att_loc_kernel(const T* __restrict__ feat,      // (B, K, Tn, C)
               const T* __restrict__ enc_proj,  // (B, Tn, A)
               const T* __restrict__ enc,       // (B, Tn, E)
               const T* __restrict__ dec,       // (B, K, A)
               const T* __restrict__ wloc,      // (C, A)
               const T* __restrict__ g,         // (A,)
               const float* __restrict__ mask,  // (B, Tn)
               float* __restrict__ ctx,         // (B, K, E)
               float* __restrict__ att,         // (B, K, Tn)
               int K, int Tn, int C, int A, int E, float sharpening) {
  extern __shared__ float smem[];
  float* w_s = smem;          // C * A
  float* d_s = w_s + C * A;   // A
  float* g_s = d_s + A;       // A
  float* e_s = g_s + A;       // Tn: scores, then the alignment
  __shared__ float f_s[kWarps][kMaxC];
  __shared__ float red[32];

  const int bk = blockIdx.x;
  const int b = bk / K;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  for (int i = threadIdx.x; i < C * A; i += kThreads) w_s[i] = rg::to_f(wloc[i]);
  for (int a = threadIdx.x; a < A; a += kThreads) {
    d_s[a] = rg::to_f(dec[(size_t)bk * A + a]);
    g_s[a] = rg::to_f(g[a]);
  }
  __syncthreads();

  // ---- scores: one frame per warp at a time
  const T* ep_b = enc_proj + (size_t)b * Tn * A;
  for (int t = warp; t < Tn; t += kWarps) {
    if (lane < C) f_s[warp][lane] = rg::to_f(feat[((size_t)bk * Tn + t) * C + lane]);
    __syncwarp();
    float part = 0.f;
    for (int a = lane; a < A; a += 32) {
      float loc = 0.f;
      for (int c = 0; c < C; ++c) loc = fmaf(f_s[warp][c], w_s[c * A + a], loc);
      loc = rg::rnd<T>(loc);
      const float pre = rg::rnd<T>(rg::rnd<T>(rg::to_f(ep_b[(size_t)t * A + a]) + loc)
                                   + d_s[a]);
      part = fmaf(rg::rnd<T>(tanhf(pre)), g_s[a], part);
    }
    part = warp_sum(part);
    if (lane == 0) e_s[t] = part;
    __syncwarp();  // f_s[warp] is read before the next frame overwrites it
  }
  __syncthreads();

  // ---- sharpened, masked softmax over T
  const float* m_b = mask + (size_t)b * Tn;
  float vmax = -CUDART_INF_F;
  for (int t = threadIdx.x; t < Tn; t += kThreads) {
    const float v = m_b[t] > 0.f ? sharpening * e_s[t] : kMaskMin;
    e_s[t] = v;
    vmax = fmaxf(vmax, v);
  }
  vmax = block_reduce<true>(vmax, red);
  float vsum = 0.f;
  for (int t = threadIdx.x; t < Tn; t += kThreads) {
    const float ex = expf(e_s[t] - vmax);
    e_s[t] = ex;
    vsum += ex;
  }
  vsum = block_reduce<false>(vsum, red);
  float msum = 0.f;
  for (int t = threadIdx.x; t < Tn; t += kThreads) {
    const float p = e_s[t] / vsum * m_b[t];
    e_s[t] = p;
    msum += p;
  }
  msum = fmaxf(block_reduce<false>(msum, red), 1e-8f);
  float* att_bk = att + (size_t)bk * Tn;
  for (int t = threadIdx.x; t < Tn; t += kThreads) {
    const float p = e_s[t] / msum;
    e_s[t] = p;
    att_bk[t] = p;
  }
  __syncthreads();

  // ---- context
  const T* enc_b = enc + (size_t)b * Tn * E;
  for (int e = threadIdx.x; e < E; e += kThreads) {
    float acc = 0.f;
    for (int t = 0; t < Tn; ++t) acc = fmaf(e_s[t], rg::to_f(enc_b[(size_t)t * E + e]), acc);
    ctx[(size_t)bk * E + e] = acc;
  }
}

template <typename T>
cudaError_t launch(const void* feat, const void* enc_proj, const void* enc, const void* dec,
                   const void* wloc, const void* g, const float* mask, float* ctx,
                   float* att, int B, int K, int Tn, int C, int A, int E,
                   float sharpening, cudaStream_t stream) {
  const size_t smem = ((size_t)C * A + 2 * (size_t)A + Tn) * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        att_loc_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  att_loc_kernel<T><<<B * K, kThreads, smem, stream>>>(
      static_cast<const T*>(feat), static_cast<const T*>(enc_proj),
      static_cast<const T*>(enc), static_cast<const T*>(dec),
      static_cast<const T*>(wloc), static_cast<const T*>(g), mask, ctx, att, K, Tn, C,
      A, E, sharpening);
  return cudaGetLastError();
}

}  // namespace

extern "C" int att_loc_step(const void* feat, const void* enc_proj, const void* enc,
                            const void* dec, const void* wloc, const void* g,
                            const void* mask, void* ctx, void* att, int B, int K, int Tn,
                            int C, int A, int E, float sharpening, int bf16, void* stream) {
  if (B < 1 || K < 1 || Tn < 1 || C < 1 || C > kMaxC || A < 1 || E < 1)
    return (int)cudaErrorInvalidValue;
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* m = static_cast<const float*>(mask);
  auto* c = static_cast<float*>(ctx);
  auto* a = static_cast<float*>(att);
  if (bf16)
    return (int)launch<__nv_bfloat16>(feat, enc_proj, enc, dec, wloc, g, m, c, a, B, K, Tn,
                                      C, A, E, sharpening, s);
  return (int)launch<float>(feat, enc_proj, enc, dec, wloc, g, m, c, a, B, K, Tn, C, A, E,
                            sharpening, s);
}
