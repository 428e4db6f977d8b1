// The location-aware attention step of one hypothesis, as a block-wide
// device function: the body of att_loc.cu, which att_dec.cu runs too.
//
// For frame t of hypothesis (b, k):
//   loc[a] = sum_c feat[t, c] * wloc[c, a]                  (rounded to T)
//   pre[a] = (enc_proj[t, a] + loc[a]) + dec[a]              (rounded to T)
//   e[t]   = sum_a g[a] * tanh(pre[a])                       (tanh rounded to T)
// then e *= sharpening, frames with mask 0 get -1e9, a softmax over T with
// the hypothesis' own max, att = softmax * mask renormalised by
// max(sum, 1e-8), and ctx[e] = sum_t att[t] * enc[t, e]. T is the compute
// type (float or bfloat16); the rounding points are those of the plain
// version (the XLA beam branch of models/attention.py::AttLoc), all sums are
// float32.
//
// Every thread of the block calls it; the block size is a multiple of 32,
// at most 1,024. Each warp scores whole frames (lanes over A, a shuffle
// reduction), so no block-wide barrier is needed per frame; the scores stay
// in shared memory for the softmax and the context, where threads run over
// E with coalesced reads of enc.
#pragma once

#include "common.cuh"

namespace rg {

constexpr int kAttMaxC = 32;  // conv channels a warp keeps in shared memory
constexpr float kAttMaskMin = -1e9f;

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

// Block-wide reduction through red[32]; every thread gets the result.
template <bool kMax>
__device__ float block_reduce(float v, float* red) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int n_warps = blockDim.x / 32;
  v = kMax ? warp_max(v) : warp_sum(v);
  __syncthreads();  // red is free
  if (lane == 0) red[warp] = v;
  __syncthreads();
  v = lane < n_warps ? red[lane] : (kMax ? -CUDART_INF_F : 0.f);
  return kMax ? warp_max(v) : warp_sum(v);
}

// Shared scratch of att_loc_body: w_s (C * A) and g_s (A) hold wloc and g
// as float, loaded by the caller before the call; d_s (A), e_s (Tn), f_s
// (blockDim.x / 32 * kAttMaxC) and red (32) are the body's own.
struct AttScratch {
  const float* w_s;
  const float* g_s;
  float* d_s;
  float* e_s;
  float* f_s;
  float* red;
};

// Loads wloc (C, A) and g (A,) of the compute type into w_s and g_s.
template <typename T>
__device__ void att_load_weights(const T* wloc, const T* g, int C, int A, float* w_s,
                                 float* g_s) {
  for (int i = threadIdx.x; i < C * A; i += blockDim.x) w_s[i] = to_f(wloc[i]);
  for (int a = threadIdx.x; a < A; a += blockDim.x) g_s[a] = to_f(g[a]);
}

// One hypothesis: feat (Tn, C), enc_proj (Tn, A), enc (Tn, E), dec (A,),
// mask (Tn,) -> att (Tn,) and ctx (E,), both float32 (global or shared
// memory). Ends with a barrier, so the caller may reuse the scratch.
template <typename T>
__device__ void att_loc_body(const T* __restrict__ feat, const T* __restrict__ enc_proj,
                             const T* __restrict__ enc, const T* __restrict__ dec,
                             const float* __restrict__ mask, int Tn, int C, int A, int E,
                             float sharpening, const AttScratch& s, float* att, float* ctx) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int n_warps = blockDim.x / 32;
  float* f_w = s.f_s + warp * kAttMaxC;
  for (int a = threadIdx.x; a < A; a += blockDim.x) s.d_s[a] = to_f(dec[a]);
  __syncthreads();

  // ---- scores: one frame per warp at a time
  for (int t = warp; t < Tn; t += n_warps) {
    if (lane < C) f_w[lane] = to_f(feat[(size_t)t * C + lane]);
    __syncwarp();
    float part = 0.f;
    for (int a = lane; a < A; a += 32) {
      float loc = 0.f;
      for (int c = 0; c < C; ++c) loc = fmaf(f_w[c], s.w_s[c * A + a], loc);
      loc = rnd<T>(loc);
      const float pre = rnd<T>(rnd<T>(to_f(enc_proj[(size_t)t * A + a]) + loc) + s.d_s[a]);
      part = fmaf(rnd<T>(tanhf(pre)), s.g_s[a], part);
    }
    part = warp_sum(part);
    if (lane == 0) s.e_s[t] = part;
    __syncwarp();  // f_w is read before the next frame overwrites it
  }
  __syncthreads();

  // ---- sharpened, masked softmax over T
  float vmax = -CUDART_INF_F;
  for (int t = threadIdx.x; t < Tn; t += blockDim.x) {
    const float v = mask[t] > 0.f ? sharpening * s.e_s[t] : kAttMaskMin;
    s.e_s[t] = v;
    vmax = fmaxf(vmax, v);
  }
  vmax = block_reduce<true>(vmax, s.red);
  float vsum = 0.f;
  for (int t = threadIdx.x; t < Tn; t += blockDim.x) {
    const float ex = expf(s.e_s[t] - vmax);
    s.e_s[t] = ex;
    vsum += ex;
  }
  vsum = block_reduce<false>(vsum, s.red);
  float msum = 0.f;
  for (int t = threadIdx.x; t < Tn; t += blockDim.x) {
    const float p = s.e_s[t] / vsum * mask[t];
    s.e_s[t] = p;
    msum += p;
  }
  msum = fmaxf(block_reduce<false>(msum, s.red), 1e-8f);
  for (int t = threadIdx.x; t < Tn; t += blockDim.x) {
    const float p = s.e_s[t] / msum;
    s.e_s[t] = p;
    att[t] = p;
  }
  __syncthreads();

  // ---- context
  for (int e = threadIdx.x; e < E; e += blockDim.x) {
    float acc = 0.f;
    for (int t = 0; t < Tn; ++t) acc = fmaf(s.e_s[t], to_f(enc[(size_t)t * E + e]), acc);
    ctx[e] = acc;
  }
  __syncthreads();  // d_s and e_s are free again
}

}  // namespace rg
