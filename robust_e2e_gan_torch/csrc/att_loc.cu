// One beam step of location-aware attention (AttLoc) for every hypothesis.
//
// Replaces robust_e2e_gan_tpu/ops/att_pallas.py::att_loc_fused. What one
// hypothesis computes, and how a block computes it, is att_body.cuh.
//
// What bounds it on Hopper: the reads of enc_proj and enc (B x T x A and
// B x T x E), once per hypothesis, and the T x A tanh evaluations. The
// (B, K, T, A) location projection, which the plain version writes to and
// reads back from device memory, never leaves the SM here.
//
// Design: one block per hypothesis (B*K blocks). wloc, the hypothesis' dec
// row and g sit in shared memory. The K hypotheses of one utterance read
// the same enc_proj and enc rows, which L2 serves.

#include "att_body.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

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
  float* g_s = w_s + C * A;   // A
  float* d_s = g_s + A;       // A
  float* e_s = d_s + A;       // Tn: scores, then the alignment
  __shared__ float f_s[kWarps * rg::kAttMaxC];
  __shared__ float red[32];

  const int bk = blockIdx.x;
  const int b = bk / K;
  rg::att_load_weights(wloc, g, C, A, w_s, g_s);
  const rg::AttScratch s{w_s, g_s, d_s, e_s, f_s, red};
  rg::att_loc_body<T>(feat + (size_t)bk * Tn * C, enc_proj + (size_t)b * Tn * A,
                      enc + (size_t)b * Tn * E, dec + (size_t)bk * A, mask + (size_t)b * Tn,
                      Tn, C, A, E, sharpening, s, att + (size_t)bk * Tn, ctx + (size_t)bk * E);
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
  if (B < 1 || K < 1 || Tn < 1 || C < 1 || C > rg::kAttMaxC || A < 1 || E < 1)
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
