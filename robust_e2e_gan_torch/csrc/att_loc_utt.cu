// One beam step of location-aware attention with one block per utterance:
// the "utt" route of ops/att.py::att_loc_step.
//
// Replaces robust_e2e_gan_tpu/ops/att_pallas.py::att_loc_fused (:178,
// pallas_call :251) wherever ops/att.py::utt_plan fits; csrc/att_loc.cu,
// one block per hypothesis (the "hyp" route), takes the other shapes. The
// contract and the rounding points are att_body.cuh's, the plain version's
// (ops/att.py::att_loc_step_plain):
//   loc = rnd(sum_c feat * wloc)                  (float32 sums)
//   pre = rnd(rnd(enc_proj + loc) + dec)
//   e   = sum_a f32(rnd(tanhf(pre))) * g          (float32 sums)
// then sharpening, frames with mask 0 at -1e9, a softmax with each
// hypothesis' own max, x mask, renormalised by max(sum, 1e-8), and the
// float32 context. rnd rounds to the compute type T (float or bfloat16).
//
// What bounds it on Hopper: the B x K x T x A elementwise chain, on the
// issue slots: at the flagship (B=128, K=8, T=174, A=256) 45.6 M elements
// of two adds, three roundings, tanhf (~15 instructions and two
// special-function ops, kept accurate) and one FMA, ~21 instructions an
// element. The bytes (enc_proj, enc, feat; 28.8 MB) are read once and
// hide under it. The per-hypothesis route reads enc_proj and enc once
// per hypothesis (K times) and runs the location projection on the CUDA
// cores with two shared loads per FMA.
//
// Design. Block b runs utterance b's K hypotheses, so every enc_proj and
// enc element is read from device memory once. Frames go in chunks of F =
// 16 G: enc_proj's rows and each hypothesis' feat rows of chunk i + 1 are
// copied to shared memory by cp.async while chunk i is scored (double
// buffered); dec, wloc and g come with chunk 0, and the last chunk's
// copies start enc's first chunk. feat is repacked per chunk into the
// product's layout (channels padded to CP = 16 or 32 with zeros, rows CP
// + 8 elements apart, so ldmatrix reads eight rows on distinct banks).
// The warps form S column splits by G frame groups: warp (s, grp) takes
// the chunk's 16-frame tile grp and the 8-column tiles s, s + S, ... of A.
// For a group of KG = 4 hypotheses and per column tile it loads its
// enc_proj, g and wloc fragments once and, for each hypothesis, runs the
// location projection of the 16 x 8 tile (bfloat16: mma.sync m16n8k16 on
// the tensor cores, one or two k-steps; float32: FMAs with the two
// columns' weights in registers), adds enc_proj and dec (bfloat16: one
// packed conversion for loc, the adds as bfloat16 pairs, one packed
// conversion for the tanh), takes tanhf and accumulates g * tanh into
// per-row partial scores in registers. A quad shuffle ends the tile's
// columns; the S splits' partial scores meet in shared memory and are
// summed in a fixed order (reruns are bit-identical). The (T, Kp) scores
// stay in shared memory. The softmax runs one warp per hypothesis. For
// the context, each thread owns a column of E for a group of four
// hypotheses, reads each staged enc element once for the group and the
// group's four att values of a frame as one float4. att and ctx are
// written coalesced. Hypotheses past K (up to a multiple of KG) run on
// zero inputs and are dropped.
//
// The tanh stays the accurate tanhf: 45.6 M of them a launch at the
// flagship already cost ~11 us at one special-function op each on 132
// SMs (tanhf takes two), more than the bytes bound.

#include "att_utt_body.cuh"

namespace {

template <typename T>
__global__ void __launch_bounds__(kThreads<T>, 1)
att_utt_kernel(const T* __restrict__ feat,      // (B, K, Tn, C)
               const T* __restrict__ enc_proj,  // (B, Tn, A)
               const T* __restrict__ enc,       // (B, Tn, E)
               const T* __restrict__ dec,       // (B, K, A)
               const T* __restrict__ wloc,      // (C, A)
               const T* __restrict__ g,         // (A,)
               const float* __restrict__ mask,  // (B, Tn)
               float* __restrict__ ctx,         // (B, K, E)
               float* __restrict__ att,         // (B, K, Tn)
               int K, int Tn, int C, int A, int E, int F, int S, float sharpening) {
  extern __shared__ __align__(16) char smem[];
  const int b = blockIdx.x;
  float* ctx_b = ctx + (size_t)b * K * E;
  att_utt_body<T>(feat, enc_proj, enc, dec, wloc, g, mask, att, b, K, Tn, C, A, E, F, S,
                  sharpening, smem, [=](int i, float v) { ctx_b[i] = v; });
}

template <typename T>
cudaError_t launch(const void* feat, const void* enc_proj, const void* enc, const void* dec,
                   const void* wloc, const void* g, const float* mask, float* ctx, float* att,
                   int B, int K, int Tn, int C, int A, int E, int F, int S, size_t smem,
                   float sharpening, cudaStream_t stream) {
  constexpr int NW = kThreads<T> / 32;
  if (S < 1 || NW % S || F != 16 * (NW / S) ||
      layout(K, Tn, C, A, E, F, S, sizeof(T)).total != smem)
    return cudaErrorInvalidValue;
  const cudaError_t err = rg::reserve_smem<att_utt_kernel<T>>(smem);
  if (err != cudaSuccess) {
    cudaGetLastError();
    return err;
  }
  att_utt_kernel<T><<<B, kThreads<T>, smem, stream>>>(
      static_cast<const T*>(feat), static_cast<const T*>(enc_proj),
      static_cast<const T*>(enc), static_cast<const T*>(dec), static_cast<const T*>(wloc),
      static_cast<const T*>(g), mask, ctx, att, K, Tn, C, A, E, F, S, sharpening);
  return cudaGetLastError();
}

}  // namespace

// F frames a chunk and S column splits from ops/att.py::utt_plan, smem
// its byte count: a plan that disagrees with the kernel's layout is
// refused before the launch.
extern "C" int att_loc_utt(const void* feat, const void* enc_proj, const void* enc,
                           const void* dec, const void* wloc, const void* g, const void* mask,
                           void* ctx, void* att, int B, int K, int Tn, int C, int A, int E,
                           int F, int S, int smem, float sharpening, int bf16, void* stream) {
  if (B < 1 || K < 1 || K > KMAX || Tn < 1 || C < 1 || C > CMAX || A < 1 || E < 1)
    return (int)cudaErrorInvalidValue;
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* m = static_cast<const float*>(mask);
  auto* c = static_cast<float*>(ctx);
  auto* a = static_cast<float*>(att);
  if (bf16)
    return (int)launch<__nv_bfloat16>(feat, enc_proj, enc, dec, wloc, g, m, c, a, B, K, Tn, C,
                                      A, E, F, S, (size_t)smem, sharpening, s);
  return (int)launch<float>(feat, enc_proj, enc, dec, wloc, g, m, c, a, B, K, Tn, C, A, E, F,
                            S, (size_t)smem, sharpening, s);
}
