// CTC prefix scores psi of every vocabulary extension, one block per
// utterance.
//
// Replaces robust_e2e_gan_tpu/ops/ctc_prefix_pallas.py::prefix_scores_psi_pallas
// (kernel _kernel, grid = (B,)): the function of ctc_prefix.cu's psi kernel,
//   phi_t = t == 0 ? phi0 : (v == last && len > 0 ? r_b[t-1] : logaddexp(r_n, r_b)[t-1])
//   psi   = logaddexp over t of (phi_t + lpz[t, v])
// with phi0 = 0 for the empty prefix and LOG_ZERO otherwise, and, as in the
// TPU kernel, the eos column (logaddexp(r_n, r_b)[T-1], the full-sequence
// CTC score of the prefix itself) and the blank column (LOG_ZERO) written
// here. The TPU kernel also carries the r_n/r_b recursions of every
// extension through its frame loop, but nothing it returns reads them, so
// only psi is carried here.
//
// What bounds it on Hopper: the serial chain of T dependent log-space
// steps per lane (expf and log1pf on the critical path); the data, lpz
// (T, V) and the K parents' rows, are read once per utterance.
//
// Design: one block per utterance, as the TPU's grid; unlike ctc_prefix.cu,
// whose threads each read their own column from L2, the block first stages
// the utterance's lpz rows and its K parents' r_b and logaddexp(r_n, r_b)
// rows in shared memory. Its threads are the K x V lanes (k, v), v fastest;
// the frame loop then runs on chip, with psi in a register.

#include "common.cuh"

namespace {

__global__ void psi_utt_kernel(const float* __restrict__ lpz,     // (B, T, V)
                               const int* __restrict__ last_tok,  // (B, K)
                               const int* __restrict__ lengths,   // (B, K)
                               const float* __restrict__ r_n,     // (B, K, T)
                               const float* __restrict__ r_b,     // (B, K, T)
                               float* __restrict__ psi,           // (B, K, V)
                               int K, int T, int V, int blank, int eos) {
  extern __shared__ float smem[];
  float* x_s = smem;                 // (T, V): the utterance's lpz
  float* rb_s = x_s + (size_t)T * V; // (K, T): parents' r_b
  float* rs_s = rb_s + (size_t)K * T;// (K, T): parents' logaddexp(r_n, r_b)
  const int b = blockIdx.x;
  const float* lpz_b = lpz + (size_t)b * T * V;
  for (int i = threadIdx.x; i < T * V; i += blockDim.x) x_s[i] = lpz_b[i];
  const size_t off = (size_t)b * K * T;
  for (int i = threadIdx.x; i < K * T; i += blockDim.x) {
    const float rb = r_b[off + i];
    rb_s[i] = rb;
    rs_s[i] = rg::logaddexp(r_n[off + i], rb);
  }
  __syncthreads();

  const int lane = threadIdx.x;
  if (lane >= K * V) return;
  const int k = lane / V, v = lane % V;
  const int bk = b * K + k;
  const int len = lengths[bk];
  const float* phi_row = (v == last_tok[bk] && len > 0) ? rb_s + k * T : rs_s + k * T;
  float acc = rg::LOG_ZERO;
  float phi = len == 0 ? 0.f : rg::LOG_ZERO;
  for (int t = 0; t < T; ++t) {
    if (t > 0) phi = phi_row[t - 1];
    acc = rg::logaddexp(acc, phi + x_s[t * V + v]);
  }
  if (v == eos) acc = rs_s[k * T + T - 1];
  if (v == blank) acc = rg::LOG_ZERO;
  psi[(size_t)bk * V + v] = acc;
}

}  // namespace

extern "C" int ctc_prefix_utt(const void* lpz, const void* last_tok, const void* lengths,
                              const void* r_n, const void* r_b, void* psi, int B, int K,
                              int T, int V, int blank, int eos, void* stream) {
  if (B < 1 || K < 1 || T < 1 || V < 1 || K * V > 1024) return (int)cudaErrorInvalidValue;
  const size_t smem = ((size_t)T * V + 2 * (size_t)K * T) * sizeof(float);
  const cudaError_t err = rg::reserve_smem<psi_utt_kernel>(smem);
  if (err != cudaSuccess) return (int)err;
  const int threads = ((K * V + 31) / 32) * 32;
  psi_utt_kernel<<<B, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(lpz), static_cast<const int*>(last_tok),
      static_cast<const int*>(lengths), static_cast<const float*>(r_n),
      static_cast<const float*>(r_b), static_cast<float*>(psi), K, T, V, blank, eos);
  return (int)cudaGetLastError();
}
