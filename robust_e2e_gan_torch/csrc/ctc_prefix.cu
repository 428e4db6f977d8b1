// CTC prefix scoring of the joint CTC/attention beam search.
//
// Replaces robust_e2e_gan_tpu/ops/ctc_prefix_tiled.py::prefix_psi_tiled
// (ctc_prefix_psi) and ::prefix_state_tiled (ctc_prefix_state): the
// Watanabe prefix recursion in log space over T frames,
//   phi_t = t == 0 ? phi0 : (tok == last ? r_b[t-1] : logaddexp(r_n, r_b)[t-1])
//   r_n_t = x_t[tok]   + logaddexp(r_n_{t-1}, phi_t)
//   r_b_t = x_t[blank] + logaddexp(r_n_{t-1}, r_b_{t-1})
//   psi   = logaddexp over t of (phi_t + x_t[tok])
// with phi0 = 0 for the empty prefix and LOG_ZERO otherwise. The eos and
// blank candidate columns of psi are set outside, as in the JAX package.
//
// What bounds it on Hopper: the serial chain of T dependent log-space
// steps per lane (expf and log1pf on the critical path). The data are
// small: lpz (B, T, V) and the parents' r_n/r_b (B, K, T) stay in L2.
//
// Design. psi: one thread per (b, k, v) lane, v fastest, so a warp's reads
// of lpz[b, t, :] coalesce and the parent's r_n/r_b at t-1 are one
// broadcast read. psi depends on phi and x alone, so the r_n/r_b carries
// of the V extensions, which the pruning never reads, are not computed.
// state: one thread per (b, k), walking T and writing r_n/r_b of the
// selected extension.

#include "common.cuh"

namespace {

__global__ void psi_kernel(const float* __restrict__ lpz,     // (B, T, V)
                           const int* __restrict__ last_tok,  // (B, K)
                           const int* __restrict__ lengths,   // (B, K)
                           const float* __restrict__ r_n,     // (B, K, T)
                           const float* __restrict__ r_b,     // (B, K, T)
                           float* __restrict__ psi,           // (B, K, V)
                           int B, int K, int T, int V) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= B * K * V) return;
  const int v = idx % V;
  const int bk = idx / V;
  const int b = bk / K;
  const int len = lengths[bk];
  const bool is_last = v == last_tok[bk] && len > 0;
  const float* x = lpz + (size_t)b * T * V + v;
  const float* rn = r_n + (size_t)bk * T;
  const float* rb = r_b + (size_t)bk * T;
  float acc = rg::LOG_ZERO;
  float phi = len == 0 ? 0.f : rg::LOG_ZERO;
  for (int t = 0; t < T; ++t) {
    if (t > 0) phi = is_last ? rb[t - 1] : rg::logaddexp(rn[t - 1], rb[t - 1]);
    acc = rg::logaddexp(acc, phi + x[(size_t)t * V]);
  }
  psi[idx] = acc;
}

__global__ void state_kernel(const float* __restrict__ lpz,     // (B, T, V)
                             const int* __restrict__ tok,       // (B, K)
                             const int* __restrict__ last_tok,  // (B, K)
                             const int* __restrict__ lengths,   // (B, K)
                             const float* __restrict__ r_n,     // (B, K, T)
                             const float* __restrict__ r_b,     // (B, K, T)
                             float* __restrict__ rn_out,        // (B, K, T)
                             float* __restrict__ rb_out,        // (B, K, T)
                             int B, int K, int T, int V, int blank) {
  const int bk = blockIdx.x * blockDim.x + threadIdx.x;
  if (bk >= B * K) return;
  const int b = bk / K;
  const int c = tok[bk];
  const int len = lengths[bk];
  const bool is_last = c == last_tok[bk] && len > 0;
  const float* x = lpz + (size_t)b * T * V;
  const float* rn_p = r_n + (size_t)bk * T;
  const float* rb_p = r_b + (size_t)bk * T;
  float* rn_o = rn_out + (size_t)bk * T;
  float* rb_o = rb_out + (size_t)bk * T;
  float rn = rg::LOG_ZERO, rb = rg::LOG_ZERO;
  float phi = len == 0 ? 0.f : rg::LOG_ZERO;
  for (int t = 0; t < T; ++t) {
    if (t > 0) phi = is_last ? rb_p[t - 1] : rg::logaddexp(rn_p[t - 1], rb_p[t - 1]);
    const float* xt = x + (size_t)t * V;
    const float rn_new = xt[c] + rg::logaddexp(rn, phi);
    rb = xt[blank] + rg::logaddexp(rn, rb);
    rn = rn_new;
    rn_o[t] = rn;
    rb_o[t] = rb;
  }
}

constexpr int kThreads = 256;

}  // namespace

extern "C" int ctc_prefix_psi(const void* lpz, const void* last_tok, const void* lengths,
                              const void* r_n, const void* r_b, void* psi, int B, int K,
                              int T, int V, void* stream) {
  if (B < 1 || K < 1 || T < 1 || V < 1) return (int)cudaErrorInvalidValue;
  const int n = B * K * V;
  psi_kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0,
               static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(lpz), static_cast<const int*>(last_tok),
      static_cast<const int*>(lengths), static_cast<const float*>(r_n),
      static_cast<const float*>(r_b), static_cast<float*>(psi), B, K, T, V);
  return (int)cudaGetLastError();
}

extern "C" int ctc_prefix_state(const void* lpz, const void* tok, const void* last_tok,
                                const void* lengths, const void* r_n, const void* r_b,
                                void* rn_out, void* rb_out, int B, int K, int T, int V,
                                int blank, void* stream) {
  if (B < 1 || K < 1 || T < 1 || V < 1 || blank < 0 || blank >= V)
    return (int)cudaErrorInvalidValue;
  const int n = B * K;
  state_kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0,
                 static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(lpz), static_cast<const int*>(tok),
      static_cast<const int*>(last_tok), static_cast<const int*>(lengths),
      static_cast<const float*>(r_n), static_cast<const float*>(r_b),
      static_cast<float*>(rn_out), static_cast<float*>(rb_out), B, K, T, V, blank);
  return (int)cudaGetLastError();
}
