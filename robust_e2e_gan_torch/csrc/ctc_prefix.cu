// CTC prefix scoring of the joint CTC/attention beam search.
//
// Replaces robust_e2e_gan_tpu/ops/ctc_prefix_tiled.py::prefix_psi_tiled
// (ctc_prefix_psi_utt, ctc_prefix_psi) and ::prefix_state_tiled
// (ctc_prefix_state_utt, ctc_prefix_state): the Watanabe prefix recursion
// in log space over T frames,
//   phi_t = t == 0 ? phi0 : (tok == last ? r_b[t-1] : logaddexp(r_n, r_b)[t-1])
//   r_n_t = x_t[tok]   + logaddexp(r_n_{t-1}, phi_t)
//   r_b_t = x_t[blank] + logaddexp(r_n_{t-1}, r_b_{t-1})
//   psi   = logaddexp over t of (phi_t + x_t[tok]), from LOG_ZERO
// with phi0 = 0 for the empty prefix and LOG_ZERO otherwise.
//
// Two routes, chosen before the launch by ops/ctc_prefix.py (psi_plan,
// state_plan).
//
// Route "utt", one block per utterance. B = 128 blocks fill 128 of the
// 132 SMs, and every frame step reads shared memory and registers only.
//   state: lpz in chunks of F frames, the chosen extensions' phi (K, F)
//   and their r_n/r_b outputs are double-buffered in shared memory. Warp 0
//   walks the chain, one thread per hypothesis, while warps 1-7 write the
//   previous chunk's rows out and stage the next chunk, all with
//   coalesced accesses along T. The kernel also does the searcher's work
//   around the call: it reads each parent row by k_idx and writes the
//   parent row unchanged where append is false. Outputs are fresh rows:
//   other blocks' parents are never written.
//   psi: not a recursion but a log-sum-exp over frames. Each (k, v) lane's
//   frames are split over S threads (every S-th frame); each thread keeps
//   an online max-shifted (max, sum) pair, one exponential a term, over lpz
//   chunks staged in shared memory with the (K, F) phi tables, computed
//   once per (k, t). The S pairs and the LOG_ZERO start term are combined
//   in a fixed order, so reruns are bit-identical. The eos column
//   (logaddexp(r_n, r_b)[T-1]) and the blank column (LOG_ZERO) are set
//   here.
// What bounds it, as measured at the decode shape (PERF.md rows 3 and 4,
// tools/ctc_prefix_phases.py): the state, its chain, ~90% of the launch at
// ~234 cycles a frame: one accurate logaddexp (expf, then log1pf) on the
// critical path of each frame, with the next frame's inputs read ahead.
// psi, the issue of ~15 instructions a term over K x V x T terms an
// utterance (~60% of the launch), then staging its 47 KB (~25%).
//
// Route "lane", one thread per (b, k[, v]) lane, past the plans (K > 32
// for the state, K x V > 1024 for psi, or lpz chunks too wide for shared
// memory). Each frame step reads the lane's own parents and lpz from L2,
// dependent loads on the state's chain: L2 latency binds it, with few
// warps to hide it (1,024 state lanes are 4 blocks on 4 SMs), ~6x the
// "utt" route's time at the decode shape. psi recomputes
// logaddexp(r_n, r_b) for each of the V columns and keeps a serial
// logaddexp chain; its eos and blank columns are set outside.

#include "common.cuh"

// clock64() marks of thread 0 for robust_e2e_gan_torch/tools/
// ctc_prefix_phases.py, which defines them; empty in the library build.
#ifndef PHASE_BEGIN
#define PHASE_BEGIN
#define PHASE(n)
#define PHASE_END(kernel)
#endif

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

// ---- route "utt" ----------------------------------------------------------

constexpr int kStateThreads = 256;  // warp 0: the chain; warps 1-7: copies
constexpr int kStateMaxK = 32;      // hypotheses warp 0 carries
constexpr int kPsiMaxThreads = 1024;

// Shared floats of one state buffer: lpz (F, V), then phi, r_n and r_b of
// the K extensions (K, F) each.
__host__ __device__ inline size_t state_buffer(int K, int V, int F) {
  return (size_t)F * V + 3 * (size_t)K * F;
}

// Starts dst[i] = src[i] for i = first, first + step, ... below n as
// asynchronous copies to shared memory (cp.async), so the phi tables'
// loads overlap them; copy_wait() completes this thread's copies.
__device__ __forceinline__ void copy_rows(float* dst, const float* src, int n, int first,
                                          int step) {
  for (int i = first; i < n; i += step)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(rg::smem_addr(dst + i)),
                 "l"(src + i)
                 : "memory");
}

__device__ __forceinline__ void copy_wait() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

__global__ void __launch_bounds__(kStateThreads)
    state_utt_kernel(const float* __restrict__ lpz,          // (B, T, V)
                     const long long* __restrict__ k_idx,    // (B, K) or null: parent k
                     const int* __restrict__ tok,            // (B, K)
                     const bool* __restrict__ append,        // (B, K) or null: all true
                     const int* __restrict__ last_tok,       // (B, K) by parent
                     const int* __restrict__ lengths,        // (B, K) by parent
                     const float* __restrict__ r_n,          // (B, K, T) by parent
                     const float* __restrict__ r_b,          // (B, K, T) by parent
                     float* __restrict__ rn_out,             // (B, K, T)
                     float* __restrict__ rb_out,             // (B, K, T)
                     int K, int T, int V, int blank, int F) {
  extern __shared__ float smem[];
  __shared__ int s_par[kStateMaxK], s_tok[kStateMaxK];
  __shared__ bool s_app[kStateMaxK], s_last[kStateMaxK];
  __shared__ float s_phi0[kStateMaxK];
  PHASE_BEGIN
  const int b = blockIdx.x, tid = threadIdx.x;
  const size_t row0 = (size_t)b * K * T;  // row (b, 0) of the (B, K, T) tensors
  if (tid < K) {
    const int bk = b * K + tid;
    const int par = k_idx ? (int)k_idx[bk] : tid;
    const int c = tok[bk];
    const int len = lengths[b * K + par];
    s_par[tid] = par;
    s_tok[tid] = c;
    s_app[tid] = append ? append[bk] : true;
    s_last[tid] = c == last_tok[b * K + par] && len > 0;
    s_phi0[tid] = len == 0 ? 0.f : rg::LOG_ZERO;
  }
  __syncthreads();
  PHASE(0)
  const size_t stride = state_buffer(K, V, F);
  const float* lpz_b = lpz + (size_t)b * T * V;
  const int n_chunks = (T + F - 1) / F;

  // lpz rows and phi of chunk c, by threads first, first + step, ...
  auto stage = [&](int c, int first, int step) {
    float* x = smem + (c & 1) * stride;
    float* phi = x + (size_t)F * V;
    const int t0 = c * F, fc = min(F, T - t0);
    copy_rows(x, lpz_b + (size_t)t0 * V, fc * V, first, step);
    for (int i = first; i < K * fc; i += step) {
      const int k = i / fc, t = i - k * fc;
      float p = s_phi0[k];
      if (t0 + t > 0) {
        const size_t at = row0 + (size_t)s_par[k] * T + t0 + t - 1;
        const float rb = r_b[at];
        p = s_last[k] ? rb : rg::logaddexp(r_n[at], rb);
      }
      phi[k * F + t] = p;
    }
    copy_wait();
  };
  // chunk c's rows to global memory: the chain's where append, else the
  // parent's
  auto write = [&](int c, int first, int step) {
    const float* rn_s = smem + (c & 1) * stride + (size_t)F * V + (size_t)K * F;
    const float* rb_s = rn_s + (size_t)K * F;
    const int t0 = c * F, fc = min(F, T - t0);
    for (int i = first; i < K * fc; i += step) {
      const int k = i / fc, t = i - k * fc;
      const size_t o = row0 + (size_t)k * T + t0 + t;
      if (s_app[k]) {
        rn_out[o] = rn_s[k * F + t];
        rb_out[o] = rb_s[k * F + t];
      } else {
        const size_t p = row0 + (size_t)s_par[k] * T + t0 + t;
        rn_out[o] = r_n[p];
        rb_out[o] = r_b[p];
      }
    }
  };

  stage(0, tid, kStateThreads);
  __syncthreads();
  PHASE(1)
  float rn = rg::LOG_ZERO, rb = rg::LOG_ZERO;
  for (int c = 0; c < n_chunks; ++c) {
    if (tid < 32) {
      if (tid < K && s_app[tid]) {
        float* x = smem + (c & 1) * stride;
        const float* phi = x + (size_t)F * V + tid * F;
        float* rn_s = x + (size_t)F * V + (size_t)K * F + tid * F;
        float* rb_s = rn_s + (size_t)K * F;
        const int fc = min(F, T - c * F), ct = s_tok[tid];
        float xc = x[ct], xb = x[blank], ph = phi[0];
        for (int t = 0; t < fc; ++t) {
          // the next frame's inputs, read before this frame's stores
          const int tn = min(t + 1, fc - 1);
          const float xc_n = x[tn * V + ct], xb_n = x[tn * V + blank], ph_n = phi[tn];
          const float rn_new = xc + rg::logaddexp(rn, ph);
          rb = xb + rg::logaddexp(rn, rb);
          rn = rn_new;
          rn_s[t] = rn;
          rb_s[t] = rb;
          xc = xc_n;
          xb = xb_n;
          ph = ph_n;
        }
      }
    } else {
      if (c > 0) write(c - 1, tid - 32, kStateThreads - 32);
      if (c + 1 < n_chunks) stage(c + 1, tid - 32, kStateThreads - 32);
    }
    PHASE(2)
    __syncthreads();
    PHASE(3)
  }
  write(n_chunks - 1, tid, kStateThreads);
  PHASE(4)
  PHASE_END(0)
}

__global__ void __launch_bounds__(kPsiMaxThreads)
    psi_lse_kernel(const float* __restrict__ lpz,     // (B, T, V)
                   const int* __restrict__ last_tok,  // (B, K)
                   const int* __restrict__ lengths,   // (B, K)
                   const float* __restrict__ r_n,     // (B, K, T)
                   const float* __restrict__ r_b,     // (B, K, T)
                   float* __restrict__ psi,           // (B, K, V)
                   int K, int T, int V, int blank, int eos, int S, int F) {
  extern __shared__ float smem[];
  PHASE_BEGIN
  float* x_s = smem;                     // (F, V): lpz rows of the chunk
  float* rs_s = x_s + (size_t)F * V;     // (K, F): phi of other tokens
  float* rb_s = rs_s + (size_t)K * F;    // (K, F): phi of the last token
  const int b = blockIdx.x, tid = threadIdx.x;
  const int L = K * V;
  const bool active = tid < L * S;
  const int lane = tid % L, s = tid / L;  // lane = k * V + v; s: frame split
  const int k = lane / V, v = lane - k * V;
  const size_t row0 = (size_t)b * K * T;
  // read now, used after the first chunk's copies
  const int last = active ? last_tok[b * K + k] : -1;
  const int len = active ? lengths[b * K + k] : 0;
  const float* lpz_b = lpz + (size_t)b * T * V;
  float m = -CUDART_INF_F, acc = 0.f;  // sum of exp(term - m) over this thread's frames
  PHASE(0)
  for (int t0 = 0; t0 < T; t0 += F) {
    const int fc = min(F, T - t0);
    __syncthreads();  // the previous chunk is read
    copy_rows(x_s, lpz_b + (size_t)t0 * V, fc * V, tid, blockDim.x);
#pragma unroll 2
    for (int i = tid; i < K * fc; i += blockDim.x) {
      const int kk = i / fc, t = i - kk * fc;
      float rs, rb;
      if (t0 + t == 0) {
        rs = rb = lengths[b * K + kk] == 0 ? 0.f : rg::LOG_ZERO;
      } else {
        const size_t at = row0 + (size_t)kk * T + t0 + t - 1;
        rb = r_b[at];
        rs = rg::logaddexp(r_n[at], rb);
      }
      rs_s[kk * F + t] = rs;
      rb_s[kk * F + t] = rb;
    }
    copy_wait();
    __syncthreads();
    PHASE(1)
    if (active) {
      // online max shift: a term above the running max m rescales the
      // sum to it, one exponential a term either way. __expf (ex2.approx)
      // of -|d| errs by a few ulps near 0, where the sum's terms matter
      const float* phi = (v == last && len > 0 ? rb_s : rs_s) + k * F;
#pragma unroll 4
      for (int t = s; t < fc; t += S) {
        const float term = phi[t] + x_s[t * V + v];
        const float d = term - m;
        const float e = __expf(-fabsf(d));
        acc = d > 0.f ? fmaf(acc, e, 1.f) : acc + e;
        m = fmaxf(m, term);
      }
      PHASE(2)
    }
  }
  // each lane's S partial pairs and the LOG_ZERO start term, in a fixed
  // order
  __syncthreads();
  float* pm = smem;
  float* pa = smem + (size_t)L * S;
  if (active) {
    pm[tid] = m;
    pa[tid] = acc;
  }
  __syncthreads();
  if (tid < L) {
    float top = rg::LOG_ZERO;
    for (int j = 0; j < S; ++j) top = fmaxf(top, pm[j * L + tid]);
    float sum = expf(rg::LOG_ZERO - top);
    for (int j = 0; j < S; ++j) sum += pa[j * L + tid] * expf(pm[j * L + tid] - top);
    float out = top + logf(sum);
    if (v == eos) {
      const size_t at = row0 + (size_t)k * T + T - 1;
      out = rg::logaddexp(r_n[at], r_b[at]);
    }
    if (v == blank) out = rg::LOG_ZERO;
    psi[(size_t)b * L + tid] = out;
  }
  PHASE(3)
  PHASE_END(1)
}

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

extern "C" int ctc_prefix_psi_utt(const void* lpz, const void* last_tok, const void* lengths,
                                  const void* r_n, const void* r_b, void* psi, int B, int K,
                                  int T, int V, int blank, int eos, int S, int F,
                                  void* stream) {
  if (B < 1 || K < 1 || T < 1 || V < 1 || S < 1 || F < 1 || K * V * S > kPsiMaxThreads ||
      blank < 0 || blank >= V || eos < 0 || eos >= V)
    return (int)cudaErrorInvalidValue;
  // the chunk's lpz and phi tables, then the partial pairs
  const size_t chunk = (size_t)F * V + 2 * (size_t)K * F, pairs = 2 * (size_t)K * V * S;
  const size_t floats = chunk > pairs ? chunk : pairs;
  const cudaError_t err = rg::reserve_smem<psi_lse_kernel>(floats * sizeof(float));
  if (err != cudaSuccess) return (int)err;
  const int threads = (K * V * S + 31) / 32 * 32;
  psi_lse_kernel<<<B, threads, floats * sizeof(float), static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(lpz), static_cast<const int*>(last_tok),
      static_cast<const int*>(lengths), static_cast<const float*>(r_n),
      static_cast<const float*>(r_b), static_cast<float*>(psi), K, T, V, blank, eos, S, F);
  return (int)cudaGetLastError();
}

// k_idx (int64) null: each row is its own parent; append (bool) null: every
// row is extended
extern "C" int ctc_prefix_state_utt(const void* lpz, const void* k_idx, const void* tok,
                                    const void* append, const void* last_tok,
                                    const void* lengths, const void* r_n, const void* r_b,
                                    void* rn_out, void* rb_out, int B, int K, int T, int V,
                                    int blank, int F, void* stream) {
  if (B < 1 || K < 1 || K > kStateMaxK || T < 1 || V < 1 || F < 1 || blank < 0 ||
      blank >= V)
    return (int)cudaErrorInvalidValue;
  const size_t bytes = 2 * state_buffer(K, V, F) * sizeof(float);
  const cudaError_t err = rg::reserve_smem<state_utt_kernel>(bytes);
  if (err != cudaSuccess) return (int)err;
  state_utt_kernel<<<B, kStateThreads, bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(lpz), static_cast<const long long*>(k_idx),
      static_cast<const int*>(tok), static_cast<const bool*>(append),
      static_cast<const int*>(last_tok), static_cast<const int*>(lengths),
      static_cast<const float*>(r_n), static_cast<const float*>(r_b),
      static_cast<float*>(rn_out), static_cast<float*>(rb_out), K, T, V, blank, F);
  return (int)cudaGetLastError();
}
