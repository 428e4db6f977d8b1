// CTC loss kernels: the whole per-utterance loss and its gradient
// (ctc_nll_fwd / ctc_nll_bwd), and the bare alpha recursion with its
// adjoint (ctc_alpha_fwd / ctc_alpha_bwd), on one pair of per-frame steps.
//
// Replaces robust_e2e_gan_tpu/ops/ctc_pallas.py::ctc_alpha_final (:296):
// _fwd_kernel (with the alpha history, for training), _fwd_only_kernel (no
// history, for no-grad calls) and _bwd_kernel (the hand-derived adjoint of
// the log-sum-exp recursion). The JAX package keeps the log-softmax, the
// emission gather, alpha0 and the final two-position log-sum-exp outside
// its kernel (ops/ctc.py:61-90, :145-158); ctc_nll_fwd/bwd take them in, so
// a loss and its gradient are one launch each way.
//
// What bounds it on Hopper: the serial chain over T frames of tiny
// (U = 2S+1 lanes) log-sum-exp steps; bytes and operations are negligible.
// Around the chain, ~90 small PyTorch ops (log-softmax, gather, masks,
// alpha0, the final log-sum-exp and all their backwards) cost more host
// time than the chain costs device time; the fused pair has none of them.
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
//
// ctc_nll_fwd/bwd: the block is U rounded up to a warp. Each frame's
// log-normalizer lse[t] over V is a warp's shuffle reduction (warps over
// frames), written (B, T) to global memory, where the chain reads it and the
// backward finds it. The emission of (t, u) is logit[t, ext[u]] - lse[t]
// rounded once to the logits' type, as torch's log_softmax on that type
// gives it, read one frame ahead of the chain. The backward writes the (T, U)
// emission adjoints of its utterance to a global scratch (in L2 at the train
// shapes), routes frame 0's through alpha0, and writes dlogits[t, v] =
// sum_{u: ext[u] = v} demit[t, u] - softmax[t, v] * sum_u demit[t, u], the
// softmax recomputed from the logits and lse. Its label sums walk
// per-utterance lists of equal labels (head[v] in the scratch, nxt[s]), in
// ascending position order, so the result is deterministic. Shared memory is
// static and bounded by U <= 1,024, so T, V and S set no other limit. A label
// outside [0, V) inside an utterance, or a label length outside [0, S], is a
// device-side assert in the forward, as torch.gather's on the plain path.

#undef NDEBUG  // the label check below is an assert
#include <cassert>

#include "common.cuh"

namespace {

constexpr float NEG_INF = -1e30f;
constexpr float NEG_THRESH = -5e29f;
constexpr int MAX_THREADS = 1024;
constexpr int MAX_LABELS = (MAX_THREADS - 1) / 2;

// One frame of the alpha recursion at position u, t ascending. alpha holds
// alpha_{t-1} of every position, a = alpha_{t-1}[u], e the emission of
// (t, u); frames at or past the utterance's length (!active) keep alpha.
// Ends with alpha_t in shared memory; returns alpha_t[u].
__device__ __forceinline__ float alpha_frame(float* alpha, float a, int u, float sk, float ps,
                                             float e, bool active) {
  const float sh1 = u >= 1 ? alpha[u - 1] : NEG_INF;
  const float sh2 = (u >= 2 ? alpha[u - 2] : NEG_INF) + sk;
  const float m = fmaxf(fmaxf(a, sh1), sh2);
  const float safe = m <= NEG_THRESH ? 0.f : m;
  const float summed = fmaxf(expf(a - safe) + expf(sh1 - safe) + expf(sh2 - safe), 1e-37f);
  float na = (m <= NEG_THRESH ? NEG_INF : safe + logf(summed)) + e + ps;
  na = fmaxf(na, NEG_INF);
  const float next = active ? na : a;
  __syncthreads();  // every thread has read alpha_{t-1}
  alpha[u] = next;
  __syncthreads();
  return next;
}

// One frame of the adjoint at position u < U (threads past U pass
// a_new = -1e30), t descending. prev: alpha_{t-1} (U values), a_new =
// alpha_t[u], e the emission of (t, u), da = dL/dalpha_t[u]. v1, v2: shared
// scratch of the block's width. Sets *dpre = dL/demit[t][u] and returns
// dL/dalpha_{t-1}[u].
__device__ __forceinline__ float adjoint_frame(const float* prev, float a_new, float e, int u,
                                               int U, float sk, float ps, bool active,
                                               float da, float* v1, float* v2, float* dpre) {
  const bool live = u < U;
  const float a_prev = live ? prev[u] : NEG_INF;
  const float da_na = active ? da : 0.f;
  const float da_pass = active ? 0.f : da;
  const float pre = a_new - e - ps;
  const float dp = (active && a_new > NEG_THRESH) ? da_na : 0.f;
  const float sh1 = live && u >= 1 ? prev[u - 1] : NEG_INF;
  const float sh2 = (live && u >= 2 ? prev[u - 2] : NEG_INF) + sk;
  const float safe_pre = pre <= NEG_THRESH ? 0.f : pre;
  const float w0 = expf(fmaxf(a_prev - safe_pre, NEG_INF));
  const float w1 = expf(fmaxf(sh1 - safe_pre, NEG_INF));
  const float w2 = expf(fmaxf(sh2 - safe_pre, NEG_INF));
  v1[u] = w1 * dp;
  v2[u] = w2 * dp;
  __syncthreads();
  const float g1 = u + 1 < U ? v1[u + 1] : 0.f;
  const float g2 = u + 2 < U ? v2[u + 2] : 0.f;
  __syncthreads();  // v1/v2 are rewritten next frame
  *dpre = dp;
  return w0 * dp + g1 + g2 + da_pass;
}

// ---------------------------------------------------------------------------
// ctc_alpha: emit (B, T, U), alpha0/skip/pos (B, U), lens (B,) in; the JAX
// kernel's contract
// ---------------------------------------------------------------------------

// hist (T, B, U) or null; afin (B, U)
__global__ void alpha_fwd_kernel(const float* __restrict__ emit,
                                 const float* __restrict__ alpha0,
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
    a = alpha_frame(alpha, a, u, sk, ps, emit[((size_t)b * T + t) * U + u], t < len);
    if (hist != nullptr) hist[((size_t)t * B + b) * U + u] = a;
  }
  afin[(size_t)b * U + u] = a;
}

// dfin (B, U) -> demit (B, T, U) (row t = 0 zero) and da0 (B, U)
__global__ void alpha_bwd_kernel(const float* __restrict__ emit, const float* __restrict__ skip,
                                 const float* __restrict__ pos, const int* __restrict__ lens,
                                 const float* __restrict__ hist, const float* __restrict__ dfin,
                                 float* __restrict__ demit, float* __restrict__ da0, int B,
                                 int T, int U) {
  extern __shared__ float sm[];
  const int b = blockIdx.x;
  const int u = threadIdx.x;
  const float sk = skip[(size_t)b * U + u];
  const float ps = pos[(size_t)b * U + u];
  const int len = lens[b];
  float da = dfin[(size_t)b * U + u];
  demit[(size_t)b * T * U + u] = 0.f;
  for (int t = T - 1; t >= 1; --t) {
    float dp;
    da = adjoint_frame(hist + ((size_t)(t - 1) * B + b) * U, hist[((size_t)t * B + b) * U + u],
                       emit[((size_t)b * T + t) * U + u], u, U, sk, ps, t < len, da, sm,
                       sm + U, &dp);
    demit[((size_t)b * T + t) * U + u] = dp;
  }
  da0[(size_t)b * U + u] = da;
}

// ---------------------------------------------------------------------------
// ctc_nll: logits (B, T, V) in, the per-utterance loss (B,) out
// ---------------------------------------------------------------------------

__device__ __forceinline__ long long load_index(const void* p, size_t i, bool i64) {
  return i64 ? static_cast<const long long*>(p)[i] : static_cast<const int*>(p)[i];
}

// The logits' log-softmax at one (frame, column), rounded to the logits'
// type: torch's log_softmax on T followed by .float().
template <typename T>
__device__ __forceinline__ float emission(const T* row, long long col, float lse) {
  return rg::rnd<T>(rg::to_f(row[col]) - lse);
}

__device__ __forceinline__ float warp_max(float x) {
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// What thread u knows of its extended-label position: ops/ctc.py:196-204.
struct Position {
  long long col;  // ext[u], the logits' column of its emission (blank past 2S_b)
  float sk;       // 0 where the skip from u-2 is allowed, else -1e30
  float ps;       // 0 where u < 2 S_b + 1, else -1e30
  int len;        // the utterance's frames (logit length)
  int sb;         // its label length, clamped to [0, S]
  bool bad;       // (block-wide) a label or label length the plain version refuses
};

// idx64: bit 0 labels, bit 1 logit lengths, bit 2 label lengths are int64.
// Every thread of the block must call it (it ends with a barrier).
__device__ Position position(const void* labels, const void* logit_lens,
                             const void* label_lens, int idx64, int b, int u, int Tn, int U,
                             int V, int blank) {
  const int S = (U - 1) / 2;
  Position p;
  const long long len = load_index(logit_lens, b, idx64 & 2);
  p.len = len < 0 ? 0 : len > Tn ? Tn : (int)len;
  const long long sb = load_index(label_lens, b, idx64 & 4);
  p.sb = sb < 0 ? 0 : sb > S ? S : (int)sb;
  bool bad = sb < 0 || sb > S;
  const bool live = u < U;
  const bool valid = live && u < 2 * p.sb + 1;
  long long ext = blank, ext2 = -1;  // ext[u], ext[u-2] (-1 off the start)
  if (live && (u & 1)) {
    const size_t row = (size_t)b * S;
    ext = load_index(labels, row + (u - 1) / 2, idx64 & 1);
    if (u >= 3) ext2 = load_index(labels, row + (u - 3) / 2, idx64 & 1);
  } else if (u >= 2) {
    ext2 = blank;
  }
  bad |= valid && (ext < 0 || ext >= V);
  p.col = valid ? ext : blank;
  p.sk = live && ext != blank && ext != ext2 ? 0.f : NEG_INF;
  p.ps = valid ? 0.f : NEG_INF;
  p.bad = __syncthreads_or(bad);
  return p;
}

// lse[t] = log sum_v exp(logit[t, v]) in float32 for every frame of the
// block's utterance (0 with log_input), one warp per frame at a time. The
// caller synchronises.
template <typename T>
__device__ void frame_lse(const T* __restrict__ x, float* lse, int Tn, int V, bool log_input) {
  const int lane = threadIdx.x & 31;
  const int nwarps = blockDim.x >> 5;
  for (int t = threadIdx.x >> 5; t < Tn; t += nwarps) {
    float l = 0.f;
    if (!log_input) {
      const T* row = x + (size_t)t * V;
      float m = -INFINITY;
      for (int v = lane; v < V; v += 32) m = fmaxf(m, rg::to_f(row[v]));
      m = warp_max(m);
      float s = 0.f;
      for (int v = lane; v < V; v += 32) s += expf(rg::to_f(row[v]) - m);
      l = m + logf(warp_sum(s));
    }
    if (lane == 0) lse[t] = l;
  }
}

// alpha0[u] (ops/ctc.py:206-210) from the frame-0 emission e0.
__device__ __forceinline__ float alpha_init(int u, float e0, const Position& p) {
  float a = NEG_INF;
  if (u == 0) a = e0;
  if (u == 1 && p.sb > 0) a = e0;
  return fmaxf(a + p.ps, NEG_INF);
}

// nll (B,), lse (B, T); hist (T, B, U) or null
template <typename T>
__global__ void nll_fwd_kernel(const T* __restrict__ logits, const void* labels,
                               const void* logit_lens, const void* label_lens, int idx64,
                               float* __restrict__ hist, float* lse_all, float* __restrict__ nll,
                               int B, int Tn, int V, int U, int blank, int log_input) {
  __shared__ float alpha[MAX_THREADS];
  const int b = blockIdx.x;
  const int u = threadIdx.x;
  const bool live = u < U;
  const T* x = logits + (size_t)b * Tn * V;
  float* lse = lse_all + (size_t)b * Tn;  // written and read here: not __restrict__
  const Position p = position(labels, logit_lens, label_lens, idx64, b, u, Tn, U, V, blank);
  assert(!p.bad && "ctc_nll: a label outside [0, V) or a label length outside [0, S]");
  frame_lse(x, lse, Tn, V, log_input);
  __syncthreads();

  float a = alpha_init(u, emission(x, p.col, lse[0]), p);
  alpha[u] = a;
  if (hist != nullptr && live) hist[(size_t)b * U + u] = a;
  __syncthreads();
  float e_next = Tn > 1 ? emission(x + V, p.col, lse[1]) : 0.f;
  for (int t = 1; t < Tn; ++t) {
    const float e = e_next;
    if (t + 1 < Tn) e_next = emission(x + (size_t)(t + 1) * V, p.col, lse[t + 1]);
    a = alpha_frame(alpha, a, u, p.sk, p.ps, e, t < p.len);
    if (hist != nullptr && live) hist[((size_t)t * B + b) * U + u] = a;
  }

  // the final two-position log-sum-exp, ops/ctc.py:215-223
  if (u == 0) {
    const int last = 2 * p.sb;
    const float a_last = alpha[last];
    const float a_prev = p.sb > 0 ? alpha[last - 1] : NEG_INF;
    const float m = fmaxf(a_last, a_prev);
    const float safe = m <= NEG_INF ? 0.f : m;
    const float ll =
        safe + logf(fmaxf(expf(a_last - safe) + expf(a_prev - safe), 1e-37f));
    nll[b] = -(m <= NEG_INF ? NEG_INF : ll);
  }
}

// dnll (B, stride dnll_stride) -> dlogits (B, T, V) in the logits' type.
// scratch: demit (B, T, U), then rowsum and blanksum (B, 2T), then head
// (B, V) as int; ops/ctc.py::_nll_fwd sizes it.
template <typename T>
__global__ void nll_bwd_kernel(const T* __restrict__ logits, const void* labels,
                               const void* logit_lens, const void* label_lens, int idx64,
                               const float* __restrict__ hist, const float* __restrict__ lse_all,
                               const float* __restrict__ dnll, int dnll_stride, float* scratch,
                               T* __restrict__ dlogits, int B, int Tn, int V, int U, int blank,
                               int log_input) {
  __shared__ float v1[MAX_THREADS], v2[MAX_THREADS];
  __shared__ int nxt[MAX_LABELS];  // the next position of the same label
  __shared__ int lab[MAX_LABELS];  // the labels
  const int nt = blockDim.x;
  const int S = (U - 1) / 2;
  const int b = blockIdx.x;
  const int u = threadIdx.x;
  const bool live = u < U;
  // the scratch is written and read here: not __restrict__
  float* demit = scratch + (size_t)b * Tn * U;                           // Tn x U
  float* rowsum = scratch + (size_t)B * Tn * U + (size_t)b * 2 * Tn;     // Tn
  float* blanksum = rowsum + Tn;                                         // Tn
  int* head = reinterpret_cast<int*>(scratch + (size_t)B * Tn * (U + 2)) + (size_t)b * V;
  const float* lse = lse_all + (size_t)b * Tn;
  const T* x = logits + (size_t)b * Tn * V;
  T* dx = dlogits + (size_t)b * Tn * V;
  const Position p = position(labels, logit_lens, label_lens, idx64, b, u, Tn, U, V, blank);
  for (int s = u; s < p.sb; s += nt)
    lab[s] = (int)load_index(labels, (size_t)b * S + s, idx64 & 1);
  __syncthreads();

  // seed: the final log-sum-exp's weights at 2 S_b and 2 S_b - 1, negated
  float da = 0.f;
  {
    const float* fin = hist + ((size_t)(Tn - 1) * B + b) * U;
    const int last = 2 * p.sb;
    const float a_last = fin[last];
    const float a_prev = p.sb > 0 ? fin[last - 1] : NEG_INF;
    const float m = fmaxf(a_last, a_prev);
    if (m > NEG_INF) {
      const float e1 = expf(a_last - m);
      const float e2 = expf(a_prev - m);
      const float s = fmaxf(e1 + e2, 1e-37f);
      const float g = -dnll[(size_t)b * dnll_stride];
      if (u == last) da = g * e1 / s;
      if (p.sb > 0 && u == last - 1) da = g * e2 / s;
    }
  }

  float a_new = live ? hist[((size_t)(Tn - 1) * B + b) * U + u] : NEG_INF;
  float e_next = Tn > 1 ? emission(x + (size_t)(Tn - 1) * V, p.col, lse[Tn - 1]) : 0.f;
  for (int t = Tn - 1; t >= 1; --t) {
    const float e = e_next;
    e_next = emission(x + (size_t)(t - 1) * V, p.col, lse[t - 1]);
    const float* prev = hist + ((size_t)(t - 1) * B + b) * U;
    float dp;
    da = adjoint_frame(prev, a_new, e, u, U, p.sk, p.ps, t < p.len, da, v1, v2, &dp);
    if (live) {
      demit[(size_t)t * U + u] = dp;
      a_new = prev[u];
    }
  }
  // frame 0 through alpha0: positions 0 and 1, the position mask and the
  // clamp (torch's clamp_min passes the gradient where x >= min)
  if (live) {
    const float e0 = emission(x, p.col, lse[0]);
    const bool taken = (u == 0 || (u == 1 && p.sb > 0)) && e0 + p.ps >= NEG_INF;
    demit[u] = taken ? da : 0.f;
  }
  for (int v = u; v < V; v += nt) head[v] = -1;
  __syncthreads();

  // lists of equal labels, ascending positions
  for (int s = u; s < p.sb; s += nt) {
    bool first = true;
    for (int r = 0; r < s && first; ++r) first = lab[r] != lab[s];
    int n = -1;
    for (int r = s + 1; r < p.sb && n < 0; ++r)
      if (lab[r] == lab[s]) n = r;
    nxt[s] = n;
    if (first) head[lab[s]] = s;
  }
  // each frame's adjoint sums: all positions and the blank (even) ones
  const int lane = u & 31;
  for (int t = u >> 5; t < Tn; t += nt >> 5) {
    float all = 0.f, even = 0.f;
    for (int i = lane; i < U; i += 32) {
      const float d = demit[(size_t)t * U + i];
      all += d;
      if (!(i & 1)) even += d;
    }
    all = warp_sum(all);
    even = warp_sum(even);
    if (lane == 0) {
      rowsum[t] = all;
      blanksum[t] = even;
    }
  }
  __syncthreads();

  for (int i = u; i < Tn * V; i += nt) {
    const int t = i / V;
    const int v = i - t * V;
    float g = v == blank ? blanksum[t] : 0.f;
    for (int s = head[v]; s >= 0; s = nxt[s]) g += demit[(size_t)t * U + 2 * s + 1];
    if (!log_input) g -= expf(rg::to_f(x[i]) - lse[t]) * rowsum[t];
    dx[i] = rg::from_f<T>(g);
  }
}

int block_threads(int U) { return (U + 31) / 32 * 32; }

template <typename T>
cudaError_t launch_fwd(const void* logits, const void* labels, const void* logit_lens,
                       const void* label_lens, int idx64, float* hist, float* lse, float* nll,
                       int B, int Tn, int V, int U, int blank, int log_input,
                       cudaStream_t stream) {
  nll_fwd_kernel<T><<<B, block_threads(U), 0, stream>>>(static_cast<const T*>(logits), labels,
                                                        logit_lens, label_lens, idx64, hist, lse,
                                                        nll, B, Tn, V, U, blank, log_input);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_bwd(const void* logits, const void* labels, const void* logit_lens,
                       const void* label_lens, int idx64, const float* hist, const float* lse,
                       const float* dnll, int dnll_stride, float* scratch, void* dlogits, int B,
                       int Tn, int V, int U, int blank, int log_input, cudaStream_t stream) {
  nll_bwd_kernel<T><<<B, block_threads(U), 0, stream>>>(
      static_cast<const T*>(logits), labels, logit_lens, label_lens, idx64, hist, lse, dnll,
      dnll_stride, scratch, static_cast<T*>(dlogits), B, Tn, V, U, blank, log_input);
  return cudaGetLastError();
}

bool nll_args_ok(int B, int Tn, int V, int U, int blank) {
  return B >= 1 && Tn >= 1 && V >= 1 && U >= 1 && U <= MAX_THREADS && (U & 1) && blank >= 0 &&
         blank < V;
}

}  // namespace

extern "C" int ctc_alpha_fwd(const void* emit, const void* alpha0, const void* skip,
                             const void* pos, const void* lens, void* hist, void* afin, int B,
                             int T, int U, void* stream) {
  if (B < 1 || T < 1 || U < 1 || U > MAX_THREADS) return (int)cudaErrorInvalidValue;
  alpha_fwd_kernel<<<B, U, U * sizeof(float), static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(emit), static_cast<const float*>(alpha0),
      static_cast<const float*>(skip), static_cast<const float*>(pos),
      static_cast<const int*>(lens), static_cast<float*>(hist), static_cast<float*>(afin), B,
      T, U);
  return (int)cudaGetLastError();
}

extern "C" int ctc_alpha_bwd(const void* emit, const void* skip, const void* pos,
                             const void* lens, const void* hist, const void* dfin, void* demit,
                             void* da0, int B, int T, int U, void* stream) {
  if (B < 1 || T < 1 || U < 1 || U > MAX_THREADS) return (int)cudaErrorInvalidValue;
  alpha_bwd_kernel<<<B, U, 2 * U * sizeof(float), static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(emit), static_cast<const float*>(skip),
      static_cast<const float*>(pos), static_cast<const int*>(lens),
      static_cast<const float*>(hist), static_cast<const float*>(dfin),
      static_cast<float*>(demit), static_cast<float*>(da0), B, T, U);
  return (int)cudaGetLastError();
}

extern "C" int ctc_nll_fwd(const void* logits, const void* labels, const void* logit_lens,
                           const void* label_lens, void* hist, void* lse, void* nll, int B,
                           int T, int V, int U, int blank, int log_input, int bf16, int idx64,
                           void* stream) {
  if (!nll_args_ok(B, T, V, U, blank) || lse == nullptr) return (int)cudaErrorInvalidValue;
  const auto s = static_cast<cudaStream_t>(stream);
  auto* h = static_cast<float*>(hist);
  auto* l = static_cast<float*>(lse);
  auto* n = static_cast<float*>(nll);
  if (bf16)
    return (int)launch_fwd<__nv_bfloat16>(logits, labels, logit_lens, label_lens, idx64, h, l,
                                          n, B, T, V, U, blank, log_input, s);
  return (int)launch_fwd<float>(logits, labels, logit_lens, label_lens, idx64, h, l, n, B, T, V,
                                U, blank, log_input, s);
}

extern "C" int ctc_nll_bwd(const void* logits, const void* labels, const void* logit_lens,
                           const void* label_lens, const void* hist, const void* lse,
                           const void* dnll, void* scratch, void* dlogits, int dnll_stride, int B,
                           int T, int V, int U, int blank, int log_input, int bf16, int idx64,
                           void* stream) {
  if (!nll_args_ok(B, T, V, U, blank)) return (int)cudaErrorInvalidValue;
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* h = static_cast<const float*>(hist);
  const auto* l = static_cast<const float*>(lse);
  const auto* d = static_cast<const float*>(dnll);
  auto* w = static_cast<float*>(scratch);
  if (bf16)
    return (int)launch_bwd<__nv_bfloat16>(logits, labels, logit_lens, label_lens, idx64, h, l,
                                          d, dnll_stride, w, dlogits, B, T, V, U, blank,
                                          log_input, s);
  return (int)launch_bwd<float>(logits, labels, logit_lens, label_lens, idx64, h, l, d,
                                dnll_stride, w, dlogits, B, T, V, U, blank, log_input, s);
}
