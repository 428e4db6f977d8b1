// CTC prefix scores psi of every vocabulary extension, one block per
// utterance.
//
// Replaces robust_e2e_gan_tpu/ops/ctc_prefix_pallas.py::prefix_scores_psi_pallas
// (kernel _kernel, grid = (B,)): the function of ctc_prefix.cu's psi kernels,
//   phi_t = t == 0 ? phi0 : (v == last && len > 0 ? r_b[t-1] : logaddexp(r_n, r_b)[t-1])
//   psi   = logaddexp over t of (phi_t + lpz[t, v]), from LOG_ZERO
// with phi0 = 0 for the empty prefix and LOG_ZERO otherwise, and, as in the
// TPU kernel, the eos column (logaddexp(r_n, r_b)[T-1], the full-sequence
// CTC score of the prefix itself) and the blank column (LOG_ZERO) written
// here. The TPU kernel also carries the r_n/r_b recursions of every
// extension through its frame loop, but nothing it returns reads them, so
// only psi is computed here.
//
// What bounds it on Hopper: K x V x T terms an utterance (72,384 at the
// decode shape: K=8, V=52, T=174), each an exponential on the SFU (16 a
// cycle an SM: ~4.5k cycles) and ~9 other instructions, so the issue of
// ~10 instructions a term (~6k cycles over 28 warps) binds the sums;
// before them, the first chunk's data (all of an utterance's lpz and
// parents' rows, ~47 KB a block, ~6 MB over the grid: ~2 us of the card's
// memory rate) and after them the combine. The first design of this
// kernel ran a serial chain of accurate logaddexp steps per lane (expf and
// log1pf on the critical path of every term) after staging the whole
// utterance, which capped T at what shared memory held.
//
// Design: one block per utterance, as the TPU's grid.
// 1. Units of work: lanes (k, v) and (k, v + H), H = ceil(V / 2), share a
//    consumer thread and their phi loads, the phi of every lane of k being
//    logaddexp(r_n, r_b) of parent k; the lane of k's last token, whose
//    phi is r_b (where len > 0), is also summed by an extra unit of its
//    own, which the combine takes for that lane. Each of the U = K x H + K
//    units is taken by S frame splits, a consumer thread each (S as large
//    as 992 consumers allow, at most 8; ops/ctc_prefix.py::utt_psi_plan);
//    split s of a chunk's fc frames sums the s-th of S contiguous runs of
//    frames, each a multiple of 4 frames long. One more warp is the
//    producer.
// 2. A ring of NS stages of F frames of lpz rows (F, V), each with a
//    "full" and an "empty" mbarrier: the producer's first thread fills
//    stage after stage as every consumer warp gives it back, each chunk by
//    one bulk copy (the copy engine) of the 16-byte granules that hold its
//    rows, landing 0-3 floats into the 16-byte aligned stage, whatever the
//    alignment of lpz. Starting a bulk copy holds the issuing warp about
//    as long as the copy takes, so no consumer issues one. The first NS
//    copies start before the block's first barrier.
// 3. The phi tables: each consumer forms up to kUttAhead items (k, t) of a
//    chunk, logaddexp(r_n, r_b) (ex2/lg2 on the SFU) and r_b at frame
//    t0 + t - 1 (phi0 at frame 0), into rows F + 4 floats apart (16-byte
//    aligned, neighbouring hypotheses on other banks) of one of kUttTabs
//    buffers, from the parents' values it loaded from device memory two
//    chunks ahead, and its warp counts itself in on the buffer's "formed"
//    mbarrier. (Copies of the parents' rows into the ring, by 4-byte
//    cp.async pieces or a bulk copy a row, cost more than the sums of a
//    chunk: a row is T floats long, so its frames are rarely 16-byte
//    aligned, and each copy is one small request of its own.) Chunk c + 1's
//    table is formed before chunk c is summed, so no block barrier stands
//    in the chunk loop: a warp waits for chunk c's table and lpz rows and
//    runs on.
// 4. Each lane keeps a running (max m, sum of exp(term - m)) over its
//    frames, taken two frames at a time (phi four frames a load): the
//    pair's own (max, 1 + exp(-|t0 - t1|)), then merged into the running
//    pair by scaling the side with the smaller max, exp(-|max - m|). Two
//    exponentials (ex2.approx on the SFU) for two terms, no logarithm until
//    the end, and every pair's instructions mix the SFU, the FMA pipe and
//    the shared-memory loads, so warps in step keep all three busy.
//    (Summing 16 frames in registers first, max then exponentials, left
//    each unit idle in turn: the warps, in step, all loaded, then all
//    exponentiated.)
// 5. The S pairs of each lane and the LOG_ZERO start term are combined in
//    a fixed order (max, then the scaled sums in split order, then one
//    log), so that two runs are bit-identical. A split with no frames
//    holds (-inf, 0), which adds nothing; a lane whose phi is LOG_ZERO
//    throughout sums finite terms near -1e10 as any other.
// Shared memory does not grow with T: any utterance length runs. Each
// chunk costs ~1 us of bookkeeping (tools/ctc_prefix_phases.py, by chunk
// size), so the plan takes chunks of up to 192 frames: the decode's 174
// frames are one chunk, and the ring turns from T = 193 on.

#include "common.cuh"

// clock64() marks of thread 0 for robust_e2e_gan_torch/tools/
// ctc_prefix_phases.py, which defines them; empty in the library build.
#ifndef PHASE_BEGIN
#define PHASE_BEGIN
#define PHASE(n)
#define PHASE_END(kernel)
#endif

namespace {

constexpr int kUttMaxThreads = 1024;  // consumers and the producer warp
constexpr int kUttMaxSplits = 8;
constexpr int kUttAhead = 2;  // phi items (k, t) a consumer forms a chunk
constexpr int kUttTabs = 4;   // phi tables in flight: chunks c - 2 .. c + 1
constexpr float kLog2e = 1.4426950408889634f;

__host__ __device__ inline size_t utt_r16(size_t x) { return (x + 15) / 16 * 16; }

// Units of work: K x ceil(V / 2) lane pairs and K last-token lanes.
__host__ __device__ inline int utt_units(int K, int V) { return K * ((V + 1) / 2) + K; }

// Consumer threads: the units x splits in whole warps, at most all warps
// but the producer's.
__host__ __device__ inline int utt_consumers(int K, int V, int S) {
  const int n = (utt_units(K, V) * S + 31) / 32 * 32;
  return n < kUttMaxThreads - 32 ? n : kUttMaxThreads - 32;
}

// Byte offsets in dynamic shared memory: NS stages of lpz rows (F x V
// floats and 8 of slack: the bulk copy lands 0-3 floats past the stage's
// start); kUttTabs phi buffers, chunk c's at c % kUttTabs, each K rows of
// logaddexp(r_n, r_b) then, 8 floats on, K rows of r_b, rows F + 4 floats
// apart (rows of neighbouring hypotheses on other banks); the (max, sum)
// pairs of each unit's two lanes and split; phi0 and the eos column of
// each hypothesis and its last token (K floats, K floats, K ints); NS
// "full", NS "empty" and kUttTabs "formed" 8-byte mbarriers.
// ops/ctc_prefix.py::utt_psi_smem is the same sum.
struct UttLayout {
  size_t stage, tab, tab_half, pairs, hyp, bar, total;
};

__host__ __device__ inline UttLayout utt_layout(int K, int V, int S, int F, int NS) {
  UttLayout L;
  L.stage = utt_r16(((size_t)F * V + 8) * 4);
  L.tab_half = ((size_t)2 * K * (F + 4) + 8) * 4;
  L.tab = (size_t)NS * L.stage;
  L.pairs = L.tab + kUttTabs * L.tab_half;
  L.hyp = L.pairs + utt_r16((size_t)4 * utt_units(K, V) * S * 4);
  L.bar = L.hyp + utt_r16((size_t)3 * K * 4);
  L.total = L.bar + (size_t)(2 * NS + kUttTabs) * 8;
  return L;
}

// 2^x on the SFU (ex2.approx.ftz: one instruction; a result below 2^-126,
// a term that far under the running max, flushes to 0)
__device__ __forceinline__ float utt_ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// log(exp(a) + exp(b)) on the SFU (ex2.approx, lg2.approx): within
// ~2e-7 of rg::logaddexp, for the phi tables, formed once per (k, t)
__device__ __forceinline__ float utt_logaddexp(float a, float b) {
  float l;
  const float e = utt_ex2(-fabsf(a - b) * kLog2e);
  asm("lg2.approx.ftz.f32 %0, %1;" : "=f"(l) : "f"(1.f + e));
  return fmaf(l, 0.6931471805599453f, fmaxf(a, b));
}

// Adds the terms t0, t1 (t1 may be -inf: no frame) to the running (m,
// acc), where acc is the sum of exp(term - m) over the terms so far: the
// pair's (max, 1 + exp(-|t0 - t1|)), then the pair and the running pair
// merged by scaling the one with the smaller max, exp(-|max - m|). Two
// exponentials for two terms; against m = -inf (no terms yet) the scale
// is 0 and acc becomes the pair's sum.
__device__ __forceinline__ void utt_add_pair(float t0, float t1, float& m, float& acc) {
  const float s = 1.f + utt_ex2(-fabsf(t1 - t0) * kLog2e);
  const float top = fmaxf(t0, t1);
  const float d = top - m;
  const float e = utt_ex2(-fabsf(d) * kLog2e);
  acc = d > 0.f ? fmaf(acc, e, s) : fmaf(s, e, acc);
  m = fmaxf(m, top);
}

// The 16-byte granules that hold n floats from p: their first address
// and byte count, and where p falls in the first (0-3 floats in).
struct Granules {
  const float* src;
  unsigned bytes;
  int ofs;
};

__device__ __forceinline__ Granules utt_granules(const float* p, int n) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(p), a16 = a & ~uintptr_t(15);
  const uintptr_t e16 = (a + 4 * (uintptr_t)n + 15) & ~uintptr_t(15);
  return {reinterpret_cast<const float*>(a16), (unsigned)(e16 - a16), (int)(a - a16) / 4};
}

__global__ void __launch_bounds__(kUttMaxThreads)
    utt_psi_kernel(const float* __restrict__ lpz,     // (B, T, V)
                   const int* __restrict__ last_tok,  // (B, K)
                   const int* __restrict__ lengths,   // (B, K)
                   const float* __restrict__ r_n,     // (B, K, T)
                   const float* __restrict__ r_b,     // (B, K, T)
                   float* __restrict__ psi,           // (B, K, V)
                   int K, int T, int V, int blank, int eos, int S, int F, int NS) {
  extern __shared__ __align__(16) unsigned char utt_smem[];
  PHASE_BEGIN
  const UttLayout lay = utt_layout(K, V, S, F, NS);
  uint64_t* full = reinterpret_cast<uint64_t*>(utt_smem + lay.bar);
  uint64_t* empty = full + NS;
  uint64_t* formed = empty + NS;
  float* s_phi0 = reinterpret_cast<float*>(utt_smem + lay.hyp);
  float* s_eos = s_phi0 + K;
  int* s_last = reinterpret_cast<int*>(s_eos + K);  // -1: no last-token lane
  const int b = blockIdx.x, tid = threadIdx.x;
  const int H = (V + 1) / 2, U = utt_units(K, V), US = U * S;
  const int C = utt_consumers(K, V, S);
  const int FS = F + 4;  // phi row stride
  const size_t row0 = (size_t)b * K * T;  // row (b, 0) of the (B, K, T) rows
  const float* lpz_b = lpz + (size_t)b * T * V;
  const int n_chunks = (T + F - 1) / F;
  float* pm = reinterpret_cast<float*>(utt_smem + lay.pairs);  // (S, U, 2) maxes
  float* pa = pm + (size_t)2 * US;                             // (S, U, 2) sums
  auto table = [&](int c) {
    return reinterpret_cast<float*>(utt_smem + lay.tab + (c % kUttTabs) * lay.tab_half);
  };

  const bool warp_lead = (tid & 31) == 0;
  // chunk c's lpz rows into stage c % NS, by the producer warp's first
  // thread
  auto issue = [&](int c) {
    uint64_t* bar = full + c % NS;
    const int t0 = c * F, fc = min(F, T - t0);
    const Granules g = utt_granules(lpz_b + (size_t)t0 * V, fc * V);
    rg::mbar_expect(bar, g.bytes);
    rg::bulk_load(utt_smem + (size_t)(c % NS) * lay.stage, g.src, g.bytes, bar);
  };
  // a consumer's phi items (kk, t) of a chunk, item tid + j C of the K x F
  // (the plan keeps K x F within kUttAhead C), and the parents' values
  // behind them, loaded two chunks ahead of their use
  int item_k[kUttAhead], item_t[kUttAhead];
  float ahead_n[kUttAhead], ahead_b[kUttAhead];
#pragma unroll
  for (int j = 0; j < kUttAhead; ++j) {
    const int i = tid + j * C;
    item_k[j] = tid < C && i < K * F ? i / F : -1;
    item_t[j] = i - (i / F) * F;
  }
  auto load_ahead = [&](int c) {
    const int t0 = c * F, fc = min(F, T - t0);
#pragma unroll
    for (int j = 0; j < kUttAhead; ++j) {
      const int t = item_t[j];
      if (c < n_chunks && item_k[j] >= 0 && t < fc && t0 + t > 0) {
        const size_t at = row0 + (size_t)item_k[j] * T + t0 + t - 1;
        ahead_n[j] = r_n[at];
        ahead_b[j] = r_b[at];
      }
    }
  };

  // The longest waits start first, before the block barrier: the
  // producer's first thread initialises the ring's mbarriers and starts
  // the first NS copies, thread 0 initialises the formed mbarriers, the
  // consumers start their first loads.
  if (tid == C) {
    // full: the producer's one arrival, with the bulk copy's bytes; empty:
    // one arrival of each consumer warp
    for (int i = 0; i < NS; ++i) {
      rg::mbar_init(full + i, 1);
      rg::mbar_init(empty + i, C / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int c = 0; c < NS && c < n_chunks; ++c) issue(c);
  } else if (tid == 0) {
    for (int i = 0; i < kUttTabs; ++i) rg::mbar_init(formed + i, C / 32);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  load_ahead(0);
  int h_len = 0, h_last = -1;  // hypothesis tid's, where tid < K
  float h_n = 0.f, h_b = 0.f;  // its r_n, r_b at frame T - 1
  if (tid < K) {
    const size_t at = row0 + (size_t)tid * T + T - 1;
    h_len = lengths[b * K + tid];
    h_last = last_tok[b * K + tid];
    h_n = r_n[at];
    h_b = r_b[at];
  }
  __syncthreads();
  PHASE(0)

  if (tid >= C) {
    // the producer: chunk c once every consumer warp is done with chunk
    // c - NS
    if (tid == C) {
      for (int c = NS; c < n_chunks; ++c) {
        rg::mbar_wait(empty + c % NS, (unsigned)(c / NS - 1) & 1u);
        issue(c);
      }
    }
  } else {
    // chunk c's phi items from the values loaded ahead; then the warp
    // counts itself in on the table's formed mbarrier
    auto form = [&](int c) {
      if (c >= n_chunks) return;
      const int t0 = c * F, fc = min(F, T - t0);
      float* rs = table(c);
      float* rbt = rs + (size_t)K * FS + 8;
#pragma unroll
      for (int j = 0; j < kUttAhead; ++j) {
        const int kk = item_k[j], t = item_t[j];
        if (kk < 0 || t >= fc) continue;
        const bool first = t0 + t == 0;
        rs[kk * FS + t] = first ? s_phi0[kk] : utt_logaddexp(ahead_n[j], ahead_b[j]);
        rbt[kk * FS + t] = first ? s_phi0[kk] : ahead_b[j];
      }
      __syncwarp();
      if (warp_lead) rg::mbar_arrive(formed + c % kUttTabs);
    };
    if (tid < K) {
      s_phi0[tid] = h_len == 0 ? 0.f : rg::LOG_ZERO;
      s_eos[tid] = rg::logaddexp(h_n, h_b);
      s_last[tid] = h_len > 0 && h_last >= 0 && h_last < V ? h_last : -1;
    }
    asm volatile("bar.sync 1, %0;\n" ::"r"(C) : "memory");
    form(0);
    load_ahead(1);
    // this thread's unit u and split: lanes (k, v0) and (k, v1) (v1 = v0
    // where the unit has one lane; v0 < 0: no work), phi row at table
    // offset row
    const int u = tid % U, split = tid / U;
    const bool pair = u < K * H;
    const int k = pair ? u / H : u - K * H;
    const int v0 = tid >= US ? -1 : pair ? u - k * H : s_last[k];
    const int v1 = pair && v0 + H < V ? v0 + H : v0;
    const int row = (pair ? 0 : K * FS + 8) + k * FS;
    float m0 = -CUDART_INF_F, a0 = 0.f, m1 = -CUDART_INF_F, a1 = 0.f;
    PHASE(1)
    // no block barrier in the loop: a warp runs on as far as the tables
    // (formed one chunk ahead, kUttTabs in flight) and the ring allow
    for (int c = 0; c < n_chunks; ++c) {
      form(c + 1);
      load_ahead(c + 2);
      PHASE(2)
      rg::mbar_wait(formed + c % kUttTabs, (unsigned)(c / kUttTabs) & 1u);
      rg::mbar_wait(full + c % NS, (unsigned)(c / NS) & 1u);
      PHASE(3)
      const int t0 = c * F, fc = min(F, T - t0);
      const float* rs = table(c);
      const float* x = reinterpret_cast<const float*>(utt_smem + (size_t)(c % NS) * lay.stage) +
                       utt_granules(lpz_b + (size_t)t0 * V, 1).ofs;
      // split s: frames a .. a + n - 1 of the chunk, in pairs, four frames
      // of phi a load
      const int per = ((fc + S - 1) / S + 3) & ~3;
      const int a = split * per;
      const int n = min(fc, a + per) - a;
      if (v0 >= 0 && n > 0) {
        const float4* ph = reinterpret_cast<const float4*>(rs + row + a);
        const float* x0 = x + (size_t)a * V + v0;
        const float* x1 = x + (size_t)a * V + v1;
        int i = 0;
#pragma unroll 2
        for (; i + 4 <= n; i += 4, x0 += 4 * V, x1 += 4 * V) {
          const float4 p = ph[i / 4];
          utt_add_pair(p.x + x0[0], p.y + x0[V], m0, a0);
          utt_add_pair(p.z + x0[2 * V], p.w + x0[3 * V], m0, a0);
          utt_add_pair(p.x + x1[0], p.y + x1[V], m1, a1);
          utt_add_pair(p.z + x1[2 * V], p.w + x1[3 * V], m1, a1);
        }
        if (i < n) {  // one to three frames left
          const float4 p = ph[i / 4];
          const bool two = i + 1 < n, three = i + 2 < n;
          utt_add_pair(p.x + x0[0], two ? p.y + x0[V] : -CUDART_INF_F, m0, a0);
          utt_add_pair(p.x + x1[0], two ? p.y + x1[V] : -CUDART_INF_F, m1, a1);
          if (three) {
            utt_add_pair(p.z + x0[2 * V], -CUDART_INF_F, m0, a0);
            utt_add_pair(p.z + x1[2 * V], -CUDART_INF_F, m1, a1);
          }
        }
      }
      // the warp is done with chunk c's lpz rows
      __syncwarp();
      if (warp_lead && c + NS < n_chunks) rg::mbar_arrive(empty + c % NS);
      PHASE(4)
    }
    if (tid < US) {
      const size_t at = ((size_t)split * U + u) * 2;
      pm[at] = m0, pa[at] = a0;
      pm[at + 1] = m1, pa[at + 1] = a1;
    }
  }

  // each lane's S pairs and the LOG_ZERO start term, in a fixed order
  __syncthreads();
  for (int lane = tid; lane < K * V; lane += blockDim.x) {
    const int k = lane / V, v = lane - k * V;
    float out;
    if (v == eos) {
      out = s_eos[k];
    } else if (v == blank) {
      out = rg::LOG_ZERO;
    } else {
      // the lane's unit and which of its two lanes
      const int u = v == s_last[k] ? K * H + k : k * H + (v < H ? v : v - H);
      const int w = v == s_last[k] || v < H ? 0 : 1;
      float top = rg::LOG_ZERO;
      for (int j = 0; j < S; ++j) top = fmaxf(top, pm[((size_t)j * U + u) * 2 + w]);
      float sum = expf(rg::LOG_ZERO - top);
      for (int j = 0; j < S; ++j) {
        const size_t at = ((size_t)j * U + u) * 2 + w;
        sum += pa[at] * expf(pm[at] - top);
      }
      out = top + logf(sum);
    }
    psi[(size_t)b * K * V + lane] = out;
  }
  PHASE(5)
  PHASE_END(2)
}

}  // namespace

// S frame splits, F frames a chunk (a multiple of 4), NS stages (2 to 4)
// and `smem` bytes from ops/ctc_prefix.py::utt_psi_plan/utt_psi_smem; a
// byte count that disagrees with the kernel's layout is refused.
extern "C" int ctc_prefix_utt(const void* lpz, const void* last_tok, const void* lengths,
                              const void* r_n, const void* r_b, void* psi, int B, int K,
                              int T, int V, int blank, int eos, int S, int F, int NS, int smem,
                              void* stream) {
  if (B < 1 || K < 1 || T < 1 || V < 1 || S < 1 || S > kUttMaxSplits || F < 4 || F % 4 ||
      NS < 2 || NS > 4 || K * V > kUttMaxThreads ||
      utt_units(K, V) * S > utt_consumers(K, V, S) ||
      K * F > kUttAhead * utt_consumers(K, V, S) || blank < 0 || blank >= V ||
      eos < 0 || eos >= V || smem < 0 || utt_layout(K, V, S, F, NS).total != (size_t)smem)
    return (int)cudaErrorInvalidValue;
  const cudaError_t err = rg::reserve_smem<utt_psi_kernel>((size_t)smem);
  if (err != cudaSuccess) return (int)err;
  const int threads = utt_consumers(K, V, S) + 32;
  utt_psi_kernel<<<B, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(lpz), static_cast<const int*>(last_tok),
      static_cast<const int*>(lengths), static_cast<const float*>(r_n),
      static_cast<const float*>(r_b), static_cast<float*>(psi), K, T, V, blank, eos, S, F, NS);
  return (int)cudaGetLastError();
}
