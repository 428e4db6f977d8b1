// The per-utterance attention step as a block-wide device function: the
// body of att_loc_utt.cu (one block an utterance, the "utt" route of
// ops/att.py::att_loc_step), which att_dec_utt.cu runs too. The contract,
// rounding points and design are described in att_loc_utt.cu.
//
// att_utt_body runs utterance b's K hypotheses on the calling block
// (kThreads<T> threads) in the dynamic shared memory `smem` of
// layout(...).total bytes, writes att, and hands each context value to
// store_ctx(k * E + e, value) at the end. It begins by overwriting the
// shared memory: a caller that runs it again, or reuses the shared memory
// after it, meets a block barrier in between.
#pragma once

#include "att_body.cuh"

#include <type_traits>

// clock64() marks for robust_e2e_gan_torch/tools/att_utt_phases.py, which
// defines them; empty in the library build.
#ifndef PHASE_BEGIN
#define PHASE_BEGIN
#define PHASE(n)
#define PHASE_END
#endif

namespace {

using bf16 = __nv_bfloat16;

constexpr int KMAX = 16;  // hypotheses of an utterance
constexpr int KG = 4;     // hypotheses a warp's tile product and a context thread take at once
static_assert(KG == 4, "the context reads a group's att values as one float4");
constexpr int CMAX = 32;  // location-conv channels

// threads a block: 16 warps in bfloat16; 8 in float32, whose tile product
// keeps 2 C weights a lane in registers
template <typename T> constexpr int kThreads = std::is_same<T, bf16>::value ? 512 : 256;

__host__ __device__ inline size_t r16(size_t x) { return (x + 15) & ~size_t(15); }

// channels of the bfloat16 product: one or two k-steps of 16
__host__ __device__ inline int padded_channels(int C) { return C <= 16 ? 16 : 32; }

// elements between the rows of the repacked feat: CP + 8 in bfloat16
// (ldmatrix rows on distinct banks), odd in float32 (the eight rows a warp
// reads at once on distinct banks)
__host__ __device__ inline int feat_stride(int C, bool b16) {
  return b16 ? padded_channels(C) + 8 : (C | 1);
}

// Byte offsets of the dynamic shared memory (ops/att.py::utt_smem computes
// the same total): two staging slots of F rows of max(A, E) (enc_proj,
// then enc), two sets of K raw feat slots of F x C, each 16 bytes longer
// than its rows so that a copy keeps its source's offset modulo 16; the
// repacked feat (Kp, F, stride); wloc (bfloat16: (Ap, CP + 8) transposed;
// float32: (C, Ap)); g (Ap) as float32 and dec (Kp, Ap) in T, zero past A
// and K; the partial scores (S, Kp, F), the scores (T, Kp) and the context
// (Kp, E), whose bytes first hold the raw dec (K x A), wloc (C x A) and g
// (A) slots. Kp is K rounded up to KG.
struct Layout {
  size_t stage_slot, fraw_slot;
  size_t stage, fraw, wraw_dec, wraw_w, wraw_g, fpad, w, g, dec, part, score, ctx, total;
};

__host__ __device__ inline Layout layout(int K, int Tn, int C, int A, int E, int F, int S,
                                         int isz) {
  const bool b16 = isz == 2;
  const size_t Ap = (A + 7) / 8 * 8, Kp = (K + KG - 1) / KG * KG;
  Layout L;
  L.stage_slot = r16((size_t)F * (A > E ? A : E) * isz) + 16;
  L.fraw_slot = r16((size_t)F * C * isz) + 16;
  size_t o = 0;
  L.stage = o;
  o += 2 * L.stage_slot;
  L.fraw = o;
  o += 2 * (size_t)K * L.fraw_slot;
  L.fpad = o;
  o += r16(Kp * F * feat_stride(C, b16) * isz);
  L.w = o;
  o += r16(b16 ? Ap * (padded_channels(C) + 8) * 2 : (size_t)C * Ap * 4);
  L.g = o;
  o += Ap * 4;
  L.dec = o;
  o += r16(Kp * Ap * isz);
  // the raw dec, wloc and g share their bytes with part, score and ctx:
  // they are unpacked before chunk 0's tiles write part
  L.part = o;
  L.score = L.part + (size_t)S * Kp * F * 4;
  L.ctx = L.score + r16(Kp * Tn * 4);
  L.wraw_dec = L.part;
  L.wraw_w = L.wraw_dec + r16((size_t)K * A * isz) + 16;
  L.wraw_g = L.wraw_w + r16((size_t)C * A * isz) + 16;
  const size_t wraw_end = L.wraw_g + r16((size_t)A * isz) + 16;
  const size_t ctx_end = L.ctx + r16(Kp * E * 4);
  L.total = wraw_end > ctx_end ? wraw_end : ctx_end;
  return L;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(rg::smem_addr(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(rg::smem_addr(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Starts the copy of n bytes (a multiple of 2) from src to slot + (src %
// 16), slot 16-byte aligned, by every thread of the block: 16-byte
// cp.async pieces, and the unaligned head and tail in 4-byte ones (or
// 2-byte plain copies where src is only 2-byte aligned). The caller
// commits the group, waits for it and meets a barrier before reading.
__device__ void stage(char* slot, const void* src_v, int n) {
  const char* src = static_cast<const char*>(src_v);
  const int off = (int)(reinterpret_cast<uintptr_t>(src) & 15);
  char* dst = slot + off;
  const int head = min(n, (16 - off) & 15);
  const int body = (n - head) & ~15;
  for (int i = threadIdx.x; i < body / 16; i += blockDim.x)
    cp_async16(dst + head + 16 * i, src + head + 16 * i);
  const int unit = (off % 4 == 0 && n % 4 == 0) ? 4 : 2;
  for (int i = threadIdx.x; i < (n - body) / unit; i += blockDim.x) {
    const int o = unit * i < head ? unit * i : body + unit * i;
    if (unit == 4)
      cp_async4(dst + o, src + o);
    else
      *reinterpret_cast<uint16_t*>(dst + o) = *reinterpret_cast<const uint16_t*>(src + o);
  }
}

// The staged copy of src in slot (see stage).
template <typename T>
__device__ __forceinline__ const T* staged(const char* slot, const T* src) {
  return reinterpret_cast<const T*>(slot + (reinterpret_cast<uintptr_t>(src) & 15));
}

__device__ __forceinline__ void load_pair(const float* p, float& x0, float& x1) {
  const float2 v = *reinterpret_cast<const float2*>(p);
  x0 = v.x;
  x1 = v.y;
}

// acc + g0 * rnd(tanhf(pre0)) + g1 * rnd(tanhf(pre1)) with pre = rnd(rnd(ep
// + rnd(loc)) + dec), for the two bfloat16 elements of ep and dec: loc and
// the tanh rounded by one packed conversion each, the adds in bfloat16
// pairs (the exact sum of two bfloat16 values rounded once, which is what
// a float32 add then rounded gives). The terms are added in column order.
__device__ __forceinline__ float term2(float l0, float l1, __nv_bfloat162 ep, __nv_bfloat162 dec,
                                       float g0, float g1, float acc) {
  const __nv_bfloat162 pre = __hadd2(__hadd2(ep, __floats2bfloat162_rn(l0, l1)), dec);
  const __nv_bfloat162 th =
      __floats2bfloat162_rn(tanhf(__low2float(pre)), tanhf(__high2float(pre)));
  return fmaf(__high2float(th), g1, fmaf(__low2float(th), g0, acc));
}

// The float32 form (no rounding points): acc + g0 tanhf(ep0 + loc0 + dec0)
// + g1 tanhf(ep1 + loc1 + dec1).
__device__ __forceinline__ float term2(float l0, float l1, float e0, float e1, float d0, float d1,
                                       float g0, float g1, float acc) {
  return fmaf(tanhf(e1 + l1 + d1), g1, fmaf(tanhf(e0 + l0 + d0), g0, acc));
}

template <typename T, typename StoreCtx>
__device__ __forceinline__ void att_utt_body(
    const T* __restrict__ feat,      // (B, K, Tn, C)
    const T* __restrict__ enc_proj,  // (B, Tn, A)
    const T* __restrict__ enc,       // (B, Tn, E)
    const T* __restrict__ dec,       // (B, K, A)
    const T* __restrict__ wloc,      // (C, A)
    const T* __restrict__ g,         // (A,)
    const float* __restrict__ mask,  // (B, Tn)
    float* __restrict__ att,         // (B, K, Tn)
    int b, int K, int Tn, int C, int A, int E, int F, int S, float sharpening, char* smem,
    StoreCtx store_ctx) {
  constexpr bool kB16 = std::is_same<T, bf16>::value;
  constexpr int NT = kThreads<T>;
  constexpr int NW = NT / 32;
  PHASE_BEGIN
  const Layout L = layout(K, Tn, C, A, E, F, S, sizeof(T));
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int gq = lane / 4, tq = lane % 4;  // the mma fragments' row and column pair
  const int Kp = (K + KG - 1) / KG * KG;
  const int Ap = (A + 7) / 8 * 8;
  const int CP = padded_channels(C), FS = feat_stride(C, kB16);
  const int n_chunks = (Tn + F - 1) / F;
  const T* ep_b = enc_proj + (size_t)b * Tn * A;
  const T* enc_b = enc + (size_t)b * Tn * E;
  const T* feat_b = feat + (size_t)b * K * Tn * C;
  const float* mask_b = mask + (size_t)b * Tn;
  T* fpad = reinterpret_cast<T*>(smem + L.fpad);
  T* w_s = reinterpret_cast<T*>(smem + L.w);
  float* g_s = reinterpret_cast<float*>(smem + L.g);
  T* d_s = reinterpret_cast<T*>(smem + L.dec);
  float* part = reinterpret_cast<float*>(smem + L.part);
  float* sc = reinterpret_cast<float*>(smem + L.score);
  float* ctx_s = reinterpret_cast<float*>(smem + L.ctx);
  auto slot = [&](int buf) { return smem + L.stage + buf * L.stage_slot; };
  auto raw_slot = [&](int buf, int k) { return smem + L.fraw + (buf * K + k) * L.fraw_slot; };

  // chunk i of enc_proj and of every hypothesis' feat into buffer i % 2
  auto stage_scores = [&](int i) {
    const int t0 = i * F, fv = min(F, Tn - t0);
    stage(slot(i & 1), ep_b + (size_t)t0 * A, fv * A * (int)sizeof(T));
    for (int k = 0; k < K; ++k)
      stage(raw_slot(i & 1, k), feat_b + ((size_t)k * Tn + t0) * C, fv * C * (int)sizeof(T));
  };
  // chunk j of enc into buffer (n_chunks + j) % 2
  auto stage_enc = [&](int j) {
    const int t0 = j * F, fv = min(F, Tn - t0);
    stage(slot((n_chunks + j) & 1), enc_b + (size_t)t0 * E, fv * E * (int)sizeof(T));
  };
  // the scores of chunk j: the S splits' partial sums in a fixed order
  auto reduce = [&](int j) {
    const int t0 = j * F, fv = min(F, Tn - t0);
    for (int i = tid; i < Kp * fv; i += NT) {
      const int k = i / fv, r = i % fv;
      float v = 0.f;
      for (int s = 0; s < S; ++s) v += part[(s * Kp + k) * F + r];
      sc[(t0 + r) * Kp + k] = v;
    }
  };

  // the utterance's dec rows, wloc and g, then chunk 0, in one group
  const T* dec_b = dec + (size_t)b * K * A;
  stage(smem + L.wraw_dec, dec_b, K * A * (int)sizeof(T));
  stage(smem + L.wraw_w, wloc, C * A * (int)sizeof(T));
  stage(smem + L.wraw_g, g, A * (int)sizeof(T));
  stage_scores(0);
  cp_async_commit();
  // g as float32 and dec in T, zero past A (and dec past K); wloc
  // transposed (bfloat16) or as it is (float32), zero past A and C
  auto unpack_weights = [&]() {
    const T* dec_r = staged(smem + L.wraw_dec, dec_b);
    const T* w_r = staged(smem + L.wraw_w, wloc);
    const T* g_r = staged(smem + L.wraw_g, g);
    const T zero = rg::from_f<T>(0.f);
    for (int a = tid; a < Ap; a += NT) {  // a column a thread
      g_s[a] = a < A ? rg::to_f(g_r[a]) : 0.f;
      for (int k = 0; k < Kp; ++k) d_s[k * Ap + a] = (a < A && k < K) ? dec_r[k * A + a] : zero;
      if constexpr (kB16) {
        for (int c = 0; c < CP + 8; ++c)
          w_s[a * (CP + 8) + c] = (a < A && c < C) ? w_r[c * A + a] : zero;
      } else {
        for (int c = 0; c < C; ++c) w_s[c * Ap + a] = a < A ? w_r[c * A + a] : zero;
      }
    }
  };

  PHASE(0)
  // ---- scores, chunk by chunk
  const int s_col = warp % S, grp = warp / S;  // column split, frame group
  const int nct = Ap / 8;
  const int nks = CP / 16;
  const int f_log = __ffs(F) - 1;  // F is a power of two
  for (int i = 0; i < n_chunks; ++i) {
    cp_async_wait_all();
    __syncthreads();  // chunk i has landed; chunk i - 1's tiles are done
    PHASE(1)
    if (i == 0) unpack_weights();
    const int t0 = i * F, fv = min(F, Tn - t0);
    // feat of chunk i in the product's layout, a (hypothesis, frame) row
    // a thread: zeros past C, past fv and past K
    for (int row = tid; row < Kp * F; row += NT) {
      const int k = row >> f_log, r = row & (F - 1);
      T* dst = fpad + row * FS;
      const bool valid = k < K && r < fv;
      const T* src = valid ? staged(raw_slot(i & 1, k), feat_b + ((size_t)k * Tn + t0) * C) + r * C
                           : nullptr;
      if (kB16 && valid && C % 2 == 0 && (reinterpret_cast<uintptr_t>(src) & 3) == 0) {
        // two channels a 32-bit word
        const uint32_t* s32 = reinterpret_cast<const uint32_t*>(src);
        uint32_t* d32 = reinterpret_cast<uint32_t*>(dst);
        for (int c2 = 0; c2 < CP / 2; ++c2) d32[c2] = c2 < C / 2 ? s32[c2] : 0u;
      } else {
        const int W = kB16 ? CP : C;
        for (int c = 0; c < W; ++c) dst[c] = (valid && c < C) ? src[c] : rg::from_f<T>(0.f);
      }
    }
    if (i > 0) reduce(i - 1);
    __syncthreads();  // fpad is complete; part is free
    PHASE(2)
    // chunk i + 1 into the buffers chunk i - 1 left (its tiles and repack
    // are done), or enc's first chunk after the last
    if (i + 1 < n_chunks)
      stage_scores(i + 1);
    else
      stage_enc(0);
    cp_async_commit();
    PHASE(3)

    const int r0 = grp * 16;
    if (r0 < fv) {
      const T* ep_c = staged(slot(i & 1), ep_b + (size_t)t0 * A);
      const int ra = r0 + gq, rb = ra + 8;  // the lane's two rows of the tile
      for (int k0 = 0; k0 < Kp; k0 += KG) {
        float acc[KG][2];
#pragma unroll
        for (int kk = 0; kk < KG; ++kk) acc[kk][0] = acc[kk][1] = 0.f;
        for (int ct = s_col; ct < nct; ct += S) {
          const int a = ct * 8 + 2 * tq;  // the lane's two columns a, a + 1
          float g0, g1;
          load_pair(g_s + a, g0, g1);
          // enc_proj at the lane's rows ra, rb and columns a, a + 1, zero
          // past fv and A
          T ea0 = rg::from_f<T>(0.f), ea1 = ea0, eb0 = ea0, eb1 = ea0;
          if (A % 2 == 0) {  // a even: both columns valid or both past A
            if (a < A) {
              if (ra < fv) ea0 = ep_c[ra * A + a], ea1 = ep_c[ra * A + a + 1];
              if (rb < fv) eb0 = ep_c[rb * A + a], eb1 = ep_c[rb * A + a + 1];
            }
          } else {
            if (ra < fv && a < A) ea0 = ep_c[ra * A + a];
            if (ra < fv && a + 1 < A) ea1 = ep_c[ra * A + a + 1];
            if (rb < fv && a < A) eb0 = ep_c[rb * A + a];
            if (rb < fv && a + 1 < A) eb1 = ep_c[rb * A + a + 1];
          }
          if constexpr (kB16) {
            const __nv_bfloat162 epa = __halves2bfloat162(ea0, ea1);
            const __nv_bfloat162 epb = __halves2bfloat162(eb0, eb1);
            // B fragments of wloc: lane (gq, tq) holds rows 2tq, 2tq + 1
            // (and + 8) of column ct * 8 + gq
            uint32_t bw[2][2];
#pragma unroll
            for (int ks = 0; ks < 2; ++ks) {
              if (ks < nks) {
                const bf16* wr = w_s + (ct * 8 + gq) * (CP + 8) + ks * 16 + 2 * tq;
                bw[ks][0] = *reinterpret_cast<const uint32_t*>(wr);
                bw[ks][1] = *reinterpret_cast<const uint32_t*>(wr + 8);
              }
            }
#pragma unroll
            for (int kk = 0; kk < KG; ++kk) {
              const int k = k0 + kk;
              float d[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
              for (int ks = 0; ks < 2; ++ks) {
                if (ks < nks) {
                  uint32_t af[4];
                  rg::ldsm_x4(af, fpad + (k * F + r0 + lane % 16) * FS + ks * 16 + (lane / 16) * 8);
                  rg::mma16816(d, af, bw[ks][0], bw[ks][1]);
                }
              }
              const __nv_bfloat162 dk = *reinterpret_cast<const __nv_bfloat162*>(d_s + k * Ap + a);
              acc[kk][0] = term2(d[0], d[1], epa, dk, g0, g1, acc[kk][0]);
              acc[kk][1] = term2(d[2], d[3], epb, dk, g0, g1, acc[kk][1]);
            }
          } else {
            float w0[CMAX], w1[CMAX];  // the lane's two columns of wloc
#pragma unroll
            for (int c = 0; c < CMAX; ++c)
              if (c < C) load_pair(w_s + c * Ap + a, w0[c], w1[c]);
#pragma unroll
            for (int kk = 0; kk < KG; ++kk) {
              const int k = k0 + kk;
              const T* fa = fpad + (k * F + ra) * FS;
              const T* fb = fpad + (k * F + rb) * FS;
              float d[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
              for (int c = 0; c < CMAX; ++c) {
                if (c < C) {
                  const float x = rg::to_f(fa[c]), y = rg::to_f(fb[c]);
                  d[0] = fmaf(x, w0[c], d[0]);
                  d[1] = fmaf(x, w1[c], d[1]);
                  d[2] = fmaf(y, w0[c], d[2]);
                  d[3] = fmaf(y, w1[c], d[3]);
                }
              }
              float d0, d1;
              load_pair(d_s + k * Ap + a, d0, d1);
              acc[kk][0] = term2(d[0], d[1], ea0, ea1, d0, d1, g0, g1, acc[kk][0]);
              acc[kk][1] = term2(d[2], d[3], eb0, eb1, d0, d1, g0, g1, acc[kk][1]);
            }
          }
        }
#pragma unroll
        for (int kk = 0; kk < KG; ++kk) {
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            float v = acc[kk][j];
            v += __shfl_xor_sync(0xffffffffu, v, 1);
            v += __shfl_xor_sync(0xffffffffu, v, 2);
            if (tq == 0) part[(s_col * Kp + k0 + kk) * F + r0 + gq + 8 * j] = v;
          }
        }
      }
    }
    PHASE(4)
  }
  __syncthreads();
  reduce(n_chunks - 1);
  __syncthreads();
  PHASE(5)

  // ---- sharpened, masked softmax over T: one warp per hypothesis
  for (int k = warp; k < K; k += NW) {
    float* e = sc + k;  // e[t * Kp]
    float vmax = -CUDART_INF_F;
    for (int t = lane; t < Tn; t += 32) {
      const float v = mask_b[t] > 0.f ? sharpening * e[t * Kp] : rg::kAttMaskMin;
      e[t * Kp] = v;
      vmax = fmaxf(vmax, v);
    }
    vmax = rg::warp_max(vmax);
    float vsum = 0.f;
    for (int t = lane; t < Tn; t += 32) {
      const float ex = expf(e[t * Kp] - vmax);
      e[t * Kp] = ex;
      vsum += ex;
    }
    vsum = rg::warp_sum(vsum);
    float msum = 0.f;
    for (int t = lane; t < Tn; t += 32) {
      const float p = e[t * Kp] / vsum * mask_b[t];
      e[t * Kp] = p;
      msum += p;
    }
    msum = fmaxf(rg::warp_sum(msum), 1e-8f);
    float* att_k = att + ((size_t)b * K + k) * Tn;
    for (int t = lane; t < Tn; t += 32) {
      const float p = e[t * Kp] / msum;
      e[t * Kp] = p;
      att_k[t] = p;
    }
  }

  PHASE(6)
  // ---- context: thread (e, group of KG hypotheses) reads each staged enc
  // element once for the group (rows past K hold finite scores; their
  // sums are dropped)
  for (int j = 0; j < n_chunks; ++j) {
    cp_async_wait_all();
    __syncthreads();  // enc chunk j has landed; chunk j - 1's sums are done
    PHASE(7)
    if (j + 1 < n_chunks) stage_enc(j + 1);
    cp_async_commit();
    const int t0 = j * F, fv = min(F, Tn - t0);
    const T* enc_c = staged(slot((n_chunks + j) & 1), enc_b + (size_t)t0 * E);
    for (int it = tid; it < E * (Kp / KG); it += NT) {
      const int e = it % E, k0 = it / E * KG;
      float acc[KG];
#pragma unroll
      for (int kk = 0; kk < KG; ++kk) acc[kk] = j > 0 ? ctx_s[(k0 + kk) * E + e] : 0.f;
      const float* a_t = sc + t0 * Kp + k0;  // the group's KG att values a frame
#pragma unroll 4
      for (int t = 0; t < fv; ++t) {
        const float x = rg::to_f(enc_c[t * E + e]);
        const float4 p = *reinterpret_cast<const float4*>(a_t + t * Kp);
        acc[0] = fmaf(p.x, x, acc[0]);
        acc[1] = fmaf(p.y, x, acc[1]);
        acc[2] = fmaf(p.z, x, acc[2]);
        acc[3] = fmaf(p.w, x, acc[3]);
      }
#pragma unroll
      for (int kk = 0; kk < KG; ++kk) ctx_s[(k0 + kk) * E + e] = acc[kk];
    }
    PHASE(8)
  }
  __syncthreads();
  for (int i = tid; i < K * E; i += NT) store_ctx(i, ctx_s[i]);
  PHASE(9)
  PHASE_END
}

}  // namespace
