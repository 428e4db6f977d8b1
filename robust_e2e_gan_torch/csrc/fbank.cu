// Fused log-mel frontend: framing -> windowed DFT -> power -> mel -> log ->
// masked two-pass utterance CMVN, and its backward to the waveform.
//
// Replaces robust_e2e_gan_tpu/ops/fbank_pallas.py::fbank_fused (forward)
// and the backward kernel of ::fbank_fused_trainable. DC removal,
// pre-emphasis and the window are folded into the DFT bases on the host
// (ops/fbank_fused.py::combined_bases), as on the TPU. The TPU kernel
// stacks three row-shifted copies of the waveform because Mosaic needs
// 8-aligned sublane slices; here a block reads frame t straight from
// wav[b, t * shift : t * shift + L].
//
// What bounds it on Hopper: operations. At the decode's shapes (B = 128
// utterances of 111,360 samples, 694 frames each, L = 400, 257 bins, 80
// mels) the DFT alone is ~36 GFLOP of float32 FMAs against ~85 MB of
// waveform and features: ~0.6 ms at the CUDA cores' float32 rate, ~25 us
// of memory traffic. All products are true float32 (the JAX kernel pins
// them to Precision.HIGHEST), so no TF32 or bf16 tensor-core path.
//
// Design: a block per (utterance, tile of TT frames) fills the card. It
// copies its frames into shared memory transposed ([l][t], rows padded to
// TS floats so each frame position is one aligned float4 of 4 frames);
// thread f owns DFT bin f and keeps the TT frames' real and imaginary sums
// in registers, reading the folded bases from global memory (822 KB, they
// stay in L2) once per TT frames, two rows ahead of their use. Power goes
// back to shared memory, where a thread per (mel bin, 16 frames) takes the
// mel products (16 independent sums per filterbank element read), the log
// and the length mask.
// Blocks run in no order, so CMVN's per-utterance mean and variance are a
// second, small kernel (one block per utterance, column sums in a fixed
// order). The backward recomputes the spectra tile by tile (no re/im
// residuals in device memory), applies the CMVN, log and mel chain rule,
// and writes each frame's gradient (B, T, L); a last kernel overlap-adds
// them to the waveform as a gather (each sample sums the <= 3 frames that
// cover it), so the result is deterministic. Tiling the bases in shared
// memory and 3xTF32 tensor-core products are later work.

#include "common.cuh"

namespace {

constexpr int TT = 32;      // frames per block
constexpr int TS = TT + 4;  // row stride of the transposed frame tile
constexpr int TG = 16;      // frames per thread in the mel products
// threads of the DFT blocks: one per bin (and per frame sample in the
// backward); 512 leaves each thread the registers of its 2 * TT sums
constexpr int MAX_THREADS = 512;

__device__ __forceinline__ int min_i(int a, int b) { return a < b ? a : b; }

// frT[l * TS + t] = wav[b, (t0 + t) * shift + l] for the block's frames
__device__ __forceinline__ void load_frames(const float* __restrict__ wav, float* frT,
                                            int t0, int nt, int L, int shift) {
  for (int i = threadIdx.x; i < TT * L; i += blockDim.x) {
    const int t = i / L, l = i % L;
    frT[l * TS + t] = t < nt ? wav[(size_t)(t0 + t) * shift + l] : 0.f;
  }
}

// re[t], im[t] = sum_l frame_t[l] * M[l][f] for the block's TT frames. The
// bases stream from L2; each row's pair is loaded two rows ahead, so the
// loads overlap the products instead of stalling every row.
__device__ __forceinline__ void dft(const float* frT, const float* __restrict__ mcos,
                                    const float* __restrict__ msin, int L, int F, int f,
                                    float (&re)[TT], float (&im)[TT]) {
#pragma unroll
  for (int t = 0; t < TT; ++t) re[t] = im[t] = 0.f;
  float c0 = __ldg(mcos + f), s0 = __ldg(msin + f);
  const int l1 = min_i(1, L - 1);
  float c1 = __ldg(mcos + (size_t)l1 * F + f), s1 = __ldg(msin + (size_t)l1 * F + f);
  for (int l = 0; l < L; ++l) {
    const int l2 = min_i(l + 2, L - 1);
    const float c2 = __ldg(mcos + (size_t)l2 * F + f);
    const float s2 = __ldg(msin + (size_t)l2 * F + f);
    const float4* x4 = reinterpret_cast<const float4*>(frT + l * TS);
#pragma unroll
    for (int j = 0; j < TT / 4; ++j) {
      const float4 x = x4[j];
      re[4 * j] = fmaf(x.x, c0, re[4 * j]);
      re[4 * j + 1] = fmaf(x.y, c0, re[4 * j + 1]);
      re[4 * j + 2] = fmaf(x.z, c0, re[4 * j + 2]);
      re[4 * j + 3] = fmaf(x.w, c0, re[4 * j + 3]);
      im[4 * j] = fmaf(x.x, s0, im[4 * j]);
      im[4 * j + 1] = fmaf(x.y, s0, im[4 * j + 1]);
      im[4 * j + 2] = fmaf(x.z, s0, im[4 * j + 2]);
      im[4 * j + 3] = fmaf(x.w, s0, im[4 * j + 3]);
    }
    c0 = c1, s0 = s1, c1 = c2, s1 = s2;
  }
}

// mel[j] = sum_k P[(tb + j) * F + k] * fb[k * M + m] for TG frames: one
// thread per (mel bin, group of TG frames), so each fb element read feeds TG
// independent sums (the threads of a warp read one P row: a broadcast)
__device__ __forceinline__ void mel_rows(const float* P, const float* __restrict__ fb, int F,
                                         int M, int m, int tb, float (&mel)[TG]) {
#pragma unroll
  for (int j = 0; j < TG; ++j) mel[j] = 0.f;
  for (int k = 0; k < F; ++k) {
    const float w = __ldg(fb + (size_t)k * M + m);
#pragma unroll
    for (int j = 0; j < TG; ++j) mel[j] = fmaf(P[(tb + j) * F + k], w, mel[j]);
  }
}

// masked log-mel of TT frames per block: out (B, T, M), pad frames 0
__global__ void __launch_bounds__(MAX_THREADS)
logmel_kernel(const float* __restrict__ wav, const int* __restrict__ n_valid,
              const float* __restrict__ mcos, const float* __restrict__ msin,
              const float* __restrict__ fb, float* __restrict__ out, int N, int T, int L,
              int shift, int F, int M, float log_floor, int use_power) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int b = blockIdx.y, t0 = blockIdx.x * TT;
  const int nt = min_i(TT, T - t0);
  const int nv = min_i(n_valid[b], T);
  const int f = threadIdx.x;
  load_frames(wav + (size_t)b * N, smem, t0, nt, L, shift);
  __syncthreads();
  float re[TT], im[TT];
  if (f < F) dft(smem, mcos, msin, L, F, f, re, im);
  __syncthreads();  // the frames are read: the tile becomes the power
  float* P = smem;  // (TT, F)
  if (f < F) {
#pragma unroll
    for (int t = 0; t < TT; ++t) {
      float p = re[t] * re[t] + im[t] * im[t];
      if (!use_power) p = sqrtf(fmaxf(p, 0.f));
      P[t * F + f] = p;
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < (TT / TG) * M; i += blockDim.x) {
    const int tb = i / M * TG, m = i % M;
    float mel[TG];
    mel_rows(P, fb, F, M, m, tb, mel);
#pragma unroll
    for (int j = 0; j < TG; ++j) {
      const int tg = t0 + tb + j;
      if (tb + j < nt)
        out[((size_t)b * T + tg) * M + m] = tg < nv ? logf(fmaxf(mel[j], log_floor)) : 0.f;
    }
  }
}

// block-wide column sums: S slices of the frames per mel column, added in
// slice order by slice 0; every thread gets the total of its column
__device__ __forceinline__ float column_total(float part, float* red, int m, int s, int M,
                                              int S) {
  red[s * M + m] = part;
  __syncthreads();
  float tot = 0.f;
  for (int p = 0; p < S; ++p) tot += red[p * M + m];
  __syncthreads();
  return tot;
}

// in-place two-pass masked utterance CMVN, one block per utterance
__global__ void cmvn_kernel(float* __restrict__ x, const int* __restrict__ n_valid, int T,
                            int M, int S, int norm_var, float eps) {
  extern __shared__ float red[];  // (S, M)
  const int b = blockIdx.x, m = threadIdx.x % M, s = threadIdx.x / M;
  const int nv = min_i(n_valid[b], T);
  const float denom = fmaxf((float)nv, 1.f);
  float* xb = x + (size_t)b * T * M + m;
  float part = 0.f;
  for (int t = s; t < nv; t += S) part += xb[(size_t)t * M];
  const float mean = column_total(part, red, m, s, M, S) / denom;
  float scale = 1.f;
  if (norm_var) {
    part = 0.f;
    for (int t = s; t < nv; t += S) {
      const float c = xb[(size_t)t * M] - mean;
      part = fmaf(c, c, part);
    }
    scale = rsqrtf(column_total(part, red, m, s, M, S) / denom + eps);
  }
  for (int t = s; t < nv; t += S) xb[(size_t)t * M] = (xb[(size_t)t * M] - mean) * scale;
}

// CMVN backward: dfeats from the recomputed masked log-mel and the
// cotangent g, the exact transpose of cmvn_kernel; pad frames get 0
__global__ void cmvn_bwd_kernel(const float* __restrict__ feats, const float* __restrict__ g,
                                float* __restrict__ dfeats, const int* __restrict__ n_valid,
                                int T, int M, int S, int norm_var, float eps) {
  extern __shared__ float red[];  // (S, M)
  const int b = blockIdx.x, m = threadIdx.x % M, s = threadIdx.x / M;
  const int nv = min_i(n_valid[b], T);
  const float denom = fmaxf((float)nv, 1.f);
  const size_t base = (size_t)b * T * M + m;
  const float* xb = feats + base;
  const float* gb = g + base;
  float* db = dfeats + base;
  float part = 0.f;
  for (int t = s; t < nv; t += S) part += xb[(size_t)t * M];
  const float mean = column_total(part, red, m, s, M, S) / denom;
  float sc = 1.f, coef = 0.f;
  if (norm_var) {
    float pv = 0.f, pg = 0.f;
    for (int t = s; t < nv; t += S) {
      const float c = xb[(size_t)t * M] - mean;
      pv = fmaf(c, c, pv);
      pg = fmaf(gb[(size_t)t * M], c, pg);
    }
    const float var = column_total(pv, red, m, s, M, S) / denom;
    const float sgc = column_total(pg, red, m, s, M, S);
    sc = rsqrtf(var + eps);
    const float dvar = sgc * -0.5f * sc * sc * sc;
    coef = 2.f / denom * dvar;  // dc = g * sc + coef * c
  }
  part = 0.f;
  for (int t = s; t < nv; t += S) {
    const float c = xb[(size_t)t * M] - mean;
    part += gb[(size_t)t * M] * sc + coef * c;
  }
  const float mdc = column_total(part, red, m, s, M, S) / denom;
  for (int t = s; t < T; t += S) {
    float d = 0.f;
    if (t < nv) d = gb[(size_t)t * M] * sc + coef * (xb[(size_t)t * M] - mean) - mdc;
    db[(size_t)t * M] = d;
  }
}

// per tile of TT frames: recompute the spectra, chain log -> mel -> power ->
// transposed DFT, write each frame's gradient dframes (B, T, L)
__global__ void __launch_bounds__(MAX_THREADS)
dframes_kernel(const float* __restrict__ wav, const float* __restrict__ mcos,
               const float* __restrict__ msin, const float* __restrict__ fb,
               const float* __restrict__ mcos_t, const float* __restrict__ msin_t,
               const float* __restrict__ fb_t, const float* __restrict__ dfeats,
               float* __restrict__ dframes, int N, int T, int L, int shift, int F, int M,
               float log_floor) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int region = max(L, 2 * F) * TS;
  float* frT = smem;                // (L, TS); later DRE (F, TS) and DIM (F, TS)
  float* dre_s = smem;
  float* dim_s = smem + F * TS;
  float* P = smem + region;         // (TT, F)
  float* DM = P + TT * F;           // (M, TS): d loss / d mel
  const int b = blockIdx.y, t0 = blockIdx.x * TT;
  const int nt = min_i(TT, T - t0);
  const int tid = threadIdx.x;
  load_frames(wav + (size_t)b * N, frT, t0, nt, L, shift);
  __syncthreads();
  float re[TT], im[TT];
  if (tid < F) dft(frT, mcos, msin, L, F, tid, re, im);
  __syncthreads();  // frames read
  if (tid < F) {
#pragma unroll
    for (int t = 0; t < TT; ++t) P[t * F + tid] = re[t] * re[t] + im[t] * im[t];
  }
  __syncthreads();
  for (int i = tid; i < (TT / TG) * M; i += blockDim.x) {
    const int tb = i / M * TG, m = i % M;
    float mel[TG];
    mel_rows(P, fb, F, M, m, tb, mel);
#pragma unroll
    for (int j = 0; j < TG; ++j) {
      const int t = tb + j;
      float d = 0.f;
      // d log(max(mel, floor)): zero where the floor clamps
      if (t < nt && mel[j] > log_floor)
        d = dfeats[((size_t)b * T + t0 + t) * M + m] / fmaxf(mel[j], log_floor);
      DM[m * TS + t] = d;
    }
  }
  __syncthreads();
  if (tid < F) {
    float dp[TT];
#pragma unroll
    for (int t = 0; t < TT; ++t) dp[t] = 0.f;
    // the filterbank rows, like the DFT bases, load two rows ahead
    float w0 = __ldg(fb_t + tid), w1 = __ldg(fb_t + (size_t)min_i(1, M - 1) * F + tid);
    for (int m = 0; m < M; ++m) {
      const float w = w0;
      w0 = w1;
      w1 = __ldg(fb_t + (size_t)min_i(m + 2, M - 1) * F + tid);
      const float4* d4 = reinterpret_cast<const float4*>(DM + m * TS);
#pragma unroll
      for (int j = 0; j < TT / 4; ++j) {
        const float4 x = d4[j];
        dp[4 * j] = fmaf(x.x, w, dp[4 * j]);
        dp[4 * j + 1] = fmaf(x.y, w, dp[4 * j + 1]);
        dp[4 * j + 2] = fmaf(x.z, w, dp[4 * j + 2]);
        dp[4 * j + 3] = fmaf(x.w, w, dp[4 * j + 3]);
      }
    }
#pragma unroll
    for (int t = 0; t < TT; ++t) {
      dre_s[tid * TS + t] = 2.f * re[t] * dp[t];
      dim_s[tid * TS + t] = 2.f * im[t] * dp[t];
    }
  }
  __syncthreads();
  if (tid < L) {
    float acc[TT];
#pragma unroll
    for (int t = 0; t < TT; ++t) acc[t] = 0.f;
    const int k1 = min_i(1, F - 1);
    float c0 = __ldg(mcos_t + tid), s0 = __ldg(msin_t + tid);
    float c1 = __ldg(mcos_t + (size_t)k1 * L + tid), s1 = __ldg(msin_t + (size_t)k1 * L + tid);
    for (int k = 0; k < F; ++k) {
      const int k2 = min_i(k + 2, F - 1);
      const float c = c0, s = s0;
      c0 = c1, s0 = s1;
      c1 = __ldg(mcos_t + (size_t)k2 * L + tid);
      s1 = __ldg(msin_t + (size_t)k2 * L + tid);
      const float4* r4 = reinterpret_cast<const float4*>(dre_s + k * TS);
      const float4* i4 = reinterpret_cast<const float4*>(dim_s + k * TS);
#pragma unroll
      for (int j = 0; j < TT / 4; ++j) {
        const float4 x = r4[j], y = i4[j];
        acc[4 * j] = fmaf(y.x, s, fmaf(x.x, c, acc[4 * j]));
        acc[4 * j + 1] = fmaf(y.y, s, fmaf(x.y, c, acc[4 * j + 1]));
        acc[4 * j + 2] = fmaf(y.z, s, fmaf(x.z, c, acc[4 * j + 2]));
        acc[4 * j + 3] = fmaf(y.w, s, fmaf(x.w, c, acc[4 * j + 3]));
      }
    }
#pragma unroll
    for (int t = 0; t < TT; ++t)
      if (t < nt) dframes[((size_t)b * T + t0 + t) * L + tid] = acc[t];
  }
}

// dwav[b, n] = sum over the frames t that cover sample n of
// dframes[b, t, n - t * shift], in ascending t; 0 past the last frame
__global__ void overlap_add_kernel(const float* __restrict__ dframes, float* __restrict__ dwav,
                                   int N, int T, int L, int shift) {
  const int b = blockIdx.y;
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= N) return;
  const int t_lo = n < L ? 0 : (n - L) / shift + 1;
  const int t_hi = min_i(n / shift, T - 1);
  float acc = 0.f;
  for (int t = t_lo; t <= t_hi; ++t) acc += dframes[((size_t)b * T + t) * L + n - t * shift];
  dwav[(size_t)b * N + n] = acc;
}

int block_for(int n) { return (n + 31) / 32 * 32; }

int slices_for(int M) { return max(1, min(8, 1024 / M)); }

}  // namespace

extern "C" int fbank_fwd(const void* wav, const void* n_valid, const void* mcos,
                         const void* msin, const void* fb, void* out, int B, int N, int T,
                         int L, int shift, int F, int M, float log_floor, int use_power,
                         int norm_var, float eps, void* stream) {
  if (B < 1 || T < 1 || F > MAX_THREADS || M > 1024 || L < 1) return (int)cudaErrorInvalidValue;
  const auto s = static_cast<cudaStream_t>(stream);
  const size_t smem = (size_t)max(L * TS, TT * F) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      logmel_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const auto* nv = static_cast<const int*>(n_valid);
  auto* x = static_cast<float*>(out);
  logmel_kernel<<<dim3((T + TT - 1) / TT, B), block_for(F), smem, s>>>(
      static_cast<const float*>(wav), nv, static_cast<const float*>(mcos),
      static_cast<const float*>(msin), static_cast<const float*>(fb), x, N, T, L, shift, F, M,
      log_floor, use_power);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int S = slices_for(M);
  cmvn_kernel<<<B, S * M, S * M * sizeof(float), s>>>(x, nv, T, M, S, norm_var, eps);
  return (int)cudaGetLastError();
}

extern "C" int fbank_bwd(const void* wav, const void* n_valid, const void* mcos,
                         const void* msin, const void* fb, const void* mcos_t,
                         const void* msin_t, const void* fb_t, const void* g, void* feats,
                         void* dfeats, void* dframes, void* dwav, int B, int N, int T, int L,
                         int shift, int F, int M, float log_floor, int norm_var, float eps,
                         void* stream) {
  if (B < 1 || T < 1 || F > MAX_THREADS || M > 1024 || L > MAX_THREADS || L < 1)
    return (int)cudaErrorInvalidValue;
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* w = static_cast<const float*>(wav);
  const auto* nv = static_cast<const int*>(n_valid);
  const auto* mc = static_cast<const float*>(mcos);
  const auto* ms = static_cast<const float*>(msin);
  const auto* f = static_cast<const float*>(fb);
  auto* x = static_cast<float*>(feats);
  auto* dx = static_cast<float*>(dfeats);
  auto* dfr = static_cast<float*>(dframes);
  const dim3 tiles((T + TT - 1) / TT, B);

  // the forward's masked log-mel (before CMVN), recomputed
  const size_t smem_fwd = (size_t)max(L * TS, TT * F) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      logmel_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_fwd);
  if (err != cudaSuccess) return (int)err;
  logmel_kernel<<<tiles, block_for(F), smem_fwd, s>>>(w, nv, mc, ms, f, x, N, T, L, shift, F,
                                                      M, log_floor, 1);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;

  const int S = slices_for(M);
  cmvn_bwd_kernel<<<B, S * M, S * M * sizeof(float), s>>>(
      x, static_cast<const float*>(g), dx, nv, T, M, S, norm_var, eps);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;

  const size_t smem_bwd =
      (size_t)(max(L, 2 * F) * TS + TT * F + M * TS) * sizeof(float);
  err = cudaFuncSetAttribute(dframes_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem_bwd);
  if (err != cudaSuccess) return (int)err;
  dframes_kernel<<<tiles, block_for(max(L, F)), smem_bwd, s>>>(
      w, mc, ms, f, static_cast<const float*>(mcos_t), static_cast<const float*>(msin_t),
      static_cast<const float*>(fb_t), dx, dfr, N, T, L, shift, F, M, log_floor);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;

  overlap_add_kernel<<<dim3((N + 255) / 256, B), 256, 0, s>>>(dfr, static_cast<float*>(dwav),
                                                              N, T, L, shift);
  return (int)cudaGetLastError();
}
