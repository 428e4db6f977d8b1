// Fused log-mel frontend: framing -> windowed DFT -> power -> mel -> log ->
// masked two-pass utterance CMVN, and its backward to the waveform.
//
// Replaces robust_e2e_gan_tpu/ops/fbank_pallas.py::fbank_fused (forward,
// pallas_call :214, body :97-144) and the backward kernel of
// ::fbank_fused_trainable. DC removal, pre-emphasis and the window are
// folded into the DFT bases on the host (ops/fbank_fused.py::
// combined_bases), as on the TPU. The TPU kernel stacks three row-shifted
// copies of the waveform because Mosaic needs 8-aligned sublane slices;
// here a block reads frame t straight from wav[b, t * shift : t * shift + L].
//
// What bounds it on Hopper: operations. At the decode's shapes (B = 128
// utterances of 111,360 samples, 694 frames each, L = 400, 257 bins, 80
// mels) the DFT alone is ~36 GFLOP against ~85 MB of waveform and
// features: ~0.55 ms at the CUDA cores' float32 rate, ~0.22 ms as three
// tf32 passes at the tensor cores' 495 TFLOP/s, ~25 us of memory traffic.
// The JAX kernel pins its products to Precision.HIGHEST; 3xTF32 keeps
// float32 accuracy (each operand x split into hi = tf32(x) and lo =
// tf32(x - hi), lo hi + hi lo + hi hi summed in float32). As measured
// (PERF.md, row 10; tools/fbank_phases.py; NVIDIA H100 80GB HBM3), route
// "tc" takes ~0.82 ms there, ~85% of a block's cycles in the DFT at ~2.1 k
// cycles a k8 step an SM: mma.sync m16n8k8 tf32 with each step's sums
// added apart reaches ~1.5 k on registers alone (half the tf32 peak),
// ~1.7 k with the B operand's splits; the loads and waits take the rest.
//
// The forward has two routes (ops/fbank_fused.py::fbank_plan picks "tc"
// wherever it fits, every flagship configuration; "simt" runs past it or
// where forced):
//
// "tc", logmel_tc_kernel: the DFT as an implicit GEMM on the tensor cores.
// A block takes (utterance, tile of TM = 64 or 32 frames); a tile wholly
// past the utterance's valid frames writes zeros and skips the DFT, and an
// m16 row tile past them skips its products. The block's waveform span,
// (TM - 1) * shift + L samples, is staged once by cp.async (16-byte pieces,
// or 4-byte ones where N % 4 != 0 or the base is not 16-byte aligned) with
// a 4-float skew every frame shift (sample p at p + 4 * (p / shift)), so
// the 8 frame rows an ldmatrix phase reads start in 8 different bank
// groups (rows 164 floats apart instead of 160), then split once into tf32
// hi and lo spans. Frame r's k-th sample is the A operand's (r, k)
// element; A fragments come by ldmatrix on 32-bit elements. The B operand
// is the band of bins the filterbank touches (1..255 at n_fft = 512),
// cos and sin interleaved bin by bin and padded with zero bins to a
// multiple of 32: each warp owns 32 bins (64 columns, 8 n8 tiles), so a
// C fragment's column pair is one bin's (re, im) and the power forms in
// registers. The host packs the bases in fragment order once per
// configuration and card (ops/fbank_fused.py::pack_bases); each warp
// streams its columns from L2 by cp.async into a ring of its own, 4 k8
// steps in flight, each lane copying and reading only its own 64 bytes a
// step (no block barrier in the loop), loads the next step's pieces under
// this step's products and splits them in registers (host halves would
// double the bases' L2 traffic, ~0.82 MB a block, and the ring's loads,
// and ran slower). Each k8 step's three products are summed apart and
// added to the running sums by a float32 add: the tensor cores' own
// float32 sums round toward zero. Power goes to shared memory, bin by bin;
// each mel filter, a warp's (a lane a frame), sums only its nonzero bins
// in ascending order (bands found on the host), which equals the dense
// ascending chain bit for bit given the same power (fmaf(p, 0, acc) ==
// acc); then the log floor, zeros for frames at or past n_valid.
//
// "simt", logmel_kernel: a block per (utterance, tile of TT frames) copies
// its frames transposed into shared memory; thread f owns DFT bin f (all
// 257) and keeps the TT frames' real and imaginary sums in registers,
// reading the folded bases from L2 two rows ahead, in float32 FMAs; the
// mel is the dense product over every bin.
//
// Blocks run in no order, so CMVN's per-utterance mean and variance are a
// second, small kernel (one block per utterance, column sums in a fixed
// order).
//
// The backward (replaces fbank_pallas.py::_fbank_fused_bwd_impl, body
// _bwd_kernel :228, pallas_call :404) is four launches: the masked log-mel
// recomputed through the forward's route; cmvn_bwd_kernel, the CMVN's
// transpose; the frame pass, which chains log -> mel -> power -> DFT
// transposed and writes each frame's gradient (B, T, L); and
// overlap_add_kernel, a gather (each sample sums the <= 3 frames that cover
// it, in order), so the result is deterministic. The frame pass has two
// routes (ops/fbank_fused.py::fbank_bwd_plan picks "tc" wherever it fits,
// every flagship configuration; "simt" runs past it or where forced):
//
// "tc", dframes_tc_kernel: the recompute on route "tc" also writes each
// valid frame's band spectra (the C fragments, re and im interleaved bin by
// bin: 2 KB a frame) and its mel before the log, so the frame pass
// computes no DFT. A block takes (utterance, tile of 32 frames): dmel =
// dfeats / mel above the log floor; dpower, each bin summing the few
// filters that touch it in ascending order (bands found on the host,
// mel_tbands); A = [dre | dim] = 2 [re | im] dpower, split into tf32 hi/lo
// rows 2 nbins + 4 floats apart (ldmatrix rows conflict-free); then
// dframes (32 x L) = A (32 x 2 nbins) @ B, B the forward's interleaved band
// transposed (2 nbins x L; fb is zero outside the band, so dpower, dre and
// dim are exactly 0 there and the band's product is the full one), in
// 3xTF32 mma.sync m16n8k8 with each k8 step's sums added apart. B is packed
// on the host in fragment order (pack_bases_t) and streamed per warp into
// its own cp.async ring, each lane copying and reading its own 16-byte
// pieces (two tiles' fragments each). The L / 8 = 50 n8 tiles of dframes
// go 7, 7, 6, ... 6 to the 8 warps (the 7-tile warps on two different SM
// sub-partitions: 13 or 12 tiles on each sub-partition's tensor core),
// every warp over both m16 tiles, so each B element read feeds two
// products, each pass over all of a warp's tiles before the next, so a
// tile's three dependent products are far apart. Each lane keeps its 8
// bins' filters and weights in registers, loaded under the copies. As
// measured (PERF.md, row 9; tools/fbank_phases.py; NVIDIA H100 80GB HBM3)
// at the train step's shape: ~0.134 ms, 85% of a block's cycles in the
// products at ~1.09 k cycles a k8 step against a 734-cycle register-only
// ceiling of this mma.sync pattern; 276 live blocks at one an SM take
// three waves. Where a bin's mel sits within float32's error of the log
// floor (clean speech's near-silent frames), which side of the floor it
// falls on decides dmel (0 or dfeats / mel), so there the gradient can
// differ from a float32 chain's by that bin's whole term (PERF.md).
//
// "simt", dframes_kernel: recomputes the spectra tile by tile (float32
// FMAs, no residuals), the dense mel and its transpose, and the transposed
// DFT as float32 FMAs, a thread a frame sample.

#include "common.cuh"

// clock64() marks for robust_e2e_gan_torch/tools/fbank_phases.py, which
// defines them; empty in the library build.
#ifndef FB_PHASE_BEGIN
#define FB_PHASE_BEGIN
#define FB_PHASE(n)
#define FB_PHASE_END
#define FB_CMVN_BEGIN
#define FB_CMVN_END
#endif
#ifndef FB_BWD_BEGIN
#define FB_BWD_BEGIN
#define FB_BWD_PHASE(n)
#define FB_BWD_END
#endif

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
  FB_PHASE_BEGIN
  load_frames(wav + (size_t)b * N, smem, t0, nt, L, shift);
  __syncthreads();
  FB_PHASE(0)
  float re[TT], im[TT];
  if (f < F) dft(smem, mcos, msin, L, F, f, re, im);
  __syncthreads();  // the frames are read: the tile becomes the power
  FB_PHASE(1)
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
  FB_PHASE(2)
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
  FB_PHASE(3)
  FB_PHASE_END
}

// ---------------------------------------------------------------------------
// route "tc": the DFT as an implicit GEMM on the tensor cores, in 3xTF32
// ---------------------------------------------------------------------------

constexpr int TC_WARP_BINS = 32;             // bins a warp owns: 64 columns (re, im)
constexpr int TC_NT = 2 * TC_WARP_BINS / 8;  // its n8 tiles
constexpr int TC_MAX_WARPS = 8;
constexpr int TC_STAGES = 4;                 // k8 steps of the bases in flight a warp
constexpr int TC_STEP = 32 * 2 * TC_NT;      // floats of a warp's bases a k8 step, 16 a lane
constexpr int TC_SKEW = 4;                   // floats inserted every frame shift in the span
constexpr int TC_PPAD = 8;                   // the power tile's bin rows are TM + 8 floats apart

// floats of one staged span of TM frames (hi or lo), a multiple of 4
__host__ __device__ __forceinline__ int tc_span_words(int tm, int L, int shift) {
  const int span = (tm - 1) * shift + L;
  return (span + TC_SKEW * ((span - 1) / shift) + 3) / 4 * 4;
}

// the hi and lo spans, later the (F', TM + 8) power tile
__host__ __device__ __forceinline__ int tc_region(int tm, int L, int shift, int nbins) {
  return max(2 * tc_span_words(tm, L, shift), nbins * (tm + TC_PPAD));
}

// bytes of shared memory of a "tc" block: the region, then the warps'
// rings of bases, later the (TM, M + 1) mel tile (ops/fbank_fused.py::
// tc_smem)
int tc_smem_bytes(int tm, int L, int shift, int nbins, int M) {
  const int ring = nbins / TC_WARP_BINS * TC_STAGES * TC_STEP;
  return 4 * (tc_region(tm, L, shift, nbins) + max(ring, tm * (M + 1)));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(rg::smem_addr(dst)), "l"(src)
               : "memory");
}

// span[p + TC_SKEW * (p / shift)] = src[p] for p < span (src[p] exists for
// p < avail, zeros past it): 16-byte pieces where copy16 (base 16-byte
// aligned, N and shift multiples of 4, so no piece crosses avail or a
// shift), else 4-byte ones
__device__ __forceinline__ void stage_span(float* dst, const float* __restrict__ src, int span,
                                           int avail, int shift, int copy16) {
  if (copy16) {
    for (int p = 4 * threadIdx.x; p < span; p += 4 * blockDim.x) {
      float* d = dst + p + TC_SKEW * (p / shift);
      if (p < avail)
        rg::cp_async16(d, src + p);
      else
        *reinterpret_cast<float4*>(d) = make_float4(0.f, 0.f, 0.f, 0.f);
    }
  } else {
    for (int p = threadIdx.x; p < span; p += blockDim.x) {
      float* d = dst + p + TC_SKEW * (p / shift);
      if (p < avail)
        cp_async4(d, src + p);
      else
        *d = 0.f;
    }
  }
}

// one k8 step of a warp's bases into its ring slot: lane l copies (and
// later reads) the four 16-byte pieces q * 32 + l, its own fragments
__device__ __forceinline__ void copy_step(float* slot, const float4* __restrict__ src, int lane) {
#pragma unroll
  for (int q = 0; q < TC_NT / 2; ++q)
    rg::cp_async16(slot + (q * 32 + lane) * 4, src + q * 32 + lane);
}

// masked log-mel of TM = 16 MT frames per block (route "tc"): out (B, T, M),
// pad frames 0. bases: the packed (L / 8, warps, 4, 32, 4) fragments of the
// interleaved band (ops/fbank_fused.py::pack_bases); bands (3, M): each
// filter's first bin (relative to the band's), its length and the offset of
// its weights in bw. For the backward's frame pass (res not null), each
// valid frame's band spectra go to res (B, T, 2 nbins; re, im interleaved
// bin by bin) and its mel before the log to melr (B, T, M)
template <int MT>
__global__ void __launch_bounds__(TC_MAX_WARPS * 32, 1)
logmel_tc_kernel(const float* __restrict__ wav, const int* __restrict__ n_valid,
                 const float4* __restrict__ bases, const int* __restrict__ bands,
                 const float* __restrict__ bw, float* __restrict__ out, float* __restrict__ res,
                 float* __restrict__ melr, int N, int T, int L, int shift, int M, int nbins,
                 int copy16, float log_floor, int use_power) {
  constexpr int TM = 16 * MT;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int b = blockIdx.y, t0 = blockIdx.x * TM;
  const int nv = min_i(n_valid[b], T);
  const int rows = min_i(TM, T - t0);
  float* outb = out + ((size_t)b * T + t0) * M;
  if (t0 >= nv) {  // wholly past the valid frames: zeros, no DFT
    for (int i = threadIdx.x; i < rows * M; i += blockDim.x) outb[i] = 0.f;
    return;
  }
  FB_PHASE_BEGIN
  const int warps = blockDim.x / 32, warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int sw = tc_span_words(TM, L, shift);
  const int region = tc_region(TM, L, shift, nbins);
  float* a_hi = smem;
  float* a_lo = smem + sw;
  float* ring = smem + region + warp * TC_STAGES * TC_STEP;
  const int steps = L / 8;
  const float4* wb = bases + (size_t)warp * (TC_STEP / 4);
  const size_t step_stride = (size_t)warps * (TC_STEP / 4);

  // the span, then the first TC_STAGES steps of the bases behind it
  stage_span(a_hi, wav + (size_t)b * N + (size_t)t0 * shift, (TM - 1) * shift + L,
             N - t0 * shift, shift, copy16);
  rg::cp_async_commit();
#pragma unroll
  for (int s = 0; s < TC_STAGES; ++s) {
    if (s < steps) copy_step(ring + s * TC_STEP, wb + s * step_stride, lane);
    rg::cp_async_commit();
  }
  rg::cp_async_wait<TC_STAGES>();
  __syncthreads();
  for (int i = threadIdx.x; i < sw; i += blockDim.x) {
    uint32_t h, l;
    rg::split_tf32(a_hi[i], h, l);
    a_hi[i] = __uint_as_float(h);
    a_lo[i] = __uint_as_float(l);
  }
  __syncthreads();
  FB_PHASE(0)

  // the products: re and im of the warp's 32 bins for the tile's frames
  const int live = min_i(MT, (nv - t0 + 15) / 16);  // m16 tiles holding a valid frame
  const int rs = shift + TC_SKEW;                   // frame r's row starts at r * rs
  // ldmatrix rows: lanes 0-15 frames 0-15 of an m16 tile at k, 16-31 at k + 4
  const float* a_row = a_hi + (lane % 16) * rs + (lane / 16) * 4;
  // lane's pieces of step s's bases: (b0, b1) of n8 tiles 2j and 2j + 1 in
  // piece j, where b0 is row (k) t and b1 row t + 4 of column (n) g
  const float4* own = reinterpret_cast<const float4*>(ring) + lane;
  uint32_t bh[TC_NT][2], bl[TC_NT][2];
  float4 v[TC_NT / 2];
  auto split_bases = [&]() {
#pragma unroll
    for (int j = 0; j < TC_NT / 2; ++j) {
      rg::split_tf32(v[j].x, bh[2 * j][0], bl[2 * j][0]);
      rg::split_tf32(v[j].y, bh[2 * j][1], bl[2 * j][1]);
      rg::split_tf32(v[j].z, bh[2 * j + 1][0], bl[2 * j + 1][0]);
      rg::split_tf32(v[j].w, bh[2 * j + 1][1], bl[2 * j + 1][1]);
    }
  };
  rg::cp_async_wait<TC_STAGES - 1>();
#pragma unroll
  for (int j = 0; j < TC_NT / 2; ++j) v[j] = own[j * 32];
  split_bases();
  float acc[MT][TC_NT][4] = {};
  int kpos = 0, k = 0, seg_end = shift;  // span column of k = 8 s: k + TC_SKEW * (k / shift)
  for (int s = 0; s < steps; ++s) {
    // step s + 1's pieces load under step s's products (a stale slot after
    // the last step, unused); step s + TC_STAGES goes into step s's slot,
    // whose pieces this lane alone read, into registers, a step ago
    rg::cp_async_wait<TC_STAGES - 2>();
    const float4* next = own + ((s + 1) % TC_STAGES) * (TC_STEP / 4);
#pragma unroll
    for (int j = 0; j < TC_NT / 2; ++j) v[j] = next[j * 32];
    if (s + TC_STAGES < steps)
      copy_step(ring + (s % TC_STAGES) * TC_STEP, wb + (s + TC_STAGES) * step_stride, lane);
    rg::cp_async_commit();
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      if (mt < live) {
        // ldmatrix on 32-bit elements gives the tf32 fragment (a0: row g,
        // col t; a1: row g + 8; a2, a3: col t + 4)
        uint32_t ah[4], al[4];
        const float* p = a_row + mt * 16 * rs + kpos;
        rg::ldsm_x4(ah, reinterpret_cast<const __nv_bfloat16*>(p));
        rg::ldsm_x4(al, reinterpret_cast<const __nv_bfloat16*>(p + sw));
        // lo hi, hi lo, then hi hi into this k8 step's own sums, added to
        // the running sums by a float32 add (the tensor cores' float32
        // sums round toward zero)
        float d[TC_NT][4] = {};
#pragma unroll
        for (int nt = 0; nt < TC_NT; ++nt) rg::mma1688(d[nt], al, bh[nt][0], bh[nt][1]);
#pragma unroll
        for (int nt = 0; nt < TC_NT; ++nt) rg::mma1688(d[nt], ah, bl[nt][0], bl[nt][1]);
#pragma unroll
        for (int nt = 0; nt < TC_NT; ++nt) rg::mma1688(d[nt], ah, bh[nt][0], bh[nt][1]);
#pragma unroll
        for (int nt = 0; nt < TC_NT; ++nt) {
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[mt][nt][e] += d[nt][e];
        }
      }
    }
    split_bases();
    k += 8;  // shift % 8 == 0: a k8 step never straddles a shift
    if (k == seg_end) seg_end += shift, kpos += TC_SKEW;
    kpos += 8;
  }
  const int g = lane / 4, t = lane % 4;
  if (res) {  // the valid frames' spectra: 8 rows x 32 bytes a store
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = mt * 16 + h * 8 + g;
        if (t0 + r >= nv) continue;
        float2* row = reinterpret_cast<float2*>(res + ((size_t)b * T + t0 + r) * 2 * nbins);
#pragma unroll
        for (int nt = 0; nt < TC_NT; ++nt)
          row[warp * TC_NT * 4 + nt * 4 + t] =
              make_float2(acc[mt][nt][2 * h], acc[mt][nt][2 * h + 1]);
      }
    }
  }
  __syncthreads();  // every warp is done with the spans: they become the power
  FB_PHASE(1)

  // power, bin by bin (c0, c1: frame g's re and im of the tile's bin; c2,
  // c3: frame g + 8's); the rows TM + 8 floats apart, so a warp's stores
  // (8 frames x 4 bins) hit 32 banks
  float* P = smem;
  const int ps = TM + TC_PPAD;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int nt = 0; nt < TC_NT; ++nt) {
      float p0 = acc[mt][nt][0] * acc[mt][nt][0] + acc[mt][nt][1] * acc[mt][nt][1];
      float p1 = acc[mt][nt][2] * acc[mt][nt][2] + acc[mt][nt][3] * acc[mt][nt][3];
      if (!use_power) p0 = sqrtf(fmaxf(p0, 0.f)), p1 = sqrtf(fmaxf(p1, 0.f));
      float* col = P + (warp * TC_WARP_BINS + nt * 4 + t) * ps + mt * 16 + g;
      col[0] = p0;
      col[8] = p1;
    }
  }
  __syncthreads();
  // the mel: a warp a filter (its band in ascending bin order, the same
  // weight for every lane), a lane a frame (and the frame 32 on)
  float* mel = smem + region;  // (TM, M + 1) over the rings, whose copies are all done
  const int mls = M + 1;
  for (int m = warp; m < M; m += warps) {
    const int len = __ldg(bands + M + m);
    const float* pc = P + __ldg(bands + m) * ps + lane;
    const float* w = bw + __ldg(bands + 2 * M + m);
    float sum[TM / 32] = {};
#pragma unroll 4
    for (int j = 0; j < len; ++j) {
      const float wj = __ldg(w + j);
#pragma unroll
      for (int i = 0; i < TM / 32; ++i) sum[i] = fmaf(pc[j * ps + 32 * i], wj, sum[i]);
    }
#pragma unroll
    for (int i = 0; i < TM / 32; ++i) mel[(lane + 32 * i) * mls + m] = sum[i];
  }
  __syncthreads();
  FB_PHASE(2)
  for (int i = threadIdx.x; i < rows * M; i += blockDim.x) {
    const int r = i / M;
    outb[i] = t0 + r < nv ? logf(fmaxf(mel[i + r], log_floor)) : 0.f;
    if (melr && t0 + r < nv) melr[((size_t)b * T + t0) * M + i] = mel[i + r];
  }
  FB_PHASE(3)
  FB_PHASE_END
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
  FB_CMVN_BEGIN
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
  FB_CMVN_END
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

// ---------------------------------------------------------------------------
// the frame pass's route "tc": the transposed DFT as a 3xTF32 implicit GEMM
// ---------------------------------------------------------------------------

constexpr int DT_TM = 32;      // frames a block: two m16 tiles
constexpr int DT_WARPS = 8;
constexpr int DT_NT = 7;       // n8 tiles of the frame's L samples a warp, at most
constexpr int DT_NP = (DT_NT + 1) / 2;  // 16-byte pieces of B a lane a k8 step: two tiles each
constexpr int DT_STAGES = 4;   // k8 steps of B in flight a warp
constexpr int DT_APAD = 4;     // A's rows are 2 nbins + 4 floats apart
constexpr int DT_BINS = 256;   // band bins at most (TC_MAX_WARPS * TC_WARP_BINS)

// bytes of shared memory of a "tc" frame-pass block (ops/fbank_fused.py::
// tc_bwd_smem): A's tf32 hi and lo rows, the mel (later dmel) and dfeats
// tiles (DT_TM, M), the warps' rings of B
int dt_smem_bytes(int nbins, int M) {
  return 4 * (2 * DT_TM * (2 * nbins + DT_APAD) + 2 * DT_TM * M +
              DT_WARPS * DT_STAGES * DT_NP * 128);
}

// dst[i] = src[i] for i < n: 16-byte pieces where both are 16-byte aligned
// and n % 4 == 0, else 4-byte ones
__device__ __forceinline__ void stage_rows(float* dst, const float* __restrict__ src, int n) {
  if (n % 4 == 0 && reinterpret_cast<uintptr_t>(src) % 16 == 0) {
    for (int i = 4 * threadIdx.x; i < n; i += 4 * blockDim.x) rg::cp_async16(dst + i, src + i);
  } else {
    for (int i = threadIdx.x; i < n; i += blockDim.x) cp_async4(dst + i, src + i);
  }
}

// per tile of DT_TM frames, from the recompute's residuals: res (B, T,
// 2 nbins) the band spectra, melr (B, T, M) the mel, both of the valid
// frames; dfeats (B, T, M). bases_t: the packed (2 nbins / 8, pieces, 32)
// 16-byte pieces of the transposed band, warp by warp, each two n8 tiles'
// fragments (b0, b1) (ops/fbank_fused.py::pack_bases_t); tbands (2, nbins)
// and tw (2, nbins): the (at most two) filters each band bin sums, in
// ascending order, and their weights (a zero weight where it sums fewer).
// Writes dframes (B, T, L)
__global__ void __launch_bounds__(DT_WARPS * 32, 1)
dframes_tc_kernel(const float* __restrict__ res, const float* __restrict__ melr,
                  const float* __restrict__ dfeats, const int* __restrict__ n_valid,
                  const float4* __restrict__ bases_t, const int* __restrict__ tbands,
                  const float* __restrict__ tw, float* __restrict__ dframes, int T, int L,
                  int M, int nbins, float log_floor) {
  constexpr int RQ = DT_TM / DT_WARPS;  // frames a warp in the A operand's build
  constexpr int JQ = DT_BINS / 32;      // band bins a lane there
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int b = blockIdx.y, t0 = blockIdx.x * DT_TM;
  const int nv = min_i(n_valid[b], T);
  const int rows = min_i(DT_TM, T - t0);
  float* outb = dframes + ((size_t)b * T + t0) * L;
  if (t0 >= nv) {  // wholly past the valid frames: zeros, no products
    for (int i = threadIdx.x; i < rows * L; i += blockDim.x) outb[i] = 0.f;
    return;
  }
  FB_BWD_BEGIN
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int valid = min_i(rows, nv - t0);
  const int K = 2 * nbins, as = K + DT_APAD;
  float* a_hi = smem;                    // (DT_TM, as)
  float* a_lo = a_hi + DT_TM * as;
  float* dm = a_lo + DT_TM * as;         // (DT_TM, M): the mel, then dmel
  float* df = dm + DT_TM * M;            // (DT_TM, M): dfeats
  float* ring = df + DT_TM * M + warp * DT_STAGES * DT_NP * 128;
  // the warp's n8 tiles of dframes' columns, n0 ... n0 + cnt - 1, in
  // pieces p0 ... p0 + pieces - 1 of the np a step
  const int ntiles = L / 8, base = ntiles / DT_WARPS, extra = ntiles % DT_WARPS;
  const int cnt = base + (warp < extra), n0 = warp * base + min_i(warp, extra);
  const int pieces = (cnt + 1) / 2;
  int p0 = 0, np = 0;
  for (int w = 0; w < DT_WARPS; ++w) {
    const int c = (base + (w < extra) + 1) / 2;
    p0 += w < warp ? c : 0;
    np += c;
  }
  const int steps = K / 8;
  const float4* wb = bases_t + (size_t)p0 * 32 + lane;
  const size_t step_stride = (size_t)np * 32;
  auto copy_step = [&](int slot, int s) {
#pragma unroll
    for (int q = 0; q < DT_NP; ++q)
      if (q < pieces)
        rg::cp_async16(ring + (slot * DT_NP + q) * 128 + 4 * lane, wb + s * step_stride + q * 32);
  };

  // the valid frames' mel and dfeats, then their spectra into A's hi rows
  // (zeros past them), then the first DT_STAGES steps of B behind them
  stage_rows(dm, melr + ((size_t)b * T + t0) * M, valid * M);
  stage_rows(df, dfeats + ((size_t)b * T + t0) * M, valid * M);
  rg::cp_async_commit();
  const float4* src = reinterpret_cast<const float4*>(res + ((size_t)b * T + t0) * K);
  for (int i = threadIdx.x; i < DT_TM * (K / 4); i += blockDim.x) {
    const int r = i / (K / 4), c = i % (K / 4);
    float* d = a_hi + r * as + 4 * c;
    if (r < valid)
      rg::cp_async16(d, src + (size_t)r * (K / 4) + c);
    else
      *reinterpret_cast<float4*>(d) = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  rg::cp_async_commit();
#pragma unroll
  for (int s = 0; s < DT_STAGES; ++s) {
    if (s < steps) copy_step(s, s);
    rg::cp_async_commit();
  }
  // the lane's bins' filters and weights, under the copies
  int f0[JQ], f1[JQ];
  float w0[JQ], w1[JQ];
#pragma unroll
  for (int i = 0; i < JQ; ++i) {
    const int j = min_i(lane + 32 * i, nbins - 1);
    f0[i] = __ldg(tbands + j), f1[i] = __ldg(tbands + nbins + j);
    w0[i] = __ldg(tw + j), w1[i] = __ldg(tw + nbins + j);
  }
  // dmel = dfeats / mel above the log floor, 0 below it and past n_valid
  rg::cp_async_wait<DT_STAGES + 1>();
  __syncthreads();
  for (int i = threadIdx.x; i < DT_TM * M; i += blockDim.x) {
    const float mel = dm[i];
    dm[i] = i < valid * M && mel > log_floor ? df[i] / fmaxf(mel, log_floor) : 0.f;
  }
  rg::cp_async_wait<DT_STAGES>();
  __syncthreads();
  // dpower of bin j (a lane a bin; the warp's RQ frames, warp + 8 q): its
  // filters in ascending order; then A = 2 [re | im] dpower, split
#pragma unroll
  for (int i = 0; i < JQ; ++i) {
    const int j = lane + 32 * i;
    if (j >= nbins) break;
#pragma unroll
    for (int q = 0; q < RQ; ++q) {
      const int r = warp + DT_WARPS * q;
      const float dp = fmaf(dm[r * M + f1[i]], w1[i], fmaf(dm[r * M + f0[i]], w0[i], 0.f));
      float2* hi = reinterpret_cast<float2*>(a_hi + r * as) + j;
      const float2 x = *hi;
      uint32_t h0, l0, h1, l1;
      rg::split_tf32(2.f * x.x * dp, h0, l0);
      rg::split_tf32(2.f * x.y * dp, h1, l1);
      *hi = make_float2(__uint_as_float(h0), __uint_as_float(h1));
      reinterpret_cast<float2*>(a_lo + r * as)[j] =
          make_float2(__uint_as_float(l0), __uint_as_float(l1));
    }
  }
  __syncthreads();
  FB_BWD_PHASE(0)

  // the products: the warp's cnt n8 tiles of both m16 tiles (the second's
  // rows are zeros where the tile holds 16 valid frames or fewer), each
  // pass over all 2 cnt tiles, so a tile's three dependent products are
  // 2 cnt - 1 products apart
  const float* a_row = a_hi + (lane % 16) * as + (lane / 16) * 4;
  const float4* own = reinterpret_cast<const float4*>(ring) + lane;
  // piece q: (b0, b1) of tile 2 q, then of tile 2 q + 1
  uint32_t bh[2 * DT_NP][2], bl[2 * DT_NP][2];
  float4 v[DT_NP];
  auto split_bases = [&]() {
#pragma unroll
    for (int q = 0; q < DT_NP; ++q) {
      rg::split_tf32(v[q].x, bh[2 * q][0], bl[2 * q][0]);
      rg::split_tf32(v[q].y, bh[2 * q][1], bl[2 * q][1]);
      rg::split_tf32(v[q].z, bh[2 * q + 1][0], bl[2 * q + 1][0]);
      rg::split_tf32(v[q].w, bh[2 * q + 1][1], bl[2 * q + 1][1]);
    }
  };
  const float4 zero4 = make_float4(0.f, 0.f, 0.f, 0.f);
  rg::cp_async_wait<DT_STAGES - 1>();
#pragma unroll
  for (int q = 0; q < DT_NP; ++q) v[q] = q < pieces ? own[q * 32] : zero4;
  split_bases();
  float acc[2][DT_NT][4] = {};
  for (int s = 0; s < steps; ++s) {
    // step s + 1's pieces load under step s's products (a stale slot after
    // the last step, unused); step s + DT_STAGES goes into step s's slot,
    // whose pieces this lane alone read, into registers, a step ago
    rg::cp_async_wait<DT_STAGES - 2>();
    const float4* next = own + ((s + 1) % DT_STAGES) * (DT_NP * 32);
#pragma unroll
    for (int q = 0; q < DT_NP; ++q) v[q] = q < pieces ? next[q * 32] : zero4;
    if (s + DT_STAGES < steps) copy_step(s % DT_STAGES, s + DT_STAGES);
    rg::cp_async_commit();
    // ldmatrix on 32-bit elements gives the tf32 fragment (a0: row g, col
    // t; a1: row g + 8; a2, a3: col t + 4)
    uint32_t ah[2][4], al[2][4];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
      const float* p = a_row + mt * 16 * as + 8 * s;
      rg::ldsm_x4(ah[mt], reinterpret_cast<const __nv_bfloat16*>(p));
      rg::ldsm_x4(al[mt], reinterpret_cast<const __nv_bfloat16*>(p + DT_TM * as));
    }
    // lo hi, hi lo, then hi hi into this k8 step's own sums, added to the
    // running sums by a float32 add (the tensor cores' float32 sums round
    // toward zero)
    float d[2][DT_NT][4] = {};
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int i = 0; i < DT_NT; ++i)
        if (i < cnt) rg::mma1688(d[mt][i], al[mt], bh[i][0], bh[i][1]);
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int i = 0; i < DT_NT; ++i)
        if (i < cnt) rg::mma1688(d[mt][i], ah[mt], bl[i][0], bl[i][1]);
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int i = 0; i < DT_NT; ++i)
        if (i < cnt) rg::mma1688(d[mt][i], ah[mt], bh[i][0], bh[i][1]);
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int i = 0; i < DT_NT; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mt][i][e] += d[mt][i][e];
    split_bases();
  }
  FB_BWD_PHASE(1)

  // the store: c0, c1 frame g's samples 2t, 2t + 1 of the tile; c2, c3
  // frame g + 8's (zeros for frames past n_valid: their A rows are zeros)
  const int g = lane / 4, t = lane % 4;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = mt * 16 + h * 8 + g;
      if (r >= rows) continue;
      float2* row = reinterpret_cast<float2*>(outb + (size_t)r * L);
#pragma unroll
      for (int i = 0; i < DT_NT; ++i)
        if (i < cnt)
          row[(n0 + i) * 4 + t] = make_float2(acc[mt][i][2 * h], acc[mt][i][2 * h + 1]);
    }
  }
  FB_BWD_PHASE(2)
  FB_BWD_END
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

// The masked log-mel (B, T, M) before CMVN: route "tc" where tm > 0 (the
// plan of ops/fbank_fused.py::fbank_plan: tm frames a block, nbins padded
// bins, shared bytes), else route "simt"
// (with res and melr: route "tc" only, and the valid frames' spectra and
// mel for the frame pass's route "tc")
cudaError_t logmel(const float* wav, const int* nv, const float* mcos, const float* msin,
                   const float* fb, const float4* bases, const int* bands, const float* bw,
                   float* x, float* res, float* melr, int B, int N, int T, int L, int shift,
                   int F, int M, int tm, int nbins, int copy16, int smem, float log_floor,
                   int use_power, cudaStream_t s) {
  if (tm == 0) {
    if (F > MAX_THREADS || res) return cudaErrorInvalidValue;
    const size_t bytes = (size_t)max(L * TS, TT * F) * sizeof(float);
    const cudaError_t err = rg::reserve_smem<logmel_kernel>(bytes);
    if (err != cudaSuccess) return err;
    logmel_kernel<<<dim3((T + TT - 1) / TT, B), block_for(F), bytes, s>>>(
        wav, nv, mcos, msin, fb, x, N, T, L, shift, F, M, log_floor, use_power);
    return cudaGetLastError();
  }
  const int warps = nbins / TC_WARP_BINS;
  if ((tm != 32 && tm != 64) || nbins % TC_WARP_BINS || warps < 1 || warps > TC_MAX_WARPS ||
      L % 8 || shift % 8 || shift < 8 || smem < tc_smem_bytes(tm, L, shift, nbins, M) ||
      (copy16 && (reinterpret_cast<uintptr_t>(wav) % 16 || N % 4)))
    return cudaErrorInvalidValue;
  const dim3 grid((T + tm - 1) / tm, B);
  cudaError_t err;
  if (tm == 64) {
    if ((err = rg::reserve_smem<logmel_tc_kernel<4>>(smem)) != cudaSuccess) return err;
    logmel_tc_kernel<4><<<grid, warps * 32, smem, s>>>(wav, nv, bases, bands, bw, x, res,
                                                       melr, N, T, L, shift, M, nbins,
                                                       copy16, log_floor, use_power);
  } else {
    if ((err = rg::reserve_smem<logmel_tc_kernel<2>>(smem)) != cudaSuccess) return err;
    logmel_tc_kernel<2><<<grid, warps * 32, smem, s>>>(wav, nv, bases, bands, bw, x, res,
                                                       melr, N, T, L, shift, M, nbins,
                                                       copy16, log_floor, use_power);
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" int fbank_fwd(const void* wav, const void* n_valid, const void* mcos,
                         const void* msin, const void* fb, const void* bases, const void* bands,
                         const void* bw, void* out, int B, int N, int T, int L, int shift, int F,
                         int M, int tm, int nbins, int copy16, int smem, float log_floor,
                         int use_power, int norm_var, float eps, void* stream) {
  if (B < 1 || T < 1 || M > 1024 || L < 1) return (int)cudaErrorInvalidValue;
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* nv = static_cast<const int*>(n_valid);
  auto* x = static_cast<float*>(out);
  cudaError_t err = logmel(
      static_cast<const float*>(wav), nv, static_cast<const float*>(mcos),
      static_cast<const float*>(msin), static_cast<const float*>(fb),
      static_cast<const float4*>(bases), static_cast<const int*>(bands),
      static_cast<const float*>(bw), x, nullptr, nullptr, B, N, T, L, shift, F, M, tm, nbins,
      copy16, smem, log_floor, use_power, s);
  if (err != cudaSuccess) return (int)err;
  const int S = slices_for(M);
  cmvn_kernel<<<B, S * M, S * M * sizeof(float), s>>>(x, nv, T, M, S, norm_var, eps);
  return (int)cudaGetLastError();
}

// The backward: the frame pass on route "tc" where bwd_smem > 0 (the plan
// of ops/fbank_fused.py::fbank_bwd_plan: its shared bytes; the recompute
// must be on route "tc", tm > 0, and write res and melr), else route
// "simt" (dframes_kernel; res, melr, bases_t, tbands and tw unused)
extern "C" int fbank_bwd(const void* wav, const void* n_valid, const void* mcos,
                         const void* msin, const void* fb, const void* bases, const void* bands,
                         const void* bw, const void* mcos_t, const void* msin_t,
                         const void* fb_t, const void* bases_t, const void* tbands,
                         const void* tw, const void* g, void* feats, void* dfeats, void* res,
                         void* melr, void* dframes, void* dwav, int B, int N, int T, int L,
                         int shift, int F, int M, int tm, int nbins, int copy16, int smem,
                         int bwd_smem, float log_floor, int norm_var, float eps, void* stream) {
  const bool tc = bwd_smem > 0;
  if (B < 1 || T < 1 || M > 1024 || L < 1 || (!tc && (F > MAX_THREADS || L > MAX_THREADS)))
    return (int)cudaErrorInvalidValue;
  if (tc && (tm == 0 || L % 8 || (L / 8 + DT_WARPS - 1) / DT_WARPS > DT_NT || nbins % 32 ||
             nbins > DT_BINS ||
             bwd_smem < dt_smem_bytes(nbins, M) || !res || !melr))
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
  auto* r = tc ? static_cast<float*>(res) : nullptr;
  auto* mr = tc ? static_cast<float*>(melr) : nullptr;

  // the forward's masked log-mel (before CMVN), recomputed by its route
  cudaError_t err = logmel(w, nv, mc, ms, f, static_cast<const float4*>(bases),
                           static_cast<const int*>(bands), static_cast<const float*>(bw), x, r,
                           mr, B, N, T, L, shift, F, M, tm, nbins, copy16, smem, log_floor, 1,
                           s);
  if (err != cudaSuccess) return (int)err;

  const int S = slices_for(M);
  cmvn_bwd_kernel<<<B, S * M, S * M * sizeof(float), s>>>(
      x, static_cast<const float*>(g), dx, nv, T, M, S, norm_var, eps);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;

  if (tc) {
    if ((err = rg::reserve_smem<dframes_tc_kernel>(bwd_smem)) != cudaSuccess) return (int)err;
    dframes_tc_kernel<<<dim3((T + DT_TM - 1) / DT_TM, B), DT_WARPS * 32, bwd_smem, s>>>(
        r, mr, dx, nv, static_cast<const float4*>(bases_t), static_cast<const int*>(tbands),
        static_cast<const float*>(tw), dfr, T, L, M, nbins, log_floor);
  } else {
    const size_t smem_bwd = (size_t)(max(L, 2 * F) * TS + TT * F + M * TS) * sizeof(float);
    if ((err = rg::reserve_smem<dframes_kernel>(smem_bwd)) != cudaSuccess) return (int)err;
    dframes_kernel<<<dim3((T + TT - 1) / TT, B), block_for(max(L, F)), smem_bwd, s>>>(
        w, mc, ms, f, static_cast<const float*>(mcos_t), static_cast<const float*>(msin_t),
        static_cast<const float*>(fb_t), dx, dfr, N, T, L, shift, F, M, log_floor);
  }
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;

  overlap_add_kernel<<<dim3((N + 255) / 256, B), 256, 0, s>>>(dfr, static_cast<float*>(dwav),
                                                              N, T, L, shift);
  return (int)cudaGetLastError();
}
