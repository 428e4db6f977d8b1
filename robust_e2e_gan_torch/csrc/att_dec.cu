// The whole beam step of the attention decoder in one launch: location-aware
// attention, the token embedding, the single-layer LSTM cell and the
// vocabulary readout, for every hypothesis.
//
// Replaces robust_e2e_gan_tpu/ops/att_pallas.py::att_dec_step_fused (kernel
// body _kernel_step). For hypothesis (b, k):
//   ctx, att = the attention step of att_body.cuh
//   gates    = (emb[tok] @ Wx[:EMB] + T(ctx) @ Wx[EMB:] + T(z) @ Wh) + bias
//   c'       = sigmoid(f) * c + sigmoid(i) * tanh(g);  z' = sigmoid(o) * tanh(c')
//   logits   = (T(z') @ Wout[:H] + T(ctx) @ Wout[H:]) + bout
// in the order i, f, g, o, with T() the rounding to the compute type (float
// or bfloat16), products of T operands and float32 sums: the TPU kernel's
// rounding points (att_pallas.py:341-388), where the f32 LSTM state is
// rounded for the recurrent product and the readout. The context, gates and
// cell intermediates never touch device memory.
//
// This is route "hyp" of ops/att_dec.py::att_dec_step: csrc/att_dec_utt.cu
// (route "utt") runs every shape its plan fits, and this kernel the others
// (K > 16, C > 32, H not a multiple of 8).
//
// What bounds it on Hopper, as measured (PERF.md, row 5; NVIDIA H100 80GB
// HBM3): 0.464 ms a launch at the flagship's decode shapes (B = 128, K = 8,
// T = 174, A = E = EMB = H = 256, V = 52, bfloat16), 0.556 ms at the decode
// CLI's float32 model (A = E = EMB = H = 512, V = 12, T = 30), against
// ~0.08 ms for the attention alone. A block runs its K hypotheses'
// attention one after another, each re-reading enc_proj and enc and
// running the location projection on the CUDA cores, and then every one
// of the B blocks reads all of Wx and Wh from L2 (1.5 MB in bfloat16 at
// the flagship, 12.6 MB in the CLI's float32) for its K lanes, one FMA per
// weight and lane.
//
// Design: a block owns one utterance's K lanes, as the TPU kernel batches
// over BB*K lanes, so each weight row it reads serves all of them. It runs
// the attention body for its K hypotheses in turn (the contexts stay in
// shared memory), then the cell as lm_step.cu does: KS threads per hidden
// unit u (KS * H <= 1024), thread (q, u) accumulating the four gate columns
// of 8 lanes over its slice q of the [emb | ctx] and recurrent rows, the
// q = 0 threads adding the other slices' partial sums in a fixed order and
// applying the cell. The embedding is a row gather: the TPU's one-hot
// product exists only because Mosaic has no gather. The readout gives one
// (lane, token) to a thread.

#include "att_body.cuh"

namespace {

constexpr int ROWS = 8;  // lanes per pass of the cell

__host__ __device__ inline int threads_per_unit(int H) { return max(1, min(4, 1024 / H)); }

template <typename T>
__global__ void __launch_bounds__(1024)
att_dec_kernel(const T* __restrict__ feat,      // (B, K, Tn, C)
               const T* __restrict__ enc_proj,  // (B, Tn, A)
               const T* __restrict__ enc,       // (B, Tn, E)
               const T* __restrict__ dec,       // (B, K, A)
               const T* __restrict__ wloc,      // (C, A)
               const T* __restrict__ g,         // (A,)
               const float* __restrict__ mask,  // (B, Tn)
               const int* __restrict__ tok,     // (B, K)
               const T* __restrict__ emb,       // (V, EMB)
               const T* __restrict__ wx,        // (EMB + E, 4H)
               const T* __restrict__ wh,        // (H, 4H)
               const float* __restrict__ bias,  // (4H,)
               const T* __restrict__ wout,      // (H + E, V)
               const float* __restrict__ bout,  // (V,)
               const float* __restrict__ z_in,  // (B, K, H)
               const float* __restrict__ c_in,  // (B, K, H)
               float* __restrict__ logits,      // (B, K, V)
               float* __restrict__ att,         // (B, K, Tn)
               float* __restrict__ z_out,       // (B, K, H)
               float* __restrict__ c_out,       // (B, K, H)
               int K, int Tn, int C, int A, int E, int V, int EMB, int H,
               float sharpening) {
  extern __shared__ float smem[];
  const int D = EMB + E;  // the cell's input row: [embedding | context]
  const int G = 4 * H;
  const int KS = threads_per_unit(H);
  float* w_s = smem;                                 // C * A
  float* g_s = w_s + C * A;                          // A
  float* d_s = g_s + A;                              // A
  float* e_s = d_s + A;                              // Tn
  float* f_s = e_s + Tn;                             // warps * kAttMaxC
  float* red = f_s + blockDim.x / 32 * rg::kAttMaxC; // 32
  float* x_s = red + 32;                             // K * D
  float* z_s = x_s + (size_t)K * D;                  // K * H: T(z), then T(z')
  float* part_s = z_s + (size_t)K * H;               // (KS - 1) * ROWS * 4 * H
  const int b = blockIdx.x;

  rg::att_load_weights(wloc, g, C, A, w_s, g_s);
  for (int i = threadIdx.x; i < K * EMB; i += blockDim.x) {
    const int r = i / EMB, j = i % EMB;
    const int t = min(max(tok[b * K + r], 0), V - 1);
    x_s[r * D + j] = rg::to_f(emb[(size_t)t * EMB + j]);
  }
  for (int i = threadIdx.x; i < K * H; i += blockDim.x)
    z_s[i] = rg::rnd<T>(z_in[(size_t)b * K * H + i]);
  // (the body's first barrier publishes these loads)

  // ---- attention, one hypothesis after another; contexts into x_s
  const rg::AttScratch s{w_s, g_s, d_s, e_s, f_s, red};
  for (int k = 0; k < K; ++k) {
    const size_t bk = (size_t)b * K + k;
    rg::att_loc_body<T>(feat + bk * Tn * C, enc_proj + (size_t)b * Tn * A,
                        enc + (size_t)b * Tn * E, dec + bk * A, mask + (size_t)b * Tn, Tn, C,
                        A, E, sharpening, s, att + bk * Tn, x_s + (size_t)k * D + EMB);
  }
  for (int i = threadIdx.x; i < K * E; i += blockDim.x) {
    float* p = x_s + (size_t)(i / E) * D + EMB + i % E;
    *p = rg::rnd<T>(*p);
  }
  __syncthreads();

  // ---- the LSTM cell, ROWS lanes per pass
  const int u = threadIdx.x % H, q = threadIdx.x / H;  // q >= KS: idle here
  for (int r0 = 0; r0 < K; r0 += ROWS) {
    const int rows = min(ROWS, K - r0);
    float acc[ROWS][4];
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
#pragma unroll
      for (int gt = 0; gt < 4; ++gt) acc[r][gt] = 0.f;
    }
    if (q < KS) {
      const int kx = (D + KS - 1) / KS;
      for (int j = q * kx; j < min(D, (q + 1) * kx); ++j) {
        const T* wj = wx + (size_t)j * G + u;
        const float w0 = rg::to_f(wj[0]), w1 = rg::to_f(wj[H]);
        const float w2 = rg::to_f(wj[2 * H]), w3 = rg::to_f(wj[3 * H]);
#pragma unroll
        for (int r = 0; r < ROWS; ++r) {
          const float xj = r < rows ? x_s[(size_t)(r0 + r) * D + j] : 0.f;
          acc[r][0] = fmaf(xj, w0, acc[r][0]);
          acc[r][1] = fmaf(xj, w1, acc[r][1]);
          acc[r][2] = fmaf(xj, w2, acc[r][2]);
          acc[r][3] = fmaf(xj, w3, acc[r][3]);
        }
      }
      const int kh = (H + KS - 1) / KS;
      for (int j = q * kh; j < min(H, (q + 1) * kh); ++j) {
        const T* wj = wh + (size_t)j * G + u;
        const float w0 = rg::to_f(wj[0]), w1 = rg::to_f(wj[H]);
        const float w2 = rg::to_f(wj[2 * H]), w3 = rg::to_f(wj[3 * H]);
#pragma unroll
        for (int r = 0; r < ROWS; ++r) {
          const float zj = r < rows ? z_s[(r0 + r) * H + j] : 0.f;
          acc[r][0] = fmaf(zj, w0, acc[r][0]);
          acc[r][1] = fmaf(zj, w1, acc[r][1]);
          acc[r][2] = fmaf(zj, w2, acc[r][2]);
          acc[r][3] = fmaf(zj, w3, acc[r][3]);
        }
      }
      if (q > 0) {
#pragma unroll
        for (int r = 0; r < ROWS; ++r) {
#pragma unroll
          for (int gt = 0; gt < 4; ++gt)
            part_s[(((q - 1) * ROWS + r) * 4 + gt) * H + u] = acc[r][gt];
        }
      }
    }
    __syncthreads();  // partial sums are in; this pass's z_s rows are read
    if (q == 0) {
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        if (r >= rows) continue;
        for (int p = 0; p < KS - 1; ++p) {
#pragma unroll
          for (int gt = 0; gt < 4; ++gt) acc[r][gt] += part_s[((p * ROWS + r) * 4 + gt) * H + u];
        }
        const size_t o = ((size_t)b * K + r0 + r) * H + u;
        const float gi = acc[r][0] + bias[u];
        const float gf = acc[r][1] + bias[H + u];
        const float gg = acc[r][2] + bias[2 * H + u];
        const float go = acc[r][3] + bias[3 * H + u];
        const float cn = rg::sigmoid(gf) * c_in[o] + rg::sigmoid(gi) * tanhf(gg);
        const float zn = rg::sigmoid(go) * tanhf(cn);
        z_out[o] = zn;
        c_out[o] = cn;
        z_s[(r0 + r) * H + u] = rg::rnd<T>(zn);  // the readout's input
      }
    }
    __syncthreads();  // part_s is free; the pass's z' rows are complete
  }

  // ---- readout: one (lane, token) per thread
  for (int i = threadIdx.x; i < K * V; i += blockDim.x) {
    const int r = i / V, v = i % V;
    float az = 0.f, ac = 0.f;
    for (int j = 0; j < H; ++j) az = fmaf(z_s[r * H + j], rg::to_f(wout[(size_t)j * V + v]), az);
    const float* ctx = x_s + (size_t)r * D + EMB;
    for (int j = 0; j < E; ++j) ac = fmaf(ctx[j], rg::to_f(wout[(size_t)(H + j) * V + v]), ac);
    logits[((size_t)b * K + r) * V + v] = (az + ac) + bout[v];
  }
}

int block_threads(int H) { return ((threads_per_unit(H) * H + 31) / 32) * 32; }

size_t smem_bytes(int K, int Tn, int C, int A, int E, int EMB, int H) {
  const int warps = block_threads(H) / 32;
  return ((size_t)C * A + 2 * (size_t)A + Tn + (size_t)warps * rg::kAttMaxC + 32 +
          (size_t)K * (EMB + E) + (size_t)K * H +
          (size_t)(threads_per_unit(H) - 1) * ROWS * 4 * H) *
         sizeof(float);
}

template <typename T>
cudaError_t launch(const void* const* p, float* logits, float* att, float* z_out,
                   float* c_out, int B, int K, int Tn, int C, int A, int E, int V, int EMB,
                   int H, float sharpening, cudaStream_t stream) {
  const size_t smem = smem_bytes(K, Tn, C, A, E, EMB, H);
  const cudaError_t err = rg::reserve_smem<att_dec_kernel<T>>(smem);
  if (err != cudaSuccess) return err;
  att_dec_kernel<T><<<B, block_threads(H), smem, stream>>>(
      static_cast<const T*>(p[0]), static_cast<const T*>(p[1]), static_cast<const T*>(p[2]),
      static_cast<const T*>(p[3]), static_cast<const T*>(p[4]), static_cast<const T*>(p[5]),
      static_cast<const float*>(p[6]), static_cast<const int*>(p[7]),
      static_cast<const T*>(p[8]), static_cast<const T*>(p[9]), static_cast<const T*>(p[10]),
      static_cast<const float*>(p[11]), static_cast<const T*>(p[12]),
      static_cast<const float*>(p[13]), static_cast<const float*>(p[14]),
      static_cast<const float*>(p[15]), logits, att, z_out, c_out, K, Tn, C, A, E, V, EMB, H,
      sharpening);
  return cudaGetLastError();
}

}  // namespace

extern "C" int att_dec_step(const void* feat, const void* enc_proj, const void* enc,
                            const void* dec, const void* wloc, const void* g,
                            const void* mask, const void* tok, const void* emb,
                            const void* wx, const void* wh, const void* bias,
                            const void* wout, const void* bout, const void* z_in,
                            const void* c_in, void* logits, void* att, void* z_out,
                            void* c_out, int B, int K, int Tn, int C, int A, int E, int V,
                            int EMB, int H, float sharpening, int bf16, void* stream) {
  if (B < 1 || K < 1 || Tn < 1 || C < 1 || C > rg::kAttMaxC || A < 1 || E < 1 || V < 1 ||
      EMB < 1 || H < 1 || H > 1024)
    return (int)cudaErrorInvalidValue;
  const void* in[] = {feat, enc_proj, enc, dec, wloc, g, mask, tok,
                      emb, wx, wh, bias, wout, bout, z_in, c_in};
  const auto s = static_cast<cudaStream_t>(stream);
  auto* lg = static_cast<float*>(logits);
  auto* at = static_cast<float*>(att);
  auto* zo = static_cast<float*>(z_out);
  auto* co = static_cast<float*>(c_out);
  if (bf16)
    return (int)launch<__nv_bfloat16>(in, lg, at, zo, co, B, K, Tn, C, A, E, V, EMB, H,
                                      sharpening, s);
  return (int)launch<float>(in, lg, at, zo, co, B, K, Tn, C, A, E, V, EMB, H, sharpening, s);
}
