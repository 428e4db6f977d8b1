// Masked bidirectional LSTM recurrence for inference: the "row_tiled" route
// of ops/blstm.py::blstm_recurrence.
//
// Replaces robust_e2e_gan_tpu/ops/blstm_pallas.py::blstm_infer, in the form
// of its gate-stream variant (_gx_kernel, pallas_call :455), the one the
// JAX package takes for layers too large for its W_x-resident variant,
// where ops/blstm.py::gx_plan does not fit the "grid" route
// (csrc/blstm_gx_grid.cu: H not a multiple of 32, or too many rows for its
// warps' tiles, e.g. B > 128 at H = 1,024), and under a forced route for
// timing. The input projection
// x @ W_x + bias of both directions is one matrix product outside the
// kernel, and the kernel owns the serial frame loop
//   gates = gx_t + h_{t-1} @ W_h  ->  i, f, g, o  ->  c_t, h_t.
//
// What bounds it on Hopper: the latency of the serial chain of T frames.
// Each frame needs the whole W_h of its direction (H x 4H; 0.5 MB in bf16
// at H=256), far more than one SM's shared memory, and every frame depends
// on the one before, so no block can run ahead.
//
// Design: grid (2 directions, ceil(B / ROWS) row tiles); rows are
// independent, so no block waits for another. A block has KS threads per
// hidden unit u (KS * H <= 1024). Thread (q, u) accumulates the four gate
// columns u, H+u, 2H+u, 3H+u of ROWS rows over its slice q of the H inputs,
// reading W_h from global memory each frame (it stays in the 50 MB L2) and
// h_{t-1} from shared memory; splitting the inputs KS ways shortens each
// thread's chain of dependent L2 reads and puts KS times more warps in
// flight to hide their latency. The q = 0 threads add the other slices'
// partial sums from shared memory, apply the gates, keep c in registers
// and publish h_t. ROWS trades L2 traffic (one W_h read per block per
// frame) against blocks in flight: on an H100 at H=256, two rows per block
// measured fastest (one row compiles to a slower loop; eight spill), so the
// wrapper takes 2, or 4 when 2 would need more blocks than SMs. The
// backward direction walks t = len-1 ... 0 directly, so no flipped copy of
// the input is made; frames at or past a row's length are written as exact
// zeros and leave the state alone. The recurrent product reads h_{t-1}
// rounded to the compute type, as the TPU kernel's h_prev.astype(cdtype);
// the output is h_t, written in the compute type. The W_x-resident variant
// of the same TPU function is csrc/blstm_infer.cu. The "grid" route splits
// W_h by gate columns over a co-resident grid instead, so that each
// element is read once a frame, and runs the product on the tensor cores.

#include "common.cuh"

namespace {

template <typename W, int ROWS>
__global__ void __launch_bounds__(1024)
blstm_rec_kernel(const float* __restrict__ gx,      // (B, T, 2, 4H)
                 const W* __restrict__ wh,          // (2, H, 4H)
                 const int* __restrict__ lengths,   // (B,)
                 W* __restrict__ out,               // (B, T, 2H)
                 int B, int T, int H, int KS) {
  extern __shared__ float smem[];
  float* h_s = smem;              // (ROWS, H): h_{t-1} rounded to W
  float* part_s = smem + ROWS * H;  // (KS-1, ROWS, 4, H): partial gate sums
  const int z = blockIdx.x;
  const int row0 = blockIdx.y * ROWS;
  const int u = threadIdx.x % H;
  const int q = threadIdx.x / H;
  const int G = 4 * H;
  const int kc = (H + KS - 1) / KS;
  const int k0 = q * kc, k1 = min(H, k0 + kc);
  const W* w = wh + (size_t)z * H * G + u;

  float c[ROWS];
  int len[ROWS];
  int steps = 0;
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    const int b = row0 + r;
    const int l = b < B ? min(max(lengths[b], 0), T) : 0;
    len[r] = l;
    c[r] = 0.f;
    if (q == 0) h_s[r * H + u] = 0.f;
    steps = max(steps, l);
  }
  __syncthreads();

  for (int s = 0; s < steps; ++s) {
    float acc[ROWS][4];
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
#pragma unroll
      for (int g = 0; g < 4; ++g) acc[r][g] = 0.f;
    }
#pragma unroll 8
    for (int k = k0; k < k1; ++k) {
      const W* wk = w + (size_t)k * G;
      const float w0 = rg::to_f(wk[0]);
      const float w1 = rg::to_f(wk[H]);
      const float w2 = rg::to_f(wk[2 * H]);
      const float w3 = rg::to_f(wk[3 * H]);
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        const float hk = h_s[r * H + k];
        acc[r][0] = fmaf(hk, w0, acc[r][0]);
        acc[r][1] = fmaf(hk, w1, acc[r][1]);
        acc[r][2] = fmaf(hk, w2, acc[r][2]);
        acc[r][3] = fmaf(hk, w3, acc[r][3]);
      }
    }
    if (q > 0) {
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
#pragma unroll
        for (int g = 0; g < 4; ++g)
          part_s[(((q - 1) * ROWS + r) * 4 + g) * H + u] = acc[r][g];
      }
    }
    __syncthreads();  // every thread has read h_{t-1}; partial sums are in
    if (q == 0) {
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        if (s >= len[r]) continue;
        for (int p = 0; p < KS - 1; ++p) {
#pragma unroll
          for (int g = 0; g < 4; ++g) acc[r][g] += part_s[((p * ROWS + r) * 4 + g) * H + u];
        }
        const int b = row0 + r;
        const int t = z == 0 ? s : len[r] - 1 - s;
        const float* gt = gx + (((size_t)b * T + t) * 2 + z) * G + u;
        const float gi = gt[0] + acc[r][0];
        const float gf = gt[H] + acc[r][1];
        const float gg = gt[2 * H] + acc[r][2];
        const float go = gt[3 * H] + acc[r][3];
        const float cn = rg::sigmoid(gf) * c[r] + rg::sigmoid(gi) * tanhf(gg);
        const float hn = rg::sigmoid(go) * tanhf(cn);
        c[r] = cn;
        h_s[r * H + u] = rg::rnd<W>(hn);
        out[((size_t)b * T + t) * 2 * H + z * H + u] = rg::from_f<W>(hn);
      }
    }
    __syncthreads();  // h_t is complete before the next frame reads it
  }

  // pad frames of this direction: exact zeros, written by all KS slices
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    const int b = row0 + r;
    if (b >= B) continue;
    for (int t = len[r] + q; t < T; t += KS)
      out[((size_t)b * T + t) * 2 * H + z * H + u] = rg::from_f<W>(0.f);
  }
}

template <typename W, int ROWS>
cudaError_t launch_kernel(const float* gx, const W* wh, const int* lengths, W* out,
                          int B, int T, int H, cudaStream_t stream) {
  const int ks = max(1, min(4, 1024 / H));
  const dim3 grid(2, (B + ROWS - 1) / ROWS);
  const size_t smem = (size_t)(ROWS * H + (ks - 1) * ROWS * 4 * H) * sizeof(float);
  const cudaError_t err = cudaFuncSetAttribute(
      blstm_rec_kernel<W, ROWS>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  blstm_rec_kernel<W, ROWS><<<grid, ks * H, smem, stream>>>(gx, wh, lengths, out, B, T,
                                                            H, ks);
  return cudaGetLastError();
}

template <typename W>
cudaError_t launch_rows(const float* gx, const W* wh, const int* lengths, W* out,
                        int B, int T, int H, int rows, cudaStream_t stream) {
  switch (rows) {
    case 2: return launch_kernel<W, 2>(gx, wh, lengths, out, B, T, H, stream);
    case 4: return launch_kernel<W, 4>(gx, wh, lengths, out, B, T, H, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" int blstm_recurrence(const void* gx, const void* wh, const void* lengths,
                                void* out, int B, int T, int H, int rows, int bf16,
                                void* stream) {
  if (H < 1 || H > 1024 || B < 1 || T < 1) return (int)cudaErrorInvalidValue;
  const auto s = static_cast<cudaStream_t>(stream);
  if (bf16)
    return (int)launch_rows(static_cast<const float*>(gx),
                            static_cast<const __nv_bfloat16*>(wh),
                            static_cast<const int*>(lengths),
                            static_cast<__nv_bfloat16*>(out), B, T, H, rows, s);
  return (int)launch_rows(static_cast<const float*>(gx), static_cast<const float*>(wh),
                          static_cast<const int*>(lengths), static_cast<float*>(out),
                          B, T, H, rows, s);
}
