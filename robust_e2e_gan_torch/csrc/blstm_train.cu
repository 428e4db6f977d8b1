// Masked bidirectional LSTM frame loops for training: a forward that
// streams out the backward's residuals, and the adjoint frame loop.
//
// Replaces the recurrences of robust_e2e_gan_tpu/ops/blstm_train_pallas.py
// (blstm_train :624, _fwd_kernel/_bwd_kernel, and blstm_train_gx :1050,
// _fwd_gx_kernel/_bwd_gx_kernel). The products the TPU kernels compute in
// their bodies off the serial path (input projections, dx, dW_x, dW_h,
// dbias) are csrc/gemm.cu here; these kernels own the serial chains.
//
// What bounds them on Hopper: the latency of the chain of T dependent
// frames, each needing all of W_h (H x 4H per direction) -- and in the
// backward also W_h^T -- far more than one SM's shared memory.
//
// These loops run the layers past ops/blstm_train.py::resident_plan; the
// others take csrc/blstm_train_resident.cu, W_h resident in shared memory.
//
// Design: the inference loop of csrc/blstm.cu: grid (2 directions,
// ceil(B / ROWS) row tiles), KS threads per hidden unit splitting the
// reduction, W_h read from L2 every frame, h_{t-1} in shared memory.
//
// Forward: as the inference loop, but the h that feeds the recurrent
// product is rounded to the compute type (as the JAX kernel's
// h_prev.astype(cdtype)), and besides the (B, T, 2H) output it writes
//   y_ext[z, b, r, :] = h * m   (compute type)
//   c_ext[z, b, r, :] = c * m   (float32)
// with frame t at row r = t + 1 for the forward direction (row 0 zero) and
// r = t for the backward direction (row T zero). Every mask is a length
// mask, so the carries entering a valid frame are exactly the stored row
// on the side the recurrence came from.
//
// Backward: one walk over the processing steps in descending order. Per
// step the block loads h_{t-1} from y_ext, recomputes the gate
// pre-activations gx + h_{t-1} W_h with the forward's split sums, applies
// the adjoint gate math of blstm_train_pallas.py:318-344 (dgates written in
// float32), and carries dh = dgates W_h^T (dgates rounded to the compute
// type, W_h^T read transposed so neighbouring threads read neighbouring
// addresses) and dc = f * dc_new. Pad frames get zero dgates.

#include "common.cuh"

namespace {

template <typename W, int ROWS>
__global__ void __launch_bounds__(1024)
fwd_kernel(const float* __restrict__ gx,     // (B, T, 2, 4H)
           const W* __restrict__ wh,         // (2, H, 4H)
           const int* __restrict__ lengths,  // (B,)
           W* __restrict__ out,              // (B, T, 2H)
           W* __restrict__ y_ext,            // (2, B, T+1, H)
           float* __restrict__ c_ext,        // (2, B, T+1, H)
           int B, int T, int H, int KS) {
  extern __shared__ float smem[];
  float* h_s = smem;                // (ROWS, H): rounded h_{t-1}
  float* part_s = smem + ROWS * H;  // (KS-1, ROWS, 4, H)
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
    __syncthreads();
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
        const size_t row = (((size_t)z * B + b) * (T + 1) + t + 1 - z) * H + u;
        y_ext[row] = rg::from_f<W>(hn);
        c_ext[row] = cn;
      }
    }
    __syncthreads();
  }

  // pad frames: zero outputs; every residual row no valid frame wrote
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    const int b = row0 + r;
    if (b >= B) continue;
    for (int t = len[r] + q; t < T; t += KS)
      out[((size_t)b * T + t) * 2 * H + z * H + u] = rg::from_f<W>(0.f);
    for (int i = q; i <= T; i += KS) {
      const bool valid = z == 0 ? (i >= 1 && i <= len[r]) : (i < len[r]);
      if (valid) continue;
      const size_t row = (((size_t)z * B + b) * (T + 1) + i) * H + u;
      y_ext[row] = rg::from_f<W>(0.f);
      c_ext[row] = 0.f;
    }
  }
}

template <typename W, int ROWS>
__global__ void __launch_bounds__(1024)
bwd_kernel(const float* __restrict__ gx,      // (B, T, 2, 4H)
           const W* __restrict__ wh,          // (2, H, 4H)
           const W* __restrict__ wh_t,        // (2, 4H, H)
           const int* __restrict__ lengths,   // (B,)
           const W* __restrict__ y_ext,       // (2, B, T+1, H)
           const float* __restrict__ c_ext,   // (2, B, T+1, H)
           const W* __restrict__ dy,          // (B, T, 2H)
           float* __restrict__ dgates,        // (B, T, 2, 4H)
           int B, int T, int H, int KS) {
  extern __shared__ float smem[];
  const int G = 4 * H;
  float* h_s = smem;                 // (ROWS, H): h_{t-1}
  float* dg_s = h_s + ROWS * H;      // (ROWS, 4H): rounded dgates
  float* part_s = dg_s + ROWS * G;   // (KS-1, ROWS, 4, H) partial sums
  const int z = blockIdx.x;
  const int row0 = blockIdx.y * ROWS;
  const int u = threadIdx.x % H;
  const int q = threadIdx.x / H;
  const int kc = (H + KS - 1) / KS;
  const int k0 = q * kc, k1 = min(H, k0 + kc);
  const int jc = (G + KS - 1) / KS;
  const int j0 = q * jc, j1 = min(G, j0 + jc);
  const W* w = wh + (size_t)z * H * G + u;
  const W* wt = wh_t + (size_t)z * G * H + u;
  const size_t zb = (size_t)z * B;

  float dh[ROWS], dc[ROWS];
  int len[ROWS];
  int steps = 0;
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    const int b = row0 + r;
    len[r] = b < B ? min(max(lengths[b], 0), T) : 0;
    dh[r] = 0.f;
    dc[r] = 0.f;
    steps = max(steps, len[r]);
  }

  for (int s = steps - 1; s >= 0; --s) {
    // h_{t-1} of each row: y_ext row t (forward) or t + 1 (backward)
    for (int i = threadIdx.x; i < ROWS * H; i += blockDim.x) {
      const int r = i / H, k = i % H;
      float v = 0.f;
      if (s < len[r]) {
        const int b = row0 + r;
        const int t = z == 0 ? s : len[r] - 1 - s;
        v = rg::to_f(y_ext[((zb + b) * (T + 1) + t + z) * H + k]);
      }
      h_s[i] = v;
    }
    __syncthreads();

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
    __syncthreads();
    float gf_keep[ROWS];
    if (q == 0) {
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        gf_keep[r] = 0.f;
        if (s >= len[r]) {
#pragma unroll
          for (int g = 0; g < 4; ++g) dg_s[r * G + g * H + u] = 0.f;
          continue;
        }
        for (int p = 0; p < KS - 1; ++p) {
#pragma unroll
          for (int g = 0; g < 4; ++g) acc[r][g] += part_s[((p * ROWS + r) * 4 + g) * H + u];
        }
        const int b = row0 + r;
        const int t = z == 0 ? s : len[r] - 1 - s;
        const float* gt = gx + (((size_t)b * T + t) * 2 + z) * G + u;
        const float gi = rg::sigmoid(gt[0] + acc[r][0]);
        const float gf = rg::sigmoid(gt[H] + acc[r][1]);
        const float gg = tanhf(gt[2 * H] + acc[r][2]);
        const float go = rg::sigmoid(gt[3 * H] + acc[r][3]);
        const size_t crow = ((zb + b) * (T + 1) + t) * H + u;
        const float c_prev = c_ext[crow + (size_t)z * H];        // row t + z
        const float tanh_c = tanhf(c_ext[crow + (size_t)(1 - z) * H]);  // t+1-z
        const float dh_out = rg::to_f(dy[((size_t)b * T + t) * 2 * H + z * H + u]) + dh[r];
        const float dc_new = dc[r] + dh_out * go * (1.f - tanh_c * tanh_c);
        const float di = dc_new * gg * (gi * (1.f - gi));
        const float df = dc_new * c_prev * (gf * (1.f - gf));
        const float dg = dc_new * gi * (1.f - gg * gg);
        const float d_o = dh_out * tanh_c * (go * (1.f - go));
        float* dgt = dgates + (((size_t)b * T + t) * 2 + z) * G + u;
        dgt[0] = di;
        dgt[H] = df;
        dgt[2 * H] = dg;
        dgt[3 * H] = d_o;
        dg_s[r * G + u] = rg::rnd<W>(di);
        dg_s[r * G + H + u] = rg::rnd<W>(df);
        dg_s[r * G + 2 * H + u] = rg::rnd<W>(dg);
        dg_s[r * G + 3 * H + u] = rg::rnd<W>(d_o);
        gf_keep[r] = gf * dc_new;  // dc carried to the step before
      }
    }
    __syncthreads();  // dg_s complete; part_s free

    // dh_{t-1}[u] = sum_j dgates[j] W_h[u, j], over this thread's j slice
    float racc[ROWS];
#pragma unroll
    for (int r = 0; r < ROWS; ++r) racc[r] = 0.f;
#pragma unroll 8
    for (int j = j0; j < j1; ++j) {
      const float wj = rg::to_f(wt[(size_t)j * H]);
#pragma unroll
      for (int r = 0; r < ROWS; ++r) racc[r] = fmaf(dg_s[r * G + j], wj, racc[r]);
    }
    if (q > 0) {
#pragma unroll
      for (int r = 0; r < ROWS; ++r) part_s[((q - 1) * ROWS + r) * H + u] = racc[r];
    }
    __syncthreads();
    if (q == 0) {
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        if (s >= len[r]) continue;
        for (int p = 0; p < KS - 1; ++p) racc[r] += part_s[(p * ROWS + r) * H + u];
        dh[r] = racc[r];
        dc[r] = gf_keep[r];
      }
    }
    __syncthreads();
  }

  // pad frames: zero dgates
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    const int b = row0 + r;
    if (b >= B) continue;
    for (int t = len[r] + q; t < T; t += KS) {
      float* dgt = dgates + (((size_t)b * T + t) * 2 + z) * G + u;
#pragma unroll
      for (int g = 0; g < 4; ++g) dgt[g * H] = 0.f;
    }
  }
}

int split_ways(int H) { return max(1, min(4, 1024 / H)); }

template <typename W, int ROWS>
cudaError_t launch_fwd(const float* gx, const W* wh, const int* lengths, W* out, W* y_ext,
                       float* c_ext, int B, int T, int H, cudaStream_t stream) {
  const int ks = split_ways(H);
  const dim3 grid(2, (B + ROWS - 1) / ROWS);
  const size_t smem = (size_t)(ROWS * H + (ks - 1) * ROWS * 4 * H) * sizeof(float);
  const cudaError_t err = rg::reserve_smem<fwd_kernel<W, ROWS>>(smem);
  if (err != cudaSuccess) return err;
  fwd_kernel<W, ROWS><<<grid, ks * H, smem, stream>>>(gx, wh, lengths, out, y_ext, c_ext, B,
                                                      T, H, ks);
  return cudaGetLastError();
}

template <typename W, int ROWS>
cudaError_t launch_bwd(const float* gx, const W* wh, const W* wh_t, const int* lengths,
                       const W* y_ext, const float* c_ext, const W* dy, float* dgates, int B,
                       int T, int H, cudaStream_t stream) {
  const int ks = split_ways(H);
  const dim3 grid(2, (B + ROWS - 1) / ROWS);
  const size_t smem =
      (size_t)(ROWS * H + ROWS * 4 * H + (ks - 1) * ROWS * 4 * H) * sizeof(float);
  const cudaError_t err = rg::reserve_smem<bwd_kernel<W, ROWS>>(smem);
  if (err != cudaSuccess) return err;
  bwd_kernel<W, ROWS><<<grid, ks * H, smem, stream>>>(gx, wh, wh_t, lengths, y_ext, c_ext, dy,
                                                      dgates, B, T, H, ks);
  return cudaGetLastError();
}

template <typename W>
cudaError_t fwd_rows(const void* gx, const void* wh, const void* lengths, void* out,
                     void* y_ext, void* c_ext, int B, int T, int H, int rows,
                     cudaStream_t s) {
  const auto g = static_cast<const float*>(gx);
  const auto w = static_cast<const W*>(wh);
  const auto l = static_cast<const int*>(lengths);
  const auto o = static_cast<W*>(out);
  const auto y = static_cast<W*>(y_ext);
  const auto c = static_cast<float*>(c_ext);
  switch (rows) {
    case 2: return launch_fwd<W, 2>(g, w, l, o, y, c, B, T, H, s);
    case 4: return launch_fwd<W, 4>(g, w, l, o, y, c, B, T, H, s);
    default: return cudaErrorInvalidValue;
  }
}

template <typename W>
cudaError_t bwd_rows(const void* gx, const void* wh, const void* wh_t, const void* lengths,
                     const void* y_ext, const void* c_ext, const void* dy, void* dgates, int B,
                     int T, int H, int rows, cudaStream_t s) {
  const auto g = static_cast<const float*>(gx);
  const auto w = static_cast<const W*>(wh);
  const auto wt = static_cast<const W*>(wh_t);
  const auto l = static_cast<const int*>(lengths);
  const auto y = static_cast<const W*>(y_ext);
  const auto c = static_cast<const float*>(c_ext);
  const auto d = static_cast<const W*>(dy);
  const auto o = static_cast<float*>(dgates);
  switch (rows) {
    case 2: return launch_bwd<W, 2>(g, w, wt, l, y, c, d, o, B, T, H, s);
    case 4: return launch_bwd<W, 4>(g, w, wt, l, y, c, d, o, B, T, H, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" int blstm_train_fwd(const void* gx, const void* wh, const void* lengths, void* out,
                               void* y_ext, void* c_ext, int B, int T, int H, int rows,
                               int bf16, void* stream) {
  if (H < 1 || H > 1024 || B < 1 || T < 1) return (int)cudaErrorInvalidValue;
  const auto s = static_cast<cudaStream_t>(stream);
  if (bf16)
    return (int)fwd_rows<__nv_bfloat16>(gx, wh, lengths, out, y_ext, c_ext, B, T, H, rows, s);
  return (int)fwd_rows<float>(gx, wh, lengths, out, y_ext, c_ext, B, T, H, rows, s);
}

extern "C" int blstm_train_bwd(const void* gx, const void* wh, const void* wh_t,
                               const void* lengths, const void* y_ext, const void* c_ext,
                               const void* dy, void* dgates, int B, int T, int H, int rows,
                               int bf16, void* stream) {
  if (H < 1 || H > 1024 || B < 1 || T < 1) return (int)cudaErrorInvalidValue;
  const auto s = static_cast<cudaStream_t>(stream);
  if (bf16)
    return (int)bwd_rows<__nv_bfloat16>(gx, wh, wh_t, lengths, y_ext, c_ext, dy, dgates, B, T,
                                        H, rows, s);
  return (int)bwd_rows<float>(gx, wh, wh_t, lengths, y_ext, c_ext, dy, dgates, B, T, H, rows,
                              s);
}
