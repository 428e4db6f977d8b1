// Masked bidirectional LSTM frame loops for training, W_h resident in
// shared memory across a co-resident grid: the forward with the backward's
// residuals, and the adjoint frame loop.
//
// Replaces the recurrences of robust_e2e_gan_tpu/ops/blstm_train_pallas.py
// (blstm_train :624, _fwd_kernel :84 / _bwd_kernel :211, and blstm_train_gx
// :1050, _fwd_gx_kernel :678 / _bwd_gx_kernel :786) wherever
// ops/blstm_train.py::resident_plan fits; csrc/blstm_train.cu's loops take
// the layers past it. The contracts are those loops': gx (B, T, 2, 4H) f32,
// wh (2, H, 4H) in the compute type, lengths; out (B, T, 2H), y_ext/c_ext
// (2, B, T+1, H) with the zero rows and frame-order layout described in
// blstm_train.cu, dgates (B, T, 2, 4H) f32 with zero pad frames.
//
// What bounds them on Hopper: a chain of T dependent frames, each needing
// all of W_h (H x 4H per direction; 4 MiB in f32 at H = 512). The
// row-tiled loops of blstm_train.cu re-read W_h from L2 in every frame and
// every row tile, on as few SMs as there are tiles (16 at B = 16).
//
// Design: each direction gets P blocks; block p owns n_u hidden units
// U_p = [p n_u, (p+1) n_u), i.e. the 4 n_u gate columns {g H + u}, keeps
// W_h[:, cols(U_p)] in shared memory from the first frame to the last
// (transposed, so a warp's lanes read neighbouring k), and handles all B
// rows. The P blocks of a direction meet at one grid barrier per frame
// (a generation counter: release add, acquire spin), so the whole grid
// must be co-resident: it is launched with cudaLaunchCooperativeKernel,
// which refuses a grid that is not. Every block passes the same number of
// barriers: the loop runs to the longest length of the batch, and rows
// past their length do no work in a step.
//
// Forward step s: gx of the block's columns has been copied into shared
// memory with cp.async during the step before (off the chain); stage
// h_{s-1} of all rows from y_ext (every valid frame
// writes its row there rounded to the compute type, which is the value the
// recurrent product takes), gates = gx + h_{s-1} W_h[:, cols], the cell
// update of the block's units (c in shared memory), out/y_ext/c_ext, arrive.
//
// Backward step s (descending): before waiting for the barrier (off the
// chain), recompute the block's gate columns from y_ext's h_{t-1}; h_{t-1},
// gx, c_{t-1}, c_t and dy of its units were copied into shared memory with
// cp.async during the step before; then sum the previous step's P
// partial dh vectors for its units in a fixed order (no float atomics: the
// gradients are the same every run), the adjoint gate math of
// blstm_train.cu, dgates in f32, and this block's partial
// dh_{t-1} = dgates[:, cols]_rounded W_h[:, cols]^T for all H into a
// scratch double-buffered by step parity, then arrive. The resident slice
// serves both products, so no W_h^T copy is needed.
//
// What is left per step: the barrier (~1 us), the L2 round trips of the
// exchanged h or dh partials (many loads in flight per thread), and the
// block's two B x 4n_u x H products from shared memory, which bind on
// shared-memory loads (a warp per 8 x 4 tile, lanes splitting k, one
// shuffle tree per tile in the gate product; 8 rows x 4 columns a lane in
// the dh product).
//
// Rounding points: h rounded to the compute type for the recurrent
// product, dgates rounded to it for the dh product, dy in the compute type,
// dgates stored in f32. Reads of what other blocks wrote in this launch
// (y_ext in the forward, the dh partials) bypass L1 (ld.global.cg).

#include "common.cuh"

namespace {

constexpr int NT = 512;  // threads per block
constexpr int RB = 8;    // rows of a gate-product tile (one warp)
constexpr int RC = 4;    // gate columns of a gate-product tile
constexpr int RD = 8;    // rows per lane in the dh product
constexpr int RK = 4;    // columns per lane in the dh product
constexpr int LINE = 32;  // ints between the two directions' counters

__device__ __forceinline__ float ld_cg(const float* p) { return __ldcg(p); }
__device__ __forceinline__ float ld_cg(const __nv_bfloat16* p) {
  return __bfloat162float(
      __ushort_as_bfloat16(__ldcg(reinterpret_cast<const unsigned short*>(p))));
}

__device__ __forceinline__ unsigned ld_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

// The block's writes of this step are done (the CTA barrier orders them
// before thread 0's release); thread 0 counts the block in.
__device__ __forceinline__ void grid_arrive(unsigned* count) {
  __syncthreads();
  if (threadIdx.x == 0)
    asm volatile("red.release.gpu.global.add.u32 [%0], 1;" ::"l"(count) : "memory");
}

// Wait until `target` arrivals have been counted: thread 0 acquires, the
// CTA barrier orders the block's later reads after it.
__device__ __forceinline__ void grid_wait(const unsigned* count, unsigned target) {
  if (threadIdx.x == 0) {
    while (ld_acquire(count) < target) {
    }
  }
  __syncthreads();
}

// Dynamic shared memory of one block (ops/blstm_train.py::resident_smem
// computes the same size).
template <typename W>
struct Smem {
  float* dg;    // (B, C) dgates rounded to W (backward)
  float* gate;  // (2, B, C) gx + h_{t-1} W_h[:, cols], by step parity
  float* st;    // (2, B, C) c_{t-1}, c_t, dy of the units, by step parity
  float* h;     // (B, H) staged h_{t-1}, float32 (forward) ...
  W* hb;        // ... or (2, B, H) in W by step parity (backward), same bytes
  W* w;         // (C, H) W_h[:, cols]^T
  float* dh;    // (B, NU) summed dh partials (backward)
  float* cell;  // (B, NU) c (forward) or dc (backward)
  int* len;     // (B,) clamped lengths, then the step count
};

__host__ __device__ inline size_t smem_bytes(int B, int H, int NU, size_t wsize) {
  const size_t C = 4 * (size_t)NU;
  return 4 * (5 * B * C + 2 * (size_t)B * NU + B + 1) + (2 * (size_t)B * H + C * H) * wsize;
}

template <typename W>
__device__ Smem<W> carve(char* base, int B, int H, int NU) {
  static_assert(sizeof(W) == 2 || sizeof(W) == 4, "2 B x H values of W hold B x H floats");
  const int C = 4 * NU;
  Smem<W> s;
  s.dg = reinterpret_cast<float*>(base);  // 16-byte aligned: float4 reads
  s.gate = s.dg + B * C;
  s.st = s.gate + 2 * B * C;
  s.h = s.st + 2 * B * C;                 // 16-byte aligned: vector stages
  s.hb = reinterpret_cast<W*>(s.h);
  s.w = s.hb + 2 * B * H;
  s.dh = reinterpret_cast<float*>(s.w + C * H);
  s.cell = s.dh + B * NU;
  s.len = reinterpret_cast<int*>(s.cell + B * NU);
  return s;
}

// Load the block's W_h slice (transposed; zero past H), the clamped
// lengths and the step count (the longest length), zero the carried state.
template <typename W>
__device__ int setup(const Smem<W>& s, const W* wh, const int* lengths, int B, int T,
                     int H, int NU, int u0) {
  const int C = 4 * NU;
  for (int i = threadIdx.x; i < C * H; i += NT) {
    const int c = i / H, k = i % H;
    const int g = c / NU, u = u0 + c % NU;
    s.w[i] = u < H ? wh[(size_t)k * 4 * H + g * H + u] : rg::from_f<W>(0.f);
  }
  for (int i = threadIdx.x; i < B * NU; i += NT) s.cell[i] = 0.f;
  if (threadIdx.x == 0) s.len[B] = 0;
  __syncthreads();
  for (int b = threadIdx.x; b < B; b += NT) {
    const int l = min(max(lengths[b], 0), T);
    s.len[b] = l;
    atomicMax(&s.len[B], l);
  }
  __syncthreads();
  return s.len[B];
}

// A shuffle level of the tile reduction: lanes with bit O keep the upper O
// of their values and send the lower O, the others the reverse.
template <int O>
__device__ __forceinline__ void fold(float* v, int lane) {
  const bool upper = lane & O;
#pragma unroll
  for (int i = 0; i < O; ++i) {
    const float send = upper ? v[i] : v[i + O];
    const float keep = upper ? v[i + O] : v[i];
    v[i] = keep + __shfl_xor_sync(0xffffffffu, send, O);
  }
}

// gate[b, c] += sum_k h[b, k] w[c, k]: a warp per RB x RC tile, the lanes
// splitting k (k ascending within a lane), then a fixed shuffle tree that
// leaves the tile's 32 sums one on each lane (16 + 8 + 4 + 2 + 1 shuffles).
// Shared-memory bound: RB + RC loads for RB x RC multiply-adds per lane.
template <typename HT, typename W>
__device__ void gate_product(const HT* h, const W* w, float* gate, int B, int H,
                             int C) {
  static_assert(RB * RC == 32, "one sum per lane");
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int row_tiles = (B + RB - 1) / RB;
  const int tiles = row_tiles * (C / RC);
  for (int tile = warp; tile < tiles; tile += NT / 32) {
    const int b0 = (tile % row_tiles) * RB, c0 = (tile / row_tiles) * RC;
    const HT* hr[RB];
    const W* wc[RC];
#pragma unroll
    for (int r = 0; r < RB; ++r) hr[r] = h + min(b0 + r, B - 1) * H;
#pragma unroll
    for (int c = 0; c < RC; ++c) wc[c] = w + (c0 + c) * H;
    float v[32];  // v[r * RC + c]
#pragma unroll
    for (int i = 0; i < 32; ++i) v[i] = 0.f;
#pragma unroll 4
    for (int k = lane; k < H; k += 32) {
      float hv[RB], wv[RC];
#pragma unroll
      for (int r = 0; r < RB; ++r) hv[r] = rg::to_f(hr[r][k]);
#pragma unroll
      for (int c = 0; c < RC; ++c) wv[c] = rg::to_f(wc[c][k]);
#pragma unroll
      for (int r = 0; r < RB; ++r) {
#pragma unroll
        for (int c = 0; c < RC; ++c) v[r * RC + c] = fmaf(hv[r], wv[c], v[r * RC + c]);
      }
    }
    fold<16>(v, lane);
    fold<8>(v, lane);
    fold<4>(v, lane);
    fold<2>(v, lane);
    fold<1>(v, lane);  // lane L now holds the sum of v[L]
    const int b = b0 + lane / RC;
    if (b < B) gate[b * C + c0 + lane % RC] += v[0];
  }
}

// A thread's fixed place in a sweep over (rows, cols) with cols <= NT:
// column col, rows first, first + step, ...; no division per element.
struct Sweep {
  int col, first, step;
  __device__ Sweep(int cols)
      : col(threadIdx.x % cols), first(threadIdx.x / cols), step(NT / cols) {}
  __device__ bool active() const { return first < step; }
};

// Four consecutive values as float32, past L1 (16- or 8-byte loads).
__device__ __forceinline__ float4 ld4_cg(const float* p) {
  return __ldcg(reinterpret_cast<const float4*>(p));
}
__device__ __forceinline__ float4 ld4_cg(const __nv_bfloat16* p) {
  const uint2 r = __ldcg(reinterpret_cast<const uint2*>(p));
  const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&r.x));
  const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&r.y));
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}

// Stage h_{s-1} of every row (y_ext row t + z, written in this launch by
// other blocks) as float32, zero for rows past their length or when
// `zero`: VEC consecutive values per load (4 where H % 4 == 0), RU
// predicated loads in flight per thread.
template <int VEC, typename W>
__device__ void stage_rows(float* h, const W* y_ext, const int* len, int s, int z, int B,
                           int T, int H, bool zero) {
  constexpr int RU = 8;
  const int nv = H / VEC, kc = min(nv, NT);
  const Sweep sw(kc);
  if (!sw.active()) return;
  for (int kv = sw.col; kv < nv; kv += kc) {
    const int k = kv * VEC;
    for (int b0 = sw.first; b0 < B; b0 += sw.step * RU) {
      float4 v[RU];  // .x alone when VEC == 1
#pragma unroll
      for (int j = 0; j < RU; ++j) {
        const int b = b0 + j * sw.step;
        const int l = b < B && !zero ? len[b] : 0;
        const int t = z == 0 ? s : l - 1 - s;
        const W* p = y_ext + (((size_t)z * B + b) * (T + 1) + t + z) * H + k;
        v[j] = make_float4(0.f, 0.f, 0.f, 0.f);
        if constexpr (VEC == 4) {
          if (s < l) v[j] = ld4_cg(p);
        } else {
          if (s < l) v[j].x = ld_cg(p);
        }
      }
#pragma unroll
      for (int j = 0; j < RU; ++j) {
        const int b = b0 + j * sw.step;
        if (b >= B) continue;
        if constexpr (VEC == 4)
          *reinterpret_cast<float4*>(h + b * H + k) = v[j];
        else
          h[b * H + k] = v[j].x;
      }
    }
  }
}

template <typename W>
__device__ void stage_h(float* h, const W* y_ext, const int* len, int s, int z, int B,
                        int T, int H, bool zero) {
  if (H % 4 == 0)
    stage_rows<4>(h, y_ext, len, s, z, B, T, H, zero);
  else
    stage_rows<1>(h, y_ext, len, s, z, B, T, H, zero);
}

// Copy BYTES from global to shared memory without a register round trip,
// or zeros where !on; cp_async_wait makes the copies visible.
template <int BYTES>
__device__ __forceinline__ void cp_async(void* dst, const void* src, bool on) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int n = on ? BYTES : 0;
  if constexpr (BYTES == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(d), "l"(src), "r"(n)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %3, %2;" ::"r"(d), "l"(src), "r"(n),
                 "n"(BYTES)
                 : "memory");
}

// Start copying h_{t-1} of step s (y_ext, written by the forward launch)
// into hb in W, four values per copy, zeros for rows past their length;
// cp_async_wait makes it visible. Where H % 4 != 0 it copies at once.
template <typename W>
__device__ void prefetch_h(W* hb, const W* y_ext, const int* len, int s, int z, int B,
                           int T, int H) {
  if (H % 4 != 0) {
    for (int i = threadIdx.x; i < B * H; i += NT) {
      const int b = i / H, k = i % H, l = len[b];
      const int t = z == 0 ? s : l - 1 - s;
      hb[i] = s < l ? y_ext[(((size_t)z * B + b) * (T + 1) + t + z) * H + k]
                    : rg::from_f<W>(0.f);
    }
    return;
  }
  const int nv = H / 4, kc = min(nv, NT);
  const Sweep sw(kc);
  if (!sw.active()) return;
  for (int kv = sw.col; kv < nv; kv += kc) {
    for (int b = sw.first; b < B; b += sw.step) {
      const int l = len[b];
      const int t = z == 0 ? s : l - 1 - s;
      const W* src = s < l ? y_ext + (((size_t)z * B + b) * (T + 1) + t + z) * H + 4 * kv
                           : y_ext;
      cp_async<4 * sizeof(W)>(hb + b * H + 4 * kv, src, s < l);
    }
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// Start copying gx of step s for the block's columns into gate (zero
// where there is no work).
__device__ void prefetch_gx(float* gate, const float* gx, const int* len, int s, int z,
                            int B, int T, int H, int NU, int u0) {
  const int C = 4 * NU;
  const Sweep sw(C);
  if (!sw.active()) return;
  const int u = u0 + sw.col % NU;
  const float* g = gx + (size_t)z * 4 * H + (size_t)(sw.col / NU) * H + u;
  for (int b = sw.first; b < B; b += sw.step) {
    const int l = len[b];
    const int t = z == 0 ? s : l - 1 - s;
    const bool on = u < H && s < l;
    cp_async<4>(gate + b * C + sw.col, on ? g + ((size_t)b * T + t) * 8 * H : gx, on);
  }
}

// Start copying c_{t-1} (c_ext row t + z), c_t (row t + 1 - z) and, in
// float32, dy of step s for the block's units into the slots 0, NU and
// 2 NU of st; a bfloat16 dy is loaded where it is used.
template <typename W>
__device__ void prefetch_c(float* st, const float* c_ext, const W* dy, const int* len,
                           int s, int z, int B, int T, int H, int NU, int u0,
                           const Sweep& unit) {
  const int C = 4 * NU, u = u0 + unit.col;
  for (int b = unit.first; unit.active() && b < B; b += unit.step) {
    const int l = len[b];
    const int t = z == 0 ? s : l - 1 - s;
    const bool on = u < H && s < l;
    const size_t crow = (((size_t)z * B + b) * (T + 1) + t) * H + u;
    float* p = st + b * C + unit.col;
    cp_async<4>(p, on ? c_ext + crow + (size_t)z * H : c_ext, on);
    cp_async<4>(p + NU, on ? c_ext + crow + (size_t)(1 - z) * H : c_ext, on);
    if constexpr (sizeof(W) == 4)
      cp_async<4>(p + 2 * NU, on ? dy + ((size_t)b * T + t) * 2 * H + z * H + u : dy, on);
  }
}

// dh[b * NU + j] = sum over the P blocks' partials of unit u0 + j: tpi
// lanes per unit, each summing every tpi-th block in ascending order, then
// a fixed shuffle tree; no atomics, so the sum is the same every run.
__device__ void dh_sums(float* dh, const float* prev, int B, int H, int NU, int P, int u0) {
  constexpr int RU = 16;
  const int items = B * NU;
  int tpi = 32;
  while (tpi > 1 && items * tpi > NT) tpi >>= 1;
  const int lane_in = threadIdx.x % tpi;
  const size_t stride = (size_t)B * H;
  for (int base = 0; base < items; base += NT / tpi) {  // uniform trip count
    const int item = base + threadIdx.x / tpi;
    const int u = u0 + item % NU;
    const bool on = item < items && u < H;
    const float* pr = prev + (size_t)(item / NU) * H + u;
    float acc = 0.f;
    for (int q0 = lane_in; q0 < P; q0 += RU * tpi) {
      float v[RU];
#pragma unroll
      for (int j = 0; j < RU; ++j) {
        const int q = q0 + j * tpi;
        v[j] = on && q < P ? ld_cg(pr + q * stride) : 0.f;
      }
#pragma unroll
      for (int j = 0; j < RU; ++j) acc += v[j];
    }
    for (int o = tpi / 2; o > 0; o >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, o);
    if (item < items && lane_in == 0) dh[item] = acc;
  }
}

// out[b, k] = sum_c dg[b, c] w[c, k], c ascending: a warp per RD rows x
// 32 RK columns, each lane RK columns 32 apart, so a W load serves RD rows
// and a dgates load RK columns.
template <typename W>
__device__ void dh_product(const float* dg, const W* w, float* out, int B, int H, int C) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int groups = (B + RD - 1) / RD, kgroups = (H + 32 * RK - 1) / (32 * RK);
  for (int item = warp; item < groups * kgroups; item += NT / 32) {
    const int b0 = (item % groups) * RD, k0 = (item / groups) * 32 * RK + lane;
    const float* dr[RD];
#pragma unroll
    for (int r = 0; r < RD; ++r) dr[r] = dg + min(b0 + r, B - 1) * C;
    float acc[RD][RK];
#pragma unroll
    for (int r = 0; r < RD; ++r) {
#pragma unroll
      for (int q = 0; q < RK; ++q) acc[r][q] = 0.f;
    }
    for (int c = 0; c < C; c += 4) {
      float4 d[RD];
#pragma unroll
      for (int r = 0; r < RD; ++r) d[r] = *reinterpret_cast<const float4*>(dr[r] + c);
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) {
        float wv[RK];
#pragma unroll
        for (int q = 0; q < RK; ++q) {
          const int k = k0 + 32 * q;
          wv[q] = k < H ? rg::to_f(w[(c + cc) * H + k]) : 0.f;
        }
#pragma unroll
        for (int r = 0; r < RD; ++r) {
          const float dv = cc == 0 ? d[r].x : cc == 1 ? d[r].y : cc == 2 ? d[r].z : d[r].w;
#pragma unroll
          for (int q = 0; q < RK; ++q) acc[r][q] = fmaf(dv, wv[q], acc[r][q]);
        }
      }
    }
#pragma unroll
    for (int r = 0; r < RD; ++r) {
#pragma unroll
      for (int q = 0; q < RK; ++q) {
        const int k = k0 + 32 * q;
        if (b0 + r < B && k < H) __stcg(out + (size_t)(b0 + r) * H + k, acc[r][q]);
      }
    }
  }
}

template <typename W>
__global__ void __launch_bounds__(NT, 1)
fwd_resident(const float* __restrict__ gx,     // (B, T, 2, 4H)
             const W* __restrict__ wh,         // (2, H, 4H)
             const int* __restrict__ lengths,  // (B,)
             W* __restrict__ out,              // (B, T, 2H)
             W* y_ext,                         // (2, B, T+1, H)
             float* __restrict__ c_ext,        // (2, B, T+1, H)
             unsigned* count,                  // (2 * LINE,) zeroed
             int B, int T, int H, int NU) {
  extern __shared__ __align__(16) char smem_raw[];
  const int z = blockIdx.y, P = gridDim.x, u0 = blockIdx.x * NU;
  const int C = 4 * NU;
  const Smem<W> sm = carve<W>(smem_raw, B, H, NU);
  const int steps = setup(sm, wh + (size_t)z * H * 4 * H, lengths, B, T, H, NU, u0);
  const size_t zb = (size_t)z * B;
  const Sweep unit(NU);  // the cell update: unit u0 + col of rows first, ...
  const int u = u0 + unit.col;
  const bool mine = unit.active() && u < H;

  if (steps > 0) {
    prefetch_gx(sm.gate, gx, sm.len, 0, z, B, T, H, NU, u0);
    cp_async_commit();
  }
  for (int s = 0; s < steps; ++s) {
    float* gate = sm.gate + (s & 1) * B * C;
    const bool ahead = s + 1 < steps;
    if (ahead) {  // gx of the next step is copied in while this one runs
      prefetch_gx(sm.gate + ((s + 1) & 1) * B * C, gx, sm.len, s + 1, z, B, T, H, NU, u0);
      cp_async_commit();
    }
    if (s > 0) grid_wait(count + z * LINE, (unsigned)s * P);
    stage_h(sm.h, y_ext, sm.len, s, z, B, T, H, s == 0);
    if (ahead)
      cp_async_wait<1>();  // this step's gx
    else
      cp_async_wait<0>();
    __syncthreads();
    gate_product(sm.h, sm.w, gate, B, H, C);
    __syncthreads();
    for (int b = unit.first; mine && b < B; b += unit.step) {
      const int l = sm.len[b];
      if (s >= l) continue;
      const int t = z == 0 ? s : l - 1 - s;
      const float* ga = gate + b * C + unit.col;
      float* cell = sm.cell + b * NU + unit.col;
      const float cn = rg::sigmoid(ga[NU]) * *cell + rg::sigmoid(ga[0]) * tanhf(ga[2 * NU]);
      const float hn = rg::sigmoid(ga[3 * NU]) * tanhf(cn);
      *cell = cn;
      out[((size_t)b * T + t) * 2 * H + z * H + u] = rg::from_f<W>(hn);
      const size_t row = ((zb + b) * (T + 1) + t + 1 - z) * H + u;
      y_ext[row] = rg::from_f<W>(hn);
      c_ext[row] = cn;
    }
    grid_arrive(count + z * LINE);
  }

  // pad frames of the block's units: zero outputs; every residual row no
  // valid frame wrote
  for (int b = unit.first; mine && b < B; b += unit.step) {
    const int l = sm.len[b];
    for (int r = 0; r <= T; ++r) {
      if (r >= l && r < T) out[((size_t)b * T + r) * 2 * H + z * H + u] = rg::from_f<W>(0.f);
      const bool valid = z == 0 ? (r >= 1 && r <= l) : (r < l);
      if (valid) continue;
      const size_t row = ((zb + b) * (T + 1) + r) * H + u;
      y_ext[row] = rg::from_f<W>(0.f);
      c_ext[row] = 0.f;
    }
  }
}

template <typename W>
__global__ void __launch_bounds__(NT, 1)
bwd_resident(const float* __restrict__ gx,      // (B, T, 2, 4H)
             const W* __restrict__ wh,          // (2, H, 4H)
             const int* __restrict__ lengths,   // (B,)
             const W* __restrict__ y_ext,       // (2, B, T+1, H)
             const float* __restrict__ c_ext,   // (2, B, T+1, H)
             const W* __restrict__ dy,          // (B, T, 2H)
             float* __restrict__ dgates,        // (B, T, 2, 4H)
             float* part,                       // (2, 2, P, B, H) dh partials
             unsigned* count,                   // (2 * LINE,) zeroed
             int B, int T, int H, int NU) {
  extern __shared__ __align__(16) char smem_raw[];
  const int z = blockIdx.y, p = blockIdx.x, P = gridDim.x, u0 = p * NU;
  const int C = 4 * NU, G = 4 * H;
  const Smem<W> sm = carve<W>(smem_raw, B, H, NU);
  const int steps = setup(sm, wh + (size_t)z * H * G, lengths, B, T, H, NU, u0);
  const size_t zb = (size_t)z * B;
  const size_t slab = (size_t)P * B * H;  // one direction and parity
  const Sweep unit(NU);
  const int u = u0 + unit.col;
  const bool mine = unit.active() && u < H;

  // what step s reads from the forward's outputs, copied in by cp.async
  // during the step before it (off the chain): h_{t-1}, gx, c_{t-1}, c_t, dy
  auto prefetch = [&](int s) {
    const int par = s & 1;
    prefetch_h(sm.hb + par * B * H, y_ext, sm.len, s, z, B, T, H);
    prefetch_gx(sm.gate + par * B * C, gx, sm.len, s, z, B, T, H, NU, u0);
    prefetch_c(sm.st + par * B * C, c_ext, dy, sm.len, s, z, B, T, H, NU, u0, unit);
    cp_async_commit();
  };
  if (steps > 0) prefetch(steps - 1);
  for (int s = steps - 1; s >= 0; --s) {
    float* gate = sm.gate + (s & 1) * B * C;
    float* st = sm.st + (s & 1) * B * C;
    if (s > 0) prefetch(s - 1);
    if constexpr (sizeof(W) == 2) {
      for (int b = unit.first; mine && b < B; b += unit.step) {
        const int l = sm.len[b];
        if (s >= l) continue;
        const int t = z == 0 ? s : l - 1 - s;
        st[b * C + 2 * NU + unit.col] = rg::to_f(dy[((size_t)b * T + t) * 2 * H + z * H + u]);
      }
    }
    if (s > 0)
      cp_async_wait<1>();  // this step's copies; the next step's fly on
    else
      cp_async_wait<0>();
    __syncthreads();
    gate_product(sm.hb + (s & 1) * B * H, sm.w, gate, B, H, C);
    const bool first = s == steps - 1;
    if (!first) {
      grid_wait(count + z * LINE, (unsigned)(steps - 1 - s) * P);
      // step s + 1 wrote the other parity
      dh_sums(sm.dh, part + (size_t)(z * 2 + ((s + 1) & 1)) * slab, B, H, NU, P, u0);
    }
    __syncthreads();

    // every dg slot of the block is written: zero where there is no work
    for (int b = unit.first; unit.active() && b < B; b += unit.step) {
      float* dgs = sm.dg + b * C + unit.col;
      const int l = sm.len[b];
      if (u >= H || s >= l) {
#pragma unroll
        for (int g = 0; g < 4; ++g) dgs[g * NU] = 0.f;
        continue;
      }
      const float* sv = st + b * C + unit.col;
      const float c_prev = sv[0], tanh_c = tanhf(sv[NU]);
      const float dh_out = sv[2 * NU] + (first ? 0.f : sm.dh[b * NU + unit.col]);
      const int t = z == 0 ? s : l - 1 - s;
      const float* ga = gate + b * C + unit.col;
      const float gi = rg::sigmoid(ga[0]);
      const float gf = rg::sigmoid(ga[NU]);
      const float gg = tanhf(ga[2 * NU]);
      const float go = rg::sigmoid(ga[3 * NU]);
      float* dc = sm.cell + b * NU + unit.col;
      const float dc_new = *dc + dh_out * go * (1.f - tanh_c * tanh_c);
      const float di = dc_new * gg * (gi * (1.f - gi));
      const float df = dc_new * c_prev * (gf * (1.f - gf));
      const float dg = dc_new * gi * (1.f - gg * gg);
      const float d_o = dh_out * tanh_c * (go * (1.f - go));
      float* dgt = dgates + (((size_t)b * T + t) * 2 + z) * G + u;
      dgt[0] = di;
      dgt[H] = df;
      dgt[2 * H] = dg;
      dgt[3 * H] = d_o;
      dgs[0] = rg::rnd<W>(di);
      dgs[NU] = rg::rnd<W>(df);
      dgs[2 * NU] = rg::rnd<W>(dg);
      dgs[3 * NU] = rg::rnd<W>(d_o);
      *dc = gf * dc_new;  // dc carried to the step before
    }
    __syncthreads();
    dh_product(sm.dg, sm.w, part + (size_t)(z * 2 + (s & 1)) * slab + (size_t)p * B * H, B, H,
               C);
    grid_arrive(count + z * LINE);
  }

  // pad frames of the block's units: zero dgates
  for (int b = unit.first; mine && b < B; b += unit.step) {
    for (int t = sm.len[b]; t < T; ++t) {
      float* dgt = dgates + (((size_t)b * T + t) * 2 + z) * G + u;
#pragma unroll
      for (int g = 0; g < 4; ++g) dgt[g * H] = 0.f;
    }
  }
}

// A refused launch (a grid that cannot be co-resident) is returned to the
// wrapper, which raises; the runtime also keeps it as its last error, which
// is cleared here so that the next kernel's launch check does not read it.
cudaError_t launched(cudaError_t err) {
  if (err != cudaSuccess) cudaGetLastError();
  return err;
}

template <typename W>
cudaError_t launch_fwd(const void* gx, const void* wh, const void* lengths, void* out,
                       void* y_ext, void* c_ext, void* count, int B, int T, int H, int NU,
                       cudaStream_t stream) {
  const size_t smem = smem_bytes(B, H, NU, sizeof(W));
  const cudaError_t err = rg::reserve_smem<fwd_resident<W>>(smem);
  if (err != cudaSuccess) return err;
  const float* g = static_cast<const float*>(gx);
  const W* w = static_cast<const W*>(wh);
  const int* l = static_cast<const int*>(lengths);
  W* o = static_cast<W*>(out);
  W* y = static_cast<W*>(y_ext);
  float* c = static_cast<float*>(c_ext);
  unsigned* n = static_cast<unsigned*>(count);
  void* args[] = {&g, &w, &l, &o, &y, &c, &n, &B, &T, &H, &NU};
  return launched(cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(fwd_resident<W>),
                                              dim3((H + NU - 1) / NU, 2), dim3(NT), args, smem,
                                              stream));
}

template <typename W>
cudaError_t launch_bwd(const void* gx, const void* wh, const void* lengths, const void* y_ext,
                       const void* c_ext, const void* dy, void* dgates, void* part, void* count,
                       int B, int T, int H, int NU, cudaStream_t stream) {
  const size_t smem = smem_bytes(B, H, NU, sizeof(W));
  const cudaError_t err = rg::reserve_smem<bwd_resident<W>>(smem);
  if (err != cudaSuccess) return err;
  const float* g = static_cast<const float*>(gx);
  const W* w = static_cast<const W*>(wh);
  const int* l = static_cast<const int*>(lengths);
  const W* y = static_cast<const W*>(y_ext);
  const float* c = static_cast<const float*>(c_ext);
  const W* d = static_cast<const W*>(dy);
  float* o = static_cast<float*>(dgates);
  float* q = static_cast<float*>(part);
  unsigned* n = static_cast<unsigned*>(count);
  void* args[] = {&g, &w, &l, &y, &c, &d, &o, &q, &n, &B, &T, &H, &NU};
  return launched(cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(bwd_resident<W>),
                                              dim3((H + NU - 1) / NU, 2), dim3(NT), args, smem,
                                              stream));
}

bool bad_shape(int B, int T, int H, int NU) {
  return H < 1 || H > 1024 || B < 1 || T < 1 || NU < 1 || NU > H || 4 * NU > NT;
}

}  // namespace

extern "C" int blstm_train_resident_fwd(const void* gx, const void* wh, const void* lengths,
                                        void* out, void* y_ext, void* c_ext, void* count,
                                        int B, int T, int H, int NU, int bf16, void* stream) {
  if (bad_shape(B, T, H, NU)) return (int)cudaErrorInvalidValue;
  const auto s = static_cast<cudaStream_t>(stream);
  if (bf16)
    return (int)launch_fwd<__nv_bfloat16>(gx, wh, lengths, out, y_ext, c_ext, count, B, T, H,
                                          NU, s);
  return (int)launch_fwd<float>(gx, wh, lengths, out, y_ext, c_ext, count, B, T, H, NU, s);
}

extern "C" int blstm_train_resident_bwd(const void* gx, const void* wh, const void* lengths,
                                        const void* y_ext, const void* c_ext, const void* dy,
                                        void* dgates, void* part, void* count, int B, int T,
                                        int H, int NU, int bf16, void* stream) {
  if (bad_shape(B, T, H, NU)) return (int)cudaErrorInvalidValue;
  const auto s = static_cast<cudaStream_t>(stream);
  if (bf16)
    return (int)launch_bwd<__nv_bfloat16>(gx, wh, lengths, y_ext, c_ext, dy, dgates, part,
                                          count, B, T, H, NU, s);
  return (int)launch_bwd<float>(gx, wh, lengths, y_ext, c_ext, dy, dgates, part, count, B, T,
                                H, NU, s);
}
