// Strided batched matrix product with float32 accumulation, and a column
// sum: the products the TPU training BLSTM computes in its kernel bodies.
//
// Replaces the in-kernel matmuls of robust_e2e_gan_tpu/ops/
// blstm_train_pallas.py::blstm_train (:624): the chunk input projections
// x W_x + b (:150-158) and their recompute in the backward (:296-308), and
// the backward's dx = dgates W_x^T, dW_x = x^T dgates, dW_h = h_prev^T
// dgates and dbias = sum dgates (:346-359); for blstm_train_gx (:1050) only
// dW_h (:902-907). The TPU kernel runs them on its matrix unit inside its
// pallas_calls (:489, :565, :930, :972), dW_x and dW_h summed in VMEM.
//
// Contract (ops/blstm_train.py::gemm): C[z] (+)= A[z] @ B[z] (+ bias[z]) in
// float32, for z < batch. Operands are float32 or bfloat16, read through
// element strides, so transposed and interleaved views (a direction's slice
// of the (B, T, 2, 4H) gate stream, W_x^T, x^T) need no copy; the reduction
// index k splits as (k / KI, k % KI) with a stride for each part, which
// walks the (row, frame) pairs of a padded (B, T+1, H) residual, or both
// directions' gates of a row. round_bf16 rounds both operands to bfloat16
// as they are loaded (the compute-type rounding of dgates). The result is
// float32: written, or added to what is there, plus an optional bias per
// column. Rows and columns past the edge are masked.
//
// What bounds it on Hopper: operations. At the flagship's train shapes the
// products are far above the ~295 bf16 operations a byte where the tensor
// cores rather than memory bind (dW_h of an enhancer layer: 2 x 4.8 GFLOP
// from ~40 MB), so the bound is the tensor cores' rate: 989 TFLOP/s in
// bfloat16, and in float32 three tf32 passes at 495 TFLOP/s.
//
// Design (gemm_tc_kernel; the SIMT kernel it replaced, gemm_simt_kernel,
// stays for timing only, behind ops/blstm_train.py::_force_gemm_route):
// - 128 x 128 output tiles, 8 warps (two warpgroups) of 64 x 32 outputs, k
//   in chunks of 32. The compute type is bfloat16 where round_bf16 is set or
//   both operands are bfloat16: mma.sync m16n8k16, fragments by ldmatrix
//   from a tile whose rows run along k ([mn][k]) or by ldmatrix.trans from
//   one whose rows run along m or n ([k][mn]), whichever axis is contiguous
//   in device memory. Otherwise float32 as 3xTF32: each operand split once,
//   as it is staged, into hi = tf32(x) and lo = tf32(x - hi) (two integer
//   operations a rounding, common.cuh::tf32), lo hi + hi lo + hi hi of
//   each k8 step summed by mma.sync m16n8k8 and the step's sum added by a
//   float32 add (the tensor cores' own float32 sums round toward zero; over
//   a long K that bias misses the float32 tolerance, as single-pass TF32
//   does: tests/test_torch_blstm_train.py emulates both).
// - Copies run ahead of the products. bfloat16 tiles in the bfloat16 type
//   go straight to shared memory by cp.async, 3 chunks ahead in a ring of 4
//   (16-byte pieces, or 4-byte ones where a row is only 4-byte aligned).
//   Tiles that change on the way in (float32 rounded to bfloat16 or split
//   to tf32, and bfloat16 rows with no 4-byte alignment, e.g. D = 257) are
//   loaded into registers a chunk ahead, then converted and stored once the
//   chunk before them is multiplied (a ring of 2 in tf32); two blocks a
//   multiprocessor in bfloat16 hide the loads' waits. The wrapper picks each
//   operand's copy width from its strides, extents and base pointer
//   (ops/blstm_train.py::copy_mode); the (k / KI, k % KI) offsets are
//   computed once a chunk and advanced by adds.
// - Split-K where the output tiles fill at most half of the blocks the
//   card runs at once (the weight gradients: M, N <= 2,560 x 1,024, K =
//   B*T up to ~9,000): S slices of whole chunks, as many as keep one wave
//   (ops/blstm_train.py::gemm_plan, the one place the plan is made). Each slice's block writes its float32 partial tile to a
//   workspace and takes a ticket; the last of a tile's S blocks sums the S
//   partials in slice order, adds the bias or C and writes the tile, and
//   resets the ticket to 0. No float atomics: reruns are bit-identical.
// - One launch a product for both directions: batch = 2 with z the
//   direction, or (dx) both directions' gates as K = 8H with KI = 4H.

#include "common.cuh"

namespace {

using bf16 = __nv_bfloat16;

// ---------------------------------------------------------------------------
// the tensor-core product
// ---------------------------------------------------------------------------

constexpr int BM = 128, BN = 128, BK = 32;  // output tile, k chunk
constexpr int NT = 256;                     // 8 warps: 2 x 4 of 64 x 32 outputs
constexpr int LDK = BK + 8;                 // bf16 between rows of a [mn][k] tile
constexpr int LDK32 = BK + 4;               // words between rows of a [mn][k] tf32 tile
constexpr int LDR = BM + 8;                 // elements between rows of a [k][mn] tile

// How an operand's tiles are copied: element type and elements a copy
// (ops/blstm_train.py::copy_mode picks it from strides and alignment)
enum Mode { F32_V4 = 0, F32_V1 = 1, BF16_V8 = 2, BF16_V2 = 3, BF16_V1 = 4 };

// Shared memory of one operand's stage: the larger of its two layouts,
// [128][LDK] and [32][LDR] (ops/blstm_train.py::GEMM_TILE_BYTES mirrors it);
// in tf32 the hi tile, then the lo tile
template <bool TF32> struct Cfg;
template <> struct Cfg<false> {
  static constexpr int STAGES = 4;
  static constexpr int TILE = BM * LDK * 2;  // 10,240 bytes
};
template <> struct Cfg<true> {
  static constexpr int STAGES = 2;
  static constexpr int HALF = BM * LDK32 * 4;  // 18,432 bytes
  static constexpr int TILE = 2 * HALF;
};
static_assert(BK * LDR * 2 <= Cfg<false>::TILE, "bf16 [k][mn] tile");
static_assert(BK * LDR * 4 <= Cfg<true>::HALF, "tf32 [k][mn] tile");

struct Params {
  const void* a;
  const void* b;
  float* c;
  const float* bias;
  float* ws;          // split-K partial tiles (splits > 1)
  unsigned* tickets;  // one per output tile (splits > 1), 0 between launches
  long long ab, am, ak1, ak0;
  long long bb, bk1, bk0, bn;
  long long cb, cm, cn, biasb;
  long long a_wrap, b_wrap;  // s_k1 - KI s_k0 of A, B: the step where k % KI wraps
  int M, N, K, KI;
  int mode_a, mode_b;
  int splits, slice_chunks, accumulate;
};

// One operand as its loads see it, A with mn = m, B with mn = n, read
// from the launch's parameters where they are used (constant memory, not
// registers: the registers go to the accumulators)
template <bool IS_B>
struct Side {
  const Params& p;
  __device__ __forceinline__ const char* ptr() const {
    return static_cast<const char*>(IS_B ? p.b : p.a);
  }
  __device__ __forceinline__ long long s_batch() const { return IS_B ? p.bb : p.ab; }
  __device__ __forceinline__ long long s_mn() const { return IS_B ? p.bn : p.am; }
  __device__ __forceinline__ long long s_k1() const { return IS_B ? p.bk1 : p.ak1; }
  __device__ __forceinline__ long long s_k0() const { return IS_B ? p.bk0 : p.ak0; }
  __device__ __forceinline__ long long wrap() const { return IS_B ? p.b_wrap : p.a_wrap; }
  __device__ __forceinline__ int mn0() const { return IS_B ? blockIdx.x * BN : blockIdx.y * BM; }
  __device__ __forceinline__ int mn_end() const { return IS_B ? p.N : p.M; }
  __device__ __forceinline__ int mode() const { return IS_B ? p.mode_b : p.mode_a; }
};

// A k a thread loads: k, k % KI and its offset in elements from the
// operand's pointer, z s_batch + (k / KI) s_k1 + (k % KI) s_k0
struct Cursor {
  int k, r;
  long long off;
};

template <class O>
__device__ __forceinline__ Cursor cursor_at(int z, int k, int KI, const O& o) {
  const int q = k / KI, r = k - q * KI;
  return {k, r, z * o.s_batch() + q * o.s_k1() + r * o.s_k0()};
}

template <class O>
__device__ __forceinline__ void advance(Cursor& c, int d, int KI, const O& o) {
  c.k += d;
  c.r += d;
  c.off += d * o.s_k0();
  while (c.r >= KI) {
    c.r -= KI;
    c.off += o.wrap();
  }
}

__device__ __forceinline__ int mode_vec(int mode) {
  return mode == F32_V4 ? 4 : mode == BF16_V8 ? 8 : mode == BF16_V2 ? 2 : 1;
}

// The thread's place in a tile copied in pieces of VEC elements: rows of
// the tile are mn ([mn][k], KCOL) or k ([k][mn]); the thread copies piece
// (row0 + i STEP, col0) for i < N
template <bool KCOL, int VEC>
struct Map {
  static constexpr int PER = (KCOL ? BK : BM) / VEC;  // pieces a tile row
  static constexpr int STEP = NT / PER;
  static constexpr int N = 16 / VEC;
};

// The first k of a chunk that the thread loads, by copy width
template <bool KCOL>
__device__ __forceinline__ int first_k(int vec, int tid) {
  const int per = (KCOL ? BK : BM) / vec;
  return KCOL ? tid % per * vec : tid / per;
}

// Loads that the compiler keeps where they are written: a chunk ahead of
// the products that hide them
__device__ __forceinline__ uint4 ldg16(const void* p) {
  uint4 v;
  asm volatile("ld.global.nc.v4.u32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "l"(p));
  return v;
}

__device__ __forceinline__ uint32_t ldg4(const void* p) {
  uint32_t v;
  asm volatile("ld.global.nc.u32 %0, [%1];\n" : "=r"(v) : "l"(p));
  return v;
}

__device__ __forceinline__ uint32_t ldg2(const void* p) {
  unsigned short v;
  asm volatile("ld.global.nc.u16 %0, [%1];\n" : "=h"(v) : "l"(p));
  return v;
}

// cp.async of 16 or 4 bytes; zeros where !on (no byte is read)
__device__ __forceinline__ void cp16z(void* dst, const void* src, bool on) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(rg::smem_addr(dst)),
               "l"(src), "r"(on ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp4z(void* dst, const void* src, bool on) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(rg::smem_addr(dst)),
               "l"(src), "r"(on ? 4 : 0)
               : "memory");
}

// Piece i of VEC elements of type T into the registers, packed: element e
// of the thread's pieces (e = i VEC + j) in word e of float32 pieces, in
// half e % 2 of word e / 2 of bfloat16 ones; zeros where !on
template <typename T, int VEC>
__device__ __forceinline__ void load_piece(uint32_t (&reg)[16], int i, const T* p, bool on) {
  constexpr int BYTES = VEC * (int)sizeof(T);
  if constexpr (BYTES == 16) {
    const uint4 v = on ? ldg16(p) : make_uint4(0u, 0u, 0u, 0u);
    reg[4 * i] = v.x;
    reg[4 * i + 1] = v.y;
    reg[4 * i + 2] = v.z;
    reg[4 * i + 3] = v.w;
  } else if constexpr (BYTES == 4) {
    reg[i] = on ? ldg4(p) : 0u;
  } else {
    const uint32_t h = on ? ldg2(p) : 0u;
    reg[i / 2] = i % 2 ? reg[i / 2] | h << 16 : h;
  }
}

// The thread's pieces of the chunk at cursor c into registers
template <bool KCOL, typename T, int VEC, class O>
__device__ __forceinline__ void load_regs(uint32_t (&reg)[16], const O& o, Cursor c, int K,
                                          int KI, int tid) {
  using P = Map<KCOL, VEC>;
  const int row0 = tid / P::PER, col0 = tid % P::PER * VEC;
  const T* p = reinterpret_cast<const T*>(o.ptr());
  if constexpr (KCOL) {
    const bool k_on = c.k < K;
    const T* base = p + c.off;
#pragma unroll
    for (int i = 0; i < P::N; ++i) {
      const int mn = o.mn0() + row0 + i * P::STEP;
      load_piece<T, VEC>(reg, i, base + mn * o.s_mn(), k_on && mn < o.mn_end());
    }
  } else {
    const int mn = o.mn0() + col0;
    const bool mn_on = mn < o.mn_end();
    const T* base = p + mn * o.s_mn();
#pragma unroll
    for (int i = 0; i < P::N; ++i) {
      load_piece<T, VEC>(reg, i, base + c.off, mn_on && c.k < K);
      if (i + 1 < P::N) advance(c, P::STEP, KI, o);
    }
  }
}

// The thread's pieces of the chunk at cursor c into the tile by cp.async
// (bfloat16 in the bfloat16 type; VEC 8 or 2)
template <bool KCOL, int VEC, class O>
__device__ __forceinline__ void copy_async(unsigned char* tile, const O& o, Cursor c, int K,
                                           int KI, int tid) {
  using P = Map<KCOL, VEC>;
  constexpr int LD = KCOL ? LDK : LDR;
  const int row0 = tid / P::PER, col0 = tid % P::PER * VEC;
  const bf16* p = reinterpret_cast<const bf16*>(o.ptr());
  bf16* t = reinterpret_cast<bf16*>(tile) + row0 * LD + col0;
#pragma unroll
  for (int i = 0; i < P::N; ++i) {
    const int mn = o.mn0() + (KCOL ? row0 + i * P::STEP : col0);
    const bool on = c.k < K && mn < o.mn_end();
    const bf16* src = p + c.off + mn * o.s_mn();
    if (!on) src = p;
    if constexpr (VEC == 8)
      cp16z(t + i * P::STEP * LD, src, on);
    else
      cp4z(t + i * P::STEP * LD, src, on);
    if constexpr (!KCOL) {
      if (i + 1 < P::N) advance(c, P::STEP, KI, o);
    }
  }
}

// Element e of the thread's pieces in registers (load_piece) as float32
template <typename T>
__device__ __forceinline__ float unpack(const uint32_t (&reg)[16], int e) {
  if constexpr (sizeof(T) == 4) {
    return __uint_as_float(reg[e]);
  } else {
    const uint32_t w = reg[e / 2];
    return __uint_as_float(e % 2 ? w & 0xFFFF0000u : w << 16);
  }
}

// The registers' pieces into the tile: rounded to bfloat16, or split into
// tf32 hi and lo
template <bool TF32, bool KCOL, typename T, int VEC>
__device__ __forceinline__ void store_regs(const uint32_t (&reg)[16], unsigned char* tile,
                                           int tid) {
  using P = Map<KCOL, VEC>;
  const int row0 = tid / P::PER, col0 = tid % P::PER * VEC;
#pragma unroll
  for (int i = 0; i < P::N; ++i) {
    float f[VEC];
#pragma unroll
    for (int j = 0; j < VEC; ++j) f[j] = unpack<T>(reg, i * VEC + j);
    if constexpr (TF32) {
      constexpr int LD = KCOL ? LDK32 : LDR;
      const int idx = (row0 + i * P::STEP) * LD + col0;
      uint32_t h[VEC], l[VEC];
#pragma unroll
      for (int j = 0; j < VEC; ++j) rg::split_tf32(f[j], h[j], l[j]);
      uint32_t* hi = reinterpret_cast<uint32_t*>(tile) + idx;
      uint32_t* lo = reinterpret_cast<uint32_t*>(tile + Cfg<true>::HALF) + idx;
      if constexpr (VEC % 4 == 0) {
#pragma unroll
        for (int j = 0; j < VEC; j += 4) {
          *reinterpret_cast<uint4*>(hi + j) = make_uint4(h[j], h[j + 1], h[j + 2], h[j + 3]);
          *reinterpret_cast<uint4*>(lo + j) = make_uint4(l[j], l[j + 1], l[j + 2], l[j + 3]);
        }
      } else if constexpr (VEC == 2) {
        *reinterpret_cast<uint2*>(hi) = make_uint2(h[0], h[1]);
        *reinterpret_cast<uint2*>(lo) = make_uint2(l[0], l[1]);
      } else {
        *hi = h[0];
        *lo = l[0];
      }
    } else {
      constexpr int LD = KCOL ? LDK : LDR;
      bf16* d = reinterpret_cast<bf16*>(tile) + (row0 + i * P::STEP) * LD + col0;
      if constexpr (VEC == 1) {
        *d = __float2bfloat16_rn(f[0]);
      } else {
        uint32_t w[VEC / 2];
#pragma unroll
        for (int j = 0; j < VEC / 2; ++j) {
          const __nv_bfloat162 v = __floats2bfloat162_rn(f[2 * j], f[2 * j + 1]);
          w[j] = *reinterpret_cast<const uint32_t*>(&v);
        }
        if constexpr (VEC == 8)
          *reinterpret_cast<uint4*>(d) = make_uint4(w[0], w[1], w[2], w[3]);
        else if constexpr (VEC == 4)
          *reinterpret_cast<uint2*>(d) = make_uint2(w[0], w[1]);
        else
          *reinterpret_cast<uint32_t*>(d) = w[0];
      }
    }
  }
}

// Register-staged operands: the loads of a chunk, then (a chunk later) its
// stores, by copy mode. In bfloat16 the modes that cp.async copies do not
// come here.
template <bool KCOL, class O>
__device__ __forceinline__ void fetch_regs(uint32_t (&reg)[16], const O& o, const Cursor& c,
                                           int K, int KI, int tid) {
  switch (o.mode()) {
    case F32_V4: load_regs<KCOL, float, 4>(reg, o, c, K, KI, tid); break;
    case F32_V1: load_regs<KCOL, float, 1>(reg, o, c, K, KI, tid); break;
    case BF16_V8: load_regs<KCOL, bf16, 8>(reg, o, c, K, KI, tid); break;
    case BF16_V2: load_regs<KCOL, bf16, 2>(reg, o, c, K, KI, tid); break;
    default: load_regs<KCOL, bf16, 1>(reg, o, c, K, KI, tid); break;
  }
}

template <bool TF32, bool KCOL>
__device__ __forceinline__ void place_regs(const uint32_t (&reg)[16], unsigned char* tile,
                                           int mode, int tid) {
  switch (mode) {
    case F32_V4: store_regs<TF32, KCOL, float, 4>(reg, tile, tid); break;
    case F32_V1: store_regs<TF32, KCOL, float, 1>(reg, tile, tid); break;
    case BF16_V8: store_regs<TF32, KCOL, bf16, 8>(reg, tile, tid); break;
    case BF16_V2: store_regs<TF32, KCOL, bf16, 2>(reg, tile, tid); break;
    default: store_regs<TF32, KCOL, bf16, 1>(reg, tile, tid); break;
  }
}

template <bool KCOL, class O>
__device__ __forceinline__ void fetch_async(unsigned char* tile, const O& o, const Cursor& c,
                                            int K, int KI, int tid) {
  if (o.mode() == BF16_V8)
    copy_async<KCOL, 8>(tile, o, c, K, KI, tid);
  else
    copy_async<KCOL, 2>(tile, o, c, K, KI, tid);
}

// One chunk's products in bfloat16: warp (wm, wn) adds its 64 x 32 outputs
template <bool AKC, bool BKC>
__device__ __forceinline__ void chunk_bf16(float (&acc)[4][4][4], const bf16* As, const bf16* Bs,
                                           int wm, int wn, int lane) {
  const int j = lane / 8;
#pragma unroll
  for (int ks = 0; ks < BK / 16; ++ks) {
    uint32_t af[4][4];
#pragma unroll
    for (int mt = 0; mt < 4; ++mt) {
      const int m = wm * 64 + mt * 16;
      if constexpr (AKC)
        rg::ldsm_x4(af[mt], As + (m + lane % 16) * LDK + ks * 16 + (lane / 16) * 8);
      else
        rg::ldsm_x4_trans(af[mt], As + (ks * 16 + (j / 2) * 8 + lane % 8) * LDR + m + (j % 2) * 8);
    }
#pragma unroll
    for (int np = 0; np < 2; ++np) {
      const int n = wn * 32 + np * 16;
      uint32_t bw[4];
      if constexpr (BKC)
        rg::ldsm_x4(bw, Bs + (n + (j / 2) * 8 + lane % 8) * LDK + ks * 16 + (j % 2) * 8);
      else
        rg::ldsm_x4_trans(bw, Bs + (ks * 16 + lane % 16) * LDR + n + (lane / 16) * 8);
#pragma unroll
      for (int mt = 0; mt < 4; ++mt) {
        rg::mma16816(acc[mt][2 * np], af[mt], bw[0], bw[1]);
        rg::mma16816(acc[mt][2 * np + 1], af[mt], bw[2], bw[3]);
      }
    }
  }
}

// One chunk's products in 3xTF32 from the hi and lo tiles
template <bool AKC, bool BKC>
__device__ __forceinline__ void chunk_tf32(float (&acc)[4][4][4], const uint32_t* Ah,
                                           const uint32_t* Bh, int wm, int wn, int lane) {
  constexpr int LO = Cfg<true>::HALF / 4;  // words from a hi tile to its lo tile
  const int g = lane / 4, t = lane % 4, j = lane / 8;
#pragma unroll
  for (int ks = 0; ks < BK / 8; ++ks) {
    uint32_t ah[4][4], al[4][4], bh[4][2], bl[4][2];
#pragma unroll
    for (int mt = 0; mt < 4; ++mt) {
      const int m = wm * 64 + mt * 16;
      if constexpr (AKC) {
        // ldmatrix on 32-bit elements gives the tf32 fragment (a0: row g,
        // col t; a1: row g + 8; a2, a3: col t + 4)
        const uint32_t* p = Ah + (m + lane % 16) * LDK32 + ks * 8 + (lane / 16) * 4;
        rg::ldsm_x4(ah[mt], reinterpret_cast<const bf16*>(p));
        rg::ldsm_x4(al[mt], reinterpret_cast<const bf16*>(p + LO));
      } else {
        const uint32_t* p = Ah + (ks * 8 + t) * LDR + m + g;
        ah[mt][0] = p[0];
        ah[mt][1] = p[8];
        ah[mt][2] = p[4 * LDR];
        ah[mt][3] = p[4 * LDR + 8];
        al[mt][0] = p[LO];
        al[mt][1] = p[LO + 8];
        al[mt][2] = p[LO + 4 * LDR];
        al[mt][3] = p[LO + 4 * LDR + 8];
      }
    }
    // B: b0 row (k) t, b1 row t + 4, column (n) g
#pragma unroll
    for (int np = 0; np < 2; ++np) {
      const int n = wn * 32 + np * 16;
      if constexpr (BKC) {
        const uint32_t* p = Bh + (n + (j / 2) * 8 + lane % 8) * LDK32 + ks * 8 + (j % 2) * 4;
        uint32_t r[4], s[4];
        rg::ldsm_x4(r, reinterpret_cast<const bf16*>(p));
        rg::ldsm_x4(s, reinterpret_cast<const bf16*>(p + LO));
        bh[2 * np][0] = r[0];
        bh[2 * np][1] = r[1];
        bh[2 * np + 1][0] = r[2];
        bh[2 * np + 1][1] = r[3];
        bl[2 * np][0] = s[0];
        bl[2 * np][1] = s[1];
        bl[2 * np + 1][0] = s[2];
        bl[2 * np + 1][1] = s[3];
      } else {
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          const uint32_t* p = Bh + (ks * 8 + t) * LDR + n + q * 8 + g;
          bh[2 * np + q][0] = p[0];
          bh[2 * np + q][1] = p[4 * LDR];
          bl[2 * np + q][0] = p[LO];
          bl[2 * np + q][1] = p[LO + 4 * LDR];
        }
      }
    }
    // lo hi, hi lo, then hi hi, each a pass over an m16 row's four n8
    // tiles, into a sum of this k8 step alone; the step's sum is then added
    // to the accumulator by a float32 add. The tensor cores' own float32
    // sums round toward zero: over the whole of K (2,560 at encoder layer
    // 0) that bias alone misses the float32 tolerance; over one k8 step it
    // does not.
#pragma unroll
    for (int mt = 0; mt < 4; ++mt) {
      float d[4][4] = {};
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) rg::mma1688(d[nt], al[mt], bh[nt][0], bh[nt][1]);
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) rg::mma1688(d[nt], ah[mt], bl[nt][0], bl[nt][1]);
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) rg::mma1688(d[nt], ah[mt], bh[nt][0], bh[nt][1]);
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mt][nt][e] += d[nt][e];
      }
    }
  }
}

// Block (n tile, m tile, z * splits + slice). TF32: 3xTF32 (else bfloat16);
// AKC / BKC: A / B staged as [mn][k] (else [k][mn]); AA / BA: A / B copied
// by cp.async (else through registers). Two blocks a multiprocessor in
// bfloat16 (their 80 KB rings fit, and the second block's warps hide the
// first's waits), one in tf32 (its 147 KB ring).
template <bool TF32, bool AKC, bool BKC, bool AA, bool BA>
__global__ void __launch_bounds__(NT, TF32 ? 1 : 2)
gemm_tc_kernel(const __grid_constant__ Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ unsigned last;
  constexpr int S = Cfg<TF32>::STAGES, TILE = Cfg<TF32>::TILE;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int wm = warp / 4, wn = warp % 4;
  const int z = blockIdx.z / p.splits, slice = blockIdx.z % p.splits;
  const int chunks = (p.K + BK - 1) / BK;
  const int c0 = slice * p.slice_chunks;
  const int n = max(0, min(chunks, c0 + p.slice_chunks) - c0);

  const Side<false> A{p};
  const Side<true> B{p};
  Cursor ca = cursor_at(z, c0 * BK + first_k<AKC>(mode_vec(p.mode_a), tid), p.KI, A);
  Cursor cb = cursor_at(z, c0 * BK + first_k<BKC>(mode_vec(p.mode_b), tid), p.KI, B);
  auto tile_a = [&](int c) { return smem + (c % S) * 2 * TILE; };
  auto tile_b = [&](int c) { return smem + (c % S) * 2 * TILE + TILE; };

  float acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
    }
  }

  uint32_t ra[16], rb[16];
  // the cp.async operands S - 1 chunks ahead, a commit group a chunk
#pragma unroll
  for (int c = 0; c < S - 1; ++c) {
    if (c < n) {
      if constexpr (AA) {
        fetch_async<AKC>(tile_a(c), A, ca, p.K, p.KI, tid);
        advance(ca, BK, p.KI, A);
      }
      if constexpr (BA) {
        fetch_async<BKC>(tile_b(c), B, cb, p.K, p.KI, tid);
        advance(cb, BK, p.KI, B);
      }
    }
    rg::cp_async_commit();
  }
  // the register-staged ones: the first chunk at once
  if (n > 0) {
    if constexpr (!AA) {
      fetch_regs<AKC>(ra, A, ca, p.K, p.KI, tid);
      advance(ca, BK, p.KI, A);
      place_regs<TF32, AKC>(ra, tile_a(0), p.mode_a, tid);
    }
    if constexpr (!BA) {
      fetch_regs<BKC>(rb, B, cb, p.K, p.KI, tid);
      advance(cb, BK, p.KI, B);
      place_regs<TF32, BKC>(rb, tile_b(0), p.mode_b, tid);
    }
  }

  for (int c = 0; c < n; ++c) {
    rg::cp_async_wait<S - 2>();  // chunk c's copies are done
    __syncthreads();             // ... and visible; chunk c - 1's tiles are free
    if (c + S - 1 < n) {
      if constexpr (AA) {
        fetch_async<AKC>(tile_a(c + S - 1), A, ca, p.K, p.KI, tid);
        advance(ca, BK, p.KI, A);
      }
      if constexpr (BA) {
        fetch_async<BKC>(tile_b(c + S - 1), B, cb, p.K, p.KI, tid);
        advance(cb, BK, p.KI, B);
      }
    }
    rg::cp_async_commit();
    // the register-staged operands' next chunk: loaded now, stored once this
    // chunk's products are issued (two chunks ahead wants the registers of
    // the multiprocessor's second block, which hides more)
    const bool more = c + 1 < n;
    if (more) {
      if constexpr (!AA) {
        fetch_regs<AKC>(ra, A, ca, p.K, p.KI, tid);
        advance(ca, BK, p.KI, A);
      }
      if constexpr (!BA) {
        fetch_regs<BKC>(rb, B, cb, p.K, p.KI, tid);
        advance(cb, BK, p.KI, B);
      }
    }
    if constexpr (TF32)
      chunk_tf32<AKC, BKC>(acc, reinterpret_cast<const uint32_t*>(tile_a(c)),
                           reinterpret_cast<const uint32_t*>(tile_b(c)), wm, wn, lane);
    else
      chunk_bf16<AKC, BKC>(acc, reinterpret_cast<const bf16*>(tile_a(c)),
                           reinterpret_cast<const bf16*>(tile_b(c)), wm, wn, lane);
    if (more) {
      if constexpr (!AA) place_regs<TF32, AKC>(ra, tile_a(c + 1), p.mode_a, tid);
      if constexpr (!BA) place_regs<TF32, BKC>(rb, tile_b(c + 1), p.mode_b, tid);
    }
  }
  rg::cp_async_wait<0>();

  if (p.splits > 1) {
    // this slice's partial tile to the workspace (thread-major: each thread
    // reads back what it wrote), then a ticket; the last block of the tile
    // sums the partials in slice order
    const int tile = (z * gridDim.y + blockIdx.y) * gridDim.x + blockIdx.x;
    float* w0 = p.ws + (size_t)tile * p.splits * (BM * BN);
    float* w = w0 + (size_t)slice * (BM * BN) + tid;
#pragma unroll
    for (int i = 0; i < 64; ++i) __stcg(w + i * NT, acc[i / 16][i / 4 % 4][i % 4]);
    __threadfence();
    __syncthreads();
    if (tid == 0) last = atomicAdd(p.tickets + tile, 1u) == (unsigned)(p.splits - 1);
    __syncthreads();
    if (!last) return;
    __threadfence();
    // 16 accumulators at a time, a slice's 16 loads in flight together
#pragma unroll
    for (int i0 = 0; i0 < 64; i0 += 16) {
      float v[16];
#pragma unroll
      for (int i = 0; i < 16; ++i) v[i] = 0.f;
      for (int q = 0; q < p.splits; ++q) {
        const float* wq = w0 + (size_t)q * (BM * BN) + tid;
#pragma unroll
        for (int i = 0; i < 16; ++i) {
          const int r = i0 + i;
          const float x = q == slice ? acc[r / 16][r / 4 % 4][r % 4] : __ldcg(wq + r * NT);
          v[i] = q == 0 ? x : v[i] + x;
        }
      }
#pragma unroll
      for (int i = 0; i < 16; ++i) acc[(i0 + i) / 16][(i0 + i) / 4 % 4][(i0 + i) % 4] = v[i];
    }
    if (tid == 0) p.tickets[tile] = 0;
  }

  // the tile: acc[mt][nt] holds rows g, g + 8 and columns 2t, 2t + 1 of its
  // m16 x n8 piece
  const int g = lane / 4, t = lane % 4;
  float* C = p.c + z * p.cb;
  const int mb = blockIdx.y * BM + wm * 64, nb = blockIdx.x * BN + wn * 32;
#pragma unroll
  for (int mt = 0; mt < 4; ++mt) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = mb + mt * 16 + g + 8 * h;
      if (m >= p.M) continue;
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = nb + nt * 8 + 2 * t + e;
          if (col >= p.N) continue;
          float v = acc[mt][nt][2 * h + e];
          if (p.bias != nullptr) v += p.bias[z * p.biasb + col];
          float* cp = C + m * p.cm + col * p.cn;
          *cp = p.accumulate ? *cp + v : v;
        }
      }
    }
  }
}

template <bool TF32, bool AKC, bool BKC, bool AA, bool BA>
cudaError_t launch_tc(const Params& p, dim3 grid, int smem, cudaStream_t st) {
  const cudaError_t err = rg::reserve_smem<gemm_tc_kernel<TF32, AKC, BKC, AA, BA>>(smem);
  if (err != cudaSuccess) return err;
  gemm_tc_kernel<TF32, AKC, BKC, AA, BA><<<grid, NT, smem, st>>>(p);
  return cudaGetLastError();
}

template <bool TF32, bool AKC, bool BKC>
cudaError_t pick_copies(const Params& p, dim3 grid, int smem, cudaStream_t st, bool aa,
                        bool ba) {
  if constexpr (TF32) {
    return launch_tc<true, AKC, BKC, false, false>(p, grid, smem, st);
  } else {
    if (aa)
      return ba ? launch_tc<false, AKC, BKC, true, true>(p, grid, smem, st)
                : launch_tc<false, AKC, BKC, true, false>(p, grid, smem, st);
    return ba ? launch_tc<false, AKC, BKC, false, true>(p, grid, smem, st)
              : launch_tc<false, AKC, BKC, false, false>(p, grid, smem, st);
  }
}

template <bool TF32>
cudaError_t pick_layout(const Params& p, dim3 grid, int smem, cudaStream_t st, bool akc,
                        bool bkc, bool aa, bool ba) {
  if (akc)
    return bkc ? pick_copies<TF32, true, true>(p, grid, smem, st, aa, ba)
               : pick_copies<TF32, true, false>(p, grid, smem, st, aa, ba);
  return bkc ? pick_copies<TF32, false, true>(p, grid, smem, st, aa, ba)
             : pick_copies<TF32, false, false>(p, grid, smem, st, aa, ba);
}

// Whether an operand's copy mode fits its pointer, strides and extents (the
// rule of ops/blstm_train.py::copy_mode): pieces of VEC elements run along
// the stride-1 axis (k where kcol, else m or n), start on a multiple of
// their size, and never cross the edge of that axis or of a k / KI segment
bool mode_fits(int mode, int kcol, const void* ptr, long long s_batch, long long s_mn,
               long long s_k1, long long s_k0, int mn, int K, int KI) {
  if (mode < F32_V4 || mode > BF16_V1) return false;
  const long long vec = mode == F32_V4 ? 4 : mode == BF16_V8 ? 8 : mode == BF16_V2 ? 2 : 1;
  if (vec == 1) return true;
  const long long bytes = vec * (mode <= F32_V1 ? 4 : 2);
  if (reinterpret_cast<uintptr_t>(ptr) % bytes != 0 || s_batch % vec != 0) return false;
  if (kcol)
    return s_k0 == 1 && s_mn % vec == 0 && s_k1 % vec == 0 && KI % vec == 0 && K % vec == 0;
  return s_mn == 1 && s_k1 % vec == 0 && s_k0 % vec == 0 && mn % vec == 0;
}

// ---------------------------------------------------------------------------
// the SIMT product this kernel replaced, kept to be timed against it
// ---------------------------------------------------------------------------

constexpr int SM_ = 64, SN_ = 64, SK_ = 16;

struct Strides {
  long long ab, am, ak1, ak0;  // A: batch, m, k outer, k inner
  long long bb, bk1, bk0, bn;  // B: batch, k outer, k inner, n
  long long cb, cm, cn;        // C: batch, m, n
  long long biasb;             // bias: batch
};

template <typename TA, typename TB>
__global__ void __launch_bounds__(256)
gemm_simt_kernel(const TA* __restrict__ A, const TB* __restrict__ B, float* __restrict__ C,
                 const float* __restrict__ bias, int M, int N, int K, int KI, Strides s,
                 int round_bf16, int accumulate) {
  __shared__ float As[SK_][SM_ + 4];
  __shared__ float Bs[SK_][SN_ + 4];
  const int z = blockIdx.z;
  const int m0 = blockIdx.y * SM_, n0 = blockIdx.x * SN_;
  const int tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;
  A += z * s.ab;
  B += z * s.bb;
  C += z * s.cb;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  }

  for (int k0 = 0; k0 < K; k0 += SK_) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int idx = tid + i * 256;
      // A tile: 64 rows x 16 k; B tile: 16 k x 64 columns
      {
        const int mm = idx / SK_, kk = idx % SK_;
        const int m = m0 + mm, k = k0 + kk;
        float v = 0.f;
        if (m < M && k < K)
          v = rg::to_f(A[m * s.am + (long long)(k / KI) * s.ak1 + (long long)(k % KI) * s.ak0]);
        if (round_bf16) v = rg::rnd<__nv_bfloat16>(v);
        As[kk][mm] = v;
      }
      {
        const int kk = idx / SN_, nn = idx % SN_;
        const int k = k0 + kk, n = n0 + nn;
        float v = 0.f;
        if (k < K && n < N)
          v = rg::to_f(B[(long long)(k / KI) * s.bk1 + (long long)(k % KI) * s.bk0 + n * s.bn]);
        if (round_bf16) v = rg::rnd<__nv_bfloat16>(v);
        Bs[kk][nn] = v;
      }
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < SK_; ++kk) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = As[kk][ty * 4 + i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = Bs[kk][tx * 4 + j];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty * 4 + i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx * 4 + j;
      if (n >= N) continue;
      float v = acc[i][j];
      if (bias != nullptr) v += bias[z * s.biasb + n];
      float* c = C + m * s.cm + n * s.cn;
      *c = accumulate ? *c + v : v;
    }
  }
}

template <typename TA, typename TB>
cudaError_t launch_simt(const void* A, const void* B, float* C, const float* bias, int batch,
                        int M, int N, int K, int KI, const Strides& s, int round_bf16,
                        int accumulate, cudaStream_t stream) {
  const dim3 grid((N + SN_ - 1) / SN_, (M + SM_ - 1) / SM_, batch);
  gemm_simt_kernel<TA, TB><<<grid, 256, 0, stream>>>(static_cast<const TA*>(A),
                                                     static_cast<const TB*>(B), C, bias, M, N,
                                                     K, KI, s, round_bf16, accumulate);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// the column sum
// ---------------------------------------------------------------------------

// out[n] = sum over m of X[m, n]: a block of 32 x 32 threads per 32 columns
__global__ void __launch_bounds__(1024)
colsum_kernel(const float* __restrict__ X, float* __restrict__ out, int M, int N) {
  __shared__ float part[32][33];
  const int n = blockIdx.x * 32 + threadIdx.x;
  float acc = 0.f;
  if (n < N) {
    for (int m = threadIdx.y; m < M; m += 32) acc += X[(size_t)m * N + n];
  }
  part[threadIdx.y][threadIdx.x] = acc;
  __syncthreads();
  if (threadIdx.y == 0 && n < N) {
    float v = 0.f;
    for (int r = 0; r < 32; ++r) v += part[r][threadIdx.x];
    out[n] = v;
  }
}

}  // namespace

// The tensor-core product. mode_a / mode_b: the copy modes (Mode); a_kcol /
// b_kcol: staged k-contiguous; tf32: 3xTF32 (else bfloat16, both operands
// rounded to it); splits, slice_chunks, smem: ops/blstm_train.py::gemm_plan;
// ws (splits x tiles x 128 x 128 float32) and tickets (one a tile, zero)
// only where splits > 1.
extern "C" int gemm(const void* A, const void* B, void* C, const void* bias, void* ws,
                    void* tickets, int batch, int M, int N, int K, int KI, long long sab,
                    long long sam, long long sak1, long long sak0, long long sbb,
                    long long sbk1, long long sbk0, long long sbn, long long scb,
                    long long scm, long long scn, long long sbias, int mode_a, int a_kcol,
                    int mode_b, int b_kcol, int tf32, int accumulate, int splits,
                    int slice_chunks, int smem, void* stream) {
  const int chunks = (K + BK - 1) / BK;
  if (batch < 1 || M < 0 || N < 0 || K < 0 || KI < 1 || splits < 1 || slice_chunks < 1 ||
      (long long)batch * splits > 65535 || (M + BM - 1) / BM > 65535 ||
      (long long)splits * slice_chunks < chunks ||
      (splits > 1 && (long long)(splits - 1) * slice_chunks >= chunks))
    return (int)cudaErrorInvalidValue;
  if (!mode_fits(mode_a, a_kcol, A, sab, sam, sak1, sak0, M, K, KI) ||
      !mode_fits(mode_b, b_kcol, B, sbb, sbn, sbk1, sbk0, N, K, KI))
    return (int)cudaErrorInvalidValue;
  const int need = tf32 ? Cfg<true>::STAGES * 2 * Cfg<true>::TILE
                        : Cfg<false>::STAGES * 2 * Cfg<false>::TILE;
  if (smem < need || (splits > 1 && (ws == nullptr || tickets == nullptr)))
    return (int)cudaErrorInvalidValue;
  if (M == 0 || N == 0) return 0;
  const Params p{A, B, static_cast<float*>(C), static_cast<const float*>(bias),
                 static_cast<float*>(ws), static_cast<unsigned*>(tickets),
                 sab, sam, sak1, sak0, sbb, sbk1, sbk0, sbn, scb, scm, scn, sbias,
                 sak1 - KI * sak0, sbk1 - KI * sbk0,
                 M, N, K, KI, mode_a, mode_b, splits, slice_chunks, accumulate};
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM, batch * splits);
  const auto st = static_cast<cudaStream_t>(stream);
  // cp.async copies the bfloat16 operands in the bfloat16 type
  const bool aa = !tf32 && (mode_a == BF16_V8 || mode_a == BF16_V2);
  const bool ba = !tf32 && (mode_b == BF16_V8 || mode_b == BF16_V2);
  return (int)(tf32 ? pick_layout<true>(p, grid, smem, st, a_kcol, b_kcol, aa, ba)
                    : pick_layout<false>(p, grid, smem, st, a_kcol, b_kcol, aa, ba));
}

// The SIMT product with the same contract (the replaced kernel, for timing).
extern "C" int gemm_simt(const void* A, const void* B, void* C, const void* bias, int batch,
                         int M, int N, int K, int KI, long long sab, long long sam,
                         long long sak1, long long sak0, long long sbb, long long sbk1,
                         long long sbk0, long long sbn, long long scb, long long scm,
                         long long scn, long long sbias, int a_bf16, int b_bf16,
                         int round_bf16, int accumulate, void* stream) {
  if (batch < 1 || M < 0 || N < 0 || K < 0 || KI < 1 || batch > 65535)
    return (int)cudaErrorInvalidValue;
  if (M == 0 || N == 0) return 0;
  const Strides s{sab, sam, sak1, sak0, sbb, sbk1, sbk0, sbn, scb, scm, scn, sbias};
  const auto st = static_cast<cudaStream_t>(stream);
  auto c = static_cast<float*>(C);
  auto b = static_cast<const float*>(bias);
  using bf = __nv_bfloat16;
  if (a_bf16 && b_bf16)
    return (int)launch_simt<bf, bf>(A, B, c, b, batch, M, N, K, KI, s, round_bf16, accumulate,
                                    st);
  if (a_bf16)
    return (int)launch_simt<bf, float>(A, B, c, b, batch, M, N, K, KI, s, round_bf16,
                                       accumulate, st);
  if (b_bf16)
    return (int)launch_simt<float, bf>(A, B, c, b, batch, M, N, K, KI, s, round_bf16,
                                       accumulate, st);
  return (int)launch_simt<float, float>(A, B, c, b, batch, M, N, K, KI, s, round_bf16,
                                        accumulate, st);
}

extern "C" int colsum(const void* X, void* out, int M, int N, void* stream) {
  if (M < 0 || N < 1) return (int)cudaErrorInvalidValue;
  colsum_kernel<<<(N + 31) / 32, dim3(32, 32), 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(X), static_cast<float*>(out), M, N);
  return (int)cudaGetLastError();
}
