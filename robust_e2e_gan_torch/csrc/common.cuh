// Helpers shared by the kernels of robust_e2e_gan_torch.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace rg {

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// Round a float32 value to the compute type T and back: the points where
// the plain version stores an intermediate in T (identity for float).
template <typename T> __device__ __forceinline__ float rnd(float x) {
  return to_f(from_f<T>(x));
}

__device__ __forceinline__ float sigmoid(float x) { return 1.f / (1.f + expf(-x)); }

// log(exp(a) + exp(b)) for finite a, b: the formula of jnp.logaddexp and
// torch.logaddexp.
__device__ __forceinline__ float logaddexp(float a, float b) {
  return fmaxf(a, b) + log1pf(expf(-fabsf(a - b)));
}

constexpr float LOG_ZERO = -1e10f;

// Lets Kernel take `bytes` of dynamic shared memory. The attribute is set
// only past the 48 KB every kernel may take and only when it grows, once
// per kernel and process, not on every launch: kernels launched once per
// beam step call this each time.
template <auto Kernel>
cudaError_t reserve_smem(size_t bytes) {
  static size_t reserved = 48 * 1024;
  if (bytes <= reserved) return cudaSuccess;
  const cudaError_t err =
      cudaFuncSetAttribute(Kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err == cudaSuccess) reserved = bytes;
  return err;
}

}  // namespace rg
