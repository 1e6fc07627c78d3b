// Helpers shared by the port's CUDA kernels (built for sm_90a by
// kernels/_build.py). Every kernel accumulates in f32 with fmaf: no TF32,
// no tensor cores, so sums match the JAX reference's true-f32 accumulation
// up to summation order.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>

namespace rt {

// Element-type codes shared with the Python wrappers.
enum : int { kF32 = 0, kBF16 = 1 };

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

}  // namespace rt
