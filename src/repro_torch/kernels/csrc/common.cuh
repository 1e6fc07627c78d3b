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

// The id of a padding slot in a fiber (formats/ell.py PAD_ID).
constexpr int PAD_ID = -1;

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

// ------------------------------------------------------------ cp.async
// Asynchronous copies from device to shared memory (sm_80 and later):
// `bytes` is 4, 8 or 16, and both addresses are aligned to it.
__device__ __forceinline__ void cp_async(void* dst, const void* src,
                                         int bytes) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  if (bytes == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
                 "l"(src));
  else if (bytes == 8)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s),
                 "l"(src));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
                 "l"(src));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
// Wait until at most n of this thread's committed groups are in flight.
template <int n>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(n) : "memory");
}
__device__ __forceinline__ void cp_async_wait_all() { cp_async_wait<0>(); }

// Call fn with a null pointer to the element type that `dtype` (kF32 or
// kBF16) names, so a C entry writes its launch once for both types.
template <typename Fn>
int dtype_dispatch(int dtype, Fn&& fn) {
  return dtype == kBF16 ? fn(static_cast<__nv_bfloat16*>(nullptr))
                        : fn(static_cast<float*>(nullptr));
}

}  // namespace rt
