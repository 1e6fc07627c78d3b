// TPU-like dense GEMM on Hopper: O (M, N) = A (M, K) · B (K, N), both
// row-major, f32 or bf16, accumulated in f32 and rounded once to the
// operands' type.
//
// Replaces _gemm_kernel of src/repro/kernels/gemm.py. On the TPU each
// (bm, bn) output block keeps an f32 accumulator in VMEM scratch across the
// K grid dimension, which runs in order on one core, and feeds the MXU
// (bm, bk) x (bk, bn) tiles. Here the sequential K grid becomes the K loop
// inside one block: the shared tiled kernel (tiled_gemm.cuh) owns a
// 128 x 128 output tile, stages 128 x 8 slices of A and B in shared memory
// and keeps the accumulator in registers (8 x 8 per thread), with no tile
// skipping (nullptr live masks). bf16 operands convert to f32 as they are
// loaded.
//
// Bound: 2·M·K·N operations. The FMAs are true f32 on the CUDA cores, never
// TF32 on the tensor cores, so the card's f32 rate (67 TFLOP/s on the H100
// SXM), not its memory, bounds it at every main-path shape; the register
// blocking gives each element loaded from shared memory 8 FMAs.
#include "tiled_gemm.cuh"

namespace rt {

template <typename T>
int gemm(const T* a, const T* b, T* out, int M, int K, int N,
         cudaStream_t stream) {
  launch_tiled_gemm<T, T, T>(a, b, out, M, N, K, nullptr, 1, stream);
  return (int)cudaGetLastError();
}

}  // namespace rt

// ------------------------------------------------------------- C entry
// Pointers arrive as void* (ctypes c_void_p); dtype is rt::kF32 or
// rt::kBF16 and applies to A, B and the output alike. Returns
// cudaGetLastError() after the launch.
extern "C" int gemm_launch(const void* a, const void* b, void* out, int M,
                           int K, int N, int dtype, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  if (dtype == rt::kF32)
    return rt::gemm<float>(static_cast<const float*>(a),
                           static_cast<const float*>(b),
                           static_cast<float*>(out), M, K, N, s);
  if (dtype == rt::kBF16)
    return rt::gemm<__nv_bfloat16>(static_cast<const __nv_bfloat16*>(a),
                                   static_cast<const __nv_bfloat16*>(b),
                                   static_cast<__nv_bfloat16*>(out), M, K, N,
                                   s);
  return (int)cudaErrorInvalidValue;
}
