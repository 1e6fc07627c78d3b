// Shared-memory tiled f32 product: the dense GEMM (gemm.cu) and the
// contraction step of SpMM's sparse body (A · table).
//
// C (M, N) = A (M, K) · B (K, N). A and B are f32 or bf16 (B is SpMM's f32
// table, or the dense operand of the GEMM); bf16 converts to f32 as it is
// loaded. Each block owns a 128 x 128 output tile; each of its 256 threads
// keeps an 8 x 8 register block and walks K in steps of 8 through shared
// memory, so every A and B element loaded from device memory feeds 8 FMAs
// from registers.
//
// Column skipping: col_live holds one count per window of col_win columns;
// nullptr means every window is live. A tile whose columns all fall in dead
// windows never reads A or B and writes zeros. Inside a live tile, elements
// of a dead window are written as zero as well, so the result does not
// depend on the tile size: a dead window is zero, as on the TPU.
#pragma once

#include "common.cuh"

namespace rt {

constexpr int TG_M = 128, TG_N = 128, TG_K = 8, TG_THREADS = 256;

__device__ __forceinline__ bool window_live(const int* live, int win, int i) {
  return live == nullptr || live[i / win] > 0;
}

template <typename TA, typename TB, typename TO>
__global__ void __launch_bounds__(TG_THREADS)
    tiled_gemm_kernel(const TA* __restrict__ A, const TB* __restrict__ B,
                      TO* __restrict__ C, int M, int N, int K,
                      const int* __restrict__ col_live, int col_win) {
  __shared__ float As[TG_K][TG_M];
  __shared__ float Bs[TG_K][TG_N];
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int m0 = blockIdx.y * TG_M, n0 = blockIdx.x * TG_N;

  // Threads 0..127 probe the tile's columns.
  const int any_col = __syncthreads_or(
      tid < TG_N && n0 + tid < N && window_live(col_live, col_win, n0 + tid));

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  if (any_col) {
    for (int k0 = 0; k0 < K; k0 += TG_K) {
      {  // A tile: each thread loads 4 consecutive k of one row.
        const int r = tid / 2, kq = (tid % 2) * 4;
        const int m = m0 + r;
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int k = k0 + kq + q;
          As[kq + q][r] =
              (m < M && k < K) ? to_f32(A[(size_t)m * K + k]) : 0.f;
        }
      }
      {  // B tile: a warp reads 128 consecutive columns.
        const int kr = tid / 32, nq = (tid % 32) * 4;
        const int k = k0 + kr;
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int n = n0 + nq + q;
          Bs[kr][nq + q] =
              (k < K && n < N) ? to_f32(B[(size_t)k * N + n]) : 0.f;
        }
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < TG_K; ++kk) {
        float a[8], b[8];
#pragma unroll
        for (int i = 0; i < 8; ++i) a[i] = As[kk][ty * 8 + i];
#pragma unroll
        for (int j = 0; j < 8; ++j) b[j] = Bs[kk][tx * 8 + j];
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
      __syncthreads();
    }
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int m = m0 + ty * 8 + i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int n = n0 + tx * 8 + j;
      if (n >= N) continue;
      const bool ok = window_live(col_live, col_win, n);
      C[(size_t)m * N + n] = from_f32<TO>(ok ? acc[i][j] : 0.f);
    }
  }
}

template <typename TA, typename TB, typename TO>
inline void launch_tiled_gemm(const TA* A, const TB* B, TO* C, int M,
                              int N, int K, const int* col_live, int col_win,
                              cudaStream_t stream) {
  const dim3 grid((N + TG_N - 1) / TG_N, (M + TG_M - 1) / TG_M);
  tiled_gemm_kernel<TA, TB, TO><<<grid, TG_THREADS, 0, stream>>>(
      A, B, C, M, N, K, col_live, col_win);
}

}  // namespace rt
