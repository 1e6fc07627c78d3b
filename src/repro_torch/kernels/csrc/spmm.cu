// EIE-like SpMM on Hopper: dense A (M, K) times B held as N column fibers
// (ids -> K, capacity cap, PAD_ID = -1 padding) gives O (M, N).
//
// Replaces the two TPU bodies of src/repro/kernels/spmm.py.
//
// Sparse body (replaces _spmm_sparse_kernel). On the TPU the kernel
// scatters B's live fiber chunks into a (K, bn) VMEM table at the first M
// step of each N block and reuses it for every later M step; that relies
// on the grid running in order on one core. CUDA blocks run in parallel
// and share no scratch, so here the table is built once, for all of B, by
// a kernel of its own (fiber_table.cuh, shared with the inner-product
// SpGEMM) into a (K, N) f32 buffer in device memory that the wrapper
// zeroes; the contraction kernel (tiled_gemm.cuh) then
// computes A · table. The scatter walks only the live capacity chunks of
// each fiber block (block_chunk_counts).
// Bound: the contraction does 2·M·K·N f32 FMAs-worth of work on CUDA cores
// (the table is dense), against the 2·M·nnz(B) the data needs; its design
// answers the FMA bound with 8 x 8 register blocking over shared-memory
// tiles. N blocks whose chunk count is 0 write zeros without reading A.
//
// Reference body (replaces _spmm_reference_kernel). The TPU expands every
// (bn, cap) fiber block to a dense (bn, K) tile for every output tile and
// contracts it on the MXU. Here one block owns a 256 x 32 output tile and
// never expands: each warp owns 4 output columns and walks their fibers
// (ids ascending, PAD_ID skipped), and for each nonzero (k, v) adds
// v · A[:, k] over its 256 rows. A's row block is staged in shared memory
// in chunks of 32 k, so those gathers hit shared memory, not device
// memory. Bound: 2·M·nnz(B) FMAs, each needing one shared-memory load, so
// shared-memory and issue bandwidth, not the FMA rate, limit it.
#include "fiber_table.cuh"
#include "tiled_gemm.cuh"

namespace rt {

// ------------------------------------------------------------ sparse body
template <typename T>
int spmm_sparse(const T* a, const T* vals, const int* ids, const int* counts,
                float* table, T* out, int M, int K, int N, int cap, int bn,
                int fc, cudaStream_t stream) {
  const cudaError_t err = launch_fiber_table_scatter<T>(
      vals, ids, counts, table, K, N, cap, bn, fc, stream);
  if (err != cudaSuccess) return (int)err;
  launch_tiled_gemm<T, float, T>(a, table, out, M, N, K, counts, bn,
                                 stream);
  return (int)cudaGetLastError();
}

// --------------------------------------------------------- reference body
constexpr int SR_M = 256, SR_N = 32, SR_KC = 32, SR_THREADS = 256;
constexpr int SR_COLS = SR_N / (SR_THREADS / 32);  // columns per warp
constexpr int SR_ROWS = SR_M / 32;                 // rows per lane
static_assert(SR_N == SR_KC, "the output tile reuses the A staging buffer");

template <typename T>
__global__ void __launch_bounds__(SR_THREADS)
    spmm_reference_kernel(const T* __restrict__ A, const T* __restrict__ vals,
                          const int* __restrict__ ids, T* __restrict__ out,
                          int M, int K, int N, int cap) {
  __shared__ float As[SR_KC][SR_M + 1];  // As[k][m]; +1 keeps stores
                                         // free of bank conflicts
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int m0 = blockIdx.y * SR_M, n0 = blockIdx.x * SR_N;

  float acc[SR_COLS][SR_ROWS];
  int next[SR_COLS];  // first fiber slot not yet consumed, per column
#pragma unroll
  for (int q = 0; q < SR_COLS; ++q) {
    next[q] = 0;
#pragma unroll
    for (int r = 0; r < SR_ROWS; ++r) acc[q][r] = 0.f;
  }

  for (int k0 = 0; k0 < K; k0 += SR_KC) {
    for (int idx = threadIdx.x; idx < SR_M * SR_KC; idx += SR_THREADS) {
      const int r = idx / SR_KC, c = idx % SR_KC;
      const int m = m0 + r, k = k0 + c;
      As[c][r] = (m < M && k < K) ? to_f32(A[(size_t)m * K + k]) : 0.f;
    }
    __syncthreads();
    const int k_end = k0 + SR_KC;
#pragma unroll
    for (int q = 0; q < SR_COLS; ++q) {
      const int n = n0 + warp * SR_COLS + q;  // warp-uniform
      if (n >= N) continue;
      const int* fid = ids + (size_t)n * cap;
      const T* fv = vals + (size_t)n * cap;
      int p = next[q];
      for (; p < cap; ++p) {
        const int id = fid[p];
        if (id >= k_end) break;  // ids ascend: the rest is for later chunks
        if (id < k0) continue;   // PAD_ID
        const float v = to_f32(fv[p]);
        const float* col = &As[id - k0][lane];
#pragma unroll
        for (int r = 0; r < SR_ROWS; ++r)
          acc[q][r] = fmaf(col[32 * r], v, acc[q][r]);
      }
      next[q] = p;
    }
    __syncthreads();
  }

  // Stage the tile through shared memory so rows are written coalesced.
  float(*Os)[SR_M + 1] = As;  // Os[n][m]
#pragma unroll
  for (int q = 0; q < SR_COLS; ++q)
#pragma unroll
    for (int r = 0; r < SR_ROWS; ++r)
      Os[warp * SR_COLS + q][lane + 32 * r] = acc[q][r];
  __syncthreads();
  for (int idx = threadIdx.x; idx < SR_M * SR_N; idx += SR_THREADS) {
    const int r = idx / SR_N, c = idx % SR_N;
    const int m = m0 + r, n = n0 + c;
    if (m < M && n < N) out[(size_t)m * N + n] = from_f32<T>(Os[c][r]);
  }
}

template <typename T>
int spmm_reference(const T* a, const T* vals, const int* ids, T* out, int M,
                   int K, int N, int cap, cudaStream_t stream) {
  const dim3 grid((N + SR_N - 1) / SR_N, (M + SR_M - 1) / SR_M);
  spmm_reference_kernel<T>
      <<<grid, SR_THREADS, 0, stream>>>(a, vals, ids, out, M, K, N, cap);
  return (int)cudaGetLastError();
}

}  // namespace rt

// ------------------------------------------------------------- C entries
// Pointers arrive as void* (ctypes c_void_p); dtype is rt::kF32 or
// rt::kBF16 and applies to A, the fiber values and the output alike.
// Each returns cudaGetLastError() after its launches.
extern "C" int spmm_sparse_launch(const void* a, const void* vals,
                                  const void* ids, const void* chunk_counts,
                                  void* table, void* out, int M, int K, int N,
                                  int cap, int bn, int fc, int dtype,
                                  void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  const int* i = static_cast<const int*>(ids);
  const int* c = static_cast<const int*>(chunk_counts);
  float* t = static_cast<float*>(table);
  if (dtype == rt::kF32)
    return rt::spmm_sparse<float>(
        static_cast<const float*>(a), static_cast<const float*>(vals), i, c,
        t, static_cast<float*>(out), M, K, N, cap, bn, fc, s);
  if (dtype == rt::kBF16)
    return rt::spmm_sparse<__nv_bfloat16>(
        static_cast<const __nv_bfloat16*>(a),
        static_cast<const __nv_bfloat16*>(vals), i, c, t,
        static_cast<__nv_bfloat16*>(out), M, K, N, cap, bn, fc, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" int spmm_reference_launch(const void* a, const void* vals,
                                     const void* ids, void* out, int M, int K,
                                     int N, int cap, int dtype,
                                     void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  const int* i = static_cast<const int*>(ids);
  if (dtype == rt::kF32)
    return rt::spmm_reference<float>(
        static_cast<const float*>(a), static_cast<const float*>(vals), i,
        static_cast<float*>(out), M, K, N, cap, s);
  if (dtype == rt::kBF16)
    return rt::spmm_reference<__nv_bfloat16>(
        static_cast<const __nv_bfloat16*>(a),
        static_cast<const __nv_bfloat16*>(vals), i,
        static_cast<__nv_bfloat16*>(out), M, K, N, cap, s);
  return (int)cudaErrorInvalidValue;
}
