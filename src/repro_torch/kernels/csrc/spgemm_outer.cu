// OuterSPACE-like outer-product SpGEMM on Hopper: A held as K fibers
// (ids -> M, capacity cap_a) times B held as K fibers (ids -> N, capacity
// cap_b) gives O (M, N) = sum over k of outer(A[k, :], B[k, :]).
//
// Replaces the two TPU bodies of src/repro/kernels/spgemm_outer.py.
//
// Sparse body (replaces _outer_sparse_kernel). On the TPU both operands
// are scattered into resident (M, K) and (N, K) VMEM tables at grid step
// (0, 0) and every later step reads them; that relies on the grid running
// in order on one core. Here a kernel of its own (outer_scatter_kernel)
// builds both tables in device memory, zeroed by the wrapper, and the tile
// kernel (tiled_gemm.cuh) then contracts table rows: O = TA · TBᵀ. Each
// fiber owns one table column and its ids are unique, so the scatter needs
// no atomics. The "auto" rule keeps 4·K·(M+N) bytes of tables under 8 MiB,
// so they stay in the 50 MB L2. Bound: 2·M·N·K FMAs-worth on CUDA cores
// (the tables are dense) against the 2·Σk nnzA(k)·nnzB(k) the data needs;
// tiles whose M or N window holds no nonzero (block_window_nnz) write
// zeros without reading the tables.
//
// Reference body (replaces _outer_reference_kernel). One block owns a
// 128 x 128 output tile and walks K in blocks of 32 fibers: it expands the
// A entries whose ids fall in its M window and the B entries in its N
// window into shared-memory tiles (one warp per fiber, lanes across the
// capacity) and applies a rank-32 update to 8 x 8 register accumulators,
// skipping the update when either expansion is empty. Every block scans
// every fiber slot of both operands, so at large capacities (5000 and 2504
// at synthetic_dense) the scan, not the update, bounds it.
#include "tiled_gemm.cuh"

namespace rt {

// ------------------------------------------------------------ sparse body
template <typename TV>
__global__ void outer_scatter_kernel(const TV* __restrict__ vals,
                                     const int* __restrict__ ids, int K,
                                     int cap, int minor,
                                     float* __restrict__ table) {
  // One warp per fiber k; table is (minor, K), entry (id, k).
  const int k = blockIdx.x * (blockDim.x / 32) + threadIdx.x / 32;
  if (k >= K) return;
  for (int c = threadIdx.x % 32; c < cap; c += 32) {
    const size_t off = (size_t)k * cap + c;
    const int id = ids[off];
    if (id >= 0 && id < minor) table[(size_t)id * K + k] = to_f32(vals[off]);
  }
}

template <typename T>
int outer_sparse(const T* a_vals, const int* a_ids, int cap_a,
                 const T* b_vals, const int* b_ids, int cap_b,
                 const int* a_win, int bm, const int* b_win, int bn,
                 float* ta, float* tb, T* out, int M, int K, int N,
                 cudaStream_t stream) {
  if (K > 0) {
    const int blocks = (K + 7) / 8;  // 8 warps of 256 threads
    outer_scatter_kernel<T><<<blocks, 256, 0, stream>>>(a_vals, a_ids, K,
                                                        cap_a, M, ta);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    outer_scatter_kernel<T><<<blocks, 256, 0, stream>>>(b_vals, b_ids, K,
                                                        cap_b, N, tb);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  launch_tiled_gemm<float, float, true, T>(ta, tb, out, M, N, K, a_win, bm,
                                           b_win, bn, stream);
  return (int)cudaGetLastError();
}

// --------------------------------------------------------- reference body
constexpr int OR_M = 128, OR_N = 128, OR_K = 32, OR_THREADS = 256;
static_assert(OR_M == OR_N, "the expansion tiles are zeroed together");

template <typename T>
__global__ void __launch_bounds__(OR_THREADS) outer_reference_kernel(
    const T* __restrict__ a_vals, const int* __restrict__ a_ids, int cap_a,
    const T* __restrict__ b_vals, const int* __restrict__ b_ids, int cap_b,
    T* __restrict__ out, int M, int N, int K) {
  __shared__ float Ea[OR_K][OR_M];  // Ea[k][m - m0]
  __shared__ float Eb[OR_K][OR_N];  // Eb[k][n - n0]
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int tx = tid % 16, ty = tid / 16;
  const int m0 = blockIdx.y * OR_M, n0 = blockIdx.x * OR_N;

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  for (int kb = 0; kb < K; kb += OR_K) {
    for (int i = tid; i < OR_K * OR_M; i += OR_THREADS) {
      (&Ea[0][0])[i] = 0.f;
      (&Eb[0][0])[i] = 0.f;
    }
    __syncthreads();
    const int kn = min(OR_K, K - kb);
    bool hit_a = false, hit_b = false;
    for (int kk = warp; kk < kn; kk += OR_THREADS / 32) {
      const size_t fa = (size_t)(kb + kk) * cap_a;
      for (int c = lane; c < cap_a; c += 32) {
        const int id = a_ids[fa + c];
        const int r = id - m0;
        if (id >= 0 && r >= 0 && r < OR_M) {
          Ea[kk][r] = to_f32(a_vals[fa + c]);
          hit_a = true;
        }
      }
      const size_t fb = (size_t)(kb + kk) * cap_b;
      for (int c = lane; c < cap_b; c += 32) {
        const int id = b_ids[fb + c];
        const int r = id - n0;
        if (id >= 0 && r >= 0 && r < OR_N) {
          Eb[kk][r] = to_f32(b_vals[fb + c]);
          hit_b = true;
        }
      }
    }
    const int live_a = __syncthreads_or(hit_a);
    const int live_b = __syncthreads_or(hit_b);
    if (live_a && live_b) {
#pragma unroll 4
      for (int kk = 0; kk < OR_K; ++kk) {
        float a[8], b[8];
#pragma unroll
        for (int i = 0; i < 8; ++i) a[i] = Ea[kk][ty * 8 + i];
#pragma unroll
        for (int j = 0; j < 8; ++j) b[j] = Eb[kk][tx * 8 + j];
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int m = m0 + ty * 8 + i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int n = n0 + tx * 8 + j;
      if (n < N) out[(size_t)m * N + n] = from_f32<T>(acc[i][j]);
    }
  }
}

template <typename T>
int outer_reference(const T* a_vals, const int* a_ids, int cap_a,
                    const T* b_vals, const int* b_ids, int cap_b, T* out,
                    int M, int K, int N, cudaStream_t stream) {
  const dim3 grid((N + OR_N - 1) / OR_N, (M + OR_M - 1) / OR_M);
  outer_reference_kernel<T><<<grid, OR_THREADS, 0, stream>>>(
      a_vals, a_ids, cap_a, b_vals, b_ids, cap_b, out, M, N, K);
  return (int)cudaGetLastError();
}

}  // namespace rt

// ------------------------------------------------------------- C entries
// Pointers arrive as void* (ctypes c_void_p); dtype is rt::kF32 or
// rt::kBF16 and applies to both operands' values and the output. Each
// returns cudaGetLastError() after its launches.
extern "C" int outer_sparse_launch(const void* a_vals, const void* a_ids,
                                   int cap_a, const void* b_vals,
                                   const void* b_ids, int cap_b,
                                   const void* a_win, int bm,
                                   const void* b_win, int bn, void* ta,
                                   void* tb, void* out, int M, int K, int N,
                                   int dtype, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  const int* ai = static_cast<const int*>(a_ids);
  const int* bi = static_cast<const int*>(b_ids);
  const int* aw = static_cast<const int*>(a_win);
  const int* bw = static_cast<const int*>(b_win);
  float* fa = static_cast<float*>(ta);
  float* fb = static_cast<float*>(tb);
  if (dtype == rt::kF32)
    return rt::outer_sparse<float>(
        static_cast<const float*>(a_vals), ai, cap_a,
        static_cast<const float*>(b_vals), bi, cap_b, aw, bm, bw, bn, fa, fb,
        static_cast<float*>(out), M, K, N, s);
  if (dtype == rt::kBF16)
    return rt::outer_sparse<__nv_bfloat16>(
        static_cast<const __nv_bfloat16*>(a_vals), ai, cap_a,
        static_cast<const __nv_bfloat16*>(b_vals), bi, cap_b, aw, bm, bw, bn,
        fa, fb, static_cast<__nv_bfloat16*>(out), M, K, N, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" int outer_reference_launch(const void* a_vals, const void* a_ids,
                                      int cap_a, const void* b_vals,
                                      const void* b_ids, int cap_b, void* out,
                                      int M, int K, int N, int dtype,
                                      void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  const int* ai = static_cast<const int*>(a_ids);
  const int* bi = static_cast<const int*>(b_ids);
  if (dtype == rt::kF32)
    return rt::outer_reference<float>(
        static_cast<const float*>(a_vals), ai, cap_a,
        static_cast<const float*>(b_vals), bi, cap_b,
        static_cast<float*>(out), M, K, N, s);
  if (dtype == rt::kBF16)
    return rt::outer_reference<__nv_bfloat16>(
        static_cast<const __nv_bfloat16*>(a_vals), ai, cap_a,
        static_cast<const __nv_bfloat16*>(b_vals), bi, cap_b,
        static_cast<__nv_bfloat16*>(out), M, K, N, s);
  return (int)cudaErrorInvalidValue;
}
