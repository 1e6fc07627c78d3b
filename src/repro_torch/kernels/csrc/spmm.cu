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
// contracts it on the MXU. Here it is the chunked rank-update kernel of
// chunk_update.cuh with A as dense rows: per 128 x 128 output tile, a walk
// over the 32-wide K chunks some B fiber of the N tile holds (the
// wrapper's pre-pass), A's 128 x 32 chunk copied into shared memory with
// cp.async and B's fibers expanded over it, each chunk a rank-32 update of
// 8 x 8 register blocks. "auto" sends SpMM here only when B's fibers are
// more than half full, so the dense update wastes little: the f32 FMA rate
// bounds it.
#include <type_traits>

#include "chunk_update.cuh"
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

// spmm_reference_launch scans B (fiber kinds, chunk starts, each N tile's
// live chunks, into b_kind, b_starts and b_live, the last zeroed) before
// the rank update.
extern "C" int spmm_reference_launch(const void* a, const void* vals,
                                     const void* ids, void* b_kind,
                                     void* b_starts, void* b_live, int cap,
                                     void* out, int M, int K, int N,
                                     int a_gran, int dtype, void* stream) {
  if (dtype != rt::kF32 && dtype != rt::kBF16)
    return (int)cudaErrorInvalidValue;
  const auto s = static_cast<cudaStream_t>(stream);
  const cudaError_t err = rt::launch_fiber_scan(
      static_cast<const int*>(ids), N, cap, K, static_cast<int*>(b_kind),
      static_cast<int*>(b_starts), rt::CU_KC,
      static_cast<unsigned char*>(b_live), rt::CU_N, rt::CU_KC, s);
  if (err != cudaSuccess) return (int)err;
  return rt::dtype_dispatch(dtype, [&](auto tag) {
    using T = std::remove_pointer_t<decltype(tag)>;
    rt::ChunkArgs<T> p{};
    p.a = static_cast<const T*>(a);
    p.a_gran = a_gran;
    p.b_vals = static_cast<const T*>(vals);
    p.b_ids = static_cast<const int*>(ids);
    p.b_kind = static_cast<const int*>(b_kind);
    p.b_runs = static_cast<const int*>(b_starts);
    p.cap_b = cap;
    p.live = static_cast<const unsigned char*>(b_live);
    p.out = static_cast<T*>(out);
    p.M = M;
    p.K = K;
    p.N = N;
    return rt::launch_chunk_update<T, rt::ALoad::kDenseRows>(p, s);
  });
}
