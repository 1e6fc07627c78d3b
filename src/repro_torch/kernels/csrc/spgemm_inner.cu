// ExTensor-like inner-product SpGEMM on Hopper: A held as M row fibers
// (ids -> K, capacity cap_a) times B held as N column fibers (ids -> K,
// capacity cap_b) gives O (M, N): O[m, n] sums a·b over the K coordinates
// both fibers hold. PAD_ID = -1 pads every fiber.
//
// Replaces the two TPU bodies of src/repro/kernels/spgemm_inner.py.
//
// Sparse body (replaces _inner_sparse_kernel). The TPU builds B's dense
// (K, bn) table in VMEM at the first M step of each N block and reuses it
// for the later M steps; that needs the grid to run in order on one core.
// Here the scatter of fiber_table.cuh fills one (K, N) f32 table in
// device memory, zeroed by the wrapper and skipping empty B blocks, before
// the gather-contract kernel of fiber_contract.cuh (shared with the
// Gustavson body) starts, with A's M row fibers driving. It gives
// each block 32 A rows and a run of 128 consecutive output columns; the
// trip count is the rows' live chunk bound (acnt of block_chunk_counts(a,
// bm, fc), as on the TPU); a block whose B fiber blocks are all empty
// writes zeros without reading A.
// Bound: the data needs 2·Σk nnzA(k)·nnzB(k) operations, but the gather
// does 2·nnz(A)·N (the table is dense in N); each FMA needs a table load,
// mostly from L2, so load bandwidth bounds it; the scatter moves B's ELL
// and the table once.
//
// Reference body (replaces _inner_reference_kernel). The TPU skips a
// (tile, K step) unless both tile_occupancy counts are > 0, then expands
// both operands and contracts on the MXU. Here it is the chunked
// rank-update kernel of chunk_update.cuh with A as row fibers: per 128 x
// 128 output tile, a walk over the k that some row fiber of the M tile
// holds (the wrapper's pre-pass, no host sync), 32 at a time; both
// operands' fibers are merged over each chunk from cursors that only move
// forward (one coalesced read of 32 slots per fiber and chunk where the
// k are contiguous), and each chunk is a rank-32 update of 8 x 8 register
// blocks; a chunk where no B fiber of the N tile holds an entry skips its
// update. Bound: 2·128·128 FMAs per live k against the 2·Σk
// nnzA(k)·nnzB(k) the data needs; "auto" sends inner here only when A's
// fibers are more than a quarter full, where every k is live and the f32
// FMA rate bounds it.
#include <type_traits>

#include "chunk_update.cuh"
#include "fiber_contract.cuh"
#include "fiber_table.cuh"

namespace rt {

template <typename T>
int inner_sparse(const T* a_vals, const int* a_ids, int cap_a,
                 const int* a_chunks, int bm, int fc, const T* b_vals,
                 const int* b_ids, int cap_b, const int* b_counts, int bn,
                 float* table, T* out, int M, int K, int N,
                 cudaStream_t stream) {
  const cudaError_t err = launch_fiber_table_scatter<T>(
      b_vals, b_ids, b_counts, table, K, N, cap_b, bn, 1, stream);
  if (err != cudaSuccess) return (int)err;
  return (int)launch_gather_contract<T, false>(
      a_vals, a_ids, cap_a, a_chunks, bm, fc, table, b_counts, bn, out, M, N,
      stream);
}

}  // namespace rt

// ------------------------------------------------------------- C entries
// Pointers arrive as void* (ctypes c_void_p); dtype is rt::kF32 or
// rt::kBF16 and applies to both operands' values and the output. Each
// returns cudaGetLastError() after its launches.
extern "C" int inner_sparse_launch(const void* a_vals, const void* a_ids,
                                   int cap_a, const void* a_chunks, int bm,
                                   int fc, const void* b_vals,
                                   const void* b_ids, int cap_b,
                                   const void* b_counts, int bn, void* table,
                                   void* out, int M, int K, int N, int dtype,
                                   void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  const int* ai = static_cast<const int*>(a_ids);
  const int* ac = static_cast<const int*>(a_chunks);
  const int* bi = static_cast<const int*>(b_ids);
  const int* bc = static_cast<const int*>(b_counts);
  float* t = static_cast<float*>(table);
  if (dtype == rt::kF32)
    return rt::inner_sparse<float>(
        static_cast<const float*>(a_vals), ai, cap_a, ac, bm, fc,
        static_cast<const float*>(b_vals), bi, cap_b, bc, bn, t,
        static_cast<float*>(out), M, K, N, s);
  if (dtype == rt::kBF16)
    return rt::inner_sparse<__nv_bfloat16>(
        static_cast<const __nv_bfloat16*>(a_vals), ai, cap_a, ac, bm, fc,
        static_cast<const __nv_bfloat16*>(b_vals), bi, cap_b, bc, bn, t,
        static_cast<__nv_bfloat16*>(out), M, K, N, s);
  return (int)cudaErrorInvalidValue;
}

// inner_reference_launch scans B (fiber kinds and chunk starts, into
// b_kind and b_runs) before the rank update; A's kinds, starts and live k
// come from fiber_scan_launch (chunk_update.cuh) and the wrapper's
// compaction of its flags into live_k.
extern "C" int inner_reference_launch(
    const void* a_vals, const void* a_ids, const void* a_kind,
    const void* a_runs, int cap_a, const void* b_vals, const void* b_ids,
    void* b_kind, void* b_runs, int cap_b, const void* live_k,
    const void* live_n, int ld_live, void* out, int M, int K, int N,
    int dtype, void* stream) {
  if (dtype != rt::kF32 && dtype != rt::kBF16)
    return (int)cudaErrorInvalidValue;
  const auto s = static_cast<cudaStream_t>(stream);
  const cudaError_t err = rt::launch_fiber_scan(
      static_cast<const int*>(b_ids), N, cap_b, K, static_cast<int*>(b_kind),
      static_cast<int*>(b_runs), rt::CU_KC, nullptr, 1, 1, s);
  if (err != cudaSuccess) return (int)err;
  return rt::dtype_dispatch(dtype, [&](auto tag) {
    using T = std::remove_pointer_t<decltype(tag)>;
    rt::ChunkArgs<T> p{};
    p.a = static_cast<const T*>(a_vals);
    p.a_ids = static_cast<const int*>(a_ids);
    p.a_kind = static_cast<const int*>(a_kind);
    p.a_runs = static_cast<const int*>(a_runs);
    p.cap_a = cap_a;
    p.b_vals = static_cast<const T*>(b_vals);
    p.b_ids = static_cast<const int*>(b_ids);
    p.b_kind = static_cast<const int*>(b_kind);
    p.b_runs = static_cast<const int*>(b_runs);
    p.cap_b = cap_b;
    p.list = static_cast<const int*>(live_k);
    p.list_n = static_cast<const int*>(live_n);
    p.ld_list = ld_live;
    p.out = static_cast<T*>(out);
    p.M = M;
    p.K = K;
    p.N = N;
    return rt::launch_chunk_update<T, rt::ALoad::kRowFibers>(p, s);
  });
}
