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
// Here the scatter of fiber_table.cuh (shared with SpMM) fills one (K, N)
// f32 table in device memory, zeroed by the wrapper and skipping empty B
// blocks, before the gather-contract kernel of fiber_contract.cuh (shared
// with the Gustavson body) starts, with A's M row fibers driving. It gives
// each block 32 A rows and a run of 128 consecutive output columns; the
// trip count is the rows' live chunk bound (acnt of block_chunk_counts(a,
// bm, fc), as on the TPU); a block whose B fiber blocks are all empty
// writes zeros without reading A.
// Bound: the data needs 2·Σk nnzA(k)·nnzB(k) operations, but the gather
// does 2·nnz(A)·N (the table is dense in N); each FMA needs a table load,
// mostly from L2, so load bandwidth bounds it; the scatter moves B's ELL
// and the table once.
//
// Reference body (replaces _inner_reference_kernel): the expand-update
// kernel of fiber_contract.cuh with A as row fibers. One block owns a
// 128 x 128 output tile and walks K in steps of bk <= 128. A step runs only
// when the tile's rows hold an A entry and its columns a B entry in that K
// range (the occupancy counts of tile_occupancy summed over fiber blocks,
// computed by the wrapper, as the TPU's scalar prefetch). A live step
// expands the step's slots of its 128 A fibers and 128 B fibers into
// shared-memory tiles, K-major, and applies a rank-bk update to 8 x 8
// register accumulators. The slots of step kk in fiber f are
// [off[f, kk], off[f, kk + 1]): the wrapper's prefix sums of the
// occupancy. That holds where the fiber's live ids lie in [0, K) and
// ascend and its PAD slots come last (ord[f], computed by the wrapper on
// the device), so a step reads only its own slots. Any other fiber is
// scanned whole at every step, each slot tested against the step, so no
// input makes the kernel write outside its tile.
// Bound: the dense rank updates do 2·128·128·bk FMAs per live step against
// the 2·Σk nnzA(k)·nnzB(k) the data needs; with dense-enough operands the
// f32 FMA rate bounds it, as for the GEMM.
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

template <typename T>
int inner_reference(const T* a_vals, const int* a_ids, const int* a_off,
                    const bool* a_ord, int cap_a, const T* b_vals,
                    const int* b_ids, const int* b_off, const bool* b_ord,
                    int cap_b, const int* a_occ, int bm, const int* b_occ,
                    int bn, T* out, int M, int K, int N, int bk,
                    cudaStream_t stream) {
  return launch_expand_update<T, false>(a_vals, a_ids, a_off, a_ord, cap_a,
                                        b_vals, b_ids, b_off, b_ord, cap_b,
                                        a_occ, bm, b_occ, bn, out, M, K, N,
                                        bk, stream);
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

extern "C" int inner_reference_launch(
    const void* a_vals, const void* a_ids, const void* a_off,
    const void* a_ord, int cap_a, const void* b_vals, const void* b_ids,
    const void* b_off, const void* b_ord, int cap_b, const void* a_occ, int bm,
    const void* b_occ, int bn, void* out, int M, int K, int N, int bk,
    int dtype, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  const int* ai = static_cast<const int*>(a_ids);
  const int* ao = static_cast<const int*>(a_off);
  const bool* ar = static_cast<const bool*>(a_ord);
  const int* bi = static_cast<const int*>(b_ids);
  const int* bo = static_cast<const int*>(b_off);
  const bool* br = static_cast<const bool*>(b_ord);
  const int* aq = static_cast<const int*>(a_occ);
  const int* bq = static_cast<const int*>(b_occ);
  if (dtype == rt::kF32)
    return rt::inner_reference<float>(
        static_cast<const float*>(a_vals), ai, ao, ar, cap_a,
        static_cast<const float*>(b_vals), bi, bo, br, cap_b, aq, bm, bq, bn,
        static_cast<float*>(out), M, K, N, bk, s);
  if (dtype == rt::kBF16)
    return rt::inner_reference<__nv_bfloat16>(
        static_cast<const __nv_bfloat16*>(a_vals), ai, ao, ar, cap_a,
        static_cast<const __nv_bfloat16*>(b_vals), bi, bo, br, cap_b, aq, bm,
        bq, bn, static_cast<__nv_bfloat16*>(out), M, K, N, bk, s);
  return (int)cudaErrorInvalidValue;
}
