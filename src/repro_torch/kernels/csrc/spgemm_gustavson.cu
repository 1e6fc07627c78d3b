// MatRaptor-like Gustavson (column-wise product) SpGEMM on Hopper: A held
// as K column fibers (ids -> M, capacity cap_a) times B held as N column
// fibers (ids -> K, capacity cap_b) gives O (M, N): column n of O sums
// b·A[:, k] over the entries (k, b) of B's fiber n. PAD_ID = -1 pads every
// fiber.
//
// Replaces the two TPU bodies of src/repro/kernels/spgemm_gustavson.py.
//
// Sparse body (replaces _gustavson_sparse_kernel). The TPU builds A's dense
// (K, bm) table for an M window in VMEM at the first N step and reuses it
// on the later N steps; that needs the grid to run in order on one core
// (the hazard of every sparse body). Here a kernel of its own fills one
// zeroed (K, M) f32 table in device memory first: A's fiber k is table row
// k, a row scatter with one warp per fiber and no atomics
// (fiber_table.cuh). Then B's fibers drive the gather-contract of
// fiber_contract.cuh, as A's rows drive it in the inner body: for every
// live entry (k, b) of fiber n, row n of the (N, M) product gains
// b·table[k, :], over B's live chunks (block_chunk_counts(b, bn, fc)). The
// product is O's transpose: each block stages its tile in shared memory
// and stores it transposed into O, so no (N, M) buffer is written and read
// again (at gnmt's width that buffer alone is 240 MB). Blocks whose M
// columns all lie in windows that block_window_nnz(a, bm) proves empty
// write zeros without reading B.
// Bound: the data needs 2·Σk nnzA(k)·nnzB(k) operations, but the gather
// does 2·nnz(B)·M (the table is dense in M); each FMA needs a table load,
// mostly from L2, so load bandwidth bounds it; the scatter reads A's ELL
// once and writes each live entry once into the table.
//
// Reference body (replaces _gustavson_reference_kernel): the expand-update
// kernel of fiber_contract.cuh with A as K column fibers. One block owns a
// 128 x 128 output tile and walks K in steps of bk <= 128. A step runs only
// when A's bk fibers of the step hold an entry in the tile's M range and
// B's fibers of the tile's N range hold one in the step (occupancy counts
// of tile_occupancy, summed by the wrapper; the TPU body expands every
// step, the output is the same). A live step expands A's bk fibers over
// the M range into the rows of one shared-memory tile and B's 128 fibers
// over the step into the other, then applies a rank-bk update to 8 x 8
// register accumulators. Each side's slots come from the wrapper's prefix
// sums of tile_occupancy: (a, 128) gives the range of fiber k's entries in
// M tile t, (b, bk) that of fiber n's entries in step kk. That holds for
// an ordered fiber (live ids in range and ascending, PAD slots last; a flag
// per fiber computed by the wrapper on the device, with no host sync); any
// other fiber is scanned whole, each id tested, so no input writes outside
// the tile. Nothing scans a whole fiber per tile and step otherwise: at
// synthetic_dense A's fibers hold 5120 slots, and a scan per (N, M, K)
// step would read about 2.6e9 slots.
// Bound: the dense rank updates do 2·128·128·bk FMAs per live step against
// the 2·Σk nnzA(k)·nnzB(k) the data needs; with dense-enough operands the
// f32 FMA rate bounds it, as for the GEMM.
#include "fiber_contract.cuh"
#include "fiber_table.cuh"

namespace rt {

template <typename T>
int gustavson_sparse(const T* a_vals, const int* a_ids, int cap_a,
                     const int* a_win, int bm, const T* b_vals,
                     const int* b_ids, int cap_b, const int* b_chunks, int bn,
                     int fc, float* table, T* out, int M, int K, int N,
                     cudaStream_t stream) {
  const cudaError_t err =
      launch_fiber_row_scatter<T>(a_vals, a_ids, table, K, M, cap_a, stream);
  if (err != cudaSuccess) return (int)err;
  return (int)launch_gather_contract<T, true>(
      b_vals, b_ids, cap_b, b_chunks, bn, fc, table, a_win, bm, out, N, M,
      stream);
}

}  // namespace rt

// ------------------------------------------------------------- C entries
// Pointers arrive as void* (ctypes c_void_p); dtype is rt::kF32 or
// rt::kBF16 and applies to both operands' values and the output. Each
// returns cudaGetLastError() after its launches.
extern "C" int gustavson_sparse_launch(
    const void* a_vals, const void* a_ids, int cap_a, const void* a_win,
    int bm, const void* b_vals, const void* b_ids, int cap_b,
    const void* b_chunks, int bn, int fc, void* table, void* out, int M,
    int K, int N, int dtype, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  const int* ai = static_cast<const int*>(a_ids);
  const int* aw = static_cast<const int*>(a_win);
  const int* bi = static_cast<const int*>(b_ids);
  const int* bc = static_cast<const int*>(b_chunks);
  float* t = static_cast<float*>(table);
  if (dtype == rt::kF32)
    return rt::gustavson_sparse<float>(
        static_cast<const float*>(a_vals), ai, cap_a, aw, bm,
        static_cast<const float*>(b_vals), bi, cap_b, bc, bn, fc, t,
        static_cast<float*>(out), M, K, N, s);
  if (dtype == rt::kBF16)
    return rt::gustavson_sparse<__nv_bfloat16>(
        static_cast<const __nv_bfloat16*>(a_vals), ai, cap_a, aw, bm,
        static_cast<const __nv_bfloat16*>(b_vals), bi, cap_b, bc, bn, fc, t,
        static_cast<__nv_bfloat16*>(out), M, K, N, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" int gustavson_reference_launch(
    const void* a_vals, const void* a_ids, const void* a_off,
    const void* a_ord, int cap_a, const void* b_vals, const void* b_ids,
    const void* b_off, const void* b_ord, int cap_b, const void* a_occ,
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
  // bm is unused with A as column fibers: A's occupancy is per M tile.
  if (dtype == rt::kF32)
    return rt::launch_expand_update<float, true>(
        static_cast<const float*>(a_vals), ai, ao, ar, cap_a,
        static_cast<const float*>(b_vals), bi, bo, br, cap_b, aq, rt::EU_M,
        bq, bn, static_cast<float*>(out), M, K, N, bk, s);
  if (dtype == rt::kBF16)
    return rt::launch_expand_update<__nv_bfloat16, true>(
        static_cast<const __nv_bfloat16*>(a_vals), ai, ao, ar, cap_a,
        static_cast<const __nv_bfloat16*>(b_vals), bi, bo, br, cap_b, aq,
        rt::EU_M, bq, bn, static_cast<__nv_bfloat16*>(out), M, K, N, bk, s);
  return (int)cudaErrorInvalidValue;
}
