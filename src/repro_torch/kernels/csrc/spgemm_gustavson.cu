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
// Reference body (replaces _gustavson_reference_kernel). The TPU expands
// B and A per (N, M, K block) and adds their product, every K block. Here
// it is the chunked rank-update kernel of chunk_update.cuh with A as K
// column fibers: per 128 x 128 output tile, a walk over only the K fibers
// of A that hold an entry in the M tile (spgemm_outer.live_k_lists, the
// outer product's pre-pass, with A's slot range per tile), 32 at a time;
// A's fibers expand over the tile's M window into the rows of one tile,
// B's fibers (dense ones indexed at slot k, ordered ones merged from a
// cursor) over the chunk's k into the other, and each chunk is a rank-32
// update of 8 x 8 register blocks. At m3plates an M tile has about 76 live
// k of 11000, where the old per-step walk ran dense rank-128 updates over
// 70 of 86 steps. Bound: at sparse A the reads of B's entries at the live
// k and the output write; at dense A the f32 FMA rate.
#include <type_traits>

#include "chunk_update.cuh"
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

// gustavson_reference_launch scans A (fiber kinds, into a_kind) and B
// (kinds and chunk starts, into b_kind and b_runs) before the rank update.
extern "C" int gustavson_reference_launch(
    const void* a_vals, const void* a_ids, const void* a_off, void* a_kind,
    int cap_a, const void* b_vals, const void* b_ids, void* b_kind,
    void* b_runs, int cap_b, const void* live_k, const void* live_n,
    int ld_live, void* out, int M, int K, int N, int dtype, void* stream) {
  if (dtype != rt::kF32 && dtype != rt::kBF16)
    return (int)cudaErrorInvalidValue;
  const auto s = static_cast<cudaStream_t>(stream);
  cudaError_t err = rt::launch_fiber_kind(static_cast<const int*>(a_ids), K,
                                          cap_a, M,
                                          static_cast<int*>(a_kind), s);
  if (err != cudaSuccess) return (int)err;
  err = rt::launch_fiber_scan(static_cast<const int*>(b_ids), N, cap_b, K,
                              static_cast<int*>(b_kind),
                              static_cast<int*>(b_runs), rt::CU_KC, nullptr,
                              1, 1, s);
  if (err != cudaSuccess) return (int)err;
  return rt::dtype_dispatch(dtype, [&](auto tag) {
    using T = std::remove_pointer_t<decltype(tag)>;
    rt::ChunkArgs<T> p{};
    p.a = static_cast<const T*>(a_vals);
    p.a_ids = static_cast<const int*>(a_ids);
    p.a_kind = static_cast<const int*>(a_kind);
    p.a_off = static_cast<const int*>(a_off);
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
    return rt::launch_chunk_update<T, rt::ALoad::kColumnFibers>(p, s);
  });
}
