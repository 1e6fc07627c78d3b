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
// on the later N steps, and B's fibers drive a gather-contract over it:
// 2·nnz(B)·M operations where the data needs 2·Σk nnzA(k)·nnzB(k). Here no
// table exists: the body is the outer product's row merge (row_merge.cuh)
// on Oᵀ = Bᵀ·Aᵀ.
// - A warp owns one row of Oᵀ, which is B's fiber n, and an M chunk of 1024
//   f32 accumulators in shared memory. It walks the fiber's slots in
//   place, in slot order (FiberSlots: 32 slots a load, the live ones taken
//   in order; PAD and ids outside [0, K) skipped), with no sort: the outer
//   body sorts only because its rows are not fibers.
// - For each entry (k, b) it adds b·a over A's fiber k's run in the M
//   chunk: no search for a dense fiber, the warp-wide binary search for an
//   ordered one, every id tested for one out of order (the kinds from
//   launch_fiber_kind's scan of A's ids).
// - The kernel stores Oᵀ (N, M) row by row, coalesced; the wrapper returns
//   the (M, N) transposed view.
// - No float atomics and no host sync: within one entry every column gains
//   at most one add, and a row is one warp's, so two runs give the same
//   bits.
// Bound: the work goes with the (a, b) pairs plus one write of the output;
// at Table I's Gustavson launch (citeseer, 0.4 M pairs) the output write
// (49 MB) bounds it.
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
#include "row_merge.cuh"

// ------------------------------------------------------------- C entries
// Pointers arrive as void* (ctypes c_void_p); dtype is rt::kF32 or
// rt::kBF16 and applies to both operands' values and the output. Each
// returns cudaGetLastError() after its launches.

// gustavson_sparse_launch: B's N fibers (b_vals, b_ids; cap_b slots, ids
// -> K) are the rows of Oᵀ, A's K fibers (a_vals, a_ids; cap_a slots, ids
// -> M) are merged, their kinds into a_kind (K ints of scratch); out is Oᵀ
// (N, M).
extern "C" int gustavson_sparse_launch(
    const void* a_vals, const void* a_ids, void* a_kind, int cap_a,
    const void* b_vals, const void* b_ids, int cap_b, void* out, int M,
    int K, int N, int dtype, void* stream) {
  if (dtype != rt::kF32 && dtype != rt::kBF16)
    return (int)cudaErrorInvalidValue;
  return rt::dtype_dispatch(dtype, [&](auto tag) {
    using T = std::remove_pointer_t<decltype(tag)>;
    const rt::FiberSlots<T> rows{static_cast<const int*>(b_ids),
                                 static_cast<const T*>(b_vals), cap_b, K};
    return rt::launch_row_merge<T>(
        rows, static_cast<const T*>(a_vals), static_cast<const int*>(a_ids),
        static_cast<int*>(a_kind), cap_a, static_cast<T*>(out), N, K, M,
        static_cast<cudaStream_t>(stream));
  });
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
