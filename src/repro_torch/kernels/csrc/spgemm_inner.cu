// ExTensor-like inner-product SpGEMM on Hopper: A held as M row fibers
// (ids -> K, capacity cap_a) times B held as N column fibers (ids -> K,
// capacity cap_b) gives O (M, N): O[m, n] sums a·b over the K coordinates
// both fibers hold. PAD_ID = -1 pads every fiber.
//
// Replaces the two TPU bodies of src/repro/kernels/spgemm_inner.py.
//
// Sparse body (replaces _inner_sparse_kernel). The TPU builds B's dense
// (K, bn) table in VMEM at the first M step of each N block and reuses it
// for the later M steps, then gathers table rows at A's ids and contracts
// them over A's live capacity chunks. Here no table exists: the body is
// the SpMM sparse body's row walk (row_walk.cuh) on the mirrored product
// Oᵀ = Bᵀ·Aᵀ, with B's fibers as the rows (RowLoad::kFibers) and A's row
// fibers as the walked fibers.
// - A block owns 1-16 of B's fibers and expands them in shared memory,
//   k-major: it zeroes the rows, then writes each slot's value at its id
//   (ids are unique, so no atomics; PAD and ids outside [0, K) dropped).
//   Every slot of B is read once, coalesced, four slots a load where the
//   capacity is a multiple of four. A fiber too long for the block's 96 KB
//   (K·elem > 96 KB) is expanded one K window at a time, each window
//   reading the fiber's slots again.
// - The threads walk A's row fibers (they are Aᵀ's column fibers, ids ->
//   K), copied slot-major by the transpose pre-pass with the TPU body's
//   live bounds (block_chunk_counts(a, bm, fc) · fc, from A's lengths): a
//   thread takes 16 / rows fibers in step and adds b[n, id] · val into f32
//   sums for its block's rows.
// - The kernel stores Oᵀ (N, M) row by row, consecutive threads on
//   consecutive m; the wrapper returns the (M, N) transposed view.
// - A fiber block of A with no live entry walks nothing and gives zeros;
//   every output is one thread's sum in slot order: no atomics, the same
//   bits twice, nothing read on the host.
// Bound: B's ELL read once and O written once (bytes) at Table I's
// launches, where B is dense (bibd_81_3, m3plates, chem97ZtZ, speech) or
// A's fibers short (citeseer); where A's fibers are long (speech) each FMA
// reads its own b[n, id] from shared memory, so shared-memory bandwidth
// limits the walk, as in SpMM's.
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
#include "row_walk.cuh"

// ------------------------------------------------------------- C entries
// Pointers arrive as void* (ctypes c_void_p); dtype is rt::kF32 or
// rt::kBF16 and applies to both operands' values and the output. Each
// returns cudaGetLastError() after its launches.

// inner_sparse_launch: A's M row fibers (a_vals, a_ids, a_lens; cap_a
// slots, live bounds from blocks of bm and chunks of fc) are walked,
// B's N column fibers (b_vals, b_ids; cap_b slots, b_vec slots a load)
// are the rows; ids_t and vals_t are (cap_a, M) and ends (M,) scratch the
// pre-pass fills; out is Oᵀ (N, M); rows, window, split_w and n_split are
// spmm.py's spmm_sparse_plan of the mirrored product.
extern "C" int inner_sparse_launch(
    const void* a_vals, const void* a_ids, const void* a_lens, int cap_a,
    int bm, int fc, const void* b_vals, const void* b_ids, int cap_b,
    int b_vec, void* ids_t, void* vals_t, void* ends, void* out, int M,
    int K, int N, int rows, int window, int split_w, int n_split, int dtype,
    void* stream) {
  if (dtype != rt::kF32 && dtype != rt::kBF16)
    return (int)cudaErrorInvalidValue;
  return rt::dtype_dispatch(dtype, [&](auto tag) {
    using T = std::remove_pointer_t<decltype(tag)>;
    rt::SparseArgs<T> p{};
    p.row_ids = static_cast<const int*>(b_ids);
    p.row_vals = static_cast<const T*>(b_vals);
    p.row_cap = cap_b;
    p.row_vec = b_vec;
    p.ids_t = static_cast<const int*>(ids_t);
    p.vals_t = static_cast<const T*>(vals_t);
    p.ends = static_cast<const int*>(ends);
    p.out = static_cast<T*>(out);
    p.M = N;  // the rows: B's fibers
    p.K = K;
    p.N = M;  // the walked fibers: A's
    p.rows = rows;
    p.window = window;
    p.split_w = split_w;
    p.n_split = n_split;
    return rt::launch_row_walk<T, rt::RowLoad::kFibers>(
        p, static_cast<const int*>(a_ids), static_cast<const T*>(a_vals),
        static_cast<const int*>(a_lens), cap_a, bm, fc,
        static_cast<cudaStream_t>(stream));
  });
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
