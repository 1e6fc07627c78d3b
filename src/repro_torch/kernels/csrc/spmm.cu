// EIE-like SpMM on Hopper: dense A (M, K) times B held as N column fibers
// (ids -> K, capacity cap, PAD_ID = -1 padding) gives O (M, N).
//
// Replaces the two TPU bodies of src/repro/kernels/spmm.py.
//
// Sparse body (replaces _spmm_sparse_kernel). On the TPU the kernel
// scatters B's live fiber chunks into a (K, bn) VMEM table per N block and
// contracts A's row block with it on the MXU: dense work, 2·M·K·N, for the
// 2·M·nnz(B) the data needs. Here nothing dense is built: the contraction
// walks B's live slots only. It is the row walk of row_walk.cuh with A's
// rows copied as they lie (RowLoad::kDense): a block owns 1-16 rows of A,
// held k-major in shared memory, and each thread walks its fibers' live
// slots (B copied slot-major by the transpose pre-pass), adding a[m, id] ·
// val into f32 sums; a row too long for the block's 96 KB is walked in K
// windows. The inner-product sparse body (spgemm_inner.cu) runs the same
// kernel with B's fibers expanded into the rows.
//
// Bound: A read once and O written once (bytes) where B is as sparse as
// Table I's mirrored SpMM launches make it (m3plates, bibd_81_3,
// chem97ZtZ); 2·M·nnz(B) FMAs where B's fibers are long (speech). There
// each FMA reads its own a[m, id] from shared memory at a random bank, so
// shared-memory bandwidth, not the FMA rate, is the limit this design
// meets.
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
#include "row_walk.cuh"

// ------------------------------------------------------------- C entries
// Pointers arrive as void* (ctypes c_void_p); dtype is rt::kF32 or
// rt::kBF16 and applies to A, the fiber values and the output alike.
// Each returns cudaGetLastError() after its launches.

// spmm_sparse_launch: lens are the fibers' lengths, bn the fiber block and
// fc the chunk of the live bounds; ids_t and vals_t are (cap, N) and ends
// (N,) scratch the pre-pass fills; rows, window, split_w and n_split are
// spmm.py's spmm_sparse_plan.
extern "C" int spmm_sparse_launch(const void* a, const void* vals,
                                  const void* ids, const void* lens,
                                  void* ids_t, void* vals_t, void* ends,
                                  void* out, int M, int K, int N, int cap,
                                  int bn, int fc, int rows, int window,
                                  int split_w, int n_split, int a_gran,
                                  int dtype, void* stream) {
  if (dtype != rt::kF32 && dtype != rt::kBF16)
    return (int)cudaErrorInvalidValue;
  return rt::dtype_dispatch(dtype, [&](auto tag) {
    using T = std::remove_pointer_t<decltype(tag)>;
    rt::SparseArgs<T> p{};
    p.a = static_cast<const T*>(a);
    p.ids_t = static_cast<const int*>(ids_t);
    p.vals_t = static_cast<const T*>(vals_t);
    p.ends = static_cast<const int*>(ends);
    p.out = static_cast<T*>(out);
    p.M = M;
    p.K = K;
    p.N = N;
    p.rows = rows;
    p.window = window;
    p.split_w = split_w;
    p.n_split = n_split;
    p.a_gran = a_gran;
    return rt::launch_row_walk<T, rt::RowLoad::kDense>(
        p, static_cast<const int*>(ids), static_cast<const T*>(vals),
        static_cast<const int*>(lens), cap, bn, fc,
        static_cast<cudaStream_t>(stream));
  });
}

// How many sparse-body blocks of `rows` rows and `smem` bytes of shared
// memory one SM holds at once (the wrapper's plan splits N by the card's
// block slots, this times the SM count). Returns a cudaError_t as int.
extern "C" int spmm_sparse_blocks_per_sm(int rows, int smem, int dtype,
                                         int* out) {
  return rt::row_walk_blocks_per_sm<rt::RowLoad::kDense>(rows, smem, dtype,
                                                          out);
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
