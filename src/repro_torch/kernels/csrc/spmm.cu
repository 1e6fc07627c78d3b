// EIE-like SpMM on Hopper: dense A (M, K) times B held as N column fibers
// (ids -> K, capacity cap, PAD_ID = -1 padding) gives O (M, N).
//
// Replaces the two TPU bodies of src/repro/kernels/spmm.py.
//
// Sparse body (replaces _spmm_sparse_kernel). On the TPU the kernel
// scatters B's live fiber chunks into a (K, bn) VMEM table per N block and
// contracts A's row block with it on the MXU: dense work, 2·M·K·N, for the
// 2·M·nnz(B) the data needs. Here nothing dense is built: the contraction
// walks B's live slots only.
//
// - A is row-stationary: a block owns `rows` (1, 2, 4, 8 or 16) rows of A
//   and holds them whole in shared memory, at most 96 KB, so that two or
//   more blocks share an SM and one block's copy overlaps another's walk.
//   They are held k-major, a[k][r], so that the rows' values at one k are
//   one or a few loads of up to 16 bytes: a single row is copied as it
//   lies with cp.async, more rows with element loads. A row that does not
//   fit (K·elem > 96 KB) is walked in K windows: the block then takes 256
//   fibers at a time, one a thread, and keeps their sums in registers
//   across the windows.
// - Threads walk fibers: thread t takes fibers n0 + t, n0 + t + 256, ... of
//   its block's fiber range, 16 / rows of them in step (their loads in
//   flight together), walks each one's slots in order, drops PAD and any
//   id outside [0, K) (as the TPU's table drops it), and adds a[m, id] ·
//   val into `rows` f32 sums, which it rounds once and stores to out[m0 ..
//   m0 + rows, n]: consecutive threads store consecutive n.
// - B's fibers are read slot-major: a pre-pass (fiber_transpose_kernel)
//   copies each fiber's live slots (those below its block's live bound,
//   the TPU body's block_chunk_counts · fc, computed there from the
//   fibers' lengths) into (cap, N) arrays and records where each fiber's
//   last non-PAD slot ends, so a warp reads one slot of 32 fibers as 128
//   contiguous bytes and walks no trailing padding.
// - The grid is row blocks x N splits, splits of one row block adjacent so
//   that they read its rows of A from L2; the wrapper's plan (spmm.py
//   spmm_sparse_plan) splits N so that a launch with few row blocks still
//   gives the card 4 blocks an SM.
// - Every output is one thread's sum in slot order: no atomics, the same
//   bits on every run, and nothing read on the host.
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
#include <algorithm>
#include <type_traits>

#include "chunk_update.cuh"

namespace rt {

// ------------------------------------------------------------ sparse body
constexpr int SP_THREADS = 256;
constexpr int SP_TILE = 32;  // fibers and slots of a transpose tile

template <typename T>
struct SparseArgs {
  const T* a;          // (M, K) row-major
  const int* ids_t;    // (cap, N): slot c of fiber n at c·N + n
  const T* vals_t;
  const int* ends;     // (N,): one past each fiber's last non-PAD slot
  T* out;              // (M, N)
  int M, K, N;
  int rows;            // rows of A a block owns (the kernel's BM)
  int window;          // K elements of A's rows a block holds at once
  int split_w;         // fibers of a block's range
  int n_split;         // fiber ranges per row block
  int a_gran;          // elements per cp.async copy of A's rows
};

// Pre-pass: a block takes 32 fibers. Each fiber's live bound is its
// block's (bn fibers) longest length rounded up to fc slots, at most cap:
// block_chunk_counts(b, bn, fc) · fc, the TPU body's bound. The block walks
// the fibers' live slots 32 at a time through a shared-memory tile,
// reading it fiber by fiber (a warp over 32 consecutive slots of one
// fiber) and writing it slot by slot (a warp over the 32 fibers at one
// slot), and notes where each fiber's last non-PAD slot ends. Slots at or
// past a fiber's live bound are neither read nor written.
template <typename T>
__global__ void __launch_bounds__(SP_THREADS) fiber_transpose_kernel(
    const int* __restrict__ ids, const T* __restrict__ vals,
    const int* __restrict__ lens, int N, int cap, int bn, int fc,
    int* __restrict__ ids_t, T* __restrict__ vals_t, int* __restrict__ ends) {
  constexpr int kRows = SP_THREADS / SP_TILE;
  __shared__ int s_id[SP_TILE][SP_TILE + 1];  // +1: no bank conflicts
  __shared__ float s_v[SP_TILE][SP_TILE + 1];  // bf16 converts exactly
  __shared__ int s_red[kRows][SP_TILE];
  const int tx = threadIdx.x % SP_TILE, ty = threadIdx.x / SP_TILE;
  const int n0 = blockIdx.x * SP_TILE;
  // Live bounds: the 8 warps share the reads of lane tx's block lengths.
  int most = 0;
  if (n0 + tx < N) {
    const int b0 = (n0 + tx) / bn * bn;
    for (int i = b0 + ty; i < b0 + bn; i += kRows) most = max(most, lens[i]);
  }
  s_red[ty][tx] = most;
  __syncthreads();
  if (ty == 0) {
    for (int r = 1; r < kRows; ++r) most = max(most, s_red[r][tx]);
    s_red[0][tx] = n0 + tx < N ? min(cap, (most + fc - 1) / fc * fc) : 0;
  }
  __syncthreads();
  const int live_tx = s_red[0][tx];
  most = live_tx;
  for (int o = 16; o > 0; o /= 2)
    most = max(most, __shfl_xor_sync(0xffffffffu, most, o));
  int end = 0;
  for (int c0 = 0; c0 < most; c0 += SP_TILE) {
    for (int f = ty; f < SP_TILE; f += kRows) {
      const int n = n0 + f, c = c0 + tx;
      int id = PAD_ID;
      float v = 0.f;
      if (c < s_red[0][f]) {
        id = ids[(size_t)n * cap + c];
        v = to_f32(vals[(size_t)n * cap + c]);
      }
      s_id[f][tx] = id;
      s_v[f][tx] = v;
    }
    __syncthreads();
    for (int s = ty; s < SP_TILE; s += kRows) {
      const int c = c0 + s;
      if (c < live_tx) {
        const int id = s_id[tx][s];
        ids_t[(size_t)c * N + n0 + tx] = id;
        vals_t[(size_t)c * N + n0 + tx] = from_f32<T>(s_v[tx][s]);
        if (id != PAD_ID) end = c + 1;
      }
    }
    __syncthreads();
  }
  s_id[ty][tx] = end;  // the tile is free after the last barrier
  __syncthreads();
  if (ty == 0 && n0 + tx < N) {
    for (int r = 1; r < kRows; ++r) end = max(end, s_id[r][tx]);
    ends[n0 + tx] = end;
  }
}

// A block holds its rows of A k-major, a[k][r] at k·BM + r, so that a
// slot's BM values are one or a few loads of up to 16 bytes (and fewer
// bank conflicts than BM loads at one random bank each). Copy A[m0 .. m0
// + rows, k0 .. k0 + w) there. One row is k-major as it lies: `gran`
// elements a cp.async copy (element loads for 2-byte pieces, bf16 rows of
// odd K). More rows: element loads, BM stores a k. The caller waits for
// the copies and syncs.
template <typename T, int BM>
__device__ __forceinline__ void load_rows(const SparseArgs<T>& p, T* a_s,
                                          int m0, int rows, int k0, int w,
                                          int tid) {
  const T* src = p.a + (size_t)m0 * p.K + k0;
  if constexpr (BM == 1) {
    const int bytes = p.a_gran * (int)sizeof(T);
    for (int i = tid; i < w / p.a_gran; i += SP_THREADS) {
      if (bytes >= 4)
        cp_async(a_s + i * p.a_gran, src + i * p.a_gran, bytes);
      else
        a_s[i] = src[i];
    }
    cp_async_commit();
  } else {
#pragma unroll 4
    for (int k = tid; k < w; k += SP_THREADS) {
      T v[BM];
#pragma unroll
      for (int r = 0; r < BM; ++r)
        v[r] = r < rows ? src[(size_t)r * p.K + k] : from_f32<T>(0.f);
#pragma unroll
      for (int r = 0; r < BM; ++r) a_s[k * BM + r] = v[r];
    }
  }
}

// The BM values a[k][0 .. BM) of a k-major block.
template <int BM>
__device__ __forceinline__ void load_col(const float* s, float (&x)[BM]) {
  if constexpr (BM % 4 != 0) {
#pragma unroll
    for (int r = 0; r < BM; ++r) x[r] = s[r];
    return;
  }
#pragma unroll
  for (int q = 0; q < BM / 4; ++q) {
    const float4 f = reinterpret_cast<const float4*>(s)[q];
    x[4 * q] = f.x;
    x[4 * q + 1] = f.y;
    x[4 * q + 2] = f.z;
    x[4 * q + 3] = f.w;
  }
}
template <int BM>
__device__ __forceinline__ void load_col(const __nv_bfloat16* s,
                                         float (&x)[BM]) {
  if constexpr (BM % 4 != 0) {
#pragma unroll
    for (int r = 0; r < BM; ++r) x[r] = to_f32(s[r]);
    return;
  }
#pragma unroll
  for (int q = 0; q < BM / 4; ++q) {
    const uint2 u = reinterpret_cast<const uint2*>(s)[q];
    const float2 lo = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&u.x));
    const float2 hi = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&u.y));
    x[4 * q] = lo.x;
    x[4 * q + 1] = lo.y;
    x[4 * q + 2] = hi.x;
    x[4 * q + 3] = hi.y;
  }
}

// A thread's fibers n + u·SP_THREADS (u < U, those below n_hi) walked
// in step, slot c of all U at once (U independent loads in flight), each
// in slot order, against the rows held in a_s (A's columns k0 .. k0 + w);
// sums into acc[u].
template <typename T, int BM, int U>
__device__ __forceinline__ void walk(const SparseArgs<T>& p, const T* a_s,
                                     int n, int n_hi, int k0, int w,
                                     float (&acc)[U][BM]) {
  int end[U];
  int most = 0;
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const int f = n + u * SP_THREADS;
    end[u] = f < n_hi ? p.ends[f] : 0;
    most = max(most, end[u]);
  }
  for (int c = 0; c < most; ++c) {
    int id[U];
    float v[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      id[u] = PAD_ID;
      v[u] = 0.f;
      if (c < end[u]) {
        const size_t off = (size_t)c * p.N + n + u * SP_THREADS;
        id[u] = p.ids_t[off];
        v[u] = to_f32(p.vals_t[off]);
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      // PAD, an id outside [0, K), or one of another window: dropped.
      const unsigned j = (unsigned)(id[u] - k0);
      if (j >= (unsigned)w) continue;
      float x[BM];
      load_col<BM>(a_s + j * BM, x);
#pragma unroll
      for (int r = 0; r < BM; ++r) acc[u][r] = fmaf(x[r], v[u], acc[u][r]);
    }
  }
}

template <typename T, int BM, int U>
__device__ __forceinline__ void store_columns(const SparseArgs<T>& p,
                                              const float (&acc)[U][BM],
                                              int m0, int rows, int n,
                                              int n_hi) {
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const int f = n + u * SP_THREADS;
    if (f >= n_hi) break;
#pragma unroll
    for (int r = 0; r < BM; ++r)
      if (r < rows)
        p.out[(size_t)(m0 + r) * p.N + f] = from_f32<T>(acc[u][r]);
  }
}

// A block's pass covers SP_THREADS · U fibers, U = SP_SUMS / BM a thread,
// so that every instance keeps SP_SUMS sums in registers.
constexpr int SP_SUMS = 16;

template <typename T, int BM>
__global__ void __launch_bounds__(SP_THREADS) spmm_rows_kernel(
    const SparseArgs<T> p) {
  constexpr int U = SP_SUMS / BM;
  extern __shared__ __align__(16) unsigned char sp_smem[];
  T* const a_s = reinterpret_cast<T*>(sp_smem);
  const int tid = threadIdx.x;
  const int split = blockIdx.x % p.n_split;
  const int m0 = (blockIdx.x / p.n_split) * BM;
  const int rows = min(BM, p.M - m0);
  const int n_lo = split * p.split_w, n_hi = min(p.N, n_lo + p.split_w);
  // Rows past `rows` (the last row block) are held as zeros and their
  // sums never stored.
  const bool whole = p.window >= p.K;
  if (whole) {  // A's rows whole: one copy for every pass
    load_rows<T, BM>(p, a_s, m0, rows, 0, p.K, tid);
    cp_async_wait_all();
    __syncthreads();
  }
  for (int g = n_lo; g < n_hi; g += SP_THREADS * U) {
    float acc[U][BM] = {};
    if (whole) {
      walk<T, BM, U>(p, a_s, g + tid, n_hi, 0, p.K, acc);
    } else {  // K windows, the sums kept across them
      for (int k0 = 0; k0 < p.K; k0 += p.window) {
        const int w = min(p.window, p.K - k0);
        __syncthreads();  // the previous window's reads are done
        load_rows<T, BM>(p, a_s, m0, rows, k0, w, tid);
        cp_async_wait_all();
        __syncthreads();
        walk<T, BM, U>(p, a_s, g + tid, n_hi, k0, w, acc);
      }
    }
    store_columns<T, BM, U>(p, acc, m0, rows, g + tid, n_hi);
  }
}

// Dynamic shared memory above 48 KB, with the SM's memory split in favour
// of shared memory, so that several blocks share an SM.
template <typename T, int BM>
cudaError_t set_rows_smem(int smem) {
  const cudaError_t err = cudaFuncSetAttribute(
      spmm_rows_kernel<T, BM>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(spmm_rows_kernel<T, BM>,
                              cudaFuncAttributePreferredSharedMemoryCarveout,
                              (int)cudaSharedmemCarveoutMaxShared);
}

// Call fn with an int constant BM equal to `rows` (1, 2, 4, 8 or 16).
template <typename Fn>
int rows_dispatch(int rows, Fn&& fn) {
  switch (rows) {
    case 1: return fn(std::integral_constant<int, 1>{});
    case 2: return fn(std::integral_constant<int, 2>{});
    case 4: return fn(std::integral_constant<int, 4>{});
    case 8: return fn(std::integral_constant<int, 8>{});
    case 16: return fn(std::integral_constant<int, 16>{});
  }
  return (int)cudaErrorInvalidValue;
}

template <typename T>
int spmm_sparse(const SparseArgs<T>& p, const int* ids, const T* vals,
                const int* lens, int cap, int bn, int fc,
                cudaStream_t stream) {
  if (p.M == 0 || p.N == 0) return (int)cudaSuccess;
  fiber_transpose_kernel<T><<<(p.N + SP_TILE - 1) / SP_TILE, SP_THREADS, 0,
                              stream>>>(
      ids, vals, lens, p.N, cap, bn, fc, const_cast<int*>(p.ids_t),
      const_cast<T*>(p.vals_t), const_cast<int*>(p.ends));
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return rows_dispatch(p.rows, [&](auto bm) {
    constexpr int BM = decltype(bm)::value;
    const int smem = BM * std::min(p.window, p.K) * (int)sizeof(T);
    const cudaError_t e = set_rows_smem<T, BM>(smem);
    if (e != cudaSuccess) return (int)e;
    const int row_blocks = (p.M + BM - 1) / BM;
    spmm_rows_kernel<T, BM><<<row_blocks * p.n_split, SP_THREADS, smem,
                              stream>>>(p);
    return (int)cudaGetLastError();
  });
}

}  // namespace rt

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
    return rt::spmm_sparse<T>(p, static_cast<const int*>(ids),
                              static_cast<const T*>(vals),
                              static_cast<const int*>(lens), cap, bn,
                              fc, static_cast<cudaStream_t>(stream));
  });
}

// How many sparse-body blocks of `rows` rows and `smem` bytes of shared
// memory one SM holds at once (the wrapper's plan splits N by the card's
// block slots, this times the SM count). Returns a cudaError_t as int.
extern "C" int spmm_sparse_blocks_per_sm(int rows, int smem, int dtype,
                                         int* out) {
  return rt::dtype_dispatch(dtype, [&](auto tag) {
    using T = std::remove_pointer_t<decltype(tag)>;
    return rt::rows_dispatch(rows, [&](auto bm) {
      constexpr int BM = decltype(bm)::value;
      cudaError_t err = rt::set_rows_smem<T, BM>(smem);
      if (err == cudaSuccess)
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            out, rt::spmm_rows_kernel<T, BM>, rt::SP_THREADS, smem);
      return (int)err;
    });
  });
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
