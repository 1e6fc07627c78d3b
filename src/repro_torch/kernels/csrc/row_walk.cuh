// The row walk shared by the SpMM sparse body (spmm.cu) and the
// inner-product sparse body (spgemm_inner.cu): a few rows of a dense-side
// operand held k-major in shared memory, times column fibers (ids -> K)
// that the block's threads walk slot by slot. Both bodies launch the one
// kernel, row_walk_kernel; the template's RowLoad says where its rows come
// from, so that each instantiation is the code its body would have alone.
//
// - RowLoad::kDense (SpMM): the rows of a dense row-major (M, K) operand,
//   copied as they lie (cp.async for a single row, element loads for
//   more).
// - RowLoad::kFibers (inner, Oᵀ = Bᵀ·Aᵀ): the rows are fibers (ids -> K,
//   PAD_ID = -1 padding; B's column fibers), expanded in shared memory:
//   the block zeroes its rows, then writes each slot's value at its id. A
//   fiber's ids are unique, so no write needs an atomic and slot order
//   does not matter; PAD and any id outside [0, K) are dropped. Every slot
//   of every fiber is read once (ids and values coalesced, four slots a
//   load where the capacity allows), which is exactly the fibers' bytes;
//   a K window (below) reads them once a window.
//
// The walk:
// - A block owns `rows` (1, 2, 4, 8 or 16) rows and holds them whole in
//   shared memory, at most 96 KB, so that two or more blocks share an SM
//   and one block's load overlaps another's walk. They are held k-major,
//   a[k][r], so that the rows' values at one k are one or a few loads of
//   up to 16 bytes. A row that does not fit (K·elem > 96 KB) is walked in
//   K windows: the block then takes 256 fibers at a time, one a thread,
//   and keeps their sums in registers across the windows.
// - Threads walk fibers: thread t takes fibers n0 + t, n0 + t + 256, ... of
//   its block's fiber range, 16 / rows of them in step (their loads in
//   flight together), walks each one's slots in order, drops PAD and any
//   id outside [0, K) (as the TPU's table drops it), and adds a[m, id] ·
//   val into `rows` f32 sums, which it rounds once and stores to out[m0 ..
//   m0 + rows, n]: consecutive threads store consecutive n.
// - The walked fibers are read slot-major: a pre-pass
//   (fiber_transpose_kernel) copies each fiber's live slots (those below
//   its block's live bound, the TPU body's block_chunk_counts · fc,
//   computed there from the fibers' lengths) into (cap, N) arrays and
//   records where each fiber's last non-PAD slot ends, so a warp reads one
//   slot of 32 fibers as 128 contiguous bytes and walks no trailing
//   padding.
// - The grid is row blocks x fiber splits, splits of one row block
//   adjacent so that they read its rows from L2; the wrapper's plan
//   (spmm.py spmm_sparse_plan) splits the fibers so that a launch with few
//   row blocks still fills the card's block slots.
// - Every output is one thread's sum in slot order: no atomics, the same
//   bits on every run, and nothing read on the host.
#pragma once

#include <algorithm>
#include <type_traits>

#include "common.cuh"

namespace rt {

enum class RowLoad { kDense, kFibers };

constexpr int SP_THREADS = 256;
constexpr int SP_TILE = 32;  // fibers and slots of a transpose tile

template <typename T>
struct SparseArgs {
  const T* a;          // kDense: (M, K) row-major
  const int* row_ids;  // kFibers: (M, row_cap) fibers, ids -> K
  const T* row_vals;
  int row_cap;
  int row_vec;         // kFibers: slots a load (4 where aligned, else 1)
  const int* ids_t;    // (cap, N): slot c of fiber n at c·N + n
  const T* vals_t;
  const int* ends;     // (N,): one past each fiber's last non-PAD slot
  T* out;              // (M, N)
  int M, K, N;
  int rows;            // rows a block owns (the kernel's BM)
  int window;          // K elements of the rows a block holds at once
  int split_w;         // fibers of a block's range
  int n_split;         // fiber ranges per row block
  int a_gran;          // kDense: elements per cp.async copy of A's rows
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

// A block holds its rows k-major, a[k][r] at k·BM + r, so that a slot's BM
// values are one or a few loads of up to 16 bytes (and fewer bank
// conflicts than BM loads at one random bank each). Copy A[m0 .. m0 +
// rows, k0 .. k0 + w) there. One row is k-major as it lies: `gran`
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

// Four slots of a fiber's values, as one load where the slots allow it.
template <typename T>
struct Vec4;
template <>
struct Vec4<float> {
  using type = float4;
  __device__ static float get(const float4& v, int i) {
    return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
  }
};
template <>
struct Vec4<__nv_bfloat16> {
  using type = uint2;
  __device__ static __nv_bfloat16 get(const uint2& v, int i) {
    const unsigned u = i < 2 ? v.x : v.y;
    const unsigned short h = (unsigned short)(i % 2 ? u >> 16 : u & 0xffffu);
    return __ushort_as_bfloat16(h);
  }
};

// Expand the fibers m0 .. m0 + rows of (row_ids, row_vals) over the K
// window [k0, k0 + w) into a_s, k-major as load_rows holds rows: zero the
// block's rows (rows past `rows` stay zero), barrier, then write each slot
// whose id lies in the window. The slots of all the rows are one index
// space, each thread taking kBatch of them (row_vec slots a load) before
// it writes any, so that their loads are in flight together. The caller
// syncs before the walk.
constexpr int SP_EXPAND_BATCH = 4;

template <typename T, int BM>
__device__ __forceinline__ void expand_rows(const SparseArgs<T>& p, T* a_s,
                                            int m0, int rows, int k0, int w,
                                            int tid) {
  const int n16 = w * BM * (int)sizeof(T) / 16;
  int4* z = reinterpret_cast<int4*>(a_s);
  for (int i = tid; i < n16; i += SP_THREADS) z[i] = make_int4(0, 0, 0, 0);
  for (int i = n16 * 16 / (int)sizeof(T) + tid; i < w * BM; i += SP_THREADS)
    a_s[i] = from_f32<T>(0.f);
  __syncthreads();
  const int vec = p.row_vec;
  const int per_row = p.row_cap / vec;  // loads a row (row_cap % vec == 0)
  const int total = rows * per_row;
  const size_t base = (size_t)m0 * p.row_cap;
  const int* ids = p.row_ids + base;
  const T* vals = p.row_vals + base;
  for (int i0 = tid; i0 < total; i0 += SP_THREADS * SP_EXPAND_BATCH) {
    int id[SP_EXPAND_BATCH][4];
    T v[SP_EXPAND_BATCH][4];
    int r[SP_EXPAND_BATCH];
#pragma unroll
    for (int b = 0; b < SP_EXPAND_BATCH; ++b) {
      const int i = i0 + b * SP_THREADS;
      r[b] = i / per_row;
      const int s = (i - r[b] * per_row) * vec;  // first slot in its row
      const size_t off = (size_t)r[b] * p.row_cap + s;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        id[b][j] = PAD_ID;
        v[b][j] = from_f32<T>(0.f);
      }
      if (i >= total) continue;
      if (vec == 4) {
        const int4 i4 = *reinterpret_cast<const int4*>(ids + off);
        const auto v4 =
            *reinterpret_cast<const typename Vec4<T>::type*>(vals + off);
        id[b][0] = i4.x;
        id[b][1] = i4.y;
        id[b][2] = i4.z;
        id[b][3] = i4.w;
#pragma unroll
        for (int j = 0; j < 4; ++j) v[b][j] = Vec4<T>::get(v4, j);
      } else {
        id[b][0] = ids[off];
        v[b][0] = vals[off];
      }
    }
#pragma unroll
    for (int b = 0; b < SP_EXPAND_BATCH; ++b)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        // PAD, an id outside [0, K), or one of another window: dropped.
        const unsigned kk = (unsigned)(id[b][j] - k0);
        if (kk < (unsigned)w) a_s[kk * BM + r[b]] = v[b][j];
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
// in step, D slots of all U at once (U·D independent loads in flight),
// each in slot order, against the rows held in a_s (columns k0 .. k0 +
// w); sums into acc[u].
template <typename T, int BM, int U, int D>
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
  for (int c = 0; c < most; c += D) {
    int id[D][U];
    float v[D][U];
#pragma unroll
    for (int d = 0; d < D; ++d)
#pragma unroll
      for (int u = 0; u < U; ++u) {
        id[d][u] = PAD_ID;
        v[d][u] = 0.f;
        if (c + d < end[u]) {
          const size_t off = (size_t)(c + d) * p.N + n + u * SP_THREADS;
          id[d][u] = p.ids_t[off];
          v[d][u] = to_f32(p.vals_t[off]);
        }
      }
#pragma unroll
    for (int d = 0; d < D; ++d)
#pragma unroll
      for (int u = 0; u < U; ++u) {
        // PAD, an id outside [0, K), or one of another window: dropped.
        const unsigned j = (unsigned)(id[d][u] - k0);
        if (j >= (unsigned)w) continue;
        float x[BM];
        load_col<BM>(a_s + j * BM, x);
#pragma unroll
        for (int r = 0; r < BM; ++r)
          acc[u][r] = fmaf(x[r], v[d][u], acc[u][r]);
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

// A block's pass covers SP_THREADS · U fibers, U a thread, each walked D
// slots at a time. SpMM's rows (kDense): U = SP_SUMS / BM, so that every
// instance keeps SP_SUMS sums in registers, one slot at a time. The inner
// body's (kFibers) trade fibers for slots where its launches give a thread
// few but long fibers: one row (bibd_81_3: 640 walked fibers of about 20
// slots for 256 threads) walks 4 fibers 4 slots at a time, 4 and 8 rows
// (citeseer, speech) 2 and 4 slots at a time; 2 rows (m3plates: about one
// slot a fiber) keep 8 fibers one slot at a time. spgemm_inner.INNER_WALK
// is this table.
constexpr int SP_SUMS = 16;

template <RowLoad kLoad, int BM>
struct WalkShape {
  static constexpr bool kFib = kLoad == RowLoad::kFibers;
  static constexpr int U = kFib && BM == 1 ? 4 : SP_SUMS / BM;
  static constexpr int D = !kFib || BM == 2 ? 1 : BM == 4 ? 2 : 4;
};

// The block's rows over the K window [k0, k0 + w), ready for the walk.
template <typename T, int BM, RowLoad kLoad>
__device__ __forceinline__ void hold_rows(const SparseArgs<T>& p, T* a_s,
                                          int m0, int rows, int k0, int w,
                                          int tid) {
  if constexpr (kLoad == RowLoad::kDense) {
    load_rows<T, BM>(p, a_s, m0, rows, k0, w, tid);
    cp_async_wait_all();
  } else {
    expand_rows<T, BM>(p, a_s, m0, rows, k0, w, tid);
  }
  __syncthreads();
}

template <typename T, int BM, RowLoad kLoad>
__global__ void __launch_bounds__(SP_THREADS) row_walk_kernel(
    const SparseArgs<T> p) {
  constexpr int U = WalkShape<kLoad, BM>::U, D = WalkShape<kLoad, BM>::D;
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
  if (whole)  // the rows whole: one load for every pass
    hold_rows<T, BM, kLoad>(p, a_s, m0, rows, 0, p.K, tid);
  for (int g = n_lo; g < n_hi; g += SP_THREADS * U) {
    float acc[U][BM] = {};
    if (whole) {
      walk<T, BM, U, D>(p, a_s, g + tid, n_hi, 0, p.K, acc);
    } else {  // K windows, the sums kept across them
      for (int k0 = 0; k0 < p.K; k0 += p.window) {
        const int w = min(p.window, p.K - k0);
        __syncthreads();  // the previous window's reads are done
        hold_rows<T, BM, kLoad>(p, a_s, m0, rows, k0, w, tid);
        walk<T, BM, U, D>(p, a_s, g + tid, n_hi, k0, w, acc);
      }
    }
    store_columns<T, BM, U>(p, acc, m0, rows, g + tid, n_hi);
  }
}

// Dynamic shared memory above 48 KB, with the SM's memory split in favour
// of shared memory, so that several blocks share an SM. The attributes are
// the function's and outlive a launch: each device sets them again only
// for a size larger than it has set.
template <typename T, int BM, RowLoad kLoad>
cudaError_t set_rows_smem(int smem) {
  constexpr int kDevices = 64;
  static int set[kDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < kDevices && set[dev] >= smem) return cudaSuccess;
  err = cudaFuncSetAttribute(row_walk_kernel<T, BM, kLoad>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(row_walk_kernel<T, BM, kLoad>,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             (int)cudaSharedmemCarveoutMaxShared);
  if (err == cudaSuccess && dev < kDevices) set[dev] = smem;
  return err;
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

// The pre-pass over the walked fibers (ids, vals, lens; N of them, cap
// slots, live bounds from blocks of bn and chunks of fc), then the walk.
template <typename T, RowLoad kLoad>
int launch_row_walk(const SparseArgs<T>& p, const int* ids, const T* vals,
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
    const cudaError_t e = set_rows_smem<T, BM, kLoad>(smem);
    if (e != cudaSuccess) return (int)e;
    const int row_blocks = (p.M + BM - 1) / BM;
    row_walk_kernel<T, BM, kLoad><<<row_blocks * p.n_split, SP_THREADS, smem,
                                    stream>>>(p);
    return (int)cudaGetLastError();
  });
}

// How many blocks of `rows` rows and `smem` bytes of shared memory one SM
// holds at once, for the instantiation of kLoad in `dtype`.
template <RowLoad kLoad>
int row_walk_blocks_per_sm(int rows, int smem, int dtype, int* out) {
  return dtype_dispatch(dtype, [&](auto tag) {
    using T = std::remove_pointer_t<decltype(tag)>;
    return rows_dispatch(rows, [&](auto bm) {
      constexpr int BM = decltype(bm)::value;
      cudaError_t err = set_rows_smem<T, BM, kLoad>(smem);
      if (err == cudaSuccess)
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            out, row_walk_kernel<T, BM, kLoad>, SP_THREADS, smem);
      return (int)err;
    });
  });
}

}  // namespace rt
