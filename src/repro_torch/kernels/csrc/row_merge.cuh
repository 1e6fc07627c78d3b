// The row merge shared by the outer product's sparse body (spgemm_outer.cu)
// and the Gustavson sparse body (spgemm_gustavson.cu): an output computed
// row by row, each row a sum of scaled fibers. Row m's entries (k, v) come
// from a row source; for each, in order, the row gains v times fiber k of
// the merged operand (ids -> the output's columns). Both bodies launch the
// one kernel, row_merge_kernel; the row source is its template parameter,
// so that each instantiation is the code its body would have alone:
//
// - SortedSlots (outer): row m's entries are A's slots in row order, read
//   through the permutation of the wrapper's stable sort by id
//   (spgemm_outer.a_row_order), ascending in k.
// - FiberSlots (Gustavson, Oᵀ = Bᵀ·Aᵀ): row n is B's fiber n (ids -> K),
//   read in place in slot order with no sort: the warp loads 32 slots at
//   once (with the kinds of their fibers) and takes the live ones in
//   order, so PAD and any id outside [0, K) cost no merge.
//
// A block owns 8 output rows (a warp each) and a chunk of 1024 columns,
// held as f32 accumulators in shared memory. For each entry (k, v) of its
// row a warp adds v·F[k, n] over fiber k's slots in the column chunk: a
// run found by the warp-wide binary search (fiber_search.cuh) for an
// ordered fiber, a run known without a search for a dense one, and a
// tested scan of every slot for a fiber out of order (the kinds from
// launch_fiber_kind's scan). A fiber's ids are unique and a row is one
// warp's, so within one entry every column gains at most one add and no
// add needs an atomic: two runs give the same bits. The work is the (v,
// F) pair count plus one write of the output.
#pragma once

#include "fiber_search.cuh"

namespace rt {

constexpr int OS_ROWS = 8, OS_COLS = 1024, OS_THREADS = OS_ROWS * 32;
constexpr int OS_BATCH = 4;  // entries whose fiber runs are searched together

// Row m's entries are A's slots order[e] for e in [row_ptr[m], row_ptr[m +
// 1]), ascending in k: A's slots sorted into row order (slot s holds fiber
// k = s / cap's value vals[s]).
template <typename T>
struct SortedSlots {
  // OS_BATCH entries a step, their runs read in turn.
  static constexpr int kBatch = OS_BATCH;
  static constexpr bool kBatchRuns = false;
  const int* row_ptr;
  const long long* order;
  const T* vals;
  int cap;

  struct Cursor {
    const long long* __restrict__ order;
    const T* __restrict__ vals;
    const int* __restrict__ kinds;
    int cap, e0, e1;

    __device__ __forceinline__ bool more() const { return e0 < e1; }

    // The next OS_BATCH entries (k = -1 past the row's end) and the kinds
    // of their fibers.
    __device__ __forceinline__ void take(int (&k)[OS_BATCH],
                                         float (&v)[OS_BATCH],
                                         int (&kind)[OS_BATCH]) {
#pragma unroll
      for (int j = 0; j < OS_BATCH; ++j) {
        const bool in = e0 + j < e1;
        const long long slot = in ? order[e0 + j] : 0;
        k[j] = in ? (int)(slot / cap) : -1;
        v[j] = in ? to_f32(vals[slot]) : 0.f;
        kind[j] = in ? kinds[k[j]] : kUnordered;
      }
      e0 += OS_BATCH;
    }
  };

  __device__ __forceinline__ Cursor cursor(int m, int lane,
                                           const int* kinds) const {
    return Cursor{order, vals, kinds, cap, row_ptr[m], row_ptr[m + 1]};
  }
};

// Row m is fiber m of (ids, vals), `cap` slots, ids -> [0, minor): its
// entries are the slots holding an id in range, in slot order. The warp
// reads 32 slots at a time, lane j slot g + j with its fiber's kind, and
// hands the live ones out by a ballot mask, lowest slot first.
template <typename T>
struct FiberSlots {
  // Rows of many short entries (citeseer: about 28 a fiber, each a run of
  // about one slot): 8 entries a step, their runs read together.
  static constexpr int kBatch = 2 * OS_BATCH;
  static constexpr bool kBatchRuns = true;
  const int* ids;
  const T* vals;
  int cap;
  int minor;

  struct Cursor {
    const int* __restrict__ ids;
    const T* __restrict__ vals;
    const int* __restrict__ kinds;
    int cap, minor, lane, g;
    unsigned live;  // lanes of the current 32 slots not yet handed out
    int my_k, my_kind;
    float my_v;

    __device__ __forceinline__ bool more() {
      while (live == 0 && g < cap) {  // uniform across the warp
        const int s = g + lane;
        const int id = s < cap ? ids[s] : PAD_ID;
        const bool in = (unsigned)id < (unsigned)minor;
        my_k = id;
        my_v = in ? to_f32(vals[s]) : 0.f;
        my_kind = in ? kinds[id] : kUnordered;
        live = __ballot_sync(kFull, in);
        g += 32;
      }
      return live != 0;
    }

    // Up to kBatch of the current slots' live entries (k = -1 for the
    // rest) and the kinds of their fibers.
    __device__ __forceinline__ void take(int (&k)[kBatch],
                                         float (&v)[kBatch],
                                         int (&kind)[kBatch]) {
#pragma unroll
      for (int j = 0; j < kBatch; ++j) {
        const bool in = live != 0;
        const int src = in ? __ffs(live) - 1 : 0;
        k[j] = __shfl_sync(kFull, my_k, src);
        v[j] = __shfl_sync(kFull, my_v, src);
        kind[j] = __shfl_sync(kFull, my_kind, src);
        if (!in) {
          k[j] = -1;
          v[j] = 0.f;
          kind[j] = kUnordered;
        }
        live &= live - 1;
      }
    }
  };

  __device__ __forceinline__ Cursor cursor(int m, int lane,
                                           const int* kinds) const {
    const size_t base = (size_t)m * cap;
    return Cursor{ids + base, vals + base, kinds, cap, minor, lane, 0,
                  0u, PAD_ID, kUnordered, 0.f};
  }
};

// The entries' fibers merged one after another, each over its run in the
// column chunk [n0, n0 + width): the runs of ordered fibers binary-searched
// together first, then each entry's slots read and added in entry order.
template <typename T>
__device__ __forceinline__ void merge_runs_in_turn(
    const int (&k)[OS_BATCH], const float (&v)[OS_BATCH],
    const int (&kind)[OS_BATCH], const T* __restrict__ f_vals,
    const int* __restrict__ f_ids, int cap_f, int n0, int width, float* row,
    int lane) {
  bool ord[OS_BATCH];
  const int* fib[2 * OS_BATCH];
  int x[2 * OS_BATCH], lo[2 * OS_BATCH], hi[2 * OS_BATCH];
#pragma unroll
  for (int j = 0; j < OS_BATCH; ++j) {
    ord[j] = kind[j] != kUnordered;
    fib[2 * j] = fib[2 * j + 1] = f_ids + (size_t)max(k[j], 0) * cap_f;
    x[2 * j] = n0;
    x[2 * j + 1] = n0 + width;
    window_ranges(kind[j], cap_f, n0, n0 + width, lo[2 * j], hi[2 * j],
                  lo[2 * j + 1], hi[2 * j + 1]);
  }
  warp_lower_bounds<2 * OS_BATCH>(fib, x, lo, hi, lane);
  // Entries in order; within one, every column gains at most one add.
#pragma unroll
  for (int j = 0; j < OS_BATCH; ++j) {
    if (k[j] < 0) continue;
    const size_t fb = (size_t)k[j] * cap_f;
    const int* ids = f_ids + fb;
    const T* vals = f_vals + fb;
    if (ord[j]) {
      for (int s = lo[2 * j] + lane; s < lo[2 * j + 1]; s += 32) {
        const int c = ids[s] - n0;
        row[c] = fmaf(v[j], to_f32(vals[s]), row[c]);
      }
    } else {
      for (int s = lane; s < cap_f; s += 32) {
        const unsigned c = (unsigned)(ids[s] - n0);
        if (c < (unsigned)width) row[c] = fmaf(v[j], to_f32(vals[s]), row[c]);
      }
    }
    __syncwarp();
  }
}

// Fibers of at most this many slots are read whole (every id tested)
// rather than binary-searched: two rounds of loads at most, no more than a
// search and its run.
constexpr int OS_SCAN_CAP = 64;

// The entries' fibers merged together, 32 slots of each at a time: fibers
// of at most 32 slots are read whole, one slot a lane, ids tested (no
// ranges at all: citeseer's A holds about 4 entries a fiber); else every
// entry's slot range in the column chunk first (a dense fiber's without a
// search; an ordered fiber's binary-searched unless it is short; else the
// whole fiber, ids tested), then in rounds of 32 slots the loads of all
// entries in flight together before the adds, entry by entry. Within one
// entry every column gains at most one add, and the order of the adds is
// fixed by the data, so two runs give the same bits.
template <typename T, int B>
__device__ __forceinline__ void merge_runs_together(
    const int (&k)[B], const float (&v)[B], const int (&kind)[B],
    const T* __restrict__ f_vals, const int* __restrict__ f_ids, int cap_f,
    int n0, int width, float* row, int lane) {
  static_assert(B % OS_BATCH == 0, "searched OS_BATCH entries at a time");
  if (cap_f <= 32) {  // uniform: one slot a lane, every fiber read whole
    unsigned c[B];
    float x_v[B];
#pragma unroll
    for (int j = 0; j < B; ++j) {
      c[j] = ~0u;
      x_v[j] = 0.f;
      if (k[j] >= 0 && lane < cap_f) {
        const size_t at = (size_t)k[j] * cap_f + lane;
        c[j] = (unsigned)(f_ids[at] - n0);
        x_v[j] = to_f32(f_vals[at]);
      }
    }
#pragma unroll
    for (int j = 0; j < B; ++j) {
      if (c[j] < (unsigned)width) row[c[j]] = fmaf(v[j], x_v[j], row[c[j]]);
      __syncwarp();
    }
    return;
  }
  const bool search = cap_f > OS_SCAN_CAP;  // uniform across the warp
  int s0[B], s1[B], most = 0;
#pragma unroll
  for (int h = 0; h < B; h += OS_BATCH) {
    const int* fib[2 * OS_BATCH];
    int x[2 * OS_BATCH], lo[2 * OS_BATCH], hi[2 * OS_BATCH];
    bool scan[OS_BATCH];
#pragma unroll
    for (int i = 0; i < OS_BATCH; ++i) {
      const int j = h + i;
      fib[2 * i] = fib[2 * i + 1] = f_ids + (size_t)max(k[j], 0) * cap_f;
      x[2 * i] = n0;
      x[2 * i + 1] = n0 + width;
      scan[i] = k[j] >= 0 && (kind[j] == kUnordered ||
                              (kind[j] == kOrdered && !search));
      // No entry, or a fiber scanned whole: closed ranges (kind 0).
      window_ranges(k[j] < 0 || scan[i] ? 0 : kind[j], cap_f, n0, n0 + width,
                    lo[2 * i], hi[2 * i], lo[2 * i + 1], hi[2 * i + 1]);
    }
    if (search) warp_lower_bounds<2 * OS_BATCH>(fib, x, lo, hi, lane);
#pragma unroll
    for (int i = 0; i < OS_BATCH; ++i) {
      s0[h + i] = scan[i] ? 0 : lo[2 * i];
      s1[h + i] = scan[i] ? cap_f : lo[2 * i + 1];
      most = max(most, s1[h + i] - s0[h + i]);
    }
  }
  for (int off = 0; off < most; off += 32) {
    unsigned c[B];
    float x_v[B];
#pragma unroll
    for (int j = 0; j < B; ++j) {
      const int s = s0[j] + off + lane;
      c[j] = ~0u;
      x_v[j] = 0.f;
      if (s < s1[j]) {
        const size_t at = (size_t)k[j] * cap_f + s;
        c[j] = (unsigned)(f_ids[at] - n0);
        x_v[j] = to_f32(f_vals[at]);
      }
    }
#pragma unroll
    for (int j = 0; j < B; ++j) {
      if (c[j] < (unsigned)width) row[c[j]] = fmaf(v[j], x_v[j], row[c[j]]);
      __syncwarp();
    }
  }
}

// out (M, N): row m of the output over the column chunk blockIdx.y, from
// rows' entries (k, v) and the merged fibers (f_vals, f_ids; cap_f slots,
// ids -> [0, N), kinds f_kind).
template <typename T, typename Rows>
__device__ __forceinline__ void merge_rows(
    const Rows& rows, const T* __restrict__ f_vals,
    const int* __restrict__ f_ids, const int* __restrict__ f_kind,
    int cap_f, T* __restrict__ out, int M, int N) {
  __shared__ float acc[OS_ROWS][OS_COLS];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int m = blockIdx.x * OS_ROWS + warp;
  const int n0 = blockIdx.y * OS_COLS, width = min(OS_COLS, N - n0);
  if (m >= M) return;  // no block-wide barrier below: a row is one warp's
  float* row = acc[warp];
  for (int c = lane; c < width; c += 32) row[c] = 0.f;
  __syncwarp();
  for (auto cur = rows.cursor(m, lane, f_kind); cur.more();) {
    int k[Rows::kBatch], kind[Rows::kBatch];
    float v[Rows::kBatch];
    cur.take(k, v, kind);
    if constexpr (Rows::kBatchRuns)
      merge_runs_together<T, Rows::kBatch>(k, v, kind, f_vals, f_ids, cap_f,
                                           n0, width, row, lane);
    else
      merge_runs_in_turn<T>(k, v, kind, f_vals, f_ids, cap_f, n0, width,
                            row, lane);
  }
  T* dst = out + (size_t)m * N + n0;
  for (int c = lane; c < width; c += 32) dst[c] = from_f32<T>(row[c]);
}

// The kernel, one instantiation a row source: the outer product's with no
// register cap.
template <typename T, typename Rows>
__global__ void __launch_bounds__(OS_THREADS) row_merge_kernel(
    const Rows rows, const T* __restrict__ f_vals,
    const int* __restrict__ f_ids, const int* __restrict__ f_kind,
    int cap_f, T* __restrict__ out, int M, int N) {
  merge_rows<T>(rows, f_vals, f_ids, f_kind, cap_f, out, M, N);
}

// Gustavson's rows of short entries (citeseer: about 28 a row, each a run
// of about one slot) wait on loads more than they compute: at most 64
// registers a thread, so that four blocks (32 warps) share an SM.
template <typename T>
__global__ void __launch_bounds__(OS_THREADS, 4) row_merge_kernel(
    const FiberSlots<T> rows, const T* __restrict__ f_vals,
    const int* __restrict__ f_ids, const int* __restrict__ f_kind,
    int cap_f, T* __restrict__ out, int M, int N) {
  merge_rows<T>(rows, f_vals, f_ids, f_kind, cap_f, out, M, N);
}

// The kinds of the merged fibers (K of them), then the merge.
template <typename T, typename Rows>
int launch_row_merge(const Rows& rows, const T* f_vals, const int* f_ids,
                     int* f_kind, int cap_f, T* out, int M, int K, int N,
                     cudaStream_t stream) {
  if (M == 0 || N == 0) return (int)cudaSuccess;
  const cudaError_t err =
      launch_fiber_kind(f_ids, K, cap_f, N, f_kind, stream);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((M + OS_ROWS - 1) / OS_ROWS, (N + OS_COLS - 1) / OS_COLS);
  // The FiberSlots overload where it applies (the more specialized).
  row_merge_kernel<T><<<grid, OS_THREADS, 0, stream>>>(
      rows, f_vals, f_ids, f_kind, cap_f, out, M, N);
  return (int)cudaGetLastError();
}

}  // namespace rt
