// Contraction kernels shared by the inner-product SpGEMM (spgemm_inner.cu)
// and the Gustavson SpGEMM (spgemm_gustavson.cu). Both compute a product
// of two fiber operands; they differ in which operand drives and in how
// the output is laid out, which the template flags below select at compile
// time, so each instantiation is the code its kernel would have alone.
//
// gather_contract_kernel: a dense (K, C) f32 table (built beforehand by a
// scatter of fiber_table.cuh) times R driving fibers (ids -> K): for every
// live slot (k, v) of driving fiber r, row r of the product gains
// v·table[k, :]. Inner: A's M row fibers drive B's (K, N) table and the
// product (M, N) is the output. Gustavson: B's N column fibers drive A's
// (K, M) table, the product is (N, M), and the output (M, N) is its
// transpose (kTransposeOut): each block stages its tile in shared memory
// and stores it transposed, so no (N, M) buffer is written and transposed
// afterwards.
//
// expand_update_kernel: one block owns a 128 x 128 output tile and walks K
// in steps of bk <= 128; each live step expands both operands' entries in
// the step into shared-memory tiles, K-major, and applies a rank-bk update
// with f32 FMAs. B is N column fibers (ids -> K) in both. A is M row fibers
// (ids -> K) for inner, or K column fibers (ids -> M) for Gustavson
// (kAColumns): then A's fiber axis is K and its window is the tile's M
// range, and A's bk fibers of the step fill the rows of the A tile.
#pragma once

#include "common.cuh"

namespace rt {

// ------------------------------------------------------- gather-contract
constexpr int GC_ROWS = 32, GC_COLS = 128, GC_SLOTS = 64, GC_THREADS = 256;
constexpr int GC_WROWS = GC_ROWS / (GC_THREADS / 32);  // rows per warp
constexpr int GC_WCOLS = GC_COLS / 32;                 // columns per lane

// Each block takes 32 driving fibers and a run of 128 consecutive table
// columns: it stages the fibers' ids and values in shared memory, 64 slots
// at a time, and for every live slot (k, v) of a fiber each lane adds
// v·table[k, c] for its 4 columns c, so the 32 lanes of a warp read 128
// consecutive floats of one table row. The trip count is the fibers' live
// chunk bound (row_chunks of block_chunk_counts(fibers, row_block, fc)); a
// block whose table columns all lie in blocks that col_live (> 0 where a
// column block holds an entry) marks empty writes zeros without reading
// the driving fibers.
template <typename T, bool kTransposeOut>
__global__ void __launch_bounds__(GC_THREADS) gather_contract_kernel(
    const T* __restrict__ vals, const int* __restrict__ ids, int cap,
    const int* __restrict__ row_chunks, int row_block, int fc,
    const float* __restrict__ table, const int* __restrict__ col_live,
    int col_block, T* __restrict__ out, int R, int C) {
  __shared__ int s_ids[GC_ROWS][GC_SLOTS];
  __shared__ float s_vals[GC_ROWS][GC_SLOTS];
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int r0 = blockIdx.y * GC_ROWS, c0 = blockIdx.x * GC_COLS;

  // Live slots: the most that any fiber block among the block's rows holds.
  int live = 0;
  const int r_last = min(R, r0 + GC_ROWS) - 1;
  for (int w = r0 / row_block; w <= r_last / row_block; ++w)
    live = max(live, min(cap, row_chunks[w] * fc));
  const bool probe = tid < GC_COLS && c0 + tid < C &&
                     col_live[(c0 + tid) / col_block] > 0;
  if (!__syncthreads_or(probe)) live = 0;  // every column block empty

  float acc[GC_WROWS][GC_WCOLS];
#pragma unroll
  for (int r = 0; r < GC_WROWS; ++r)
#pragma unroll
    for (int q = 0; q < GC_WCOLS; ++q) acc[r][q] = 0.f;

  for (int s0 = 0; s0 < live; s0 += GC_SLOTS) {
    const int ns = min(GC_SLOTS, live - s0);
    for (int i = tid; i < GC_ROWS * GC_SLOTS; i += GC_THREADS) {
      const int r = i / GC_SLOTS, c = i % GC_SLOTS;
      const int row = r0 + r;
      int id = -1;  // PAD_ID
      float v = 0.f;
      if (row < R && c < ns) {
        const size_t off = (size_t)row * cap + s0 + c;
        id = ids[off];
        v = to_f32(vals[off]);
      }
      s_ids[r][c] = id;
      s_vals[r][c] = v;
    }
    __syncthreads();
    for (int c = 0; c < ns; ++c) {
#pragma unroll
      for (int r = 0; r < GC_WROWS; ++r) {
        const int id = s_ids[warp * GC_WROWS + r][c];  // warp-uniform
        if (id < 0) continue;
        const float v = s_vals[warp * GC_WROWS + r][c];
        const float* trow = table + (size_t)id * C + c0 + lane;
#pragma unroll
        for (int q = 0; q < GC_WCOLS; ++q)
          if (c0 + lane + 32 * q < C)
            acc[r][q] = fmaf(v, trow[32 * q], acc[r][q]);
      }
    }
    __syncthreads();
  }

  if constexpr (kTransposeOut) {
    // out is (C, R): stage the (rows, columns) tile, then let each warp
    // store one column's 32 rows, which are consecutive in out. The +1
    // keeps both the staging writes and the column reads free of bank
    // conflicts.
    __shared__ float s_out[GC_ROWS][GC_COLS + 1];
#pragma unroll
    for (int r = 0; r < GC_WROWS; ++r)
#pragma unroll
      for (int q = 0; q < GC_WCOLS; ++q) {
        const int cl = lane + 32 * q, c = c0 + cl;
        s_out[warp * GC_WROWS + r][cl] =
            c < C && col_live[c / col_block] > 0 ? acc[r][q] : 0.f;
      }
    __syncthreads();
    const int row = r0 + lane;
    for (int cl = warp; cl < GC_COLS; cl += GC_THREADS / 32) {
      const int c = c0 + cl;
      if (c < C && row < R)
        out[(size_t)c * R + row] = from_f32<T>(s_out[lane][cl]);
    }
  } else {
#pragma unroll
    for (int r = 0; r < GC_WROWS; ++r) {
      const int row = r0 + warp * GC_WROWS + r;
      if (row >= R) continue;
#pragma unroll
      for (int q = 0; q < GC_WCOLS; ++q) {
        const int c = c0 + lane + 32 * q;
        if (c < C)
          out[(size_t)row * C + c] =
              from_f32<T>(col_live[c / col_block] > 0 ? acc[r][q] : 0.f);
      }
    }
  }
}

// Launch the gather-contract over an (R, C) product; returns
// cudaGetLastError().
template <typename T, bool kTransposeOut>
cudaError_t launch_gather_contract(const T* vals, const int* ids, int cap,
                                   const int* row_chunks, int row_block,
                                   int fc, const float* table,
                                   const int* col_live, int col_block, T* out,
                                   int R, int C, cudaStream_t stream) {
  const dim3 grid((C + GC_COLS - 1) / GC_COLS, (R + GC_ROWS - 1) / GC_ROWS);
  gather_contract_kernel<T, kTransposeOut><<<grid, GC_THREADS, 0, stream>>>(
      vals, ids, cap, row_chunks, row_block, fc, table, col_live, col_block,
      out, R, C);
  return cudaGetLastError();
}

// ---------------------------------------------------------- expand-update
constexpr int EU_M = 128, EU_N = 128, EU_KMAX = 128, EU_THREADS = 256;
// Row stride of the expansion tiles: 4 floats of padding keep rows 16-byte
// aligned for the vector loads of the update and spread the scatter's
// writes (lanes on different k, one column) over 8 banks instead of one.
constexpr int EU_LD = EU_M + 4;
static_assert(EU_M == EU_N, "both expansion tiles share EU_LD");

// One fiber's entries with ids in [lo, lo + width) into a shared tile: the
// entry with id i lands at E[(i - lo) * kStride]. An ordered fiber (live
// ids in range and ascending, PAD slots last) reads just the slots
// [range[0], range[1]) that the wrapper's occupancy prefix sums give for
// the window, and tests no id: the test made the inner reference body
// about 1.5x slower at gnmt on the H100 (PERF.md). Any other fiber scans
// every slot, each id tested, so no input writes outside the tile.
template <int kStride, typename T>
__device__ __forceinline__ void expand_fiber(
    const T* __restrict__ vals, const int* __restrict__ ids, int cap,
    bool ordered, const int* __restrict__ range, int lo, int width,
    float* __restrict__ E, int lane) {
  if (ordered) {
    const int s1 = range[1];
    for (int s = range[0] + lane; s < s1; s += 32)
      E[(ids[s] - lo) * kStride] = to_f32(vals[s]);
  } else {
    for (int s = lane; s < cap; s += 32) {
      const unsigned r = (unsigned)(ids[s] - lo);
      if (r < (unsigned)width) E[r * kStride] = to_f32(vals[s]);
    }
  }
}

// Occupancy and slot ranges, computed by the wrapper (as the TPU's scalar
// prefetch): b_occ[(n / bn) * k_steps + kk] counts B's entries of fiber
// block n / bn in step kk, and b_off[n * (k_steps + 1) + kk] is where they
// start in fiber n. For A, inner: a_occ[(m / bm) * k_steps + kk] and
// a_off[m * (k_steps + 1) + kk], as for B. Gustavson: with T = gridDim.y M
// tiles of 128, a_occ[kk * T + t] counts A's entries of step kk's fibers in
// M tile t, and a_off[k * (T + 1) + t] is where fiber k's entries in tile t
// start. A step runs only when both sides hold an entry in the tile.
template <typename T, bool kAColumns>
__global__ void __launch_bounds__(EU_THREADS) expand_update_kernel(
    const T* __restrict__ a_vals, const int* __restrict__ a_ids,
    const int* __restrict__ a_off, const bool* __restrict__ a_ord, int cap_a,
    const T* __restrict__ b_vals, const int* __restrict__ b_ids,
    const int* __restrict__ b_off, const bool* __restrict__ b_ord, int cap_b,
    const int* __restrict__ a_occ, int bm, const int* __restrict__ b_occ,
    int bn, T* __restrict__ out, int M, int N, int bk, int k_steps) {
  extern __shared__ __align__(16) float smem[];
  float* Ea = smem;               // Ea[k - k0][m - m0]
  float* Eb = smem + bk * EU_LD;  // Eb[k - k0][n - n0]
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int tx = tid % 16, ty = tid / 16;
  const int m0 = blockIdx.y * EU_M, n0 = blockIdx.x * EU_N;
  const int n_a = kAColumns ? bk : EU_M;  // A fibers expanded per step

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  for (int kk = 0; kk < k_steps; ++kk) {
    // Both-live test: A's count (one per tile for Gustavson; threads
    // 0..127 probe the tile's rows for inner), then threads 128..255 probe
    // the tile's columns.
    bool probe = false;
    if constexpr (kAColumns) {
      probe = tid == 0 && a_occ[(size_t)kk * gridDim.y + blockIdx.y] > 0;
    } else if (tid < EU_M) {
      const int m = m0 + tid;
      probe = m < M && a_occ[(size_t)(m / bm) * k_steps + kk] > 0;
    }
    const int live_a = __syncthreads_or(probe);
    probe = false;
    if (tid >= EU_M) {
      const int n = n0 + tid - EU_M;
      probe = n < N && b_occ[(size_t)(n / bn) * k_steps + kk] > 0;
    }
    const int live_b = __syncthreads_or(probe);
    if (!(live_a && live_b)) continue;  // uniform across the block

    for (int i = tid; i < 2 * bk * EU_LD; i += EU_THREADS) smem[i] = 0.f;
    __syncthreads();
    const int k0 = kk * bk;
    // One warp per fiber (A's n_a, then B's 128), lanes over its slots.
    for (int f = warp; f < n_a + EU_N; f += EU_THREADS / 32) {
      if (f < n_a) {
        if constexpr (kAColumns) {
          const int k = k0 + f;  // bk divides K: always a fiber of A
          const size_t base = (size_t)k * cap_a;
          expand_fiber<1>(a_vals + base, a_ids + base, cap_a, a_ord[k],
                          a_off + (size_t)k * (gridDim.y + 1) + blockIdx.y,
                          m0, EU_M, Ea + f * EU_LD, lane);
        } else {
          const int m = m0 + f;
          if (m >= M) continue;
          const size_t base = (size_t)m * cap_a;
          expand_fiber<EU_LD>(a_vals + base, a_ids + base, cap_a, a_ord[m],
                              a_off + (size_t)m * (k_steps + 1) + kk, k0,
                              bk, Ea + f, lane);
        }
      } else {
        const int col = f - n_a, n = n0 + col;
        if (n >= N) continue;
        const size_t base = (size_t)n * cap_b;
        expand_fiber<EU_LD>(b_vals + base, b_ids + base, cap_b, b_ord[n],
                            b_off + (size_t)n * (k_steps + 1) + kk, k0, bk,
                            Eb + col, lane);
      }
    }
    __syncthreads();
#pragma unroll 4
    for (int k = 0; k < bk; ++k) {
      float a[8], b[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) a[i] = Ea[k * EU_LD + ty * 8 + i];
#pragma unroll
      for (int j = 0; j < 8; ++j) b[j] = Eb[k * EU_LD + tx * 8 + j];
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int m = m0 + ty * 8 + i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int n = n0 + tx * 8 + j;
      if (n < N) out[(size_t)m * N + n] = from_f32<T>(acc[i][j]);
    }
  }
}

// Launch the expand-update over an (M, N) output; bk must divide K and be
// at most EU_KMAX. Returns a cudaError_t as int.
template <typename T, bool kAColumns>
int launch_expand_update(const T* a_vals, const int* a_ids, const int* a_off,
                         const bool* a_ord, int cap_a, const T* b_vals,
                         const int* b_ids, const int* b_off,
                         const bool* b_ord, int cap_b, const int* a_occ,
                         int bm, const int* b_occ, int bn, T* out, int M,
                         int K, int N, int bk, cudaStream_t stream) {
  if (bk < 1 || bk > EU_KMAX || K % bk) return (int)cudaErrorInvalidValue;
  const size_t smem = 2 * (size_t)bk * EU_LD * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      expand_update_kernel<T, kAColumns>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((N + EU_N - 1) / EU_N, (M + EU_M - 1) / EU_M);
  expand_update_kernel<T, kAColumns><<<grid, EU_THREADS, smem, stream>>>(
      a_vals, a_ids, a_off, a_ord, cap_a, b_vals, b_ids, b_off, b_ord, cap_b,
      a_occ, bm, b_occ, bn, out, M, N, bk, K / bk);
  return (int)cudaGetLastError();
}

}  // namespace rt
