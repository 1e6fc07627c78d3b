// The gather-contract kernel shared by the sparse bodies of the
// inner-product SpGEMM (spgemm_inner.cu) and the Gustavson SpGEMM
// (spgemm_gustavson.cu). Both compute a product of two fiber operands; they
// differ in which operand drives and in how the output is laid out, which
// the template flag below selects at compile time, so each instantiation is
// the code its kernel would have alone.
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

}  // namespace rt
