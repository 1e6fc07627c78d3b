// Scatters of fibers into a dense f32 table for the sparse bodies: of
// column fibers into table columns, for the inner-product SpGEMM
// (spgemm_inner.cu), and of fibers into table rows, for the Gustavson
// SpGEMM (spgemm_gustavson.cu; at the end of this file).
//
// N fibers (ids -> K, capacity cap, PAD_ID = -1 padding) land in a (K, N)
// table: entry c of fiber f goes to table[ids[f, c], f]. The table must be
// zeroed beforehand (the wrappers allocate it with torch.zeros). Each fiber
// owns one table column and its ids are unique, so no atomics are needed.
// chunk_counts holds, per block of bn fibers, the number of live capacity
// chunks of fc slots (block_chunk_counts): slots beyond them are padding
// and are never read, and a block whose count is 0 writes nothing.
//
// On the TPU each kernel builds its table in VMEM at the first grid step of
// an N block and reuses it on later steps, which needs the grid to run in
// order on one core. CUDA blocks run in parallel, so here the table is a
// buffer in device memory built by this kernel before the contraction
// kernel starts: stream order replaces grid order.
#pragma once

#include <algorithm>

#include "common.cuh"

namespace rt {

constexpr int FT_FIBERS = 32, FT_SLOTS = 32, FT_THREADS = 256;
constexpr int FT_ROWS = FT_THREADS / 32;  // warps of the block

// Each block owns 32 consecutive fibers and walks their live slots 32 at a
// time through a shared-memory tile: it reads the tile fiber by fiber (a
// warp over 32 consecutive slots of one fiber, coalesced) and writes it
// slot by slot (a warp over the 32 fibers at one slot, i.e. 32 adjacent
// table columns of one row wherever the fibers share the id, as dense
// fibers do). Writing fiber by fiber instead would put every lane of a
// warp on its own table row, N floats apart.
template <typename TV>
__global__ void __launch_bounds__(FT_THREADS) fiber_table_scatter_kernel(
    const TV* __restrict__ vals, const int* __restrict__ ids,
    const int* __restrict__ chunk_counts, float* __restrict__ table, int K,
    int N, int cap, int bn, int fc) {
  __shared__ int s_ids[FT_FIBERS][FT_SLOTS + 1];  // +1: no bank conflicts
  __shared__ float s_vals[FT_FIBERS][FT_SLOTS + 1];
  const int tx = threadIdx.x % 32, ty = threadIdx.x / 32;
  const int f0 = blockIdx.x * FT_FIBERS;
  // Lane tx's fiber and its live slots; the tile walks the most of any.
  const int f_lane = f0 + tx;
  const int live_lane =
      f_lane < N ? min(cap, chunk_counts[f_lane / bn] * fc) : 0;
  int live = live_lane;
  for (int o = 16; o > 0; o /= 2)
    live = max(live, __shfl_xor_sync(0xffffffffu, live, o));
  for (int c0 = blockIdx.y * FT_SLOTS; c0 < live;
       c0 += gridDim.y * FT_SLOTS) {
    for (int fl = ty; fl < FT_FIBERS; fl += FT_ROWS) {
      const int f = f0 + fl, c = c0 + tx;
      int id = -1;  // PAD_ID
      float v = 0.f;
      if (f < N && c < min(cap, chunk_counts[f / bn] * fc)) {
        const size_t off = (size_t)f * cap + c;
        id = ids[off];
        v = to_f32(vals[off]);
      }
      s_ids[fl][tx] = id;
      s_vals[fl][tx] = v;
    }
    __syncthreads();
    for (int cl = ty; cl < FT_SLOTS; cl += FT_ROWS) {
      const int id = s_ids[tx][cl];
      if (id >= 0 && id < K)
        table[(size_t)id * N + f_lane] = s_vals[tx][cl];
    }
    __syncthreads();
  }
}

// Launch the scatter over all N fibers; returns cudaGetLastError().
template <typename TV>
cudaError_t launch_fiber_table_scatter(const TV* vals, const int* ids,
                                       const int* chunk_counts, float* table,
                                       int K, int N, int cap, int bn, int fc,
                                       cudaStream_t stream) {
  if (N <= 0 || cap <= 0) return cudaSuccess;
  const int gx = (N + FT_FIBERS - 1) / FT_FIBERS;
  const int gy = std::min(256, (cap + FT_SLOTS - 1) / FT_SLOTS);
  fiber_table_scatter_kernel<TV><<<dim3(gx, gy), FT_THREADS, 0, stream>>>(
      vals, ids, chunk_counts, table, K, N, cap, bn, fc);
  return cudaGetLastError();
}

// Row scatter: F fibers (ids -> W, capacity cap) land in an (F, W) table,
// entry c of fiber f at table[f, ids[f, c]]; the table must be zeroed
// beforehand. One warp per fiber, lanes over its slots: a fiber owns its
// table row and its ids are unique, so no atomics, and a warp writes into
// one row (consecutive columns where the fiber's ids ascend densely).
// Every slot is read once (the input's size) and ids outside [0, W),
// PAD_ID among them, are skipped, so slots out of order need nothing
// more.
constexpr int RS_THREADS = 256;

template <typename TV>
__global__ void __launch_bounds__(RS_THREADS) fiber_row_scatter_kernel(
    const TV* __restrict__ vals, const int* __restrict__ ids,
    float* __restrict__ table, int F, int W, int cap) {
  const int f = blockIdx.x * (RS_THREADS / 32) + threadIdx.x / 32;
  if (f >= F) return;
  const int lane = threadIdx.x % 32;
  const int* fid = ids + (size_t)f * cap;
  const TV* fv = vals + (size_t)f * cap;
  float* row = table + (size_t)f * W;
  for (int s = lane; s < cap; s += 32) {
    const unsigned id = (unsigned)fid[s];
    if (id < (unsigned)W) row[id] = to_f32(fv[s]);
  }
}

// Launch the row scatter over all F fibers; returns cudaGetLastError().
template <typename TV>
cudaError_t launch_fiber_row_scatter(const TV* vals, const int* ids,
                                     float* table, int F, int W, int cap,
                                     cudaStream_t stream) {
  if (F <= 0 || cap <= 0) return cudaSuccess;
  constexpr int kFibers = RS_THREADS / 32;
  fiber_row_scatter_kernel<TV><<<(F + kFibers - 1) / kFibers, RS_THREADS, 0,
                                 stream>>>(vals, ids, table, F, W, cap);
  return cudaGetLastError();
}

}  // namespace rt
