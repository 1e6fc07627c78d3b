// ExTensor-like inner-product SpGEMM on Hopper: A held as M row fibers
// (ids -> K, capacity cap_a) times B held as N column fibers (ids -> K,
// capacity cap_b) gives O (M, N): O[m, n] sums a·b over the K coordinates
// both fibers hold. PAD_ID = -1 pads every fiber.
//
// Replaces the two TPU bodies of src/repro/kernels/spgemm_inner.py.
//
// Sparse body (replaces _inner_sparse_kernel). The TPU builds B's dense
// (K, bn) table in VMEM at the first M step of each N block and reuses it
// for the later M steps; that needs the grid to run in order on one core.
// Here the scatter of fiber_table.cuh (shared with SpMM) fills one (K, N)
// f32 table in device memory, zeroed by the wrapper and skipping empty B
// blocks, before the gather-contract kernel starts. That kernel gives each
// block 32 A rows and a run of 128 consecutive output columns: it stages
// the rows' ids and values in shared memory, 64 slots at a time, and for
// every live slot (k, v) of a row each lane adds v·table[k, n] for its 4
// columns n, so the 32 lanes of a warp read 128 consecutive floats of one
// table row. The trip count is the rows' live chunk bound (acnt of
// block_chunk_counts(a, bm, fc), as on the TPU); a block whose B fiber
// blocks are all empty writes zeros without reading A.
// Bound: the data needs 2·Σk nnzA(k)·nnzB(k) operations, but the gather
// does 2·nnz(A)·N (the table is dense in N); each FMA needs a table load,
// mostly from L2, so load bandwidth bounds it; the scatter moves B's ELL
// and the table once.
//
// Reference body (replaces _inner_reference_kernel). One block owns a
// 128 x 128 output tile and walks K in steps of bk <= 128. A step runs only
// when the tile's rows hold an A entry and its columns a B entry in that K
// range (the occupancy counts of tile_occupancy summed over fiber blocks,
// computed by the wrapper, as the TPU's scalar prefetch). A live step
// expands the step's slots of its 128 A fibers and 128 B fibers into
// shared-memory tiles, K-major, and applies a rank-bk update to 8 x 8
// register accumulators. The slots of step kk in fiber f are
// [off[f, kk], off[f, kk + 1]): the wrapper's prefix sums of the
// occupancy. That holds where the fiber's live ids lie in [0, K) and
// ascend and its PAD slots come last (ord[f], computed by the wrapper on
// the device), so a step reads only its own slots. Any other fiber is
// scanned whole at every step, each slot tested against the step, so no
// input makes the kernel write outside its tile.
// Bound: the dense rank updates do 2·128·128·bk FMAs per live step against
// the 2·Σk nnzA(k)·nnzB(k) the data needs; with dense-enough operands the
// f32 FMA rate bounds it, as for the GEMM.
#include "fiber_table.cuh"

namespace rt {

// ------------------------------------------------------------ sparse body
constexpr int IS_ROWS = 32, IS_COLS = 128, IS_SLOTS = 64, IS_THREADS = 256;
constexpr int IS_WROWS = IS_ROWS / (IS_THREADS / 32);  // rows per warp
constexpr int IS_WCOLS = IS_COLS / 32;                 // columns per lane

template <typename T>
__global__ void __launch_bounds__(IS_THREADS) inner_gather_kernel(
    const T* __restrict__ a_vals, const int* __restrict__ a_ids, int cap_a,
    const int* __restrict__ a_chunks, int bm, int fc,
    const float* __restrict__ table, const int* __restrict__ b_live, int bn,
    T* __restrict__ out, int M, int N) {
  __shared__ int s_ids[IS_ROWS][IS_SLOTS];
  __shared__ float s_vals[IS_ROWS][IS_SLOTS];
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int m0 = blockIdx.y * IS_ROWS, n0 = blockIdx.x * IS_COLS;

  // Live slots: the most that any M block among the block's rows holds.
  int live = 0;
  const int m_last = min(M, m0 + IS_ROWS) - 1;
  for (int w = m0 / bm; w <= m_last / bm; ++w)
    live = max(live, min(cap_a, a_chunks[w] * fc));
  const bool probe = tid < IS_COLS && n0 + tid < N &&
                     b_live[(n0 + tid) / bn] > 0;
  if (!__syncthreads_or(probe)) live = 0;  // every B block empty

  float acc[IS_WROWS][IS_WCOLS];
#pragma unroll
  for (int r = 0; r < IS_WROWS; ++r)
#pragma unroll
    for (int q = 0; q < IS_WCOLS; ++q) acc[r][q] = 0.f;

  for (int s0 = 0; s0 < live; s0 += IS_SLOTS) {
    const int ns = min(IS_SLOTS, live - s0);
    for (int i = tid; i < IS_ROWS * IS_SLOTS; i += IS_THREADS) {
      const int r = i / IS_SLOTS, c = i % IS_SLOTS;
      const int m = m0 + r;
      int id = -1;  // PAD_ID
      float v = 0.f;
      if (m < M && c < ns) {
        const size_t off = (size_t)m * cap_a + s0 + c;
        id = a_ids[off];
        v = to_f32(a_vals[off]);
      }
      s_ids[r][c] = id;
      s_vals[r][c] = v;
    }
    __syncthreads();
    for (int c = 0; c < ns; ++c) {
#pragma unroll
      for (int r = 0; r < IS_WROWS; ++r) {
        const int id = s_ids[warp * IS_WROWS + r][c];  // warp-uniform
        if (id < 0) continue;
        const float v = s_vals[warp * IS_WROWS + r][c];
        const float* row = table + (size_t)id * N + n0 + lane;
#pragma unroll
        for (int q = 0; q < IS_WCOLS; ++q)
          if (n0 + lane + 32 * q < N)
            acc[r][q] = fmaf(v, row[32 * q], acc[r][q]);
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int r = 0; r < IS_WROWS; ++r) {
    const int m = m0 + warp * IS_WROWS + r;
    if (m >= M) continue;
#pragma unroll
    for (int q = 0; q < IS_WCOLS; ++q) {
      const int n = n0 + lane + 32 * q;
      if (n < N)
        out[(size_t)m * N + n] =
            from_f32<T>(b_live[n / bn] > 0 ? acc[r][q] : 0.f);
    }
  }
}

template <typename T>
int inner_sparse(const T* a_vals, const int* a_ids, int cap_a,
                 const int* a_chunks, int bm, int fc, const T* b_vals,
                 const int* b_ids, int cap_b, const int* b_counts, int bn,
                 float* table, T* out, int M, int K, int N,
                 cudaStream_t stream) {
  const cudaError_t err = launch_fiber_table_scatter<T>(
      b_vals, b_ids, b_counts, table, K, N, cap_b, bn, 1, stream);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((N + IS_COLS - 1) / IS_COLS, (M + IS_ROWS - 1) / IS_ROWS);
  inner_gather_kernel<T><<<grid, IS_THREADS, 0, stream>>>(
      a_vals, a_ids, cap_a, a_chunks, bm, fc, table, b_counts, bn, out, M, N);
  return (int)cudaGetLastError();
}

// --------------------------------------------------------- reference body
constexpr int IR_M = 128, IR_N = 128, IR_KMAX = 128, IR_THREADS = 256;
// Row stride of the expansion tiles: 4 floats of padding keep rows 16-byte
// aligned for the vector loads of the update and spread the scatter's
// writes (lanes on different k, one column) over 8 banks instead of one.
constexpr int IR_LD = IR_M + 4;
static_assert(IR_M == IR_N, "both expansion tiles share IR_LD");

template <typename T>
__global__ void __launch_bounds__(IR_THREADS) inner_reference_kernel(
    const T* __restrict__ a_vals, const int* __restrict__ a_ids,
    const int* __restrict__ a_off, const bool* __restrict__ a_ord, int cap_a,
    const T* __restrict__ b_vals, const int* __restrict__ b_ids,
    const int* __restrict__ b_off, const bool* __restrict__ b_ord, int cap_b,
    const int* __restrict__ a_occ, int bm, const int* __restrict__ b_occ,
    int bn, T* __restrict__ out, int M, int N, int bk, int k_steps) {
  extern __shared__ __align__(16) float smem[];
  float* Ea = smem;               // Ea[k - k0][m - m0]
  float* Eb = smem + bk * IR_LD;  // Eb[k - k0][n - n0]
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int tx = tid % 16, ty = tid / 16;
  const int m0 = blockIdx.y * IR_M, n0 = blockIdx.x * IR_N;

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  for (int kk = 0; kk < k_steps; ++kk) {
    // Both-live test: threads 0..127 probe the tile's rows, 128..255 its
    // columns, each against its fiber block's occupancy at this step.
    bool probe = false;
    if (tid < IR_M) {
      const int m = m0 + tid;
      probe = m < M && a_occ[(size_t)(m / bm) * k_steps + kk] > 0;
    }
    const int live_a = __syncthreads_or(probe);
    probe = false;
    if (tid >= IR_M) {
      const int n = n0 + tid - IR_M;
      probe = n < N && b_occ[(size_t)(n / bn) * k_steps + kk] > 0;
    }
    const int live_b = __syncthreads_or(probe);
    if (!(live_a && live_b)) continue;  // uniform across the block

    for (int i = tid; i < 2 * bk * IR_LD; i += IR_THREADS) smem[i] = 0.f;
    __syncthreads();
    const int k0 = kk * bk;
    // One warp per fiber (A's 128, then B's 128), lanes over its slots.
    for (int f = warp; f < IR_M + IR_N; f += IR_THREADS / 32) {
      const bool is_a = f < IR_M;
      const int col = is_a ? f : f - IR_M;
      const int fib = (is_a ? m0 : n0) + col;
      if (fib >= (is_a ? M : N)) continue;
      const int* off = (is_a ? a_off : b_off) + (size_t)fib * (k_steps + 1);
      const int cap = is_a ? cap_a : cap_b;
      const int* ids = (is_a ? a_ids : b_ids) + (size_t)fib * cap;
      const T* vals = (is_a ? a_vals : b_vals) + (size_t)fib * cap;
      float* E = is_a ? Ea : Eb;
      if ((is_a ? a_ord : b_ord)[fib]) {
        // The step's slots, whose ids all fall inside the tile. No test
        // on the id here: it made the kernel about 1.5x slower at gnmt on
        // the H100 (PERF.md).
        const int s1 = off[kk + 1];
        for (int s = off[kk] + lane; s < s1; s += 32)
          E[(ids[s] - k0) * IR_LD + col] = to_f32(vals[s]);
      } else {
        // Any other fiber: every slot, each id tested against the step.
        for (int s = lane; s < cap; s += 32) {
          const unsigned r = (unsigned)(ids[s] - k0);
          if (r < (unsigned)bk) E[r * IR_LD + col] = to_f32(vals[s]);
        }
      }
    }
    __syncthreads();
#pragma unroll 4
    for (int k = 0; k < bk; ++k) {
      float a[8], b[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) a[i] = Ea[k * IR_LD + ty * 8 + i];
#pragma unroll
      for (int j = 0; j < 8; ++j) b[j] = Eb[k * IR_LD + tx * 8 + j];
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

template <typename T>
int inner_reference(const T* a_vals, const int* a_ids, const int* a_off,
                    const bool* a_ord, int cap_a, const T* b_vals,
                    const int* b_ids, const int* b_off, const bool* b_ord,
                    int cap_b, const int* a_occ, int bm, const int* b_occ,
                    int bn, T* out, int M, int K, int N, int bk,
                    cudaStream_t stream) {
  if (bk < 1 || bk > IR_KMAX || K % bk) return (int)cudaErrorInvalidValue;
  const size_t smem = 2 * (size_t)bk * IR_LD * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      inner_reference_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((N + IR_N - 1) / IR_N, (M + IR_M - 1) / IR_M);
  inner_reference_kernel<T><<<grid, IR_THREADS, smem, stream>>>(
      a_vals, a_ids, a_off, a_ord, cap_a, b_vals, b_ids, b_off, b_ord, cap_b,
      a_occ, bm, b_occ, bn, out, M, N, bk, K / bk);
  return (int)cudaGetLastError();
}

}  // namespace rt

// ------------------------------------------------------------- C entries
// Pointers arrive as void* (ctypes c_void_p); dtype is rt::kF32 or
// rt::kBF16 and applies to both operands' values and the output. Each
// returns cudaGetLastError() after its launches.
extern "C" int inner_sparse_launch(const void* a_vals, const void* a_ids,
                                   int cap_a, const void* a_chunks, int bm,
                                   int fc, const void* b_vals,
                                   const void* b_ids, int cap_b,
                                   const void* b_counts, int bn, void* table,
                                   void* out, int M, int K, int N, int dtype,
                                   void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  const int* ai = static_cast<const int*>(a_ids);
  const int* ac = static_cast<const int*>(a_chunks);
  const int* bi = static_cast<const int*>(b_ids);
  const int* bc = static_cast<const int*>(b_counts);
  float* t = static_cast<float*>(table);
  if (dtype == rt::kF32)
    return rt::inner_sparse<float>(
        static_cast<const float*>(a_vals), ai, cap_a, ac, bm, fc,
        static_cast<const float*>(b_vals), bi, cap_b, bc, bn, t,
        static_cast<float*>(out), M, K, N, s);
  if (dtype == rt::kBF16)
    return rt::inner_sparse<__nv_bfloat16>(
        static_cast<const __nv_bfloat16*>(a_vals), ai, cap_a, ac, bm, fc,
        static_cast<const __nv_bfloat16*>(b_vals), bi, cap_b, bc, bn, t,
        static_cast<__nv_bfloat16*>(out), M, K, N, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" int inner_reference_launch(
    const void* a_vals, const void* a_ids, const void* a_off,
    const void* a_ord, int cap_a, const void* b_vals, const void* b_ids,
    const void* b_off, const void* b_ord, int cap_b, const void* a_occ, int bm,
    const void* b_occ, int bn, void* out, int M, int K, int N, int bk,
    int dtype, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  const int* ai = static_cast<const int*>(a_ids);
  const int* ao = static_cast<const int*>(a_off);
  const bool* ar = static_cast<const bool*>(a_ord);
  const int* bi = static_cast<const int*>(b_ids);
  const int* bo = static_cast<const int*>(b_off);
  const bool* br = static_cast<const bool*>(b_ord);
  const int* aq = static_cast<const int*>(a_occ);
  const int* bq = static_cast<const int*>(b_occ);
  if (dtype == rt::kF32)
    return rt::inner_reference<float>(
        static_cast<const float*>(a_vals), ai, ao, ar, cap_a,
        static_cast<const float*>(b_vals), bi, bo, br, cap_b, aq, bm, bq, bn,
        static_cast<float*>(out), M, K, N, bk, s);
  if (dtype == rt::kBF16)
    return rt::inner_reference<__nv_bfloat16>(
        static_cast<const __nv_bfloat16*>(a_vals), ai, ao, ar, cap_a,
        static_cast<const __nv_bfloat16*>(b_vals), bi, bo, br, cap_b, aq, bm,
        bq, bn, static_cast<__nv_bfloat16*>(out), M, K, N, bk, s);
  return (int)cudaErrorInvalidValue;
}
