// OuterSPACE-like outer-product SpGEMM on Hopper: A held as K fibers
// (ids -> M, capacity cap_a) times B held as K fibers (ids -> N, capacity
// cap_b) gives O (M, N) = sum over k of outer(A[k, :], B[k, :]), in f32
// with f32 FMAs, for f32 or bf16 operands.
//
// Replaces the two TPU bodies of src/repro/kernels/spgemm_outer.py. Both
// TPU bodies spend their work on K·(M + N) (dense tables, or every fiber
// against every tile); on this card both are rebuilt so that the work goes
// with the data: the live K fibers of a tile, or the (a, b) pairs.
//
// Reference body (replaces _outer_reference_kernel). One block owns a
// 128 x 128 output tile and walks only its M tile's live-K list (the k
// whose A fiber holds an entry in the tile, built by the wrapper) in chunks
// of 32. Per chunk it expands A's slots in the tile (a slot range from the
// wrapper's sorted search) and B's slots in its N window (a slot range found
// by a warp-wide binary search of the fiber) into shared memory, skips the
// update when B has no entry in the chunk, and applies a rank-32 update to
// 8 x 8 register accumulators. A fiber out of order (fiber kinds from the
// scan of fiber_search.cuh, one pass over the ids) is scanned whole with
// every id tested, and a dense one (ids equal to slots) needs no search.
// So a block reads the slots that land in its tile and the live fibers'
// search probes; at dense data it is a SIMT f32 product bounded by the
// FMA rate, at sparse A by B's window slices and the output write.
//
// Sparse body (replaces _outer_sparse_kernel). OuterSPACE's multiply and
// merge without the TPU's dense (M, K) and (N, K) tables: the wrapper sorts
// A's slots into row order (a stable sort by id, so each row's entries
// ascend in k; the kernel reads A through the sort's permutation), and a
// block owns 8 output rows (a warp each) and 1024 columns held as f32
// accumulators in shared memory. For each entry (k, v)
// of its row, in order, a warp adds v·B[k, n] over B fiber k's slots in the
// column chunk (a binary-searched run, a run known without a search for a
// dense fiber, or a tested scan of a fiber out of order). A fiber's ids are unique and a row is one warp's, so no add needs
// an atomic and two runs give the same bits. The work is the pair count
// plus one write of the output.
#include "fiber_search.cuh"

namespace rt {

// --------------------------------------------------------- reference body
constexpr int OR_M = 128, OR_N = 128, OR_KC = 32, OR_THREADS = 256;
constexpr int OR_WARPS = OR_THREADS / 32;
constexpr int OR_FPW = OR_KC / OR_WARPS;  // fibers per warp per chunk
// Row stride of the expansion tiles: 16-byte aligned rows for the update's
// vector loads.
constexpr int OR_LD = OR_M + 4;
static_assert(OR_M == OR_N, "both expansion tiles share OR_LD");

// live_k[t * ld_live + i], i < live_n[t]: the k whose A fiber holds an entry
// in M tile t, ascending; a_off[k * (T + 1) + t]: where fiber k's entries
// in tile t start, for an ordered fiber (T = gridDim.y M tiles); a_kind and
// b_kind from fiber_scan_kernel.
template <typename T>
__global__ void __launch_bounds__(OR_THREADS, 2) outer_reference_kernel(
    const T* __restrict__ a_vals, const int* __restrict__ a_ids,
    const int* __restrict__ a_off, const int* __restrict__ a_kind, int cap_a,
    const T* __restrict__ b_vals, const int* __restrict__ b_ids,
    const int* __restrict__ b_kind, int cap_b,
    const int* __restrict__ live_k, const int* __restrict__ live_n,
    int ld_live, T* __restrict__ out, int M, int N) {
  __shared__ __align__(16) float Ea[OR_KC][OR_LD];  // Ea[kk][m - m0]
  __shared__ __align__(16) float Eb[OR_KC][OR_LD];  // Eb[kk][n - n0]
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int tx = tid % 16, ty = tid / 16;
  const int t = blockIdx.y, m0 = t * OR_M, n0 = blockIdx.x * OR_N;
  const size_t a_ld = gridDim.y + 1;
  const int count = live_n[t];
  const int* ks = live_k + (size_t)t * ld_live;

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  for (int c0 = 0; c0 < count; c0 += OR_KC) {
    for (int i = tid; i < OR_KC * OR_LD; i += OR_THREADS) {
      (&Ea[0][0])[i] = 0.f;
      (&Eb[0][0])[i] = 0.f;
    }
    __syncthreads();
    const int kn = min(OR_KC, count - c0);
    // This warp's fibers: rows warp, warp + 8, ... of the chunk's tiles.
    int k[OR_FPW];
#pragma unroll
    for (int j = 0; j < OR_FPW; ++j) {
      const int kk = warp + OR_WARPS * j;
      k[j] = kk < kn ? ks[c0 + kk] : -1;
    }
    // B's run in the N window of each ordered fiber: two searches a fiber
    // (none for a dense one).
    const int* fib[2 * OR_FPW];
    int x[2 * OR_FPW], lo[2 * OR_FPW], hi[2 * OR_FPW];
    bool ord_b[OR_FPW];
#pragma unroll
    for (int j = 0; j < OR_FPW; ++j) {
      const int kind = k[j] >= 0 ? b_kind[k[j]] : kUnordered;
      ord_b[j] = kind != kUnordered;
      fib[2 * j] = fib[2 * j + 1] = b_ids + (size_t)max(k[j], 0) * cap_b;
      x[2 * j] = n0;
      x[2 * j + 1] = n0 + OR_N;
      window_ranges(kind, cap_b, n0, n0 + OR_N, lo[2 * j], hi[2 * j],
                    lo[2 * j + 1], hi[2 * j + 1]);
    }
    warp_lower_bounds<2 * OR_FPW>(fib, x, lo, hi, lane);
    bool hit_b = false;
#pragma unroll
    for (int j = 0; j < OR_FPW; ++j) {
      if (k[j] < 0) continue;
      const int kk = warp + OR_WARPS * j;
      const size_t fa = (size_t)k[j] * cap_a;
      const int* off = a_off + (size_t)k[j] * a_ld + t;
      const bool ord_a = a_kind[k[j]] != kUnordered;
      expand_window(a_vals + fa, a_ids + fa, cap_a, ord_a,
                    ord_a ? off[0] : 0, ord_a ? off[1] : 0, m0, OR_M,
                    &Ea[kk][0], lane);
      const size_t fb = (size_t)k[j] * cap_b;
      hit_b |= expand_window(b_vals + fb, b_ids + fb, cap_b, ord_b[j],
                             lo[2 * j], lo[2 * j + 1], n0, OR_N, &Eb[kk][0],
                             lane);
    }
    if (__syncthreads_or(hit_b)) {  // uniform across the block
#pragma unroll 4
      for (int kk = 0; kk < kn; ++kk) {
        const float4* pa = reinterpret_cast<const float4*>(&Ea[kk][ty * 8]);
        const float4* pb = reinterpret_cast<const float4*>(&Eb[kk][tx * 8]);
        const float4 a0 = pa[0], a1 = pa[1], b0 = pb[0], b1 = pb[1];
        const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
        const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
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
int outer_reference(const T* a_vals, const int* a_ids, const int* a_off,
                    int* a_kind, int cap_a, const T* b_vals, const int* b_ids,
                    int* b_kind, int cap_b, const int* live_k,
                    const int* live_n, int ld_live, T* out, int M, int K,
                    int N, cudaStream_t stream) {
  if (M == 0 || N == 0) return (int)cudaSuccess;
  cudaError_t err = launch_fiber_kind(a_ids, K, cap_a, M, a_kind, stream);
  if (err != cudaSuccess) return (int)err;
  err = launch_fiber_kind(b_ids, K, cap_b, N, b_kind, stream);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((N + OR_N - 1) / OR_N, (M + OR_M - 1) / OR_M);
  outer_reference_kernel<T><<<grid, OR_THREADS, 0, stream>>>(
      a_vals, a_ids, a_off, a_kind, cap_a, b_vals, b_ids, b_kind, cap_b,
      live_k, live_n, ld_live, out, M, N);
  return (int)cudaGetLastError();
}

// ------------------------------------------------------------ sparse body
constexpr int OS_ROWS = 8, OS_COLS = 1024, OS_THREADS = OS_ROWS * 32;
constexpr int OS_BATCH = 4;  // entries whose B runs are searched together

// Row m's entries are A's slots order[e] for e in [row_ptr[m],
// row_ptr[m + 1]), ascending in k: A's slots sorted into row order (slot s
// holds fiber k = s / cap_a's value a_vals[s]).
template <typename T>
__global__ void __launch_bounds__(OS_THREADS) outer_merge_kernel(
    const int* __restrict__ row_ptr, const long long* __restrict__ order,
    const T* __restrict__ a_vals, int cap_a, const T* __restrict__ b_vals,
    const int* __restrict__ b_ids, const int* __restrict__ b_kind, int cap_b,
    T* __restrict__ out, int M, int N) {
  __shared__ float acc[OS_ROWS][OS_COLS];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int m = blockIdx.x * OS_ROWS + warp;
  const int n0 = blockIdx.y * OS_COLS, width = min(OS_COLS, N - n0);
  if (m >= M) return;  // no block-wide barrier below: a row is one warp's
  float* row = acc[warp];
  for (int c = lane; c < width; c += 32) row[c] = 0.f;
  __syncwarp();
  const int e1 = row_ptr[m + 1];
  for (int e0 = row_ptr[m]; e0 < e1; e0 += OS_BATCH) {
    int k[OS_BATCH];
    float v[OS_BATCH];
    bool ord[OS_BATCH];
    const int* fib[2 * OS_BATCH];
    int x[2 * OS_BATCH], lo[2 * OS_BATCH], hi[2 * OS_BATCH];
#pragma unroll
    for (int j = 0; j < OS_BATCH; ++j) {
      const bool in = e0 + j < e1;
      const long long slot = in ? order[e0 + j] : 0;
      k[j] = in ? (int)(slot / cap_a) : -1;
      v[j] = in ? to_f32(a_vals[slot]) : 0.f;
      const int kind = in ? b_kind[k[j]] : kUnordered;
      ord[j] = kind != kUnordered;
      fib[2 * j] = fib[2 * j + 1] = b_ids + (size_t)max(k[j], 0) * cap_b;
      x[2 * j] = n0;
      x[2 * j + 1] = n0 + width;
      window_ranges(kind, cap_b, n0, n0 + width, lo[2 * j], hi[2 * j],
                    lo[2 * j + 1], hi[2 * j + 1]);
    }
    warp_lower_bounds<2 * OS_BATCH>(fib, x, lo, hi, lane);
    // Entries in order; within one, every column gains at most one add.
#pragma unroll
    for (int j = 0; j < OS_BATCH; ++j) {
      if (k[j] < 0) continue;
      const size_t fb = (size_t)k[j] * cap_b;
      const int* ids = b_ids + fb;
      const T* vals = b_vals + fb;
      if (ord[j]) {
        for (int s = lo[2 * j] + lane; s < lo[2 * j + 1]; s += 32) {
          const int c = ids[s] - n0;
          row[c] = fmaf(v[j], to_f32(vals[s]), row[c]);
        }
      } else {
        for (int s = lane; s < cap_b; s += 32) {
          const unsigned c = (unsigned)(ids[s] - n0);
          if (c < (unsigned)width) row[c] = fmaf(v[j], to_f32(vals[s]), row[c]);
        }
      }
      __syncwarp();
    }
  }
  T* dst = out + (size_t)m * N + n0;
  for (int c = lane; c < width; c += 32) dst[c] = from_f32<T>(row[c]);
}

template <typename T>
int outer_sparse(const int* row_ptr, const long long* order, const T* a_vals,
                 int cap_a, const T* b_vals, const int* b_ids, int* b_kind,
                 int cap_b, T* out, int M, int K, int N,
                 cudaStream_t stream) {
  if (M == 0 || N == 0) return (int)cudaSuccess;
  const cudaError_t err =
      launch_fiber_kind(b_ids, K, cap_b, N, b_kind, stream);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((M + OS_ROWS - 1) / OS_ROWS, (N + OS_COLS - 1) / OS_COLS);
  outer_merge_kernel<T><<<grid, OS_THREADS, 0, stream>>>(
      row_ptr, order, a_vals, cap_a, b_vals, b_ids, b_kind, cap_b, out, M,
      N);
  return (int)cudaGetLastError();
}

}  // namespace rt

// ------------------------------------------------------------- C entries
// Pointers arrive as void* (ctypes c_void_p); dtype is rt::kF32 or
// rt::kBF16 and applies to both operands' values and the output. a_kind
// and b_kind are scratch of K ints that the entries fill. Each returns
// cudaGetLastError() after its launches.
extern "C" int outer_sparse_launch(const void* row_ptr, const void* order,
                                   const void* a_vals, int cap_a,
                                   const void* b_vals, const void* b_ids,
                                   void* b_kind, int cap_b, void* out, int M,
                                   int K, int N, int dtype, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  const int* rp = static_cast<const int*>(row_ptr);
  const long long* od = static_cast<const long long*>(order);
  const int* bi = static_cast<const int*>(b_ids);
  int* bo = static_cast<int*>(b_kind);
  if (dtype == rt::kF32)
    return rt::outer_sparse<float>(
        rp, od, static_cast<const float*>(a_vals), cap_a,
        static_cast<const float*>(b_vals), bi, bo, cap_b,
        static_cast<float*>(out), M, K, N, s);
  if (dtype == rt::kBF16)
    return rt::outer_sparse<__nv_bfloat16>(
        rp, od, static_cast<const __nv_bfloat16*>(a_vals), cap_a,
        static_cast<const __nv_bfloat16*>(b_vals), bi, bo, cap_b,
        static_cast<__nv_bfloat16*>(out), M, K, N, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" int outer_reference_launch(
    const void* a_vals, const void* a_ids, const void* a_off, void* a_kind,
    int cap_a, const void* b_vals, const void* b_ids, void* b_kind, int cap_b,
    const void* live_k, const void* live_n, int ld_live, void* out, int M,
    int K, int N, int dtype, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  const int* ai = static_cast<const int*>(a_ids);
  const int* ao = static_cast<const int*>(a_off);
  const int* bi = static_cast<const int*>(b_ids);
  int* ad = static_cast<int*>(a_kind);
  int* bd = static_cast<int*>(b_kind);
  const int* lk = static_cast<const int*>(live_k);
  const int* ln = static_cast<const int*>(live_n);
  if (dtype == rt::kF32)
    return rt::outer_reference<float>(
        static_cast<const float*>(a_vals), ai, ao, ad, cap_a,
        static_cast<const float*>(b_vals), bi, bd, cap_b, lk, ln, ld_live,
        static_cast<float*>(out), M, K, N, s);
  if (dtype == rt::kBF16)
    return rt::outer_reference<__nv_bfloat16>(
        static_cast<const __nv_bfloat16*>(a_vals), ai, ao, ad, cap_a,
        static_cast<const __nv_bfloat16*>(b_vals), bi, bd, cap_b, lk, ln,
        ld_live, static_cast<__nv_bfloat16*>(out), M, K, N, s);
  return (int)cudaErrorInvalidValue;
}
