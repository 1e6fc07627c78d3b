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
// ascend in k), and the row merge of row_merge.cuh reads them through the
// sort's permutation (SortedSlots): a block owns 8 output rows (a warp
// each) and 1024 columns held as f32 accumulators in shared memory, and
// for each entry (k, v) of its row, in order, a warp adds v·B[k, n] over B
// fiber k's slots in the column chunk (a binary-searched run, a run known
// without a search for a dense fiber, or a tested scan of a fiber out of
// order). No add needs an atomic and two runs give the same bits. The
// work is the pair count plus one write of the output. The Gustavson
// sparse body (spgemm_gustavson.cu) runs the same kernel with B's fibers
// read in place as the rows.
#include <type_traits>

#include "fiber_search.cuh"
#include "row_merge.cuh"

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
  if (dtype != rt::kF32 && dtype != rt::kBF16)
    return (int)cudaErrorInvalidValue;
  return rt::dtype_dispatch(dtype, [&](auto tag) {
    using T = std::remove_pointer_t<decltype(tag)>;
    const rt::SortedSlots<T> rows{static_cast<const int*>(row_ptr),
                                  static_cast<const long long*>(order),
                                  static_cast<const T*>(a_vals), cap_a};
    return rt::launch_row_merge<T>(
        rows, static_cast<const T*>(b_vals), static_cast<const int*>(b_ids),
        static_cast<int*>(b_kind), cap_b, static_cast<T*>(out), M, K, N,
        static_cast<cudaStream_t>(stream));
  });
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
