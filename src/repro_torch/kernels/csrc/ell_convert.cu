// Dense to ELL on Hopper: each fiber of a 2-D f32 or bf16 slice (any two
// strides) compacted into static-capacity slots, ids ascending, PAD_ID and
// zeros beyond the fiber's length, the first `cap` nonzeros kept when a
// fiber holds more (formats/ell.py dense_to_ell, whose plain version this
// matches bit for bit).
//
// Replaces no TPU kernel: the JAX package's dense_to_ell is a stable
// jnp.argsort of the mask, left to XLA. Its plain port (a stable argsort of
// every element, an int64 order array as large as the slice, a dozen eager
// ops around it) was the largest device item of a Table I queue. The work
// is a byte-bound pass: the least a conversion can move is the slice read
// once and the ELL (4 bytes of id and 2 or 4 of value a slot) written once.
// So nothing here sorts or materialises a mask, and elements are tested
// and copied as raw bits (nonzero unless all but the sign bit are clear:
// NaN kept, -0.0 dropped, as `x != 0` decides).
//
// Two bodies, by the stride the fibers run along:
//
// Row fibers (the minor stride is 1, or neither stride is): a warp walks a
// fiber in order, 16 bytes a lane where the rows allow it (4 packs in
// flight), takes each nonzero's slot from the warp's running count plus the
// popcounts of the lanes before it (a ballot per element of the pack), and
// stages the step's nonzeros in shared memory, so that ids and values go
// out as consecutive 4-byte stores of consecutive lanes.
//
// Column fibers (the fiber stride is 1): a block of 8 warps takes 32
// neighbouring fibers and walks down the rows 64 at a time, each row read
// by a warp as one coalesced segment; the 64 x 32 tile is transposed in
// shared memory, and each warp then compacts 4 of the columns 32 rows at a
// time as the row body does, so each fiber's slots are again written by
// consecutive lanes.
//
// Each fiber is walked whole by one warp (row body) or one block of 32
// fibers (column body), which then writes its length, padding and worst
// count. Nothing is allocated here: the wrapper hands in the outputs and
// (for strict) an int that takes the fullest fiber's true count.
#include <stdint.h>

#include "common.cuh"

namespace rt {

constexpr int EC_THREADS = 256;
constexpr int EC_WARPS = EC_THREADS / 32;
constexpr int EC_UNROLL = 4;   // packs a lane has in flight (row body)
constexpr int EC_ROWS = 64;    // rows of a column tile a step
constexpr int EC_COLS_PER_WARP = 32 / EC_WARPS;
constexpr int EC_ROWS_PER_WARP = EC_ROWS / EC_WARPS;

enum : int { kRows = 0, kCols = 1 };

template <typename B>
struct EllArgs {
  const B* x;                   // element (f, j) at x[f * s_f + j * s_m]
  long long F, L, s_f, s_m;     // fibers, minor length, element strides
  int cap, width;               // width = min(cap, L)
  B* vals;                      // (F, cap)
  int* ids;                     // (F, cap)
  int* lens;                    // (F,)
  int* worst;                   // max true count, or null
};

// Nonzero as a float: any bit set but the sign.
template <typename B>
__device__ __forceinline__ bool nonzero(B bits) {
  return static_cast<B>(bits << 1) != 0;
}

template <typename B, int G>
struct alignas(sizeof(B) * G) Pack {
  B e[G];
};

// The length, the padding [len, cap) and the worst count of fiber f, once
// its true count `run` is known (one warp).
template <typename B>
__device__ __forceinline__ void finish_fiber(const EllArgs<B>& a, long long f,
                                             int run, int lane) {
  const int len = min(run, a.width);
  if (lane == 0) {
    a.lens[f] = len;
    if (a.worst != nullptr) atomicMax(a.worst, run);
  }
  B* v = a.vals + f * a.cap;
  int* id = a.ids + f * a.cap;
  for (int k = len + lane; k < a.cap; k += 32) {
    v[k] = B(0);
    id[k] = PAD_ID;
  }
}

// ------------------------------------------------------------ row fibers
// One warp per fiber. G elements a lane a step: a G-wide pack (s_m == 1
// and the wrapper found every row start and length aligned to it) or, for
// G == 1, one element at stride s_m.
template <typename B, int G>
__global__ void __launch_bounds__(EC_THREADS) ell_rows_kernel(EllArgs<B> a) {
  extern __shared__ __align__(16) unsigned char ec_smem[];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const long long f = (long long)blockIdx.x * EC_WARPS + warp;
  if (f >= a.F) return;
  const B* row = a.x + f * a.s_f;
  // This warp's staging: 32·G values, then 32·G ids.
  B* sv = reinterpret_cast<B*>(ec_smem) + warp * 32 * G;
  int* si = reinterpret_cast<int*>(ec_smem + EC_THREADS * G * sizeof(B)) +
            warp * 32 * G;
  B* out_v = a.vals + f * a.cap;
  int* out_i = a.ids + f * a.cap;
  const unsigned before_me = (1u << lane) - 1u;
  int run = 0;

  for (long long jb = 0; jb < a.L; jb += EC_UNROLL * 32 * G) {
    Pack<B, G> p[EC_UNROLL];
#pragma unroll
    for (int u = 0; u < EC_UNROLL; ++u) {
      const long long j = jb + (long long)(u * 32 + lane) * G;
      if (j < a.L) {
        if constexpr (G == 1)
          p[u].e[0] = row[j * a.s_m];
        else
          p[u] = *reinterpret_cast<const Pack<B, G>*>(row + j);
      } else {
#pragma unroll
        for (int i = 0; i < G; ++i) p[u].e[i] = B(0);
      }
    }
#pragma unroll
    for (int u = 0; u < EC_UNROLL; ++u) {
      int before = 0, total = 0;
#pragma unroll
      for (int i = 0; i < G; ++i) {
        const unsigned bal = __ballot_sync(~0u, nonzero(p[u].e[i]));
        before += __popc(bal & before_me);
        total += __popc(bal);
      }
      if (total == 0) continue;  // warp-uniform
      if (run < a.width) {
        const long long j = jb + (long long)(u * 32 + lane) * G;
        int k = before;
#pragma unroll
        for (int i = 0; i < G; ++i)
          if (nonzero(p[u].e[i])) {
            sv[k] = p[u].e[i];
            si[k] = (int)(j + i);
            ++k;
          }
        __syncwarp();
        const int n = min(total, a.width - run);
        for (int t = lane; t < n; t += 32) {
          out_v[run + t] = sv[t];
          out_i[run + t] = si[t];
        }
        __syncwarp();
      }
      run += total;
    }
  }
  finish_fiber(a, f, run, lane);
}

// --------------------------------------------------------- column fibers
// One block per 32 fibers. Each step reads EC_ROWS rows of the 32 fibers
// (a warp EC_ROWS_PER_WARP of them, one coalesced segment each),
// transposes them through shared memory, and each warp compacts its
// EC_COLS_PER_WARP columns 32 rows at a time.
template <typename B>
__global__ void __launch_bounds__(EC_THREADS) ell_cols_kernel(EllArgs<B> a) {
  __shared__ unsigned tile[EC_ROWS][33];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const long long f0 = (long long)blockIdx.x * 32;
  const bool col_ok = f0 + lane < a.F;
  const B* col = a.x + (col_ok ? (f0 + lane) * a.s_f : 0);
  const unsigned before_me = (1u << lane) - 1u;
  int run[EC_COLS_PER_WARP] = {};

  for (long long jb = 0; jb < a.L; jb += EC_ROWS) {
    unsigned v[EC_ROWS_PER_WARP];
#pragma unroll
    for (int i = 0; i < EC_ROWS_PER_WARP; ++i) {
      const long long j = jb + warp + i * EC_WARPS;
      v[i] = (col_ok && j < a.L) ? (unsigned)col[j * a.s_m] : 0u;
    }
    __syncthreads();  // the last step's tile is read
#pragma unroll
    for (int i = 0; i < EC_ROWS_PER_WARP; ++i)
      tile[warp + i * EC_WARPS][lane] = v[i];
    __syncthreads();
#pragma unroll
    for (int q = 0; q < EC_COLS_PER_WARP; ++q) {
      const int c = warp + q * EC_WARPS;
      const long long f = f0 + c;
#pragma unroll
      for (int h = 0; h < EC_ROWS / 32; ++h) {
        const int r = h * 32 + lane;
        const B bits = (B)tile[r][c];
        const bool nz = nonzero(bits);
        const unsigned bal = __ballot_sync(~0u, nz);
        if (nz && f < a.F) {
          const int slot = run[q] + __popc(bal & before_me);
          if (slot < a.width) {
            a.vals[f * a.cap + slot] = bits;
            a.ids[f * a.cap + slot] = (int)(jb + r);
          }
        }
        run[q] += __popc(bal);
      }
    }
  }
#pragma unroll
  for (int q = 0; q < EC_COLS_PER_WARP; ++q) {
    const long long f = f0 + warp + q * EC_WARPS;
    if (f < a.F) finish_fiber(a, f, run[q], lane);
  }
}

template <typename B, int G>
int launch_rows(const EllArgs<B>& a, cudaStream_t stream) {
  const unsigned blocks = (unsigned)((a.F + EC_WARPS - 1) / EC_WARPS);
  const size_t smem = (size_t)EC_THREADS * G * (sizeof(B) + sizeof(int));
  ell_rows_kernel<B, G><<<blocks, EC_THREADS, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <typename B>
int launch(const EllArgs<B>& a, int layout, int vec_bytes,
           cudaStream_t stream) {
  if (layout == kCols) {
    ell_cols_kernel<B><<<(unsigned)((a.F + 31) / 32), EC_THREADS, 0,
                         stream>>>(a);
    return (int)cudaGetLastError();
  }
  switch (vec_bytes / (int)sizeof(B)) {
    case 1: return launch_rows<B, 1>(a, stream);
    case 2: return launch_rows<B, 2>(a, stream);
    case 4: return launch_rows<B, 4>(a, stream);
    case 8:
      if constexpr (sizeof(B) == 2) return launch_rows<B, 8>(a, stream);
      return (int)cudaErrorInvalidValue;
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace rt

// x: the slice's first element; F fibers of L elements, element strides
// s_f (fiber to fiber) and s_m (along a fiber). layout: rt::kRows or
// rt::kCols (the wrapper's plan); vec_bytes: the row body's pack (a
// multiple of the element size, 16 at most; the element size unless s_m
// is 1). worst: null, or an int set to 0 that takes the fullest fiber's
// true count. Returns cudaGetLastError().
extern "C" int ell_convert_launch(const void* x, long long F, long long L,
                                  long long s_f, long long s_m, int cap,
                                  void* vals, void* ids, void* lens,
                                  void* worst, int layout, int vec_bytes,
                                  int dtype, void* stream) {
  if ((dtype != rt::kF32 && dtype != rt::kBF16) || F <= 0 ||
      (layout != rt::kRows && layout != rt::kCols))
    return (int)cudaErrorInvalidValue;
  const auto st = static_cast<cudaStream_t>(stream);
  const int width = (int)(L < cap ? L : cap);
  if (dtype == rt::kF32) {
    const rt::EllArgs<uint32_t> a{
        static_cast<const uint32_t*>(x), F, L, s_f, s_m, cap, width,
        static_cast<uint32_t*>(vals), static_cast<int*>(ids),
        static_cast<int*>(lens), static_cast<int*>(worst)};
    return rt::launch<uint32_t>(a, layout, vec_bytes, st);
  }
  const rt::EllArgs<uint16_t> a{
      static_cast<const uint16_t*>(x), F, L, s_f, s_m, cap, width,
      static_cast<uint16_t*>(vals), static_cast<int*>(ids),
      static_cast<int*>(lens), static_cast<int*>(worst)};
  return rt::launch<uint16_t>(a, layout, vec_bytes, st);
}
