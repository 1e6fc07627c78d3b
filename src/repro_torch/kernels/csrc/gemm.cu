// Dense GEMM on Hopper: O (M, N) = A (M, K) · B (K, N), both row-major,
// f32 or bf16, accumulated in f32 and rounded once to the operands' type.
//
// Replaces _gemm_kernel of src/repro/kernels/gemm.py. On the TPU each
// (bm, bn) output block keeps an f32 accumulator in VMEM scratch across the
// K grid dimension, which runs in order on one core, and feeds the MXU
// (bm, bk) x (bk, bn) tiles. Here the sequential K grid becomes the K loop
// inside one block, with the accumulator in registers.
//
// Bound: 2·M·K·N operations. The FMAs are true f32 on the CUDA cores, never
// TF32 on the tensor cores, so the card's f32 rate (67 TFLOP/s on the H100
// SXM), not its memory, bounds it at every main-path shape. The design
// keeps the FMA pipes fed:
//
// - A block owns a 128 x 128 output tile; each of its 256 threads keeps an
//   8 x 8 block of accumulators. A warp covers 32 x 64 of the tile, lane
//   (wy, wx) rows wy + 4·i (i < 8) and columns 4·wx + j, 32 + 4·wx + j
//   (j < 4), so a warp's fragment loads read 4 distinct A rows and 128
//   contiguous bytes of B: 8-byte A and 16-byte B shared-memory loads free
//   of bank conflicts, 12 loads for every 128 FMAs.
// - K advances 32 at a time through a ring of four stages in shared memory
//   (A row-major with rows padded to 36 f32 / 40 bf16 elements, B as it
//   lies), filled by 16-byte cp.async copies three steps ahead of the
//   update: one barrier per step, and the loads of later steps in flight
//   during the FMAs. bf16 stays bf16 in shared memory and converts to f32
//   as the fragments are read. Operands whose rows are not 16-byte aligned
//   (ragged shapes straight into the kernel) take element loads instead.
// - One block an SM: 136 KB of shared memory (f32) and up to 255 registers
//   a thread, which the compiler spends on keeping the next fragments in
//   flight. Two blocks an SM cap a thread at 128 registers, where the
//   kernel spills, and ran slower on the H100, as did K steps of 16
//   (PERF.md, Findings).
// - The wave tail: the main-path launch (5120 x 5120 x 2560 padded, 800
//   tiles) would run 6.06 waves on 132 block slots, the last nearly empty.
//   The wrapper's plan (gemm.py gemm_plan) computes the tiles of the last,
//   partial wave whole only if they fill more than half of it; otherwise
//   it splits each tail tile's K into `splits` pieces, one block each, so
//   that the tail runs as one short wave (8 tiles in 16 pieces of 10 K
//   steps here). A piece writes its partial tile to a workspace; the piece
//   that arrives last (an integer counter per tile, no float atomics) sums
//   the pieces in piece order and writes the tile, so the result has the
//   same bits on every run.
#include <type_traits>

#include "common.cuh"

namespace rt {

constexpr int GM_M = 128, GM_N = 128, GM_K = 32, GM_STAGES = 4;
constexpr int GM_RM = GM_M / 16;  // rows of a thread's accumulators
constexpr int GM_THREADS = 256;

// A's shared-memory row stride in elements (rows 16-byte aligned; four
// consecutive rows land in four distinct bank groups).
template <typename T>
struct GemmLd;
template <>
struct GemmLd<float> {
  static constexpr int kA = GM_K + 4;
};
template <>
struct GemmLd<__nv_bfloat16> {
  static constexpr int kA = GM_K + 8;
};

template <typename T>
__host__ __device__ constexpr int gemm_stage_elems() {
  return GM_M * GemmLd<T>::kA + GM_K * GM_N;
}
template <typename T>
__host__ __device__ constexpr size_t gemm_smem_bytes() {
  return (size_t)GM_STAGES * gemm_stage_elems<T>() * sizeof(T);
}

template <typename T>
struct GemmArgs {
  const T* a;
  const T* b;
  T* out;
  int M, K, N;
  int tiles_n;     // output tiles along N
  int dp_tiles;    // tiles computed whole, one block each
  int splits;      // K pieces of each tail tile (1: no tail)
  float* ws;       // (tail tiles · splits, 128 · 128) partial tiles
  int* arrived;    // per tail tile: pieces done (zero before the launch)
};

// ------------------------------------------------------------ tile loads
// One stage: A[m0:m0+128, k0:k0+32] into As (row stride GemmLd::kA) and
// B[k0:k0+32, n0:n0+128] into Bs (row stride 128); zeros outside the
// operands. kAsync: every row of A and B starts 16-byte aligned, so each
// 16 bytes is one cp.async (zero-filled past an edge); else element loads.
__device__ __forceinline__ void cp_async16_zfill(void* dst, const void* src,
                                                 bool valid) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(valid ? 16 : 0));
}

template <typename T, bool kAsync>
__device__ __forceinline__ void load_stage(const GemmArgs<T>& p, T* As,
                                           T* Bs, int m0, int n0, int k0,
                                           int tid) {
  constexpr int ldA = GemmLd<T>::kA;
  if constexpr (kAsync) {
    constexpr int G = 16 / (int)sizeof(T);  // elements per copy
    constexpr int A_PER_ROW = GM_K / G, B_PER_ROW = GM_N / G;
    static_assert(GM_M * A_PER_ROW % GM_THREADS == 0 &&
                  GM_K * B_PER_ROW % GM_THREADS == 0, "whole rounds");
#pragma unroll
    for (int q = 0; q < GM_M * A_PER_ROW / GM_THREADS; ++q) {
      const int i = tid + q * GM_THREADS;
      const int r = i / A_PER_ROW, c = (i % A_PER_ROW) * G;
      const bool ok = m0 + r < p.M && k0 + c < p.K;
      cp_async16_zfill(As + r * ldA + c,
                       ok ? p.a + (size_t)(m0 + r) * p.K + k0 + c : p.a, ok);
    }
#pragma unroll
    for (int q = 0; q < GM_K * B_PER_ROW / GM_THREADS; ++q) {
      const int i = tid + q * GM_THREADS;
      const int r = i / B_PER_ROW, c = (i % B_PER_ROW) * G;
      const bool ok = k0 + r < p.K && n0 + c < p.N;
      cp_async16_zfill(Bs + r * GM_N + c,
                       ok ? p.b + (size_t)(k0 + r) * p.N + n0 + c : p.b, ok);
    }
  } else {
    const T zero = from_f32<T>(0.f);
    for (int i = tid; i < GM_M * GM_K; i += GM_THREADS) {
      const int r = i / GM_K, c = i % GM_K;
      As[r * ldA + c] = m0 + r < p.M && k0 + c < p.K
                            ? p.a[(size_t)(m0 + r) * p.K + k0 + c]
                            : zero;
    }
    for (int i = tid; i < GM_K * GM_N; i += GM_THREADS) {
      const int r = i / GM_N, c = i % GM_N;
      Bs[r * GM_N + c] = k0 + r < p.K && n0 + c < p.N
                             ? p.b[(size_t)(k0 + r) * p.N + n0 + c]
                             : zero;
    }
  }
}

// ------------------------------------------------------- fragment loads
__device__ __forceinline__ float2 lds2(const float* s) {
  return *reinterpret_cast<const float2*>(s);
}
__device__ __forceinline__ float2 lds2(const __nv_bfloat16* s) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(s));
}
__device__ __forceinline__ float4 lds4(const float* s) {
  return *reinterpret_cast<const float4*>(s);
}
__device__ __forceinline__ float4 lds4(const __nv_bfloat16* s) {
  const uint2 u = *reinterpret_cast<const uint2*>(s);
  const float2 lo = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 hi = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}

__device__ __forceinline__ void fma4(float (&acc)[4], float a, float4 b) {
  acc[0] = fmaf(a, b.x, acc[0]);
  acc[1] = fmaf(a, b.y, acc[1]);
  acc[2] = fmaf(a, b.z, acc[2]);
  acc[3] = fmaf(a, b.w, acc[3]);
}

// One stage's update: 32 k, two at a time.
template <typename T>
__device__ __forceinline__ void update_stage(const T* As, const T* Bs,
                                             int row0, int col0,
                                             float (&acc)[GM_RM][2][4]) {
  constexpr int ldA = GemmLd<T>::kA;
#pragma unroll
  for (int kk = 0; kk < GM_K; kk += 2) {
    float2 a[GM_RM];
#pragma unroll
    for (int i = 0; i < GM_RM; ++i)
      a[i] = lds2(As + (row0 + 4 * i) * ldA + kk);
    const float4 b00 = lds4(Bs + kk * GM_N + col0);
    const float4 b01 = lds4(Bs + kk * GM_N + col0 + 32);
    const float4 b10 = lds4(Bs + (kk + 1) * GM_N + col0);
    const float4 b11 = lds4(Bs + (kk + 1) * GM_N + col0 + 32);
#pragma unroll
    for (int i = 0; i < GM_RM; ++i) {
      fma4(acc[i][0], a[i].x, b00);
      fma4(acc[i][1], a[i].x, b01);
      fma4(acc[i][0], a[i].y, b10);
      fma4(acc[i][1], a[i].y, b11);
    }
  }
}

__device__ __forceinline__ void store4(float* o, const float (&v)[4]) {
  *reinterpret_cast<float4*>(o) = make_float4(v[0], v[1], v[2], v[3]);
}

template <typename T, bool kAsync>
__global__ void __launch_bounds__(GM_THREADS)
    gemm_kernel(const GemmArgs<T> p) {
  extern __shared__ __align__(16) unsigned char gm_smem[];
  T* const smem = reinterpret_cast<T*>(gm_smem);
  __shared__ int s_last;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int k_steps = (p.K + GM_K - 1) / GM_K;

  // Which tile, and which of its K steps: a tile of the first dp_tiles
  // whole, else one piece of a tail tile.
  int tile = blockIdx.x, piece = -1, s0 = 0, s1 = k_steps;
  if (tile >= p.dp_tiles) {
    const int j = tile - p.dp_tiles;
    tile = p.dp_tiles + j / p.splits;
    piece = j % p.splits;
    s0 = (int)((long long)piece * k_steps / p.splits);
    s1 = (int)((long long)(piece + 1) * k_steps / p.splits);
  }
  const int m0 = (tile / p.tiles_n) * GM_M, n0 = (tile % p.tiles_n) * GM_N;
  const int row0 = (warp % 4) * (GM_M / 4) + lane / 8;  // rows row0 + 4·i
  const int col0 = (warp / 4) * 64 + (lane % 8) * 4;  // cols col0 + j, +32

  float acc[GM_RM][2][4];
#pragma unroll
  for (int i = 0; i < GM_RM; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][h][j] = 0.f;

  const int steps = s1 - s0;
  constexpr int stage = gemm_stage_elems<T>();
  constexpr int a_elems = GM_M * GemmLd<T>::kA;
#pragma unroll
  for (int s = 0; s < GM_STAGES - 1; ++s) {
    if (s < steps)
      load_stage<T, kAsync>(p, smem + s * stage, smem + s * stage + a_elems,
                            m0, n0, (s0 + s) * GM_K, tid);
    cp_async_commit();
  }
  for (int t = 0; t < steps; ++t) {
    cp_async_wait<GM_STAGES - 2>();  // step t's copies (this thread's)
    __syncthreads();  // everyone's; and step t - 1's update is done
    const int nx = t + GM_STAGES - 1;
    if (nx < steps) {
      T* const dst = smem + (nx % GM_STAGES) * stage;
      load_stage<T, kAsync>(p, dst, dst + a_elems, m0, n0, (s0 + nx) * GM_K,
                            tid);
    }
    cp_async_commit();
    const T* const src = smem + (t % GM_STAGES) * stage;
    update_stage<T>(src, src + a_elems, row0, col0, acc);
  }

  if (piece >= 0) {
    // A tail piece: write the partial tile; the last piece to arrive sums
    // all of them in piece order.
    const int slot = tile - p.dp_tiles;
    float* const ws = p.ws + (size_t)slot * p.splits * GM_M * GM_N;
    float* const mine = ws + (size_t)piece * GM_M * GM_N;
#pragma unroll
    for (int i = 0; i < GM_RM; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        store4(mine + (row0 + 4 * i) * GM_N + col0 + 32 * h, acc[i][h]);
    __threadfence();
    __syncthreads();
    if (tid == 0)
      s_last = atomicAdd(p.arrived + slot, 1) == p.splits - 1;
    __syncthreads();
    if (!s_last) return;
    __threadfence();
#pragma unroll
    for (int i = 0; i < GM_RM; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int off = (row0 + 4 * i) * GM_N + col0 + 32 * h;
        float4 v = __ldcg(reinterpret_cast<const float4*>(ws + off));
        for (int q = 1; q < p.splits; ++q) {
          const float4 w = __ldcg(reinterpret_cast<const float4*>(
              ws + (size_t)q * GM_M * GM_N + off));
          v.x += w.x;
          v.y += w.y;
          v.z += w.z;
          v.w += w.w;
        }
        acc[i][h][0] = v.x;
        acc[i][h][1] = v.y;
        acc[i][h][2] = v.z;
        acc[i][h][3] = v.w;
      }
  }

#pragma unroll
  for (int i = 0; i < GM_RM; ++i) {
    const int m = m0 + row0 + 4 * i;
    if (m >= p.M) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int n = n0 + col0 + 32 * h + j;
        if (n < p.N) p.out[(size_t)m * p.N + n] = from_f32<T>(acc[i][h][j]);
      }
  }
}

// Dynamic shared memory above 48 KB, with the SM's memory split in favour
// of shared memory (the f32 ring takes 136 KB).
template <typename T, bool kAsync>
cudaError_t set_gemm_smem() {
  const cudaError_t err = cudaFuncSetAttribute(
      gemm_kernel<T, kAsync>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)gemm_smem_bytes<T>());
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(gemm_kernel<T, kAsync>,
                              cudaFuncAttributePreferredSharedMemoryCarveout,
                              (int)cudaSharedmemCarveoutMaxShared);
}

template <typename T>
int launch_gemm(const GemmArgs<T>& p, bool aligned, int blocks,
                cudaStream_t stream) {
  if (p.M == 0 || p.N == 0) return (int)cudaSuccess;
  const size_t smem = gemm_smem_bytes<T>();
  cudaError_t err;
  if (aligned) {
    err = set_gemm_smem<T, true>();
    if (err == cudaSuccess)
      gemm_kernel<T, true><<<blocks, GM_THREADS, smem, stream>>>(p);
  } else {
    err = set_gemm_smem<T, false>();
    if (err == cudaSuccess)
      gemm_kernel<T, false><<<blocks, GM_THREADS, smem, stream>>>(p);
  }
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace rt

// ------------------------------------------------------------- C entries
// Pointers arrive as void* (ctypes c_void_p); dtype is rt::kF32 or
// rt::kBF16 and applies to A, B and the output alike. `aligned`: every row
// of A and B starts 16-byte aligned. The plan (dp_tiles, splits, blocks)
// is gemm.py's gemm_plan; ws and arrived are used only when splits > 1.
// Returns cudaGetLastError() after the launch.
extern "C" int gemm_launch(const void* a, const void* b, void* out, int M,
                           int K, int N, int tiles_n, int dp_tiles,
                           int splits, int blocks, void* ws, void* arrived,
                           int aligned, int dtype, void* stream) {
  if (dtype != rt::kF32 && dtype != rt::kBF16)
    return (int)cudaErrorInvalidValue;
  return rt::dtype_dispatch(dtype, [&](auto tag) {
    using T = std::remove_pointer_t<decltype(tag)>;
    rt::GemmArgs<T> p{};
    p.a = static_cast<const T*>(a);
    p.b = static_cast<const T*>(b);
    p.out = static_cast<T*>(out);
    p.M = M;
    p.K = K;
    p.N = N;
    p.tiles_n = tiles_n;
    p.dp_tiles = dp_tiles;
    p.splits = splits;
    p.ws = static_cast<float*>(ws);
    p.arrived = static_cast<int*>(arrived);
    return rt::launch_gemm<T>(p, aligned != 0, blocks,
                              static_cast<cudaStream_t>(stream));
  });
}

// How many blocks of the aligned kernel one SM holds at once (the plan's
// block slots are this times the SM count). Returns a cudaError_t as int.
extern "C" int gemm_blocks_per_sm(int dtype, int* out) {
  return rt::dtype_dispatch(dtype, [&](auto tag) {
    using T = std::remove_pointer_t<decltype(tag)>;
    cudaError_t err = rt::set_gemm_smem<T, true>();
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          out, rt::gemm_kernel<T, true>, rt::GM_THREADS,
          rt::gemm_smem_bytes<T>());
    return (int)err;
  });
}
