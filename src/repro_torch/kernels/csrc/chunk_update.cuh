// The chunked rank-update kernel of the three reference bodies on Hopper:
// SpMM's (spmm.cu), the inner product's (spgemm_inner.cu) and Gustavson's
// (spgemm_gustavson.cu). Each computes O (M, N) = A · B with B held as N
// column fibers (ids -> K); they differ only in how A arrives, which the
// template flag kA selects at compile time:
//
//   kDenseRows     A dense (M, K) row-major (SpMM);
//   kRowFibers     A as M row fibers, ids -> K (inner product);
//   kColumnFibers  A as K column fibers, ids -> M (Gustavson).
//
// Replaces three TPU kernels: src/repro/kernels/spmm.py
// _spmm_reference_kernel, spgemm_inner.py _inner_reference_kernel and
// spgemm_gustavson.py _gustavson_reference_kernel. On the TPU each expands
// its fibers to dense tiles per (tile, K step) and contracts them on the
// MXU, every K step of the grid whether its data is there or not. Here
// they are one kernel that walks only the K the data holds.
//
// One block owns a 128 x 128 output tile; each of its 256 threads keeps an
// 8 x 8 register block of f32 accumulators (rows ty*4.. and 64+ty*4..,
// columns tx*4.. and 64+tx*4.., so the update's 16-byte shared-memory
// loads are free of bank conflicts). The block walks the live K of its
// tile in chunks of 32: SpMM the 32-wide K chunks some B fiber of its N
// tile holds (flags of the launch's fiber scan, fiber_search.cuh); inner
// the k some A row fiber of its M tile holds (the scan's flags, compacted
// into a list by the wrapper); Gustavson the K fibers of A with an entry
// in its M tile (spgemm_outer.live_k_lists). For each chunk it expands
// A's and B's entries at the chunk's k into two K-major f32 tiles in
// shared memory and applies a rank-32 update with true f32 FMAs (bf16
// converts as it is loaded). Nothing is read on the host.
//
// Overlap: the tiles are double-buffered, and each chunk is eight steps.
// A step issues the reads of one batch of chunk c + 1, runs four k of
// chunk c's update (256 FMAs a thread), and only then writes the batch
// into the other buffers, so the reads' latency hides behind the warp's
// own FMAs (SpMM's A rows arrive by cp.async, issued before the update
// and waited for after it). One barrier per chunk; 68 KB of tiles (88 KB
// with SpMM's staging) and 128 registers let two blocks share an SM.
//
// How a fiber (ids -> K) is read over a chunk (its kind from the scan): a
// dense fiber (ids equal to slots) is indexed at slot k; an ordered fiber
// in an aligned chunk (contiguous k from a multiple of 32) is read as its
// exact run, from the scan's chunk starts, and where all the warp's fibers
// are ordered each lane reads its own fiber's run (lane mode: about 8
// instructions a fiber against some 45 for a warp-wide round); in any
// other chunk an ordered fiber is merged from a cursor that only moves
// forward (a warp-wide binary search jumps over slots before the chunk);
// a fiber out of order is scanned whole at every chunk with each id
// tested. A chunk position is k - k0 for contiguous k, else a binary
// search of the chunk's 32 k by warp shuffles. No id outside [0, K)
// matches a chunk's k, so such an id is dropped, as the TPU's expansion
// drops it. A chunk in which no B fiber of the tile holds an entry skips
// its update.
//
// Bound: 2·128·128 FMAs per live k of a tile against the 2·Σk
// nnzA(k)·nnzB(k) the data needs; at dense-enough data (every main-path
// launch that "auto" sends here) the f32 FMA rate bounds it, at sparse A
// (Gustavson at m3plates: about 76 live k per M tile) the reads of B's
// entries at the live k and the output write.
#pragma once

#include <climits>

#include "fiber_search.cuh"

namespace rt {

enum class ALoad { kDenseRows, kRowFibers, kColumnFibers };

constexpr int CU_M = 128, CU_N = 128, CU_KC = 32, CU_THREADS = 256;
constexpr int CU_WARPS = CU_THREADS / 32;
constexpr int CU_FPW = CU_N / CU_WARPS;  // fibers per warp, each operand
constexpr int CU_G = 4;                  // fibers whose first reads overlap
// Row stride of the f32 tiles: 16-byte aligned rows for the update.
constexpr int CU_LD = CU_M + 4;
static_assert(CU_M == CU_N, "both tiles share CU_LD");
static_assert(CU_KC == 32, "one chunk position per lane");
static_assert(CU_FPW % CU_G == 0 && CU_FPW <= 16, "fiber batches");

// SpMM's staging of A: each thread copies 16 k of one row per chunk into
// a region of its own (row stride in elements: 80 bytes for f32, 48 for
// bf16, both 16-byte aligned and free of bank conflicts on the reads).
template <typename T>
struct Stage;
template <>
struct Stage<float> {
  static constexpr int kLd = 20;
};
template <>
struct Stage<__nv_bfloat16> {
  static constexpr int kLd = 24;
};

template <typename T>
struct ChunkArgs {
  const T* a;          // dense rows (M, K), or A's fiber values
  const int* a_ids;    // A's fiber ids (fiber loaders)
  const int* a_kind;   // A's fiber kinds (fiber loaders)
  const int* a_off;    // Gustavson: (K, T + 1) slot starts per M tile
  int cap_a;
  int a_gran;          // dense rows: elements per cp.async copy
  const T* b_vals;
  const int* b_ids;
  const int* b_kind;
  int cap_b;
  // (ceil(K / 32) + 1, fibers): the first slot of each fiber whose id is
  // at least 32·q, for B and (inner) A; an ordered fiber's entries in the
  // aligned chunk q are the slots [runs[q], runs[q + 1]).
  const int* a_runs;
  const int* b_runs;
  const int* list;     // inner, Gustavson: per M tile, ascending live k
  const int* list_n;   // per M tile: how many
  int ld_list;
  const unsigned char* live;  // SpMM: (N tiles, ceil(K / 32)) live chunks
  T* out;
  int M, K, N;
};

// ---------------------------------------------------------------- chunks
// One chunk of the walk, as every lane of a warp holds it: lane j's k
// (INT_MAX past the chunk's kn entries), and the chunk's first and last k.
struct Chunk {
  int k, kn, kfirst, klast;
  bool contiguous;
  int q;  // contiguous from an aligned k: the 32-wide K chunk q, else -1
};

// Chunk c of the walk: SpMM's aligned K chunk c, or list entries [32c,
// 32c + 32) of the tile's live k.
template <ALoad kA>
__device__ __forceinline__ Chunk make_chunk(const int* __restrict__ ks,
                                            int count, int c, int K,
                                            int lane) {
  Chunk ch;
  if constexpr (kA == ALoad::kDenseRows) {
    const int k0 = c * CU_KC;
    ch.kn = min(CU_KC, K - k0);
    ch.k = lane < ch.kn ? k0 + lane : INT_MAX;
  } else {
    const int c0 = c * CU_KC;
    ch.kn = min(CU_KC, count - c0);
    ch.k = lane < ch.kn ? ks[c0 + lane] : INT_MAX;
  }
  ch.kfirst = __shfl_sync(kFull, ch.k, 0);
  ch.klast = __shfl_sync(kFull, ch.k, ch.kn - 1);
  ch.contiguous = ch.klast - ch.kfirst == ch.kn - 1;
  ch.q = ch.contiguous && ch.kfirst % CU_KC == 0 ? ch.kfirst / CU_KC : -1;
  return ch;
}

// The chunk position of `key` (-1 when the chunk does not hold it): key -
// kfirst for contiguous k, else a binary search over the lanes' k. Every
// lane of the warp must call it.
__device__ __forceinline__ int chunk_pos(const Chunk& ch, int key) {
  if (ch.contiguous)  // uniform across the warp
    return key >= ch.kfirst && key <= ch.klast ? key - ch.kfirst : -1;
  int pos = 0;
#pragma unroll
  for (int s = 16; s > 0; s >>= 1)
    if (__shfl_sync(kFull, ch.k, pos + s) <= key) pos += s;
  return __shfl_sync(kFull, ch.k, pos) == key && pos < ch.kn ? pos : -1;
}

// -------------------------------------------------- fibers over a chunk
// A batch: the first 32-slot reads of up to CU_G fibers, issued together
// (load_batch) and consumed a few FMAs later (store_batch), so that their
// latency hides behind the rank update of the chunk before.
struct Batch {
  int key[CU_G];
  float v[CU_G];
};

// Fiber i0 + g of the warp's CU_FPW fibers of one operand is f0 + i0 + g
// (none at or past n_f); lane src0 + i holds fiber i's kind, cursor and
// run in kind_l, cur_l, run0 and run1. The first round reads slot k of a
// dense fiber, the run of an ordered one in an aligned chunk (else the 32
// slots from its cursor), the first 32 slots of any other.
template <typename T>
__device__ __forceinline__ void load_batch(
    const T* __restrict__ vals, const int* __restrict__ ids, int cap,
    int f0, int n_f, int i0, int src0, int kind_l, int cur_l, int run0,
    int run1, const Chunk& ch, Batch& b, int lane) {
#pragma unroll
  for (int g = 0; g < CU_G; ++g) {
    const int f = f0 + i0 + g;
    const int src = src0 + i0 + g;
    const int kind = __shfl_sync(kFull, kind_l, src);
    const int cur = __shfl_sync(kFull, cur_l, src);
    const int r0 = __shfl_sync(kFull, run0, src);
    const int r1 = __shfl_sync(kFull, run1, src);
    b.key[g] = INT_MAX;
    b.v[g] = 0.f;
    if (f >= n_f) continue;  // uniform
    const size_t base = (size_t)f * cap;
    if (kind >= 0) {  // dense: slot k holds id k, k < kind
      if (ch.k < kind) {
        b.key[g] = ch.k;
        b.v[g] = to_f32(vals[base + ch.k]);
      }
    } else if (kind == kOrdered && ch.q >= 0) {  // the run, read exactly
      const int s = r0 + lane;
      if (s < r1) {
        b.key[g] = ids[base + s];
        b.v[g] = to_f32(vals[base + s]);
      }
    } else {
      const int s = (kind == kOrdered ? cur : 0) + lane;
      if (s < cap) {
        const int id = ids[base + s];
        b.key[g] = id >= 0 ? id : INT_MAX;
        b.v[g] = to_f32(vals[base + s]);
      }
    }
  }
}

// The batch's fibers into columns c0 + i0 + g of the K-major tile E (rows
// are chunk positions; zero_columns has zeroed them): a dense fiber
// writes its column whole; an ordered one is merged from its cursor (the
// binary search jumps when all 32 slots read lie before the chunk; more
// rounds where the chunk's entries run past them) and one out of order is
// scanned whole, each id tested. Returns whether this lane wrote an entry.
template <typename T>
__device__ __forceinline__ bool store_batch(
    const T* __restrict__ vals, const int* __restrict__ ids, int cap,
    int f0, int n_f, int i0, int src0, int kind_l, int& cur_l, int run0,
    int run1, const Chunk& ch, const Batch& b, float* __restrict__ E,
    int c0, int lane) {
  bool wrote = false;
#pragma unroll
  for (int g = 0; g < CU_G; ++g) {
    const int i = i0 + g, f = f0 + i, src = src0 + i;
    const int kind = __shfl_sync(kFull, kind_l, src);
    if (f >= n_f) continue;  // uniform
    float* col = E + c0 + i;
    if (kind >= 0) {
      col[lane * CU_LD] = b.v[g];
      wrote |= b.key[g] != INT_MAX;
      continue;
    }
    const size_t base = (size_t)f * cap;
    int k = b.key[g];
    float x = b.v[g];
    if (kind == kOrdered && ch.q >= 0) {
      // The run of aligned chunk q: ids in [32q, 32q + 32), so only the
      // test against the chunk's last k (a chunk cut short) remains.
      int s0 = __shfl_sync(kFull, run0, src);
      const int s1 = __shfl_sync(kFull, run1, src);
      for (;;) {
        if (s0 + lane < s1 && k <= ch.klast) {
          col[(k - ch.kfirst) * CU_LD] = x;
          wrote = true;
        }
        s0 += 32;
        if (s0 >= s1) break;  // uniform
        if (s0 + lane < s1) {
          k = ids[base + s0 + lane];
          x = to_f32(vals[base + s0 + lane]);
        }
      }
      if (lane == src) cur_l = s1;
      continue;
    }
    if (kind == kUnordered) {
      for (int s0 = 0;;) {
        const int p = chunk_pos(ch, k);
        if (p >= 0) {
          col[p * CU_LD] = x;
          wrote = true;
        }
        s0 += 32;
        if (s0 >= cap) break;
        const int s = s0 + lane;
        k = INT_MAX;
        x = 0.f;
        if (s < cap) {
          const int id = ids[base + s];
          k = id >= 0 ? id : INT_MAX;
          x = to_f32(vals[base + s]);
        }
      }
      continue;
    }
    // Ordered: keys below the chunk form a prefix of the 32 slots read,
    // keys past it a suffix (PAD counts as +inf).
    int s0 = __shfl_sync(kFull, cur_l, src);
    while (true) {
      if (__ballot_sync(kFull, k < ch.kfirst) == kFull) {
        const int* fib[1] = {ids + base};
        const int xs[1] = {ch.kfirst};
        int lo[1] = {s0 + 32}, hi[1] = {cap};
        warp_lower_bounds<1>(fib, xs, lo, hi, lane);
        s0 = lo[0];
      } else {
        const int p = chunk_pos(ch, k);
        if (p >= 0) {
          col[p * CU_LD] = x;
          wrote = true;
        }
        const unsigned past = __ballot_sync(kFull, k > ch.klast);
        if (past) {
          s0 += __ffs(past) - 1;
          break;
        }
        s0 += 32;
      }
      const int s = s0 + lane;
      k = INT_MAX;
      x = 0.f;
      if (s < cap) {
        const int id = ids[base + s];
        k = id >= 0 ? id : INT_MAX;
        x = to_f32(vals[base + s]);
      }
    }
    if (lane == src) cur_l = s0;
  }
  return wrote;
}

// Lane mode, for an aligned chunk in which every fiber of the warp is
// ordered with a run of at most 32 slots: each lane reads its own fiber's
// run, `ne` entries from entry e0 a step, into the batch's slots (its
// key INT_MAX where the run has ended), and writes them into its column.
// A warp-wide round per fiber costs some 45 instructions; this costs about
// 8 per fiber.
template <typename T>
__device__ __forceinline__ void load_run(const T* __restrict__ vals,
                                         const int* __restrict__ ids,
                                         size_t base, int run0, int run1,
                                         int e0, int ne, Batch& b) {
#pragma unroll
  for (int e = 0; e < CU_G; ++e) {
    b.key[e] = INT_MAX;
    b.v[e] = 0.f;
    const int s = run0 + e0 + e;
    if (e < ne && s < run1) {
      b.key[e] = ids[base + s];
      b.v[e] = to_f32(vals[base + s]);
    }
  }
}

__device__ __forceinline__ bool store_run(const Batch& b, const Chunk& ch,
                                          float* __restrict__ col) {
  bool wrote = false;
#pragma unroll
  for (int e = 0; e < CU_G; ++e)
    if (b.key[e] <= ch.klast) {  // ids of the run lie in [32q, 32q + 32)
      col[(b.key[e] - ch.kfirst) * CU_LD] = b.v[e];
      wrote = true;
    }
  return wrote;
}

// Zero the warp's CU_FPW columns c0.. of the K-major tile E, every row
// (lane j its row j), before its fibers are written into them.
__device__ __forceinline__ void zero_columns(float* __restrict__ E, int c0,
                                             int lane) {
  float4* z = reinterpret_cast<float4*>(E + lane * CU_LD + c0);
#pragma unroll
  for (int q = 0; q < CU_FPW / 4; ++q) z[q] = make_float4(0.f, 0.f, 0.f, 0.f);
  __syncwarp();
}

// Gustavson's A: chunk position j (warp w takes w, w + 8, ...) is K fiber
// ch.k of lane j (ids -> M), expanded over the tile's M window [m0, m0 +
// 128) into row j of Ea. Lane j holds position j's kind and its slot range
// in M tile t (from live_k_lists; used for an ordered or dense fiber, a
// fiber out of order is scanned whole, each id tested). The first round
// is key[0]/v[0] of a batch.
struct Columns {
  int kind, s0, s1;  // lane j: position j's
};

template <typename T>
__device__ __forceinline__ Columns column_ranges(const ChunkArgs<T>& p,
                                                 const Chunk& ch, int t,
                                                 int lane) {
  Columns c{kUnordered, 0, 0};
  if (lane < ch.kn) {
    c.kind = p.a_kind[ch.k];
    const int* off = p.a_off + (size_t)ch.k * (gridDim.y + 1) + t;
    c.s0 = off[0];
    c.s1 = off[1];
  }
  return c;
}

template <typename T>
__device__ __forceinline__ void load_column(const ChunkArgs<T>& p,
                                            const Chunk& ch,
                                            const Columns& cols, int j,
                                            Batch& b, int lane) {
  b.key[0] = INT_MAX;
  b.v[0] = 0.f;
  if (j >= ch.kn) return;  // uniform
  const int k = __shfl_sync(kFull, ch.k, j);
  const bool ordered = __shfl_sync(kFull, cols.kind, j) != kUnordered;
  const int lo = ordered ? __shfl_sync(kFull, cols.s0, j) : 0;
  const int hi = ordered ? __shfl_sync(kFull, cols.s1, j) : p.cap_a;
  const int s = lo + lane;
  if (s < hi) {
    const size_t base = (size_t)k * p.cap_a;
    b.key[0] = p.a_ids[base + s];
    b.v[0] = to_f32(p.a[base + s]);
  }
}

template <typename T>
__device__ __forceinline__ void store_column(const ChunkArgs<T>& p,
                                             const Chunk& ch,
                                             const Columns& cols, int j,
                                             const Batch& b, int m0,
                                             float* __restrict__ Ea,
                                             int lane) {
  float* row = Ea + j * CU_LD;
  reinterpret_cast<float4*>(row)[lane] = make_float4(0.f, 0.f, 0.f, 0.f);
  if (j >= ch.kn) return;  // uniform: a row past the chunk stays zero
  __syncwarp();
  const int k = __shfl_sync(kFull, ch.k, j);
  const bool ordered = __shfl_sync(kFull, cols.kind, j) != kUnordered;
  const int lo = ordered ? __shfl_sync(kFull, cols.s0, j) : 0;
  const int hi = ordered ? __shfl_sync(kFull, cols.s1, j) : p.cap_a;
  const size_t base = (size_t)k * p.cap_a;
  int id = b.key[0];
  float x = b.v[0];
  for (int s0 = lo;;) {
    // An ordered run holds only ids in the window; the test is for the
    // scan of a fiber out of order.
    const unsigned r = (unsigned)(id - m0);
    if (s0 + lane < hi && r < (unsigned)CU_M) row[r] = x;
    s0 += 32;
    if (s0 >= hi) break;  // uniform
    id = -1;
    if (s0 + lane < hi) {
      id = p.a_ids[base + s0 + lane];
      x = to_f32(p.a[base + s0 + lane]);
    }
  }
}

// SpMM's A: thread t copies row m0 + t % 128, k [k0 + 16·(t / 128), +16)
// of the chunk into its staging region (cp.async, `gran` elements a copy;
// 2-byte copies of bf16 rows of odd K are plain loads), and after the
// wait converts the same elements into Ea: each thread reads back only
// what it copied, so the copy needs no barrier of its own.
template <typename T>
__device__ __forceinline__ void issue_rows(const ChunkArgs<T>& p, int k0,
                                           int m0, T* R, int tid) {
  const int m = m0 + tid % CU_M, kb = k0 + 16 * (tid / CU_M);
  if (m >= p.M) return;
  const T* src = p.a + (size_t)m * p.K + kb;
  const int bytes = p.a_gran * (int)sizeof(T);
  if (bytes >= 4) {
    for (int i = 0; i < 16 && kb + i < p.K; i += p.a_gran)
      cp_async(R + i, src + i, bytes);
  } else {
    for (int i = 0; i < 16 && kb + i < p.K; ++i) R[i] = src[i];
  }
}

__device__ __forceinline__ void load16(const float* R, float (&x)[16]) {
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const float4 v = reinterpret_cast<const float4*>(R)[q];
    x[4 * q] = v.x;
    x[4 * q + 1] = v.y;
    x[4 * q + 2] = v.z;
    x[4 * q + 3] = v.w;
  }
}
__device__ __forceinline__ void load16(const __nv_bfloat16* R,
                                       float (&x)[16]) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(R);
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    x[2 * i] = f.x;
    x[2 * i + 1] = f.y;
  }
}

// k past K converts to zero (rows past the chunk stay zero); a row past M
// lands in accumulators that are never stored.
template <typename T>
__device__ __forceinline__ void convert_rows(const T* R, float* Ea, int k0,
                                             int K, int tid) {
  float x[16];
  load16(R, x);
  const int kb = k0 + 16 * (tid / CU_M);
  float* dst = Ea + 16 * (tid / CU_M) * CU_LD + tid % CU_M;
#pragma unroll
  for (int i = 0; i < 16; ++i) dst[i * CU_LD] = kb + i < K ? x[i] : 0.f;
}

// ---------------------------------------------------------------- kernel
// Four k of a chunk's rank update, kk in [kk0, kk0 + 4). Rows past the
// chunk's kn are zero in both tiles (every expansion writes all 32 rows
// of its columns, zeros past kn), so a chunk whose kn is not a multiple of
// 4 needs no test inside the block.
__device__ __forceinline__ void update4(const float* __restrict__ ea,
                                        const float* __restrict__ eb,
                                        int kk0, int tx, int ty,
                                        float (&acc)[8][8]) {
#pragma unroll
  for (int kk = kk0; kk < kk0 + 4; ++kk) {
    const float4 a0 = *reinterpret_cast<const float4*>(ea + kk * CU_LD + ty * 4);
    const float4 a1 =
        *reinterpret_cast<const float4*>(ea + kk * CU_LD + 64 + ty * 4);
    const float4 b0 = *reinterpret_cast<const float4*>(eb + kk * CU_LD + tx * 4);
    const float4 b1 =
        *reinterpret_cast<const float4*>(eb + kk * CU_LD + 64 + tx * 4);
    const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
    const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
  }
}

// Eight steps per chunk: step s issues the first reads of one batch of
// chunk c + 1, runs the update of k [4s, 4s + 4) of chunk c, then
// consumes the batch. Inner: steps 0-3 take A's four batches, 4-7 B's;
// Gustavson: steps 0-3 A's chunk positions w + 8s, 4-7 B's batches; SpMM:
// the even steps B's batches (its A arrives by cp.async).
constexpr int CU_STEPS = CU_KC / 4;
static_assert(CU_STEPS == 2 * (CU_FPW / CU_G), "a batch per step");

template <typename T, ALoad kA>
__global__ void __launch_bounds__(CU_THREADS, 2)
    chunk_update_kernel(const ChunkArgs<T> p) {
  extern __shared__ __align__(16) float smem[];
  float* const Ea = smem;                      // [2][KC][LD]: Ea[j][m - m0]
  float* const Eb = smem + 2 * CU_KC * CU_LD;  // [2][KC][LD]: Eb[j][n - n0]
  T* const R = reinterpret_cast<T*>(smem + 4 * CU_KC * CU_LD) +
               threadIdx.x * Stage<T>::kLd;    // SpMM's staging
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int tx = tid % 16, ty = tid / 16;
  const int m0 = blockIdx.y * CU_M, n0 = blockIdx.x * CU_N;
  // The walk: SpMM's live chunks of N tile t (flags), or M tile t's live
  // k in chunks of 32 (a list).
  const int t = kA == ALoad::kDenseRows ? blockIdx.x : blockIdx.y;
  const int n_chunks = kA == ALoad::kDenseRows
                           ? (p.K + CU_KC - 1) / CU_KC
                           : (p.list_n[t] + CU_KC - 1) / CU_KC;
  const int count = kA == ALoad::kDenseRows ? 0 : p.list_n[t];
  const int* ks = kA == ALoad::kDenseRows ? nullptr
                                          : p.list + (size_t)t * p.ld_list;
  const unsigned char* live =
      kA == ALoad::kDenseRows ? p.live + (size_t)t * n_chunks : nullptr;

  // Lane i < 16 holds the kind, cursor and chunk run of the warp's B fiber
  // i (fiber fl); lane 16 + i those of its A row fiber i for inner, else
  // of B fiber i again (SpMM's lane mode splits each run between them).
  // A fiber past the tile's edge counts as ordered with empty runs.
  const int c0 = warp * CU_FPW, fb = n0 + c0, fa = m0 + c0;
  const bool lane_b = kA != ALoad::kRowFibers || lane < CU_FPW;
  const int fl = (lane_b ? fb : fa) + lane % CU_FPW;
  const bool valid_l = fl < (lane_b ? p.N : p.M);
  int kind_l = kOrdered, cur_l = 0, run0 = 0, run1 = 0;
  if (valid_l) kind_l = lane_b ? p.b_kind[fl] : p.a_kind[fl];
  const T* const vals_l = lane_b ? p.b_vals : p.a;
  const int* const ids_l = lane_b ? p.b_ids : p.a_ids;
  const size_t base_l = (size_t)fl * (lane_b ? p.cap_b : p.cap_a);
  const int e0_l = kA == ALoad::kDenseRows ? 2 * (lane / CU_FPW) : 0;
  constexpr int kNe = kA == ALoad::kDenseRows ? 2 : 4;  // entries a step

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  // Each iteration updates from the chunk expanded last (buffer cur, none
  // the first time) while expanding the next live one (ch) into the other
  // buffer; the last only updates. advance() finds the chunk after that
  // and issues its small reads (the list, the runs, Gustavson's column
  // ranges) before the barrier, so that they arrive during it.
  Chunk ch{};
  Columns cols{};
  int kn = 0, cur = 1, pos = 0;
  bool hit = false, more = false, lanes = false;
  auto advance = [&]() {
    if constexpr (kA == ALoad::kDenseRows)
      while (pos < n_chunks && !live[pos]) ++pos;  // uniform
    more = pos < n_chunks;                        // uniform
    lanes = false;
    if (!more) return;
    ch = make_chunk<kA>(ks, count, pos++, p.K, lane);
    if (ch.q >= 0 && valid_l) {  // the runs of chunk q, this lane's fiber
      const int* runs = lane_b ? p.b_runs : p.a_runs;
      const size_t n_f = lane_b ? p.N : p.M;
      run0 = runs[(size_t)ch.q * n_f + fl];
      run1 = runs[(size_t)(ch.q + 1) * n_f + fl];
    }
    if constexpr (kA == ALoad::kColumnFibers) {
      cols = column_ranges(p, ch, t, lane);
    } else {  // uniform
      lanes = ch.q >= 0 && __all_sync(kFull, kind_l == kOrdered &&
                                                 run1 - run0 <= CU_KC);
    }
  };
  advance();
  for (bool first = true;; first = false) {
    if (!more && first) break;
    const int nxt = cur ^ 1;
    float* const ea_n = Ea + nxt * CU_KC * CU_LD;
    float* const eb_n = Eb + nxt * CU_KC * CU_LD;
    const float* const ea = Ea + cur * CU_KC * CU_LD;
    const float* const eb = Eb + cur * CU_KC * CU_LD;
    if (more) {
      if constexpr (kA == ALoad::kDenseRows) {
        issue_rows(p, ch.kfirst, m0, R, tid);
        cp_async_commit();
      } else if constexpr (kA == ALoad::kRowFibers) {
        zero_columns(ea_n, c0, lane);
      }
      zero_columns(eb_n, c0, lane);
    }
    // Step s's batch: which operand, and which of its fibers.
    auto b_step = [](int step) {
      return kA == ALoad::kDenseRows ? step % 2 == 0
                                     : step >= CU_STEPS / 2;
    };
    auto batch0 = [](int step) {
      return (kA == ALoad::kDenseRows ? step / 2 : step % (CU_STEPS / 2)) *
             CU_G;
    };
    auto load_step = [&](int step, Batch& bt) {
      if (b_step(step))
        load_batch(p.b_vals, p.b_ids, p.cap_b, fb, p.N, batch0(step), 0,
                   kind_l, cur_l, run0, run1, ch, bt, lane);
      else if constexpr (kA == ALoad::kRowFibers)
        load_batch(p.a, p.a_ids, p.cap_a, fa, p.M, batch0(step), CU_FPW,
                   kind_l, cur_l, run0, run1, ch, bt, lane);
      else if constexpr (kA == ALoad::kColumnFibers)
        load_column(p, ch, cols, warp + CU_WARPS * step, bt, lane);
    };
    auto store_step = [&](int step, const Batch& bt) -> bool {
      if (b_step(step))
        return store_batch(p.b_vals, p.b_ids, p.cap_b, fb, p.N, batch0(step),
                           0, kind_l, cur_l, run0, run1, ch, bt, eb_n, c0,
                           lane);
      if constexpr (kA == ALoad::kRowFibers)
        store_batch(p.a, p.a_ids, p.cap_a, fa, p.M, batch0(step), CU_FPW,
                    kind_l, cur_l, run0, run1, ch, bt, ea_n, c0, lane);
      else if constexpr (kA == ALoad::kColumnFibers)
        store_column(p, ch, cols, warp + CU_WARPS * step, bt, m0, ea_n, lane);
      return false;
    };
    bool wrote = false;
    float* const col_l = (lane_b ? eb_n : ea_n) + c0 + lane % CU_FPW;
#pragma unroll 1
    for (int step = 0; step < CU_STEPS; ++step) {
      Batch bt;
      if (lanes) {  // uniform; only while more
        if (valid_l)
          load_run(vals_l, ids_l, base_l, run0, run1, 4 * step + e0_l, kNe,
                   bt);
      } else if (more) {
        load_step(step, bt);
      }
      if (hit && 4 * step < kn) update4(ea, eb, 4 * step, tx, ty, acc);
      if (lanes) {
        if (valid_l && store_run(bt, ch, col_l) && lane_b) wrote = true;
      } else if (more) {
        wrote |= store_step(step, bt);
      }
    }
    if (lanes) cur_l = run1;
    if constexpr (kA == ALoad::kDenseRows) {
      if (more) {
        cp_async_wait_all();
        convert_rows(R, ea_n, ch.kfirst, p.K, tid);
      }
    }
    if (!more) break;
    kn = ch.kn;
    cur = nxt;
    advance();
    hit = __syncthreads_or(wrote);
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int m = m0 + (i < 4 ? ty * 4 + i : 64 + ty * 4 + i - 4);
    if (m >= p.M) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int n = n0 + (j < 4 ? tx * 4 + j : 64 + tx * 4 + j - 4);
      if (n < p.N) p.out[(size_t)m * p.N + n] = from_f32<T>(acc[i][j]);
    }
  }
}

// Launch over an (M, N) output; the fiber kinds (and runs, and SpMM's live
// chunks) must be computed beforehand by launch_fiber_scan on the same
// stream. Returns a cudaError_t as int.
template <typename T, ALoad kA>
int launch_chunk_update(const ChunkArgs<T>& p, cudaStream_t stream) {
  if (p.M == 0 || p.N == 0) return (int)cudaSuccess;
  size_t smem = 4 * CU_KC * CU_LD * sizeof(float);
  if constexpr (kA == ALoad::kDenseRows)
    smem += CU_THREADS * Stage<T>::kLd * sizeof(T);
  const cudaError_t err = cudaFuncSetAttribute(
      chunk_update_kernel<T, kA>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((p.N + CU_N - 1) / CU_N, (p.M + CU_M - 1) / CU_M);
  chunk_update_kernel<T, kA><<<grid, CU_THREADS, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace rt

// ------------------------------------------------------------- C entry
// The fiber scan of fiber_search.cuh (kinds, and unless null the chunk
// starts and the per-tile live flags), for the wrappers that need its
// outputs before the rank-update launch (inner compacts A's live flags
// into lists). Returns cudaGetLastError().
extern "C" int fiber_scan_launch(const void* ids, int F, int cap, int minor,
                                 void* kind, void* starts, int chunk,
                                 void* flags, int tile, int group,
                                 void* stream) {
  return (int)rt::launch_fiber_scan(
      static_cast<const int*>(ids), F, cap, minor, static_cast<int*>(kind),
      static_cast<int*>(starts), chunk, static_cast<unsigned char*>(flags),
      tile, group, static_cast<cudaStream_t>(stream));
}
