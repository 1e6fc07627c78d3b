// Fiber helpers shared by the kernels that read fibers by slot ranges:
// the outer product's two bodies (spgemm_outer.cu) and the chunked
// rank-update kernel of the SpMM, inner and Gustavson reference bodies
// (chunk_update.cuh). A fiber is sorted once per launch into one of three
// kinds (fiber_scan_kernel); an ordered fiber's window is found by a
// warp-wide 32-ary binary search (warp_lower_bounds), a dense one's without
// a search, and a fiber out of order is scanned whole with every id
// tested, so no input writes outside a tile.
#pragma once

#include "common.cuh"

namespace rt {

constexpr unsigned kFull = 0xffffffffu;

// ------------------------------------------------------------ fiber scan
// One pass over the ids of F fibers (ids -> minor), one warp per fiber:
//
// kind[f] says how a kernel may read fiber f: kUnordered when some id lies
// outside [PAD_ID, minor) or the keys (the id, PAD counted as minor)
// descend somewhere (spgemm_inner._ordered's test: the fiber is scanned
// whole, ids tested); else its live count L when its ids are exactly its
// slots 0..L-1 (a dense fiber: the window [x0, x1) is the slots
// [min(x0, L), min(x1, L)), found without a search); else kOrdered (live
// ids ascending, PAD slots last: windows are binary-searched).
//
// starts (unless null): starts[q * F + f], q in [0, ceil(minor / chunk)],
// is the first slot of fiber f whose key (the id in [0, minor), else past
// every chunk) is at least q·chunk, so an ordered fiber's entries in
// chunk q are the slots [starts[q], starts[q + 1]) (spgemm_outer.
// fiber_chunk_starts; garbage for a fiber out of order, which no kernel
// reads by slot ranges). Each slot writes the starts of the chunks that
// begin after its predecessors' keys, up to its own: one write per chunk
// for any fiber.
//
// flags (unless null): flags[(f / tile) * G + id / group] = 1 for every id
// in [0, minor), G = ceil(minor / group): the minor groups some fiber of
// each tile of `tile` fibers holds (the buffer zeroed beforehand; writes
// of the same byte need no atomics).
constexpr int kUnordered = -2, kOrdered = -1;

__global__ void fiber_scan_kernel(const int* __restrict__ ids, int F,
                                  int cap, int minor, int* __restrict__ kind,
                                  int* __restrict__ starts, int chunk,
                                  unsigned char* __restrict__ flags, int tile,
                                  int group) {
  const int f = blockIdx.x * (blockDim.x / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (f >= F) return;  // uniform across the warp
  const int* row = ids + (size_t)f * cap;
  const int n_chunks = (minor + chunk - 1) / chunk;
  unsigned char* frow =
      flags ? flags + (size_t)(f / tile) * ((minor + group - 1) / group)
            : nullptr;
  bool ok = true, dense = true;
  int live = 0, key_carry = -1, c_carry = -1;
  for (int s0 = 0; s0 < cap; s0 += 32) {
    const int s = s0 + lane;
    const int id = s < cap ? row[s] : PAD_ID;
    const bool in_range = id >= 0 && id < minor;
    const int key = id >= 0 ? id : minor;
    const int c = in_range ? id / chunk : n_chunks;
    // c_prev: the largest chunk of the slots before this one (for an
    // ordered fiber, the previous slot's), so each start is written once.
    int c_max = c;
    for (int o = 1; o < 32; o *= 2) {
      const int v = __shfl_up_sync(kFull, c_max, o);
      if (lane >= o) c_max = max(c_max, v);
    }
    int key_prev = __shfl_up_sync(kFull, key, 1);
    int c_prev = max(c_carry, __shfl_up_sync(kFull, c_max, 1));
    if (lane == 0) {
      key_prev = key_carry;
      c_prev = c_carry;
    }
    if (s < cap) {
      ok &= id >= PAD_ID && id < minor && key >= key_prev;
      if (id >= 0) {
        ++live;
        dense &= id == s;
      }
      if (starts)
        for (int q = c_prev + 1; q <= c; ++q) starts[(size_t)q * F + f] = s;
      if (frow && in_range) frow[id / group] = 1;
    }
    const int last = min(31, cap - 1 - s0);  // the round's last slot
    key_carry = __shfl_sync(kFull, key, last);
    c_carry = max(c_carry, __shfl_sync(kFull, c_max, last));
  }
  if (starts)  // chunks past the last slot's key start at cap
    for (int q = c_carry + 1 + lane; q <= n_chunks; q += 32)
      starts[(size_t)q * F + f] = cap;
  ok = __all_sync(kFull, ok);
  dense = __all_sync(kFull, dense);
  live = __reduce_add_sync(kFull, live);
  if (lane == 0) kind[f] = !ok ? kUnordered : dense ? live : kOrdered;
}

cudaError_t launch_fiber_scan(const int* ids, int F, int cap, int minor,
                              int* kind, int* starts, int chunk,
                              unsigned char* flags, int tile, int group,
                              cudaStream_t stream) {
  if (F > 0)
    fiber_scan_kernel<<<(F + 7) / 8, 256, 0, stream>>>(
        ids, F, cap, minor, kind, starts, chunk, flags, tile, group);
  return cudaGetLastError();
}

cudaError_t launch_fiber_kind(const int* ids, int n_fibers, int cap,
                              int minor, int* kind, cudaStream_t stream) {
  return launch_fiber_scan(ids, n_fibers, cap, minor, kind, nullptr, 1,
                           nullptr, 1, 1, stream);
}

// The search ranges of fiber `kind`'s window [x0, x1): closed at once for a
// dense fiber, the whole fiber for an ordered one, empty (no search) for a
// fiber scanned whole.
__device__ __forceinline__ void window_ranges(int kind, int cap, int x0,
                                              int x1, int& lo0, int& hi0,
                                              int& lo1, int& hi1) {
  if (kind >= 0) {
    lo0 = hi0 = min(x0, kind);
    lo1 = hi1 = min(x1, kind);
  } else {
    lo0 = lo1 = 0;
    hi0 = hi1 = kind == kOrdered ? cap : 0;
  }
}

// --------------------------------------------------------- binary search
// S lower-bound searches at once, their loads interleaved so that their
// latencies overlap. Search i looks in the slots [lo[i], hi[i]) of the
// ordered fiber ids[i] for the first slot whose key (the id; a PAD slot
// counts as +inf) is >= x[i], and leaves it in lo[i] (hi[i] if there is
// none). Each step every lane probes one slot, 32 evenly spaced, and a
// ballot keeps the gap between the last probe below x and the first at or
// above it: about log32 of the width in steps. Every lane of the warp
// passes the same arguments. spgemm_outer.warp_lower_bound is this search
// in Python, for the tests.
template <int S>
__device__ __forceinline__ void warp_lower_bounds(const int* const (&ids)[S],
                                                  const int (&x)[S],
                                                  int (&lo)[S], int (&hi)[S],
                                                  int lane) {
  while (true) {
    bool open = false, ge[S];
    int stride[S];
#pragma unroll
    for (int i = 0; i < S; ++i) {
      const int width = hi[i] - lo[i];
      open |= width > 0;
      stride[i] = (width + 31) / 32;
      const int p = lo[i] + lane * stride[i];
      ge[i] = true;  // a probe past the range counts as >= x
      if (p < hi[i]) {
        const int id = ids[i][p];
        ge[i] = id < 0 || id >= x[i];
      }
    }
    if (!open) return;  // uniform: every lane holds the same ranges
#pragma unroll
    for (int i = 0; i < S; ++i) {
      const unsigned ball = __ballot_sync(kFull, ge[i]);
      if (hi[i] > lo[i]) {
        if (ball == 0) {
          lo[i] += 31 * stride[i] + 1;
        } else {
          const int f = __ffs(ball) - 1;
          const int h = min(hi[i], lo[i] + f * stride[i]);
          if (f > 0) lo[i] += (f - 1) * stride[i] + 1;
          hi[i] = h;
        }
      }
    }
  }
}

// One fiber's entries with ids in [lo, lo + width) into E[id - lo]: the
// slots [s0, s1) of an ordered fiber, untested, or every slot of any other
// fiber, each id tested, so no input writes outside the window. Returns
// whether this lane wrote.
template <typename T>
__device__ __forceinline__ bool expand_window(
    const T* __restrict__ vals, const int* __restrict__ ids, int cap,
    bool ordered, int s0, int s1, int lo, int width, float* __restrict__ E,
    int lane) {
  bool wrote = false;
  if (ordered) {
    for (int s = s0 + lane; s < s1; s += 32) {
      E[ids[s] - lo] = to_f32(vals[s]);
      wrote = true;
    }
  } else {
    for (int s = lane; s < cap; s += 32) {
      const unsigned r = (unsigned)(ids[s] - lo);
      if (r < (unsigned)width) {
        E[r] = to_f32(vals[s]);
        wrote = true;
      }
    }
  }
  return wrote;
}

}  // namespace rt
