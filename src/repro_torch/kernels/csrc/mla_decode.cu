// Absorbed multi-head latent attention (MLA, DeepSeek-V2) for one decode
// token a row, against the latent cache: models/mla.py absorbed_attend's
// scores, softmax and weighted sum of latents, whose plain version (the
// CPU's) this matches up to the order of float32 sums.
//
// Replaces no TPU kernel: the JAX package has no MLA. The plain version on
// the card widened each layer's whole bf16 cache (every slot of every row)
// to f32, read that copy twice (a batched GEMV for the scores, a GEMM for
// the sum) and masked and softmaxed every slot. The work is bound by its
// bytes: a key costs 16 heads x (2 x 576 + 2 x 512) operations against its
// 1152 bytes of c and k_pe, about 30 a byte, where the card does 295 a byte
// in bf16. So the kernel reads each row's valid positions [0, pos] once,
// in bf16, from the cache where it lies (any row and position strides),
// and keeps scores, probabilities and sums on chip.
//
// Split kernel, a block per (chunk of positions, row, 16 heads): the grid
// covers every chunk of S_max, so a captured graph replays it for any pos;
// a block reads pos[b] on the device and returns at once past it. Four
// warps; warp w owns latent dims [128w, 128w + 128) and rope dims [16w,
// 16w + 16). Tiles of 32 positions (c and k_pe rows) stream through a ring
// of shared memory by 16-byte cp.async, one tile loading while the last
// is used; rows past pos are zero-filled, their scores masked. Each tile
// feeds both products before it is dropped:
//   scores  S (16 heads x 32) = q_lat . c + q_pe . k_pe, each warp over its
//           dims with mma.sync m16n8k16 (16 heads are mma's 16 rows), the
//           four partials summed through shared memory in one fixed order,
//           so every warp holds the same S;
//   softmax a running max and sum a head (flash attention's online form),
//           in registers; p never leaves them (the score accumulators are
//           the next product's A fragments);
//   sum     O (16 x 128 a warp) += P . c, B fragments by ldmatrix.trans from
//           the same tile.
// Same arithmetic as the plain path: the cache's bf16 values widen exactly,
// and q_lat, q_pe and p stay f32 through a split into bf16 hi and lo parts
// (x = hi + lo to 2^-18 of x), two mmas a product, f32 accumulation. A block
// writes its chunk's O, running max and sum to scratch; the merge kernel, a
// block per (head, row), combines a row's valid chunks exactly (flash
// merge) into o_lat (B, H, 512), f32.
//
// Chunk length: the wrapper's CHUNK, 1024. The long-chat cell's 24 rows of
// mean 7062 keys then give about 180 live blocks a layer, all resident at
// once (two an SM, by shared memory and registers), each streaming 32 tiles
// with the next one in flight. Shorter chunks fill the SMs' slots in count
// but add a second round of blocks, partials to write and read (32 KB a
// chunk) and merging: at the cell's shapes a layer took 0.102 ms at 1024,
// 0.119 at 512 and 0.117 at 256, and with a deeper ring (3-5 stages, one
// block an SM) 0.112-0.134 (NVIDIA H100 80GB HBM3, 700 W).
//
// Nothing is allocated here: the wrapper hands in the scratch and output.
#include <math.h>
#include <stdint.h>

#include "common.cuh"

namespace rt {

constexpr int MLA_RANK = 512;  // kv_lora_rank
constexpr int MLA_ROPE = 64;   // qk_rope_head_dim
constexpr int MLA_HEADS = 16;  // heads a block: mma's rows
constexpr int MLA_WARPS = 4;
constexpr int MLA_THREADS = 32 * MLA_WARPS;
constexpr int MLA_TILE = 32;                       // positions a stage
constexpr int MLA_DIMS = MLA_RANK / MLA_WARPS;     // latent dims a warp
constexpr int MLA_KSTEPS = MLA_DIMS / 16 + 1;      // + one rope k-step
constexpr int MLA_NT = MLA_TILE / 8;               // score n-tiles a tile
constexpr int MLA_ONT = MLA_DIMS / 8;              // output n-tiles a warp
// Shared rows padded by 16 bytes: ldmatrix's 8 rows land in 8 bank quads.
constexpr int C_ROW = MLA_RANK + 8;
constexpr int PE_ROW = MLA_ROPE + 8;
constexpr int MLA_STAGE = MLA_TILE * (C_ROW + PE_ROW);   // bf16 elements
constexpr int MLA_RED_BYTES = MLA_WARPS * MLA_NT * 32 * 16;

constexpr int MLA_STAGES = 2;  // the ring: one tile in use, one loading
constexpr size_t MLA_SMEM = (size_t)MLA_STAGES * MLA_STAGE * 2 +
                            MLA_RED_BYTES;

struct MlaArgs {
  const float* q;  // q_lat (B, H, RANK) at q[b * sqb + h * sqh + k]
  long long sqb, sqh;
  const float* qpe;  // q_pe (B, H, ROPE)
  long long spb, sph;
  const __nv_bfloat16* c;  // (B, S, RANK) at c[b * scb + s * scs + k]
  long long scb, scs;
  const __nv_bfloat16* pe;  // (B, S, ROPE)
  long long seb, ses;
  const int* pos;  // (B,): row b attends keys [0, pos[b]]
  int B, H, S, chunk, n_chunks;
  float scale;
  float* part_o;   // (B, n_chunks, H, RANK): a chunk's unnormalised sum
  float* part_ml;  // (B, n_chunks, H, 2): its running max and sum
  float* out;      // (B, H, RANK)
};

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Four 8x8 bf16 matrices; lanes 8i..8i+7 give the rows of matrix i.
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(p);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s));
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              const void* p) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(p);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s));
}

// 16 bytes global -> shared, or 16 zero bytes where !ok (nothing read).
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool ok) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(ok ? 16 : 0));
}

// (x, y) as packed bf16 pairs hi and lo with x = hi.x + lo.x to 2^-18 of x.
__device__ __forceinline__ void split2(float x, float y, uint32_t& hi,
                                       uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  const float2 hf = __bfloat1622float2(h);
  const __nv_bfloat162 l = __floats2bfloat162_rn(x - hf.x, y - hf.y);
  hi = reinterpret_cast<const uint32_t&>(h);
  lo = reinterpret_cast<const uint32_t&>(l);
}

__global__ void __launch_bounds__(MLA_THREADS, 2)
    mla_attend_split_kernel(MlaArgs a) {
  extern __shared__ __align__(16) unsigned char mla_smem[];
  const int chunk = blockIdx.x, b = blockIdx.y, h0 = blockIdx.z * MLA_HEADS;
  const int n_valid = min(a.pos[b] + 1, a.S);
  const int start = chunk * a.chunk;
  if (start >= n_valid) return;
  const int n_tiles = (min(a.chunk, n_valid - start) + MLA_TILE - 1) /
                      MLA_TILE;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int mrow = lane & 7, mat = lane >> 3;  // ldmatrix's row, matrix
  __nv_bfloat16* ring = reinterpret_cast<__nv_bfloat16*>(mla_smem);
  float4* red = reinterpret_cast<float4*>(mla_smem +
                                          (size_t)MLA_STAGES * MLA_STAGE * 2);

  // This warp's A fragments of q (8 latent k-steps, then its rope one):
  // register j holds row g + 8 (j & 1), columns 8 (j >> 1) + 2t and + 1.
  uint32_t qh[MLA_KSTEPS][4], ql[MLA_KSTEPS][4];
#pragma unroll
  for (int ks = 0; ks < MLA_KSTEPS; ++ks)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const long long h = h0 + g + 8 * (j & 1);
      const int col = 8 * (j >> 1) + 2 * t;
      const float* src =
          ks < MLA_KSTEPS - 1
              ? a.q + b * a.sqb + h * a.sqh + warp * MLA_DIMS + ks * 16 + col
              : a.qpe + b * a.spb + h * a.sph + warp * 16 + col;
      split2(src[0], src[1], qh[ks][j], ql[ks][j]);
    }

  const __nv_bfloat16* crow = a.c + b * a.scb;
  const __nv_bfloat16* perow = a.pe + b * a.seb;
  auto load = [&](int i) {
    __nv_bfloat16* st = ring + (i % MLA_STAGES) * MLA_STAGE;
    const int p0 = start + i * MLA_TILE;
    for (int k = threadIdx.x; k < MLA_TILE * (MLA_RANK / 8);
         k += MLA_THREADS) {
      const int r = k / (MLA_RANK / 8), piece = 8 * (k % (MLA_RANK / 8));
      const bool ok = p0 + r < n_valid;
      cp_async16(st + r * C_ROW + piece,
                 crow + (ok ? p0 + r : 0) * a.scs + piece, ok);
    }
    __nv_bfloat16* pt = st + MLA_TILE * C_ROW;
    for (int k = threadIdx.x; k < MLA_TILE * (MLA_ROPE / 8);
         k += MLA_THREADS) {
      const int r = k / (MLA_ROPE / 8), piece = 8 * (k % (MLA_ROPE / 8));
      const bool ok = p0 + r < n_valid;
      cp_async16(pt + r * PE_ROW + piece,
                 perow + (ok ? p0 + r : 0) * a.ses + piece, ok);
    }
  };

#pragma unroll
  for (int s = 0; s < MLA_STAGES - 1; ++s) {
    if (s < n_tiles) load(s);
    cp_async_commit();
  }
  float o[MLA_ONT][4] = {};
  float m_run[2] = {-INFINITY, -INFINITY}, l_run[2] = {0.f, 0.f};

  for (int i = 0; i < n_tiles; ++i) {
    cp_async_wait<MLA_STAGES - 2>();
    __syncthreads();  // tile i is in; tile i - 1's stage and red are free
    if (i + MLA_STAGES - 1 < n_tiles) load(i + MLA_STAGES - 1);
    cp_async_commit();
    const __nv_bfloat16* ct = ring + (i % MLA_STAGES) * MLA_STAGE;
    const __nv_bfloat16* pt = ct + MLA_TILE * C_ROW;

    // Scores over this warp's dims: n-tiles of 8 positions, two a load.
    float s[MLA_NT][4] = {};
#pragma unroll
    for (int ks = 0; ks < MLA_KSTEPS; ++ks)
#pragma unroll
      for (int np = 0; np < MLA_NT / 2; ++np) {
        const int n = 16 * np + 8 * (mat >> 1) + mrow;
        const int k = 8 * (mat & 1);
        uint32_t bf[4];
        ldsm_x4(bf, ks < MLA_KSTEPS - 1
                        ? ct + n * C_ROW + warp * MLA_DIMS + 16 * ks + k
                        : pt + n * PE_ROW + 16 * warp + k);
        mma_bf16(s[2 * np], qh[ks], bf[0], bf[1]);
        mma_bf16(s[2 * np], ql[ks], bf[0], bf[1]);
        mma_bf16(s[2 * np + 1], qh[ks], bf[2], bf[3]);
        mma_bf16(s[2 * np + 1], ql[ks], bf[2], bf[3]);
      }
#pragma unroll
    for (int nt = 0; nt < MLA_NT; ++nt)
      red[(warp * MLA_NT + nt) * 32 + lane] =
          make_float4(s[nt][0], s[nt][1], s[nt][2], s[nt][3]);
    __syncthreads();

    // The whole scores, summed over the warps in one order, scaled and
    // masked past pos; element e of n-tile nt is head g + 8 (e >> 1),
    // position 8 nt + 2t + (e & 1).
    const int p0 = start + i * MLA_TILE;
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int nt = 0; nt < MLA_NT; ++nt) {
      float4 v = red[nt * 32 + lane];
#pragma unroll
      for (int w = 1; w < MLA_WARPS; ++w) {
        const float4 u = red[(w * MLA_NT + nt) * 32 + lane];
        v.x += u.x;
        v.y += u.y;
        v.z += u.z;
        v.w += u.w;
      }
      const float tot[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool ok = p0 + 8 * nt + 2 * t + (e & 1) < n_valid;
        s[nt][e] = ok ? tot[e] * a.scale : -INFINITY;
        mx[e >> 1] = fmaxf(mx[e >> 1], s[nt][e]);
      }
    }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(~0u, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(~0u, mx[r], 2));
      const float m_new = fmaxf(m_run[r], mx[r]);  // finite: p0 is valid
      alpha[r] = expf(m_run[r] - m_new);
      m_run[r] = m_new;
      l_run[r] *= alpha[r];
    }
#pragma unroll
    for (int nt = 0; nt < MLA_NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[nt][e] = expf(s[nt][e] - m_run[e >> 1]);
        l_run[e >> 1] += s[nt][e];
      }
#pragma unroll
    for (int nt = 0; nt < MLA_ONT; ++nt) {
      o[nt][0] *= alpha[0];
      o[nt][1] *= alpha[0];
      o[nt][2] *= alpha[1];
      o[nt][3] *= alpha[1];
    }

    // O += P c: k-steps of 16 positions (two score n-tiles, whose
    // accumulators are the A fragment), n-tiles of 8 of this warp's dims.
#pragma unroll
    for (int kk = 0; kk < MLA_TILE / 16; ++kk) {
      uint32_t ph[4], pl[4];
      split2(s[2 * kk][0], s[2 * kk][1], ph[0], pl[0]);
      split2(s[2 * kk][2], s[2 * kk][3], ph[1], pl[1]);
      split2(s[2 * kk + 1][0], s[2 * kk + 1][1], ph[2], pl[2]);
      split2(s[2 * kk + 1][2], s[2 * kk + 1][3], ph[3], pl[3]);
      const int prow = 16 * kk + 8 * (mat & 1) + mrow;
#pragma unroll
      for (int dp = 0; dp < MLA_ONT / 2; ++dp) {
        uint32_t bf[4];
        ldsm_x4_trans(bf, ct + prow * C_ROW + warp * MLA_DIMS + 16 * dp +
                              8 * (mat >> 1));
        mma_bf16(o[2 * dp], ph, bf[0], bf[1]);
        mma_bf16(o[2 * dp], pl, bf[0], bf[1]);
        mma_bf16(o[2 * dp + 1], ph, bf[2], bf[3]);
        mma_bf16(o[2 * dp + 1], pl, bf[2], bf[3]);
      }
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_run[r] += __shfl_xor_sync(~0u, l_run[r], 1);
    l_run[r] += __shfl_xor_sync(~0u, l_run[r], 2);
  }
  const long long slot = ((long long)b * a.n_chunks + chunk) * a.H + h0;
  float* po = a.part_o + slot * MLA_RANK;
#pragma unroll
  for (int nt = 0; nt < MLA_ONT; ++nt) {
    const int d = warp * MLA_DIMS + 8 * nt + 2 * t;
    *reinterpret_cast<float2*>(po + g * MLA_RANK + d) =
        make_float2(o[nt][0], o[nt][1]);
    *reinterpret_cast<float2*>(po + (g + 8) * MLA_RANK + d) =
        make_float2(o[nt][2], o[nt][3]);
  }
  if (warp == 0 && t == 0) {
    float* ml = a.part_ml + slot * 2;
    ml[2 * g] = m_run[0];
    ml[2 * g + 1] = l_run[0];
    ml[2 * (g + 8)] = m_run[1];
    ml[2 * (g + 8) + 1] = l_run[1];
  }
}

// A block per (head, row): 128 threads, four dims each.
__global__ void __launch_bounds__(MLA_RANK / 4)
    mla_attend_merge_kernel(MlaArgs a) {
  const int h = blockIdx.x, b = blockIdx.y;
  const int n_valid = min(a.pos[b] + 1, a.S);
  const int nc = (n_valid + a.chunk - 1) / a.chunk;
  const long long first = (long long)b * a.n_chunks * a.H + h;
  const long long step = a.H;  // from a chunk's slot to the next one's
  const float* ml = a.part_ml + first * 2;
  float m = -INFINITY;
  for (int c = 0; c < nc; ++c) m = fmaxf(m, ml[c * step * 2]);
  const float* po = a.part_o + first * MLA_RANK + 4 * threadIdx.x;
  float l = 0.f;
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 4
  for (int c = 0; c < nc; ++c) {
    const float w = expf(ml[c * step * 2] - m);
    l += ml[c * step * 2 + 1] * w;
    const float4 v = *reinterpret_cast<const float4*>(po + c * step *
                                                      MLA_RANK);
    acc.x += w * v.x;
    acc.y += w * v.y;
    acc.z += w * v.z;
    acc.w += w * v.w;
  }
  *reinterpret_cast<float4*>(a.out + ((long long)b * a.H + h) * MLA_RANK +
                             4 * threadIdx.x) =
      make_float4(acc.x / l, acc.y / l, acc.z / l, acc.w / l);
}

// Lift the split kernel's shared-memory limit, once a device (the first
// launch is eager, before any capture).
cudaError_t set_mla_smem() {
  static unsigned done = 0;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess || (done >> dev & 1u)) return err;
  err = cudaFuncSetAttribute(mla_attend_split_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)MLA_SMEM);
  if (err == cudaSuccess) done |= 1u << dev;
  return err;
}

int launch_mla(const MlaArgs& a, cudaStream_t stream) {
  const cudaError_t err = set_mla_smem();
  if (err != cudaSuccess) return (int)err;
  mla_attend_split_kernel<<<dim3(a.n_chunks, a.B, a.H / MLA_HEADS),
                            MLA_THREADS, MLA_SMEM, stream>>>(a);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  mla_attend_merge_kernel<<<dim3(a.H, a.B), MLA_RANK / 4, 0, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace rt

// q (B, H, 512) and qpe (B, H, 64) f32 with the given row and head strides;
// c (B, S, 512) and pe (B, S, 64) bf16 with the given row and position
// strides (multiples of 8, every row start 16-byte aligned); pos (B,) int32
// in [0, S); H a multiple of 16; chunk a multiple of 32. part_o (B,
// n_chunks, H, 512) and part_ml (B, n_chunks, H, 2) f32 scratch, out (B,
// H, 512) f32, n_chunks = ceil(S / chunk). Returns cudaGetLastError()
// after the launches.
extern "C" int mla_attend_launch(const void* q, long long sqb, long long sqh,
                                 const void* qpe, long long spb,
                                 long long sph, const void* c, long long scb,
                                 long long scs, const void* pe,
                                 long long seb, long long ses,
                                 const void* pos, int B, int H, int S,
                                 int chunk, float scale, void* part_o,
                                 void* part_ml, void* out, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || H % rt::MLA_HEADS != 0 || chunk <= 0 ||
      chunk % rt::MLA_TILE != 0)
    return (int)cudaErrorInvalidValue;
  const rt::MlaArgs a{static_cast<const float*>(q),
                      sqb,
                      sqh,
                      static_cast<const float*>(qpe),
                      spb,
                      sph,
                      static_cast<const __nv_bfloat16*>(c),
                      scb,
                      scs,
                      static_cast<const __nv_bfloat16*>(pe),
                      seb,
                      ses,
                      static_cast<const int*>(pos),
                      B,
                      H,
                      S,
                      chunk,
                      (S + chunk - 1) / chunk,
                      scale,
                      static_cast<float*>(part_o),
                      static_cast<float*>(part_ml),
                      static_cast<float*>(out)};
  return rt::launch_mla(a, static_cast<cudaStream_t>(stream));
}
