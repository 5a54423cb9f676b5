// Blockwise online-softmax GQA attention (flash attention), for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/flash_attention/kernel.py
// (flash_attention_pallas, body _flash_kernel). Computes what that kernel
// computes, for q (B, Hq, S, D) against k, v (B, Hkv, T, D), query head h
// reading kv head h / G (G = Hq / Hkv):
//   s   = (q . k^T) * scale                       f32 from bf16 products
//   s   = -2^30 where key j is masked for query i: j > i + q_offset
//         (causal) or i + q_offset - j >= window (sliding window)
//   m   = running row max (starts at -1e30); p = exp(s - m), f32
//   l   = l * exp(m_old - m) + sum(p)             f32
//   acc = acc * exp(m_old - m) + bf16(p) . v      f32 accumulation
//   out = acc / max(l, 1e-30), rounded to bf16
// and, for training, writes each row's log-sum-exp m + log(l) when asked
// (the backward kernel, flash_attention_bwd.cu, recomputes p from it),
// and skips every kv tile in which no (query, key) pair of the CTA is
// visible, as the TPU kernel skips its fully masked blocks. Keys past T
// score -inf, so they add nothing even to a row that has seen no visible
// key yet.
//
// v may be narrower than q and k (width Dv, out (B, Hq, S, Dv)): MLA's
// full-rank prefill (deepseek-v2-lite-16b) attends with q and k of
// qk_nope + qk_rope = 128 + 64 = 192 and v of 128.
//
// Two designs, chosen by the widths (D, Dv) alone (design_of, which the C
// interface also exports as flash_design):
//   D = Dv 64, 128, 256 (llama-width, granite-20b, gemma3-4b) and (D 192,
//     Dv 128) (deepseek's MLA): v2, TMA and wgmma, below;
//   D = Dv 16, 80 (the smoke heads, stablelm-3b): v1, mma.sync and
//     cp.async, the first design, kept for the head dims v2 does not
//     cover yet.
//
// Both keep the rows of a kv head in position-major order, row r = s * G +
// g, so a CTA's tile holds every group head of its positions and each K/V
// tile loaded feeds all of them: the G heads that share it are never
// loaded apart (at G = 48 a tile spans a few positions; its position range
// still bounds its visible keys). Both walk the heaviest tiles first:
// under a causal mask the last query tiles see the most keys, so
// blockIdx.x counts the tiles from the end. Both take strided q, k, v and
// out (element stride 1 along D): the model passes its (B, S, H, D)
// projections as (B, H, S, D) views, with no transposing copy.
//
// v2 (TMA + wgmma):
//   * A CTA is 128 query rows and three warpgroups: two consumers of 64
//     rows each and a producer. setmaxnreg moves the registers to the
//     consumers (240 a thread: at D 256 a thread holds 128 float32 of the
//     output and 32 of the scores); the producer keeps 24. (A lone
//     producer warp would leave 168 a thread: nine warps put three on one
//     SM sub-partition, and setmaxnreg needs whole warpgroups.)
//   * One producer thread loads each K and V tile by TMA into a 2-stage
//     ring, K and V each with full and free mbarriers: a stage's K is
//     refilled once Q . K^T has read it, its V once P . V has. The tensor
//     maps read the strided (B, Hkv, T, D) views as they are (4-D, the
//     model's strides, 128-byte swizzle, D in 64-element boxes); keys past
//     T arrive as zeros. Q is loaded once per CTA by the consumers with
//     16-byte cp.async in the same swizzled layout: a tile's rows are
//     (position, group head) pairs, which a tensor map box covers only
//     where G divides 128, and granite-20b has G = 48.
//   * Per tile and warpgroup: S = Q . K^T by wgmma.mma_async m64nBKk16,
//     both operands K-major from shared memory; the softmax; P . V by
//     wgmma with P from registers (rounded to bf16, as the Pallas kernel
//     casts p to v's dtype) and V from shared memory, transposed by its
//     descriptor (MN-major). The two warpgroups share the tensor cores.
//     Key tiles: BK = 128 at D <= 192, 64 at D 256. Shared memory at
//     D 256: Q 64 KB plus two stages of K and V, 128 KB; at (192, 128):
//     Q 48 KB, two stages of K 96 KB and of V 64 KB, 209 KB in all. Q . K^T
//     takes D / 16 k-steps (12 at 192, three 128-byte swizzle chunks); the
//     registers a thread holds are those of D 128 (O 64, S 64 float32).
//   * Softmax in exp2 with scale * log2(e) folded into one multiply. The
//     per-element mask runs only on the tiles that cross the causal
//     diagonal, a window edge or the tail T for some row of the
//     warpgroup; every pair of the other visited tiles is visible.
//
// What bounds it on an H100: operations. At gemma3-4b's prefill of 4,096
// tokens a global layer has 67 M visible (query, key) pairs over 8 heads,
// 4 D = 1,024 flops each: 6.9e10 flops against ~50 MB of q, k, v and out,
// ~1,400 flops a byte, far above the ~295 where the tensor cores and not
// HBM become the limit. v2 runs wgmma, the only way to the tensor
// cores' full rate on Hopper, from two warpgroups while the producer
// keeps the next tile in flight.
//
// What a later design changes: the softmax under a product inside a
// warpgroup (issuing tile i - 1's P . V with tile i's Q . K^T, as
// FlashAttention-3 does, needed more than 240 registers here and ptxas
// serialized the products), 80-key tiles at D 256, a persistent grid, TMA
// for Q where G divides 128, and v2 for D 16 and 80.

#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>
#include <math.h>

#include "hopper.cuh"

namespace {

// ---------------------------------------------------------------------------
// v1: mma.sync (D 16, 80)
// ---------------------------------------------------------------------------
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kM = 16 * kWarps;              // query rows per CTA
constexpr float kMasked = -1073741824.0f;    // -2^30, the TPU kernel's NEG_INF
constexpr float kMInit = -1e30f;             // the running max's start

struct Params {
  const __nv_bfloat16* q;
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  __nv_bfloat16* o;
  long long q_b, q_h, q_s;                   // strides, in elements
  long long k_b, k_h, k_s;
  long long v_b, v_h, v_s;
  long long o_b, o_h, o_s;
  int S, T, G;                               // positions, keys, heads per kv head
  int causal, window, q_offset;              // window <= 0: no window
  float scale;
  int n_tiles;                               // ceil(S * G / kM)
  // when not null: [0] += kv tiles visited, [1] += those that took the
  // per-element mask, per CTA (v1) or per consumer warpgroup (v2)
  unsigned long long* tiles;
  // when not null: each row's log-sum-exp of its scaled scores, m + log(l)
  // (natural log), float32 (B, Hq, S) contiguous, for the backward kernel
  float* lse;
};

// the index of row fr (position fr / G of head kvh * G + fr % G) in lse
__device__ __forceinline__ long long lse_index(const Params& p, int b, int kvh, int fr) {
  return (static_cast<long long>(b * gridDim.y + kvh) * p.G + fr % p.G) * p.S + fr / p.G;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(s), "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::);
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const __nv_bfloat16* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(s));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const __nv_bfloat16* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(s));
}

// d += a (16 x 16, row) . b (16 x 8, col), bf16 in, f32 accumulate
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

template <int D, int BK>
__global__ void __launch_bounds__(kThreads) flash_mma_kernel(const Params p) {
  constexpr int kLd = D + 8;                 // bf16 per shared row (+16 bytes)
  constexpr int kChunks = D / 8;             // 16-byte chunks per row
  constexpr int kNT = BK / 8;                // n8 score tiles per warp
  constexpr int kDT = D / 8;                 // n8 output tiles per warp
  static_assert(D % 16 == 0 && BK % 16 == 0, "mma.sync k16 steps");
  static_assert((kM * kChunks) % kThreads == 0 && (BK * kChunks) % kThreads == 0,
                "whole chunks per thread");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);   // kM x kLd
  __nv_bfloat16* kvs = qs + kM * kLd;        // 2 stages of K (BK x kLd), V (BK x kLd)

  const int tile = p.n_tiles - 1 - static_cast<int>(blockIdx.x);
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int rows = p.S * p.G;
  const int r0 = tile * kM;
  const int q_lo = r0 / p.G + p.q_offset;
  const int q_hi = (min(r0 + kM, rows) - 1) / p.G + p.q_offset;

  // the kv tiles holding a key visible to some row of this tile
  int j_lo = 0;
  int j_hi = (p.T + BK - 1) / BK - 1;
  if (p.causal) j_hi = min(j_hi, floor_div(q_hi, BK));
  if (p.window > 0) j_lo = max(0, floor_div(q_lo - p.window + 1, BK));

  const __nv_bfloat16* qb = p.q + b * p.q_b + static_cast<long long>(kvh) * p.G * p.q_h;
  const __nv_bfloat16* kb = p.k + b * p.k_b + kvh * p.k_h;
  const __nv_bfloat16* vb = p.v + b * p.v_b + kvh * p.v_h;

  // this thread's two rows of its warp's 16: g and g + 8
  const int g = lane >> 2, t4 = lane & 3;
  const int fr0 = r0 + warp * 16 + g;
  const int fr1 = fr0 + 8;
  const int qp0 = fr0 / p.G + p.q_offset;
  const int qp1 = fr1 / p.G + p.q_offset;

  float acc[kDT][4];
#pragma unroll
  for (int i = 0; i < kDT; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[i][e] = 0.0f;
  float m_r[2] = {kMInit, kMInit};
  float l_r[2] = {0.0f, 0.0f};               // this lane's part of the row sums

  auto load_kv = [&](int stage, int j) {
    __nv_bfloat16* ks = kvs + stage * 2 * BK * kLd;
    __nv_bfloat16* vs = ks + BK * kLd;
#pragma unroll
    for (int i = 0; i < BK * kChunks / kThreads; ++i) {
      const int c = tid + i * kThreads;
      const int r = c / kChunks, col = (c % kChunks) * 8;
      const int t = j * BK + r;
      const bool live = t < p.T;
      const long long tk = live ? t : 0;
      cp_async16(ks + r * kLd + col, kb + tk * p.k_s + col, live ? 16 : 0);
      cp_async16(vs + r * kLd + col, vb + tk * p.v_s + col, live ? 16 : 0);
    }
  };

  if (j_lo <= j_hi) {
#pragma unroll
    for (int i = 0; i < kM * kChunks / kThreads; ++i) {
      const int c = tid + i * kThreads;
      const int r = c / kChunks, col = (c % kChunks) * 8;
      const int fr = r0 + r;
      const bool live = fr < rows;
      const long long off = live ? (fr % p.G) * p.q_h + static_cast<long long>(fr / p.G) * p.q_s
                                 : 0;
      cp_async16(qs + r * kLd + col, qb + off + col, live ? 16 : 0);
    }
    load_kv(0, j_lo);
    cp_async_commit();

    for (int j = j_lo; j <= j_hi; ++j) {
      const int stage = (j - j_lo) & 1;
      cp_async_wait_all();                   // tile j (and Q) landed for this thread
      __syncthreads();                       // ... for all; tile j - 1's buffer is free
      if (j < j_hi) load_kv(stage ^ 1, j + 1);
      cp_async_commit();

      const __nv_bfloat16* ks = kvs + stage * 2 * BK * kLd;
      const __nv_bfloat16* vs = ks + BK * kLd;

      // S = Q . K^T for this warp's 16 rows x BK keys
      float s[kNT][4];
#pragma unroll
      for (int n = 0; n < kNT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] = 0.0f;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        uint32_t a[4];
        ldmatrix_x4(a, qs + (warp * 16 + (lane & 15)) * kLd + kk * 16 + (lane >> 4) * 8);
#pragma unroll
        for (int n = 0; n < kNT; n += 2) {
          uint32_t bk[4];
          ldmatrix_x4(bk, ks + (n * 8 + (lane & 7) + ((lane >> 4) << 3)) * kLd + kk * 16
                              + ((lane >> 3) & 1) * 8);
          mma_bf16(s[n], a, bk[0], bk[1]);
          mma_bf16(s[n + 1], a, bk[2], bk[3]);
        }
      }

      // scale and mask; the new running max of each row (m included)
      const int k0 = j * BK;
      float mx[2] = {m_r[0], m_r[1]};
#pragma unroll
      for (int n = 0; n < kNT; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int half = e >> 1;
          const int kp = k0 + n * 8 + 2 * t4 + (e & 1);
          const int qp = half ? qp1 : qp0;
          float x = s[n][e] * p.scale;
          if (kp >= p.T) {
            x = -INFINITY;
          } else if ((p.causal && kp > qp) || (p.window > 0 && qp - kp >= p.window)) {
            x = kMasked;
          }
          s[n][e] = x;
          mx[half] = fmaxf(mx[half], x);
        }
      }
      float alpha[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
        alpha[h] = __expf(m_r[h] - mx[h]);
        m_r[h] = mx[h];
      }
      float ps[2] = {0.0f, 0.0f};
#pragma unroll
      for (int n = 0; n < kNT; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float pv = __expf(s[n][e] - m_r[e >> 1]);
          s[n][e] = pv;
          ps[e >> 1] += pv;
        }
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) l_r[h] = l_r[h] * alpha[h] + ps[h];
#pragma unroll
      for (int i = 0; i < kDT; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][e] *= alpha[e >> 1];

      // acc += bf16(P) . V: score tiles 2kk, 2kk + 1 are the A fragment of
      // the kk-th k16 step
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        uint32_t a[4];
        a[0] = f2_to_bf2(s[2 * kk][0], s[2 * kk][1]);
        a[1] = f2_to_bf2(s[2 * kk][2], s[2 * kk][3]);
        a[2] = f2_to_bf2(s[2 * kk + 1][0], s[2 * kk + 1][1]);
        a[3] = f2_to_bf2(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
        for (int dt = 0; dt < kDT; dt += 2) {
          uint32_t bv[4];
          ldmatrix_x4_trans(bv, vs + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * kLd
                                    + dt * 8 + (lane >> 4) * 8);
          mma_bf16(acc[dt], a, bv[0], bv[1]);
          mma_bf16(acc[dt + 1], a, bv[2], bv[3]);
        }
      }
    }
    cp_async_wait_all();                     // no copy outlives the CTA
    if (p.tiles != nullptr && tid == 0) {    // every tile visited takes the mask
      atomicAdd(p.tiles, static_cast<unsigned long long>(j_hi - j_lo + 1));
      atomicAdd(p.tiles + 1, static_cast<unsigned long long>(j_hi - j_lo + 1));
    }
  }

  // out = acc / max(l, 1e-30): lane holds columns 2 t4, 2 t4 + 1 of each
  // n8 output tile, for rows fr0 and fr1
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float l = l_r[h];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const float denom = fmaxf(l, 1e-30f);
    const int fr = h ? fr1 : fr0;
    if (fr >= rows) continue;
    if (p.lse != nullptr && t4 == 0) p.lse[lse_index(p, b, kvh, fr)] = m_r[h] + logf(denom);
    __nv_bfloat16* dst = p.o + b * p.o_b
                         + static_cast<long long>(kvh * p.G + fr % p.G) * p.o_h
                         + static_cast<long long>(fr / p.G) * p.o_s + 2 * t4;
#pragma unroll
    for (int i = 0; i < kDT; ++i) {
      *reinterpret_cast<uint32_t*>(dst + i * 8) =
          f2_to_bf2(acc[i][2 * h] / denom, acc[i][2 * h + 1] / denom);
    }
  }
}

template <int D, int BK>
cudaError_t launch_mma(const Params& p, int B, int Hkv, cudaStream_t stream) {
  // Q tile and two stages of K and V: 99 KB at D = 256, 85 KB at 128
  constexpr int smem = static_cast<int>(sizeof(__nv_bfloat16)) * (kM + 4 * BK) * (D + 8);
  cudaError_t err = cudaFuncSetAttribute(flash_mma_kernel<D, BK>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(p.n_tiles, Hkv, B);
  flash_mma_kernel<D, BK><<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}


// ---------------------------------------------------------------------------
// v2: TMA + wgmma (D 64, 128, 256)
// ---------------------------------------------------------------------------

constexpr int kConsumers = 2;                  // warpgroups of 64 query rows
constexpr int kWgThreads = 128 * (kConsumers + 1);   // + one producer warpgroup
constexpr int kWgRows = 64 * kConsumers;       // query rows per CTA

// DQK: the width of q and k; DV: the width of v and out (DQK == DV but
// for MLA's full-rank prefill, 192 and 128)
template <int DQK, int DV>
struct Wg {
  static constexpr int BK = DQK == 256 ? 64 : 128;         // keys per tile
  static constexpr int kRingK = 2;                         // K stages
  static constexpr int kRingV = 2;                         // V stages
  static constexpr int kChunksK = DQK / 64;                // 128-byte column chunks
  static constexpr int kChunksV = DV / 64;
  static constexpr int kQBytes = kWgRows * DQK * 2;
  static constexpr int kKTileBytes = BK * DQK * 2;         // one K tile
  static constexpr int kVTileBytes = BK * DV * 2;          // one V tile
  static constexpr int kVOff = kQBytes + kRingK * kKTileBytes;
  static constexpr int kBarOff = kVOff + kRingV * kVTileBytes;
  static constexpr int kSmem = 1024 + kBarOff + 16 * (kRingK + kRingV);   // + 1 KB to align
  static_assert(DQK % 64 == 0 && DV % 64 == 0, "whole 128-byte column chunks");
  static_assert(kSmem <= 232448, "over the shared memory a block can use");
};

// The per-tile softmax of a warpgroup's 64 rows x BK keys (log2 units):
// scale, mask where the tile needs it, the new running max, alpha, p and
// l; p goes to bf16 A fragments for P . V.
template <int BK>
struct Softmax {
  float m[2] = {kMInit, kMInit};
  float l[2] = {0.0f, 0.0f};                   // this lane's part of the row sums

  __device__ __forceinline__ void tile(float (&sc)[BK / 2], uint32_t (&pa)[BK / 16][4],
                                       float (&alpha)[2], const Params& p, int k0,
                                       bool need_mask, const int (&qp)[2], int t4, float sl) {
    constexpr float kMasked2 = kMasked * kLog2e;          // -2^30 in log2 units
    float mx[2] = {m[0], m[1]};
    if (need_mask) {
#pragma unroll
      for (int n = 0; n < BK / 8; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kp = k0 + n * 8 + 2 * t4 + (e & 1);
          const int q = qp[e >> 1];
          float x = sc[4 * n + e] * sl;
          if (kp >= p.T) {
            x = -INFINITY;
          } else if ((p.causal && kp > q) || (p.window > 0 && q - kp >= p.window)) {
            x = kMasked2;
          }
          sc[4 * n + e] = x;
          mx[e >> 1] = fmaxf(mx[e >> 1], x);
        }
      }
    } else {
#pragma unroll
      for (int n = 0; n < BK / 8; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          sc[4 * n + e] *= sl;
          mx[e >> 1] = fmaxf(mx[e >> 1], sc[4 * n + e]);
        }
      }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
      alpha[h] = exp2f(m[h] - mx[h]);
      m[h] = mx[h];
    }
    float ps[2] = {0.0f, 0.0f};
#pragma unroll
    for (int n = 0; n < BK / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float pv = exp2f(sc[4 * n + e] - m[e >> 1]);
        sc[4 * n + e] = pv;
        ps[e >> 1] += pv;
      }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) l[h] = l[h] * alpha[h] + ps[h];
    // score tiles 2kk, 2kk + 1 are the A fragment of P . V's kk-th k16 step
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      pa[kk][0] = f2_to_bf2(sc[8 * kk + 0], sc[8 * kk + 1]);
      pa[kk][1] = f2_to_bf2(sc[8 * kk + 2], sc[8 * kk + 3]);
      pa[kk][2] = f2_to_bf2(sc[8 * kk + 4], sc[8 * kk + 5]);
      pa[kk][3] = f2_to_bf2(sc[8 * kk + 6], sc[8 * kk + 7]);
    }
  }
};

template <int DQK, int DV>
__global__ void __launch_bounds__(kWgThreads, 1)
flash_wgmma_kernel(const __grid_constant__ CUtensorMap tm_k,
                   const __grid_constant__ CUtensorMap tm_v, const Params p,
                   const MapSlots ks, const MapSlots vs) {
  using W = Wg<DQK, DV>;
  constexpr int BK = W::BK;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  const uint32_t q_base = smem_u32(smem);
  const uint32_t k_base = q_base + W::kQBytes;             // K stages, then V stages
  const uint32_t v_base = q_base + W::kVOff;
  // barriers, 8 bytes each: K landed, K free (kRingK each), V landed, V
  // free (kRingV each)
  const uint32_t full_k = q_base + W::kBarOff;
  const uint32_t free_k = full_k + 8 * W::kRingK;
  const uint32_t full_v = free_k + 8 * W::kRingK;
  const uint32_t free_v = full_v + 8 * W::kRingV;

  const int tile = p.n_tiles - 1 - static_cast<int>(blockIdx.x);
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const int rows = p.S * p.G;
  const int r0 = tile * kWgRows;
  const int q_lo = r0 / p.G + p.q_offset;
  const int q_hi = (min(r0 + kWgRows, rows) - 1) / p.G + p.q_offset;
  int j_lo = 0;
  int j_hi = (p.T + BK - 1) / BK - 1;
  if (p.causal) j_hi = min(j_hi, floor_div(q_hi, BK));
  if (p.window > 0) j_lo = max(0, floor_div(q_lo - p.window + 1, BK));
  const int n = j_hi - j_lo + 1;                           // tiles to visit

  if (threadIdx.x == 0) {
    for (int s = 0; s < W::kRingK; ++s) {
      mbar_init(full_k + 8 * s, 1);
      mbar_init(free_k + 8 * s, 4 * kConsumers);           // one arrival a consumer warp
    }
    for (int s = 0; s < W::kRingV; ++s) {
      mbar_init(full_v + 8 * s, 1);
      mbar_init(free_v + 8 * s, 4 * kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == kConsumers) {
    // the producer: one thread keeps the ring full, K of a tile before its
    // V, each into its stage once the consumers have freed it
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x == kConsumers * 128) {
      int ck[4], cv[4];
      ck[ks.h] = kvh; ck[ks.b] = b;
      cv[vs.h] = kvh; cv[vs.b] = b;
      for (int i = 0; i < n; ++i) {
        const int sk = i % W::kRingK, sv = i % W::kRingV;
        ck[ks.t] = (j_lo + i) * BK;
        cv[vs.t] = (j_lo + i) * BK;
        if (i >= W::kRingK) mbar_wait(free_k + 8 * sk, ((i / W::kRingK) - 1) & 1);
        mbar_expect(full_k + 8 * sk, W::kKTileBytes);
#pragma unroll
        for (int c = 0; c < W::kChunksK; ++c)
          tma_load_4d(k_base + sk * W::kKTileBytes + c * BK * 128, &tm_k, full_k + 8 * sk,
                      c * 64, ck[1], ck[2], ck[3]);
        if (i >= W::kRingV) mbar_wait(free_v + 8 * sv, ((i / W::kRingV) - 1) & 1);
        mbar_expect(full_v + 8 * sv, W::kVTileBytes);
#pragma unroll
        for (int c = 0; c < W::kChunksV; ++c)
          tma_load_4d(v_base + sv * W::kVTileBytes + c * BK * 128, &tm_v, full_v + 8 * sv,
                      c * 64, cv[1], cv[2], cv[3]);
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
    const int ct = threadIdx.x % 128;
    const int warp = ct >> 5;
    const int lane = ct & 31;
    const int gq = lane >> 2, t4 = lane & 3;

    // Q: this warpgroup's 64 rows, swizzled as TMA would (16-byte group
    // x of row r at x ^ (r % 8)), zeros past the last row
    {
      const __nv_bfloat16* qb = p.q + b * p.q_b + static_cast<long long>(kvh) * p.G * p.q_h;
      for (int idx = ct; idx < 64 * (DQK / 8); idx += 128) {
        const int r = 64 * wg + idx / (DQK / 8), ch = idx % (DQK / 8);
        const int fr = r0 + r;
        const bool live = fr < rows;
        const long long off = live ? (fr % p.G) * p.q_h + static_cast<long long>(fr / p.G) * p.q_s
                                   : 0;
        const uint32_t dst = q_base + (ch / 8) * (kWgRows * 128) + r * 128
                             + (((ch % 8) ^ (r % 8)) << 4);
        asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                     :: "r"(dst), "l"(qb + off + ch * 8), "r"(live ? 16 : 0));
      }
      asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      asm volatile("bar.sync %0, 128;\n" :: "r"(1 + wg) : "memory");
    }

    // this thread's rows: g and g + 8 of its warp's 16
    const int fr0 = r0 + 64 * wg + warp * 16 + gq;
    const int fr1 = fr0 + 8;
    const int qp[2] = {fr0 / p.G + p.q_offset, fr1 / p.G + p.q_offset};
    const int w_first = r0 + 64 * wg;
    const int w_lo = w_first / p.G + p.q_offset;
    const int w_hi = (min(w_first + 64, rows) - 1) / p.G + p.q_offset;
    const bool w_rows = w_first < rows;
    const float sl = p.scale * kLog2e;
    const uint32_t q_wg = q_base + 64 * wg * 128;
    auto need_mask = [&](int k0) {
      return !w_rows || k0 + BK > p.T || (p.causal && k0 + BK - 1 > w_lo)
             || (p.window > 0 && w_hi - k0 >= p.window);
    };
    const uint64_t q_desc = gmma_desc(q_wg, 16, 1024);
    auto start_qk = [&](float (&sc)[BK / 2], int s) {      // S = Q . K^T, 64 x BK
      const uint64_t k_desc = gmma_desc(k_base + s * W::kKTileBytes, 16, 1024);
#pragma unroll
      for (int kk = 0; kk < DQK / 16; ++kk) {
        wgmma_ss(sc, desc_at(q_desc, (kk / 4) * (kWgRows * 128) + (kk % 4) * 32),
                 desc_at(k_desc, (kk / 4) * (BK * 128) + (kk % 4) * 32), kk > 0);
      }
      wgmma_commit();
    };
    auto start_pv = [&](float (&o)[DV / 2], uint32_t (&pa)[BK / 16][4], int s) {
      // o += bf16(P) . V; V's descriptor walks 16 keys (2 KB) a k16 step
      const uint64_t v_desc = gmma_desc(v_base + s * W::kVTileBytes, BK * 128, 1024);
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) wgmma_rs(o, pa[kk], desc_at(v_desc, kk * 2048), 1);
      wgmma_commit();
    };
    auto release = [&](uint32_t bar) {
      __syncwarp();
      if (lane == 0) mbar_arrive(bar);
    };
    float o[DV / 2];
#pragma unroll
    for (int i = 0; i < DV / 2; ++i) o[i] = 0.0f;
    Softmax<BK> sm;
    float sc[BK / 2];
    uint32_t pa[BK / 16][4];
    float alpha[2];

    // Per tile: Q . K^T, the softmax, P . V; K is freed for the next load
    // once Q . K^T has read it, V once P . V has.
    for (int i = 0; i < n; ++i) {
      const int sk = i % W::kRingK, sv = i % W::kRingV;
      const int k0 = (j_lo + i) * BK;
      mbar_wait(full_k + 8 * sk, (i / W::kRingK) & 1);
      wgmma_fence();
      start_qk(sc, sk);
      wgmma_wait_all();
      fence_regs(sc);
      release(free_k + 8 * sk);
      sm.tile(sc, pa, alpha, p, k0, need_mask(k0), qp, t4, sl);
#pragma unroll
      for (int c = 0; c < DV / 8; ++c) {
#pragma unroll
        for (int e = 0; e < 4; ++e) o[4 * c + e] *= alpha[e >> 1];
      }
      mbar_wait(full_v + 8 * sv, (i / W::kRingV) & 1);
      wgmma_fence();
      start_pv(o, pa, sv);
      wgmma_wait_all();
      fence_regs(o);
      fence_regs(pa);
      release(free_v + 8 * sv);
    }

    // out = o / max(l, 1e-30): columns 8 c + 2 t4, + 1 of rows fr0, fr1
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float l = sm.l[h];
      l += __shfl_xor_sync(0xffffffffu, l, 1);
      l += __shfl_xor_sync(0xffffffffu, l, 2);
      const float denom = fmaxf(l, 1e-30f);
      const int fr = h ? fr1 : fr0;
      if (fr >= rows) continue;
      if (p.lse != nullptr && t4 == 0) {       // m is in log2 units
        p.lse[lse_index(p, b, kvh, fr)] = (sm.m[h] + log2f(denom)) * 0.6931471805599453f;
      }
      __nv_bfloat16* dst = p.o + b * p.o_b
                           + static_cast<long long>(kvh * p.G + fr % p.G) * p.o_h
                           + static_cast<long long>(fr / p.G) * p.o_s + 2 * t4;
#pragma unroll
      for (int c = 0; c < DV / 8; ++c) {
        *reinterpret_cast<uint32_t*>(dst + c * 8) =
            f2_to_bf2(o[4 * c + 2 * h] / denom, o[4 * c + 2 * h + 1] / denom);
      }
    }

    // the tiles this warpgroup visited, and those need_mask sent through
    // the per-element mask (counted here, after the output, so the tile
    // loop holds no counter)
    if (p.tiles != nullptr && ct == 0 && n > 0) {
      int masked = 0;
      for (int i = 0; i < n; ++i) masked += need_mask((j_lo + i) * BK);
      atomicAdd(p.tiles, static_cast<unsigned long long>(n));
      atomicAdd(p.tiles + 1, static_cast<unsigned long long>(masked));
    }
  }
}

template <int DQK, int DV>
cudaError_t launch_wgmma(Params p, int B, int Hkv, cudaStream_t stream) {
  using W = Wg<DQK, DV>;
  CUtensorMap tm_k, tm_v;
  MapSlots ks, vs;
  if (!make_map(&tm_k, p.k, p.k_b, p.k_h, p.k_s, B, Hkv, p.T, DQK, W::BK, &ks)
      || !make_map(&tm_v, p.v, p.v_b, p.v_h, p.v_s, B, Hkv, p.T, DV, W::BK, &vs)) {
    return cudaErrorInvalidValue;
  }
  cudaError_t err = cudaFuncSetAttribute(flash_wgmma_kernel<DQK, DV>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, W::kSmem);
  if (err != cudaSuccess) return err;
  p.n_tiles = (p.S * p.G + kWgRows - 1) / kWgRows;
  const dim3 grid(p.n_tiles, Hkv, B);
  flash_wgmma_kernel<DQK, DV><<<grid, kWgThreads, W::kSmem, stream>>>(tm_k, tm_v, p, ks, vs);
  return cudaGetLastError();
}

// The design that serves q and k of width D and v of width Dv, by the two
// widths alone: 2 = v2 (TMA + wgmma), 1 = v1 (mma.sync), 0 = no instance.
// Only v2 takes Dv != D, and only MLA's (192, 128).
constexpr int design_of(int D, int Dv) {
  return ((D == Dv && (D == 64 || D == 128 || D == 256)) || (D == 192 && Dv == 128)) ? 2
         : (D == Dv && (D == 16 || D == 80)) ? 1 : 0;
}

template <int D, int Dv>
cudaError_t launch(const Params& p, int B, int Hkv, cudaStream_t stream) {
  static_assert(design_of(D, Dv) != 0, "an instance with no design");
  if constexpr (design_of(D, Dv) == 2) {
    return launch_wgmma<D, Dv>(p, B, Hkv, stream);
  } else {
    static_assert(D == Dv, "v1 takes one width");
    return launch_mma<D, 64>(p, B, Hkv, stream);
  }
}

}  // namespace

// C interface, loaded with ctypes. flash_design(D, Dv) names the design
// that serves q and k of width D and v of width Dv (design_of; 0:
// flash_attention_bf16 refuses the pair).
extern "C" int flash_design(int D, int Dv) { return design_of(D, Dv); }

// The keys per tile of the design that serves (D, Dv); 0 where none does.
extern "C" int flash_key_tile(int D, int Dv) {
  const int d = design_of(D, Dv);
  return d == 2 ? (D == 256 ? Wg<256, 256>::BK : Wg<128, 128>::BK) : d == 1 ? 64 : 0;
}

// q, k, v, out bf16 with the element stride along D equal to 1;
// strides[12] = (q, k, v, out) x (batch, head, position), in elements,
// each a multiple of 8, and every base pointer 16-byte aligned. window <= 0
// means no window. lse: null (serving), or float32 (B, Hq, S) that
// receives each row's log-sum-exp (training: the backward kernel reads
// it). tiles: null, or two zeroed counters that the launch adds its
// visited and masked kv tiles to. Returns a cudaError_t (0 = launched).
extern "C" int flash_attention_bf16(const void* q, const void* k, const void* v, void* out,
                                    void* lse, const long long* strides, int B, int Hkv, int S,
                                    int T, int G, int D, int Dv, int causal, int window,
                                    int q_offset, float scale, void* tiles, void* stream) {
  if (B <= 0 || B > 65535 || Hkv <= 0 || Hkv > 65535 || S <= 0 || T <= 0 || G <= 0
      || static_cast<long long>(S) * G > 2147483647LL - kM) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Params p;
  p.q = static_cast<const __nv_bfloat16*>(q);
  p.k = static_cast<const __nv_bfloat16*>(k);
  p.v = static_cast<const __nv_bfloat16*>(v);
  p.o = static_cast<__nv_bfloat16*>(out);
  p.q_b = strides[0]; p.q_h = strides[1]; p.q_s = strides[2];
  p.k_b = strides[3]; p.k_h = strides[4]; p.k_s = strides[5];
  p.v_b = strides[6]; p.v_h = strides[7]; p.v_s = strides[8];
  p.o_b = strides[9]; p.o_h = strides[10]; p.o_s = strides[11];
  p.S = S; p.T = T; p.G = G;
  p.causal = causal; p.window = window; p.q_offset = q_offset;
  p.scale = scale;
  p.n_tiles = (S * G + kM - 1) / kM;
  p.tiles = static_cast<unsigned long long*>(tiles);
  p.lse = static_cast<float*>(lse);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D == 192 && Dv == 128) return static_cast<int>(launch<192, 128>(p, B, Hkv, s));
  if (D != Dv) return static_cast<int>(cudaErrorInvalidValue);
  switch (D) {                               // the instances
    case 16: return static_cast<int>(launch<16, 16>(p, B, Hkv, s));
    case 64: return static_cast<int>(launch<64, 64>(p, B, Hkv, s));
    case 80: return static_cast<int>(launch<80, 80>(p, B, Hkv, s));
    case 128: return static_cast<int>(launch<128, 128>(p, B, Hkv, s));
    case 256: return static_cast<int>(launch<256, 256>(p, B, Hkv, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
