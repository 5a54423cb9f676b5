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
// One design, v2 (TMA + wgmma), serves every instance: D = Dv 16 (the
// smoke heads), 64 (llama-width, hymba), 80 (hubert-xlarge, stablelm-3b),
// 128 (granite-20b, qwen2-vl), 256 (gemma3-4b) and (D 192, Dv 128)
// (deepseek's MLA). design_of names it; the C interface exports it as
// flash_design.
//
// The rows of a kv head are kept in position-major order, row r = s * G +
// g, so a CTA's tile holds every group head of its positions and each K/V
// tile loaded feeds all of them: the G heads that share it are never
// loaded apart (at G = 48 a tile spans a few positions; its position range
// still bounds its visible keys). The heaviest tiles go first: under a
// causal mask the last query tiles see the most keys, so blockIdx.x counts
// the tiles from the end. q, k, v and out may be strided (element stride
// 1 along D): the model passes its (B, S, H, D) projections as (B, H, S,
// D) views, with no transposing copy.
//
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
//     T arrive as zeros, and so do the columns of a box past D: at D 80 the
//     second box holds columns 64-79 and 48 zero columns, at D 16 the one
//     box 16 columns and 48 zeros (the fill costs no read, only shared
//     memory; the barriers expect whole boxes, as TMA counts the fill). Q
//     is loaded once per CTA by the consumers with 16-byte cp.async in the
//     same chunked, swizzled layout: a tile's rows are (position, group
//     head) pairs, which a tensor map box covers only where G divides 128,
//     and granite-20b has G = 48.
//   * Per tile and warpgroup: S = Q . K^T by wgmma.mma_async m64nBKk16,
//     both operands K-major from shared memory, D / 16 k-steps (5 at D 80,
//     1 at D 16: no padded products, the zero columns are never read);
//     the softmax; P . V by wgmma m64nDvk16 with P from registers (rounded
//     to bf16, as the Pallas kernel casts p to v's dtype) and V from shared
//     memory, transposed by its descriptor (MN-major). At Dv 80 one n80
//     product reads columns 64-79 from the second chunk (a leading byte
//     offset of BK x 128 on): the hardware walks an MN-major operand in
//     8-column core matrices, so the 128-byte swizzle pattern needs no
//     whole 64-column repeat (checked on the card against the plain
//     version at every D 80 shape). Key tiles: BK = 128, 64 at D 256.
//     Shared memory at D 256: Q 64 KB plus two stages of K and V, 128 KB;
//     at (192, 128): Q 48 KB, two stages of K 96 KB and of V 64 KB, 209 KB
//     in all; at D 80: Q 32 KB, K and V 64 KB each, 161 KB.
//   * Softmax in exp2 (ex2.approx) with scale * log2(e) folded in: the row
//     max is taken over the raw scores and p = exp2(s * sl - m) is one
//     fused multiply-add before the exponential. The per-element mask (one
//     unsigned compare) runs only on the tiles that cross the causal
//     diagonal, a window edge or the tail T for some row of the warpgroup;
//     every pair of the other visited tiles is visible. hubert's encoder
//     (T 4,096, no causal mask) takes no masked tile.
//   * At Dv <= 80 (kPipe: D 16, 64, 80) the softmax runs under a product:
//     each step issues tile i's Q . K^T, rescales the output to tile
//     i - 1's max while it runs, issues tile i - 1's P . V, waits for
//     Q . K^T, computes tile i's softmax while P . V runs, then waits for
//     it and packs P. The registers allow it there (O 40, S 64 float32 and
//     P 32 packed words a thread at D 80; 168 at launch, no spills), and
//     the two warpgroups take turns issuing their products (named
//     barriers), so one's softmax also runs under the other's products. A
//     product never stays pending across a branch ptxas cannot prove
//     uniform (its note C7518 serializes every wgmma of the kernel):
//     whether a tile needs the mask is decided before its products are
//     issued, and each ring wait comes with no product pending. At D 128
//     and (192, 128) kPipe does not fit: ptxas serialized the products for
//     want of registers (note C7512) and spilled 400 bytes.
//   * Tried at D 80 on the card and not kept (no faster, or slower): a
//     3-stage ring, the warpgroups issuing without turns, and 64-key tiles
//     (slower by a fifth: twice the per-tile overhead). 128-key tiles are
//     whole tiles of hubert's 4,096 frames; 192 are not, and 256 leave no
//     registers for the scores beside P.
//
// What bounds it on an H100: operations. At gemma3-4b's prefill of 4,096
// tokens a global layer has 67 M visible (query, key) pairs over 8 heads,
// 4 D = 1,024 flops each: 6.9e10 flops against ~50 MB of q, k, v and out,
// ~1,400 flops a byte, far above the ~295 where the tensor cores and not
// HBM become the limit. v2 runs wgmma, the only way to the tensor cores'
// full rate on Hopper, from two warpgroups while the producer keeps the
// next tile in flight. At D 80 a pair costs 320 flops but still one
// exponential: hubert's 5.37e8 pairs need 0.1737 ms on the tensor cores
// and ~0.128 ms on the SFUs (16 exponentials per SM per clock), so the
// exponentials have to run under the products, not after them.
//
// What a later design changes: the softmax under a product at D 128 and
// 256 (fewer registers a thread: a third consumer warpgroup, or O split
// over two), 80-key tiles at D 256, a persistent grid, TMA for Q where G
// divides 128, P packed into a second register buffer while P . V runs,
// and some exponentials on the FMA units by a polynomial, which D 80 would
// need to get past the SFU floor.

#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>
#include <math.h>

#include "hopper.cuh"

namespace {

constexpr float kMasked = -1073741824.0f;      // -2^30, the TPU kernel's NEG_INF
constexpr float kMInit = -1e30f;               // the running max's start
constexpr int kConsumers = 2;                  // warpgroups of 64 query rows
constexpr int kWgThreads = 128 * (kConsumers + 1);   // + one producer warpgroup
constexpr int kWgRows = 64 * kConsumers;       // query rows per CTA

struct Params {
  const __nv_bfloat16* q;
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  __nv_bfloat16* o;
  long long q_b, q_h, q_s;                     // strides, in elements
  long long k_b, k_h, k_s;
  long long v_b, v_h, v_s;
  long long o_b, o_h, o_s;
  int S, T, G;                                 // positions, keys, heads per kv head
  int causal, window, q_offset;                // window <= 0: no window
  float scale;
  int n_tiles;                                 // ceil(S * G / kWgRows)
  // when not null: [0] += kv tiles visited, [1] += those that took the
  // per-element mask, per consumer warpgroup
  unsigned long long* tiles;
  // when not null: each row's log-sum-exp of its scaled scores, m + log(l)
  // (natural log), float32 (B, Hq, S) contiguous, for the backward kernel
  float* lse;
};

// the index of row fr (position fr / G of head kvh * G + fr % G) in lse
__device__ __forceinline__ long long lse_index(const Params& p, int b, int kvh, int fr) {
  return (static_cast<long long>(b * gridDim.y + kvh) * p.G + fr % p.G) * p.S + fr / p.G;
}

// keys per tile: 128 (hubert's 4,096 frames are whole tiles), 64 at D 256
// (the scores beside 128 float32 of output a thread)
constexpr int key_tile_of(int DQK) { return DQK == 256 ? 64 : 128; }

// DQK: the width of q and k; DV: the width of v and out (DQK == DV but
// for MLA's full-rank prefill, 192 and 128)
template <int DQK, int DV>
struct Wg {
  static constexpr int BK = key_tile_of(DQK);              // keys per tile
  static constexpr bool kPipe = DV <= 80;                  // softmax under P . V
  static constexpr int kRingK = 2;                         // K stages
  static constexpr int kRingV = 2;                         // V stages
  static constexpr int kChunksK = (DQK + 63) / 64;         // 128-byte column chunks
  static constexpr int kChunksV = (DV + 63) / 64;
  static constexpr int kQBytes = kWgRows * kChunksK * 128;
  static constexpr int kKTileBytes = BK * kChunksK * 128;  // one K tile, whole boxes
  static constexpr int kVTileBytes = BK * kChunksV * 128;  // one V tile
  static constexpr int kVOff = kQBytes + kRingK * kKTileBytes;
  static constexpr int kBarOff = kVOff + kRingV * kVTileBytes;
  static constexpr int kSmem = 1024 + kBarOff + 16 * (kRingK + kRingV);   // + 1 KB to align
  static_assert(DQK % 16 == 0 && DV % 16 == 0, "k16 steps of Q . K^T, n16 steps of P . V");
  static_assert(kSmem <= 232448, "over the shared memory a block can use");
};

// The per-tile softmax of a warpgroup's 64 rows x BK keys (log2 units):
// scale, mask where the tile needs it, the new running max, alpha and l;
// the raw scores in `sc` become p.
template <int BK>
struct Softmax {
  float m[2] = {kMInit, kMInit};
  float l[2] = {0.0f, 0.0f};                   // this lane's part of the row sums

  template <bool kMask>
  __device__ __forceinline__ void tile(float (&sc)[BK / 2], float (&alpha)[2], const Params& p,
                                       const Mask& mask, int k0, const int (&qp)[2], int t4,
                                       float sl) {
    constexpr float kMasked2 = kMasked * kLog2e;          // -2^30 in log2 units
    float mx[2];
    if constexpr (kMask) {
      mx[0] = m[0];
      mx[1] = m[1];
#pragma unroll
      for (int n = 0; n < BK / 8; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kp = k0 + n * 8 + 2 * t4 + (e & 1);
          const float x = sc[4 * n + e] * sl;
          sc[4 * n + e] = kp >= p.T ? -INFINITY
                          : mask.visible(qp[e >> 1] - kp) ? x : kMasked2;
          mx[e >> 1] = fmaxf(mx[e >> 1], sc[4 * n + e]);
        }
      }
    } else {                                   // sl > 0: the max commutes with it
      float r[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int i = 0; i < BK / 2; ++i) r[(i >> 1) & 1] = fmaxf(r[(i >> 1) & 1], sc[i]);
      mx[0] = fmaxf(m[0], r[0] * sl);
      mx[1] = fmaxf(m[1], r[1] * sl);
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
      alpha[h] = fast_exp2(m[h] - mx[h]);
      m[h] = mx[h];
    }
    float ps[2] = {0.0f, 0.0f};
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) {
      const float mh = m[(i >> 1) & 1];
      const float pv = kMask ? fast_exp2(sc[i] - mh) : fast_exp2(fmaf(sc[i], sl, -mh));
      sc[i] = pv;
      ps[(i >> 1) & 1] += pv;
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) l[h] = l[h] * alpha[h] + ps[h];
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
    // x of row r at x ^ (r % 8)), zeros past the last row; the columns of
    // the last chunk past D stay unwritten (no product reads them)
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
      wg_sync(wg);
    }

    // this thread's rows: g and g + 8 of its warp's 16
    const int fr0 = r0 + 64 * wg + warp * 16 + gq;
    const int fr1 = fr0 + 8;
    const int qp[2] = {fr0 / p.G + p.q_offset, fr1 / p.G + p.q_offset};
    const int w_first = r0 + 64 * wg;
    const int w_lo = w_first / p.G + p.q_offset;
    const int w_hi = (min(w_first + 64, rows) - 1) / p.G + p.q_offset;
    const float sl = p.scale * kLog2e;
    // a warpgroup past the last row, or a scale <= 0 (the unmasked
    // softmax takes the row max before scaling), takes the general path
    const bool always = w_first >= rows || !(sl > 0.0f);
    const Mask mask(p);
    const uint32_t q_wg = q_base + 64 * wg * 128;
    auto need_mask = [&](int k0) {
      return always || k0 + BK > p.T || (p.causal && k0 + BK - 1 > w_lo)
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
    auto k_ready = [&](int i) { mbar_wait(full_k + 8 * (i % W::kRingK), (i / W::kRingK) & 1); };
    auto v_ready = [&](int i) { mbar_wait(full_v + 8 * (i % W::kRingV), (i / W::kRingV) & 1); };
    float o[DV / 2];
#pragma unroll
    for (int i = 0; i < DV / 2; ++i) o[i] = 0.0f;
    Softmax<BK> sm;
    float sc[BK / 2];
    uint32_t pa[BK / 16][4];
    float alpha[2];
    auto softmax = [&](int i, auto masked) {
      sm.template tile<decltype(masked)::value>(sc, alpha, p, mask, (j_lo + i) * BK, qp, t4, sl);
    };
    auto scale_o = [&]() {
#pragma unroll
      for (int c = 0; c < DV / 8; ++c) {
#pragma unroll
        for (int e = 0; e < 4; ++e) o[4 * c + e] *= alpha[e >> 1];
      }
    };

    if constexpr (!W::kPipe) {
      // Per tile: Q . K^T, the softmax, P . V; K is freed for the next
      // load once Q . K^T has read it, V once P . V has.
      for (int i = 0; i < n; ++i) {
        k_ready(i);
        wgmma_fence();
        start_qk(sc, i % W::kRingK);
        wgmma_wait<0>();
        fence_regs(sc);
        release(free_k + 8 * (i % W::kRingK), lane);
        if (need_mask((j_lo + i) * BK)) {
          softmax(i, Flag<true>());
        } else {
          softmax(i, Flag<false>());
        }
        to_a<BK>(pa, sc);
        scale_o();
        v_ready(i);
        wgmma_fence();
        start_pv(o, pa, i % W::kRingV);
        wgmma_wait<0>();
        fence_regs(o);
        fence_regs(pa);
        release(free_v + 8 * (i % W::kRingV), lane);
      }
    } else if (n > 0) {                        // n is the CTA's: both warpgroups take turns
      if (wg == 1) turn_pass(1);               // warpgroup 0 issues first
      // tile 0: Q . K^T and its softmax (o is still zero; its alpha
      // scales zeros)
      k_ready(0);
      turn_wait(wg);
      wgmma_fence();
      start_qk(sc, 0);
      turn_pass(wg);
      wgmma_wait<0>();
      fence_regs(sc);
      release(free_k, lane);
      if (need_mask(j_lo * BK)) {
        softmax(0, Flag<true>());
      } else {
        softmax(0, Flag<false>());
      }
      to_a<BK>(pa, sc);
      // tile i's Q . K^T, the output rescaled to tile i - 1's max under
      // it, then tile i - 1's P . V; tile i's softmax while P . V runs;
      // then P packed
      for (int i = 1; i < n; ++i) {
        auto step = [&](auto masked) {
          k_ready(i);
          v_ready(i - 1);
          turn_wait(wg);
          wgmma_fence();
          start_qk(sc, i % W::kRingK);
          scale_o();
          wgmma_fence();
          start_pv(o, pa, (i - 1) % W::kRingV);
          turn_pass(wg);
          wgmma_wait<1>();
          fence_regs(sc);
          release(free_k + 8 * (i % W::kRingK), lane);
          softmax(i, masked);
          wgmma_wait<0>();
          fence_regs(o);
          fence_regs(pa);
          release(free_v + 8 * ((i - 1) % W::kRingV), lane);
          to_a<BK>(pa, sc);
        };
        if (need_mask((j_lo + i) * BK)) {
          step(Flag<true>());
        } else {
          step(Flag<false>());
        }
      }
      v_ready(n - 1);
      turn_wait(wg);
      scale_o();
      wgmma_fence();
      start_pv(o, pa, (n - 1) % W::kRingV);
      turn_pass(wg);
      wgmma_wait<0>();
      fence_regs(o);
      fence_regs(pa);
      release(free_v + 8 * ((n - 1) % W::kRingV), lane);
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
// widths alone: 2 = v2 (TMA + wgmma), 0 = no instance. Dv != D only for
// MLA's (192, 128).
constexpr int design_of(int D, int Dv) {
  return ((D == Dv && (D == 16 || D == 64 || D == 80 || D == 128 || D == 256))
          || (D == 192 && Dv == 128)) ? 2 : 0;
}

}  // namespace

// C interface, loaded with ctypes. flash_design(D, Dv) names the design
// that serves q and k of width D and v of width Dv (design_of; 0:
// flash_attention_bf16 refuses the pair).
extern "C" int flash_design(int D, int Dv) { return design_of(D, Dv); }

// The keys per tile of the design that serves (D, Dv); 0 where none does.
extern "C" int flash_key_tile(int D, int Dv) {
  return design_of(D, Dv) != 0 ? key_tile_of(D) : 0;
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
      || static_cast<long long>(S) * G > 2147483647LL - kWgRows) {
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
  p.tiles = static_cast<unsigned long long*>(tiles);
  p.lse = static_cast<float*>(lse);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D == 192 && Dv == 128) return static_cast<int>(launch_wgmma<192, 128>(p, B, Hkv, s));
  if (D != Dv) return static_cast<int>(cudaErrorInvalidValue);
  switch (D) {                                 // the instances (design_of)
    case 16: return static_cast<int>(launch_wgmma<16, 16>(p, B, Hkv, s));
    case 64: return static_cast<int>(launch_wgmma<64, 64>(p, B, Hkv, s));
    case 80: return static_cast<int>(launch_wgmma<80, 80>(p, B, Hkv, s));
    case 128: return static_cast<int>(launch_wgmma<128, 128>(p, B, Hkv, s));
    case 256: return static_cast<int>(launch_wgmma<256, 256>(p, B, Hkv, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
