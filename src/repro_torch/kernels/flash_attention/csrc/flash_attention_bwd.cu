// The gradient of flash attention, for Hopper (sm_90a): dq, dk and dv of
// csrc/flash_attention.cu's forward, for training.
//
// Replaces no TPU kernel: the JAX package trains through _sdpa_chunked
// (src/repro/models/attention.py), whose kv loop is a jax.checkpoint'ed
// block, so XLA differentiates it by recomputing each block's scores. Here
// that recompute is a kernel of its own. For q (B, Hq, S, D), k and v
// (B, Hkv, T, D), query head h reading kv head h / G, the forward's output
// out, its row log-sum-exp lse (natural log, float32 (B, Hq, S), written by
// the forward when asked) and the output's gradient dout:
//   delta_i = sum_d dout_id * out_id                       (pre-pass, f32)
//   P_ij    = exp(scale * q_i . k_j - lse_i), 0 where j is masked for i
//   dV_j   += P_ij dout_i;   dP_ij = dout_i . v_j
//   dS_ij   = P_ij (dP_ij - delta_i)
//   dK_j   += scale dS_ij q_i;   dQ_i += scale dS_ij k_j
// with products from bf16 operands into float32 (P and dS rounded to bf16
// for their products, as the forward rounds p before P . V), and dq, dk,
// dv rounded to bf16 once, at the end.
//
// Deterministic, no atomics: every output element is summed by one thread
// in a fixed order, so a replayed step gives the same bits. Three launches
// (design v2, TMA + wgmma; the kernels keep the bwd_ prefix):
//   * bwd_delta_kernel: a warp a row.
//   * bwd_dkdv_kernel: a CTA a (kv head, batch, 128 keys): two consumer
//     warpgroups of 64 keys each and a producer warpgroup whose one thread
//     issues every TMA load. K and V come once and stay in shared memory.
//     The Q and dO row tiles (64 positions of one query head: a 4-D tensor
//     map box of (D, 1 head, 64 positions, 1 batch), so any G loads alike
//     and positions past S arrive as zeros) stream through a 3-stage ring
//     with full and free mbarriers: row tile by row tile from the last, each
//     over the G heads of the kv head, so the GQA sum lands in registers in
//     a fixed order and the CTAs of a kv head read the same rows together.
//     Per tile and warpgroup: S^T = K Q^T and dP^T = V dO^T by wgmma from
//     shared memory; P^T and dS^T in registers (ex2.approx, scale * log2 e
//     folded in); dV += P^T dO and dK += dS^T Q by wgmma with A from
//     registers and B read MN-major by its descriptor, as the forward
//     reads V. A tile's lse (log2 units, +inf past S, so P = 0 there) and
//     delta are fetched from global memory one tile ahead by the
//     warpgroup's own threads into a double-buffered slot.
//   * bwd_dq_kernel: a CTA a (query head, batch, 128 positions), the last
//     (heaviest) tiles first, two consumer warpgroups of 64 positions; Q and
//     dO come once, K and V tiles (128 keys at D 64, 64 at D 128) stream
//     through a 3-stage ring. Per tile: S = Q K^T and dP = dO V^T from
//     shared memory, dS, then dQ += dS K with K read MN-major. It recomputes
//     S and dP, which the dk/dv pass does not keep: seven products a
//     visible (query, key) pair where an atomic dq would take five.
// The tile loop (tile_loop) is shared: at D 64 tile t's gradient products
// and tile t + 1's score products go to the tensor cores back to back, and
// the two warpgroups take turns issuing their batches (named barriers), so
// one's softmax gradient runs under the other's products. The mask runs
// only on tiles that cross the causal diagonal, a window edge or (dq) the
// key tail T, where zero keys would meet an unbounded P; it is one
// unsigned compare a pair, branch-free, in a loop of its own, so the
// elements of a tile interleave (a branch per element serialized them).
// The dk/dv pass needs no mask at the tails: a row past S has
// P = 0, a key past T only fills accumulator rows never stored. A CTA
// loads only the tiles some pair of its range sees; a warpgroup computes
// all of them, one with no visible pair going through the mask to zeros,
// because ptxas serializes every wgmma of a kernel that leaves one
// pending across a branch it cannot prove uniform (C7518), and each ring
// wait comes with no product pending for the same reason.
// Registers and shared memory (nvcc -Xptxas -v on the H100, the .log the
// loader keeps beside the library; the sizes are Cfg's):
// 168 registers a thread at launch, which setmaxnreg moves to 240 for the
// consumers (at D 128 dK and dV alone are 128 float32 a thread of the dk/dv
// pass) and 24 for the producer; no spills; a 16-byte stack frame (the TMA
// coordinates). Shared memory, dk/dv and dq: 85,048 and 132,152
// bytes at D 64, 166,968 and 164,920 at D 128; one CTA an SM.
//
// What bounds it on an H100: operations. At llama3.2-1b's training shape
// (2 x 32 heads of 64 over 4,096 tokens, causal) the backward needs 2.5x
// the forward's 1.37e11 flops of visible pairs, 0.3475 ms at 989 TFLOP/s;
// the two passes run 3.5x. v1 (mma.sync m16n8k16 from ldmatrix, four-warp
// CTAs of 64 keys or rows, cp.async double buffering and a mask on every
// tile) took 3.1585 ms there and 1.3892 ms at the windowed D 128 check
// shape (chip_smoke on an H100 80GB HBM3 at 700 W, L2 flushed). What a
// later design changes: dq folded into the dk/dv pass by an ordered
// accumulation (five products a pair), and larger score tiles, which the
// registers refuse at 240 a thread.
//
// Instances: D 64 and 128 (q, k and v of one width); each other width is
// one more instance of the same templates.

#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>
#include <math.h>

#include "hopper.cuh"

namespace {

constexpr int kConsumers = 2;                        // consumer warpgroups
constexpr int kThreads = 128 * (kConsumers + 1);     // + one producer warpgroup
constexpr int kKeys = 64 * kConsumers;               // keys per dk/dv CTA
constexpr int kRows = 64 * kConsumers;               // positions per dq CTA
constexpr int kBM = 64;                              // positions per dk/dv row tile
constexpr int kStages = 3;                           // ring depth of both passes

struct Params {
  const __nv_bfloat16* q;
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  const __nv_bfloat16* o;
  const __nv_bfloat16* dout;
  const float* lse;                            // (B, Hq, S), natural log
  float* delta;                                // (B, Hq, S) scratch
  __nv_bfloat16* dq;
  __nv_bfloat16* dk;
  __nv_bfloat16* dv;
  long long q_b, q_h, q_s;                     // strides, in elements
  long long k_b, k_h, k_s;
  long long v_b, v_h, v_s;
  long long o_b, o_h, o_s;
  long long do_b, do_h, do_s;
  long long dq_b, dq_h, dq_s;
  long long dk_b, dk_h, dk_s;
  long long dv_b, dv_h, dv_s;
  int B, Hkv, S, T, G;                         // G: query heads per kv head
  int causal, window, q_offset;                // window <= 0: no window
  float scale;
};

// Tiles and the software pipeline, by instance; then the shared memory of
// each pass, in bytes from a 1024-byte aligned base.
template <int D>
struct Cfg {
  static constexpr int BN = D == 64 ? 128 : 64;         // keys per dq tile
  // tile t + 1's score products issued behind tile t's gradient products
  // (tile_loop); at D 128 the dk/dv registers leave no room for it
  static constexpr bool kPipe = D == 64;
  // dk/dv: K and V of the CTA's keys, kStages x (Q, dO) row tiles, each
  // consumer's two (lse2, delta) slots, then the barriers (K/V landed,
  // kStages full, kStages free)
  static constexpr int kKV = kKeys * D * 2;
  static constexpr int kRowTile = kBM * D * 2;
  static constexpr int kKvRing = 2 * kKV;
  static constexpr int kKvVec = kKvRing + kStages * 2 * kRowTile;
  static constexpr int kKvBar = kKvVec + kConsumers * 2 * 2 * kBM * 4;
  static constexpr int kDkdv = 1024 + kKvBar + 8 * (1 + 2 * kStages);
  // dq: Q and dO of the CTA's positions, kStages x (K, V) tiles, barriers
  static constexpr int kQ = kRows * D * 2;
  static constexpr int kKTile = BN * D * 2;
  static constexpr int kQRing = 2 * kQ;
  static constexpr int kQBar = kQRing + kStages * 2 * kKTile;
  static constexpr int kDq = 1024 + kQBar + 8 * (1 + 2 * kStages);
  static_assert(D % 64 == 0, "whole 128-byte column chunks");
  static_assert(kDkdv <= 232448 && kDq <= 232448, "over the shared memory a block can use");
};

// d (64 x N) = A (64 x D, K-major, chunks `a_stride` bytes apart) . B^T
// (B: N rows x D, K-major, chunks `b_stride` apart), both from shared memory
template <int D, int N>
__device__ __forceinline__ void product_ss(float (&d)[N / 2], uint32_t a, int a_stride,
                                           uint32_t b, int b_stride) {
  const uint64_t da = gmma_desc(a, 16, 1024), db = gmma_desc(b, 16, 1024);
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    wgmma_ss(d, desc_at(da, (kk / 4) * a_stride + (kk % 4) * 32),
             desc_at(db, (kk / 4) * b_stride + (kk % 4) * 32), kk > 0);
  }
}

// d (64 x D) += A (64 x K, bf16 registers) . B (K rows x D in shared
// memory, D contiguous in chunks of K rows: MN-major)
template <int K, int D>
__device__ __forceinline__ void product_rs(float (&d)[D / 2], const uint32_t (&a)[K / 16][4],
                                           uint32_t b) {
  const uint64_t db = gmma_desc(b, K * 128, 1024);
#pragma unroll
  for (int kk = 0; kk < K / 16; ++kk) wgmma_rs(d, a[kk], desc_at(db, kk * 2048), 1);
}

// rows kp0 + 8h of a 64 x D accumulator (times `mul`), columns 8c + 2t4,
// + 1, to bf16 at `dst` + row * `row_stride`, for rows below `rows`
template <int D>
__device__ __forceinline__ void store_rows(__nv_bfloat16* dst, long long row_stride,
                                           const float (&acc)[D / 2], int kp0, int rows,
                                           int t4, float mul) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = kp0 + 8 * h;
    if (r >= rows) continue;
    __nv_bfloat16* d = dst + r * row_stride + 2 * t4;
#pragma unroll
    for (int c = 0; c < D / 8; ++c) {
      *reinterpret_cast<uint32_t*>(d + c * 8) =
          f2_to_bf2(acc[4 * c + 2 * h] * mul, acc[4 * c + 2 * h + 1] * mul);
    }
  }
}

// The tile loop of both passes, for one consumer warpgroup and n >= 1
// tiles: tile t's score products, its softmax gradient (which waits for
// them), then its gradient products; each batch of products is issued in
// the warpgroup's turn. With kPipe, tile t's gradient products and tile
// t + 1's score products go to the tensor cores back to back and the
// warpgroup waits only for the first. Every wgmma is waited for on the
// path that issued it (see the dk/dv kernel).
template <bool kPipe, class Wait, class Scores, class Soft, class Grads, class Finish>
__device__ __forceinline__ void tile_loop(int n, int wg, Wait&& full_wait, Scores&& scores,
                                          Soft&& softmax_grad, Grads&& grads,
                                          Finish&& finish) {
  if (wg == 1) turn_pass(1);                   // warpgroup 0 issues first
  full_wait(0);
  turn_wait(wg);
  wgmma_fence();
  scores(0);
  turn_pass(wg);
  for (int t = 0; t + 1 < n; ++t) {
    softmax_grad(t);
    if constexpr (kPipe) {
      full_wait(t + 1);
      turn_wait(wg);
      wgmma_fence();
      grads(t);
      scores(t + 1);
      turn_pass(wg);
      wgmma_wait<1>();
      finish(t);
    } else {
      turn_wait(wg);
      wgmma_fence();
      grads(t);
      turn_pass(wg);
      wgmma_wait<0>();
      finish(t);
      full_wait(t + 1);
      turn_wait(wg);
      wgmma_fence();
      scores(t + 1);
      turn_pass(wg);
    }
  }
  softmax_grad(n - 1);
  turn_wait(wg);
  wgmma_fence();
  grads(n - 1);
  turn_pass(wg);
  wgmma_wait<0>();
  finish(n - 1);
}

// delta = rowsum(dout * out), one warp a (batch, head, position) row
template <int D>
__global__ void __launch_bounds__(256) bwd_delta_kernel(const Params p) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int Hq = p.Hkv * p.G;
  const long long row = static_cast<long long>(blockIdx.x) * 8 + warp;
  if (row >= static_cast<long long>(p.B) * Hq * p.S) return;
  const long long s = row % p.S;
  const long long h = (row / p.S) % Hq;
  const long long b = row / (static_cast<long long>(p.S) * Hq);
  const __nv_bfloat16* o = p.o + b * p.o_b + h * p.o_h + s * p.o_s;
  const __nv_bfloat16* d = p.dout + b * p.do_b + h * p.do_h + s * p.do_s;
  float acc = 0.0f;
#pragma unroll
  for (int c = 2 * lane; c < D; c += 64) {
    const float2 x = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(o + c));
    const float2 y = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(d + c));
    acc += x.x * y.x + x.y * y.y;
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) p.delta[row] = acc;
}

// Load the D columns of one box of `map` (64-column chunks, each `rows`
// x 128 bytes) at (head, position, batch) into `dst`.
template <int D>
__device__ __forceinline__ void tma_rows(uint32_t dst, const CUtensorMap* map, const MapSlots& m,
                                         uint32_t bar, int rows, int head, int pos, int b) {
  int c[4];
  c[m.h] = head;
  c[m.t] = pos;
  c[m.b] = b;
#pragma unroll
  for (int ch = 0; ch < D / 64; ++ch) {
    tma_load_4d(dst + ch * rows * 128, map, bar, ch * 64, c[1], c[2], c[3]);
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
bwd_dkdv_kernel(const __grid_constant__ CUtensorMap tm_k, const __grid_constant__ CUtensorMap tm_v,
                const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_do,
                const Params p, const MapSlots ks, const MapSlots vs, const MapSlots qs,
                const MapSlots ds) {
  using M = Cfg<D>;
  static_assert(2 * kBM == 128, "a consumer thread fetches one of a tile's lse2 and delta");
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  const uint32_t k_base = smem_u32(smem);
  const uint32_t v_base = k_base + M::kKV;
  const uint32_t ring = k_base + M::kKvRing;   // stage s: Q at ring + 2 s kRowTile, dO after
  float* vec = reinterpret_cast<float*>(smem + M::kKvVec);
  const uint32_t kv_bar = k_base + M::kKvBar;
  const uint32_t full = kv_bar + 8;
  const uint32_t free_ = full + 8 * kStages;

  const int kvh = blockIdx.x, b = blockIdx.y;
  const int k0 = blockIdx.z * kKeys;
  // the positions that see some key of this CTA, in row tiles of kBM; the
  // tiles run row tile by row tile, from the last, each over the G heads:
  // tile t is head t % G of row tile i_lo + n_i - 1 - t / G (the CTAs of a
  // kv head all start at the last rows, so they read them from L2 together)
  long long s_hi = p.S - 1;
  const int s_lo = p.causal ? max(0, k0 - p.q_offset) : 0;
  if (p.window > 0) {
    s_hi = min(s_hi, static_cast<long long>(min(k0 + kKeys, p.T) - 1) + p.window - 1
                         - p.q_offset);
  }
  const int i_lo = s_lo / kBM;
  const int n_i = s_lo <= s_hi ? static_cast<int>(s_hi) / kBM - i_lo + 1 : 0;
  const int n = n_i * p.G;

  auto tile_head = [&](int t) { return t % p.G; };
  auto tile_row = [&](int t) { return i_lo + n_i - 1 - t / p.G; };
  if (threadIdx.x == 0) {
    mbar_init(kv_bar, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(free_ + 8 * s, 4 * kConsumers);           // one arrival a consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == kConsumers) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x == kConsumers * 128 && n > 0) {
      mbar_expect(kv_bar, 2 * M::kKV);
      tma_rows<D>(k_base, &tm_k, ks, kv_bar, kKeys, kvh, k0, b);
      tma_rows<D>(v_base, &tm_v, vs, kv_bar, kKeys, kvh, k0, b);
      for (int t = 0; t < n; ++t) {
        const int s = t % kStages;
        if (t >= kStages) mbar_wait(free_ + 8 * s, ((t / kStages) - 1) & 1);
        mbar_expect(full + 8 * s, 2 * M::kRowTile);
        const int head = kvh * p.G + tile_head(t), pos = tile_row(t) * kBM;
        const uint32_t dst = ring + s * 2 * M::kRowTile;
        tma_rows<D>(dst, &tm_q, qs, full + 8 * s, kBM, head, pos, b);
        tma_rows<D>(dst + M::kRowTile, &tm_do, ds, full + 8 * s, kBM, head, pos, b);
      }
    }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
  const int ct = threadIdx.x % 128, warp = ct >> 5, lane = ct & 31;
  const int gq = lane >> 2, t4 = lane & 3;
  const int kw = k0 + 64 * wg;                 // this warpgroup's first key
  const int kw_hi = min(kw + 63, p.T - 1);
  const float sl = p.scale * kLog2e;
  const Mask mask(p);
  const long long lse0 = (static_cast<long long>(b) * p.Hkv + kvh) * p.G * p.S;
  float* my_vec = vec + wg * 2 * 2 * kBM;      // slot j: lse2 at 2 j kBM, delta after

  // entry ct of tile t's slot: row ct's lse2 (ct < kBM) or row ct - kBM's
  // delta
  auto fetch = [&](int t) -> float {
    const int s = tile_row(t) * kBM + ct % kBM;
    const long long idx = lse0 + static_cast<long long>(tile_head(t)) * p.S + s;
    return t >= n ? 0.0f
           : s >= p.S ? (ct < kBM ? INFINITY : 0.0f)
           : ct < kBM ? p.lse[idx] * kLog2e : p.delta[idx];
  };

  float dk[D / 2], dv[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dk[i] = dv[i] = 0.0f;
  const int kp0 = kw + warp * 16 + gq;         // this thread's keys: kp0, kp0 + 8

  // No wgmma below sits on a path some thread of the warpgroup may skip:
  // ptxas serializes every product of a kernel that leaves one pending
  // across a divergent branch. So a warpgroup computes every tile of its
  // CTA's range (one in which none of its pairs is visible goes through
  // the mask, to zeros), the tile count is checked before the first
  // product, and each ring wait comes with no product pending.
  const int kp1 = kp0 + 8;
  if (n == 0) {
    store_rows<D>(p.dk + b * p.dk_b + kvh * p.dk_h, p.dk_s, dk, kp0, p.T, t4, p.scale);
    store_rows<D>(p.dv + b * p.dv_b + kvh * p.dv_h, p.dv_s, dv, kp0, p.T, t4, 1.0f);
    return;
  }
  float next = fetch(0);
  my_vec[ct] = next;
  wg_sync(wg);
  mbar_wait(kv_bar, 0);
  const uint32_t k_wg = k_base + wg * 64 * 128, v_wg = v_base + wg * 64 * 128;
  float st[kBM / 2], dpt[kBM / 2];             // S^T, dP^T: 64 keys x kBM positions
  uint32_t pa[kBM / 16][4], sa[kBM / 16][4];   // P^T, dS^T in bf16
  auto stage = [&](int t) { return ring + (t % kStages) * 2 * M::kRowTile; };
  auto scores = [&](int t) {                   // S^T = K Q^T, dP^T = V dO^T of tile t
    const uint32_t q_t = stage(t), do_t = q_t + M::kRowTile;
    product_ss<D, kBM>(st, k_wg, kKeys * 128, q_t, kBM * 128);
    product_ss<D, kBM>(dpt, v_wg, kKeys * 128, do_t, kBM * 128);
    wgmma_commit();
  };
  auto full_wait = [&](int t) { mbar_wait(full + 8 * (t % kStages), (t / kStages) & 1); };
  // P^T and dS^T of tile t from its finished score products
  auto softmax_grad = [&](int t) {
    wgmma_wait<0>();
    fence_regs(st);
    fence_regs(dpt);
    next = fetch(t + 1);                       // in flight through the rest of the tile
    const int q_lo = tile_row(t) * kBM + p.q_offset;
    const int q_hi = min(q_lo - p.q_offset + kBM, p.S) - 1 + p.q_offset;
    const bool need_mask = (p.causal && kw_hi > q_lo) || (p.window > 0 && q_hi - kw >= p.window);
    const float* lv = my_vec + (t & 1) * 2 * kBM;
    // the element (key kp0 + 8 (e >> 1), position q_lo + 8 c + 2 t4 + (e & 1)):
    // d = base[e >> 1] + 8 c + (e & 1)
    const int base[2] = {q_lo + 2 * t4 - kp0, q_lo + 2 * t4 - kp1};
    auto body = [&](auto masked) {
#pragma unroll
      for (int c = 0; c < kBM / 8; ++c) {
        const int col = 8 * c + 2 * t4;        // positions col, col + 1 of the tile
        const float2 l2 = *reinterpret_cast<const float2*>(lv + col);
        const float2 dl = *reinterpret_cast<const float2*>(lv + kBM + col);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = st[4 * c + e] * sl - ((e & 1) ? l2.y : l2.x);
          if constexpr (decltype(masked)::value) {
            x = mask.visible(base[e >> 1] + 8 * c + (e & 1)) ? x : -INFINITY;
          }
          const float pv = fast_exp2(x);
          st[4 * c + e] = pv;                                          // P^T
          dpt[4 * c + e] = pv * (dpt[4 * c + e] - ((e & 1) ? dl.y : dl.x));   // dS^T
        }
      }
    };
    if (need_mask) {
      body(Flag<true>());
    } else {
      body(Flag<false>());
    }
    to_a<kBM>(pa, st);
    to_a<kBM>(sa, dpt);
  };
  auto grads = [&](int t) {                    // dV += P^T dO, dK += dS^T Q
    const uint32_t q_t = stage(t);
    product_rs<kBM, D>(dv, pa, q_t + M::kRowTile);
    product_rs<kBM, D>(dk, sa, q_t);
    wgmma_commit();
  };
  auto finish = [&](int t) {
    fence_regs(dv);
    fence_regs(dk);
    fence_regs(pa);
    fence_regs(sa);
    release(free_ + 8 * (t % kStages), lane);
    my_vec[((t + 1) & 1) * 2 * kBM + ct] = next;
    wg_sync(wg);
  };

  tile_loop<M::kPipe>(n, wg, full_wait, scores, softmax_grad, grads, finish);

  store_rows<D>(p.dk + b * p.dk_b + kvh * p.dk_h, p.dk_s, dk, kp0, p.T, t4, p.scale);
  store_rows<D>(p.dv + b * p.dv_b + kvh * p.dv_h, p.dv_s, dv, kp0, p.T, t4, 1.0f);
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
bwd_dq_kernel(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_do,
              const __grid_constant__ CUtensorMap tm_k, const __grid_constant__ CUtensorMap tm_v,
              const Params p, const MapSlots qs, const MapSlots ds, const MapSlots ks,
              const MapSlots vs) {
  using M = Cfg<D>;
  constexpr int BN = M::BN;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  const uint32_t q_base = smem_u32(smem);
  const uint32_t do_base = q_base + M::kQ;
  const uint32_t ring = q_base + M::kQRing;    // stage s: K at ring + 2 s kKTile, V after
  const uint32_t qd_bar = q_base + M::kQBar;
  const uint32_t full = qd_bar + 8;
  const uint32_t free_ = full + 8 * kStages;

  const int h = blockIdx.x, b = blockIdx.y;
  const int kvh = h / p.G;
  const int r0 = (static_cast<int>(gridDim.z) - 1 - static_cast<int>(blockIdx.z)) * kRows;
  const int q_lo = r0 + p.q_offset;
  const int q_hi = min(r0 + kRows, p.S) - 1 + p.q_offset;
  int j_lo = 0;
  int j_hi = (p.T + BN - 1) / BN - 1;
  if (p.causal) j_hi = min(j_hi, floor_div(q_hi, BN));
  if (p.window > 0) j_lo = max(0, floor_div(q_lo - p.window + 1, BN));
  const int n = max(j_hi - j_lo + 1, 0);       // key tiles to visit

  if (threadIdx.x == 0) {
    mbar_init(qd_bar, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(free_ + 8 * s, 4 * kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == kConsumers) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x == kConsumers * 128 && n > 0) {
      mbar_expect(qd_bar, 2 * M::kQ);
      tma_rows<D>(q_base, &tm_q, qs, qd_bar, kRows, h, r0, b);
      tma_rows<D>(do_base, &tm_do, ds, qd_bar, kRows, h, r0, b);
      for (int t = 0; t < n; ++t) {
        const int s = t % kStages;
        if (t >= kStages) mbar_wait(free_ + 8 * s, ((t / kStages) - 1) & 1);
        mbar_expect(full + 8 * s, 2 * M::kKTile);
        const uint32_t dst = ring + s * 2 * M::kKTile;
        tma_rows<D>(dst, &tm_k, ks, full + 8 * s, BN, kvh, (j_lo + t) * BN, b);
        tma_rows<D>(dst + M::kKTile, &tm_v, vs, full + 8 * s, BN, kvh, (j_lo + t) * BN, b);
      }
    }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
  const int ct = threadIdx.x % 128, warp = ct >> 5, lane = ct & 31;
  const int gq = lane >> 2, t4 = lane & 3;
  const int rw = r0 + 64 * wg;                 // this warpgroup's first position
  const int w_lo = rw + p.q_offset;
  const int w_hi = min(rw + 64, p.S) - 1 + p.q_offset;
  const float sl = p.scale * kLog2e;
  const Mask mask(p);

  // this thread's positions sr0 and sr0 + 8: lse (log2 units) and delta
  const int sr0 = rw + warp * 16 + gq;
  const long long lse0 = (static_cast<long long>(b) * p.Hkv * p.G + h) * p.S;
  float lse2[2], dl[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int s = sr0 + 8 * i;
    lse2[i] = s < p.S ? p.lse[lse0 + s] * kLog2e : INFINITY;
    dl[i] = s < p.S ? p.delta[lse0 + s] : 0.0f;
  }

  float dq[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dq[i] = 0.0f;
  if (n == 0) {                                // no key visible to any row of the CTA
    store_rows<D>(p.dq + b * p.dq_b + h * p.dq_h, p.dq_s, dq, sr0, p.S, t4, p.scale);
    return;
  }
  mbar_wait(qd_bar, 0);
  const uint32_t q_wg = q_base + wg * 64 * 128, do_wg = do_base + wg * 64 * 128;
  // As in the dk/dv pass, no product is left pending across a branch: a
  // warpgroup computes every tile of its CTA's range.
  float sc[BN / 2], dp[BN / 2];                // S, dP: 64 positions x BN keys
  uint32_t sa[BN / 16][4];                     // dS in bf16
  auto stage = [&](int t) { return ring + (t % kStages) * 2 * M::kKTile; };
  auto full_wait = [&](int t) { mbar_wait(full + 8 * (t % kStages), (t / kStages) & 1); };
  auto scores = [&](int t) {                   // S = Q K^T, dP = dO V^T of tile t
    const uint32_t k_t = stage(t), v_t = k_t + M::kKTile;
    product_ss<D, BN>(sc, q_wg, kRows * 128, k_t, BN * 128);
    product_ss<D, BN>(dp, do_wg, kRows * 128, v_t, BN * 128);
    wgmma_commit();
  };
  auto softmax_grad = [&](int t) {             // dS of tile t from its finished S and dP
    wgmma_wait<0>();
    fence_regs(sc);
    fence_regs(dp);
    const int kj = (j_lo + t) * BN;
    const bool need_mask = kj + BN > p.T || (p.causal && kj + BN - 1 > w_lo)
                           || (p.window > 0 && w_hi - kj >= p.window);
    // the element (position sr0 + 8 (e >> 1), key kj + 8 c + 2 t4 + (e & 1)):
    // d = base[e >> 1] - 8 c - (e & 1); the key is past T from tail on
    const int base[2] = {w_lo + warp * 16 + gq - kj - 2 * t4,
                         w_lo + warp * 16 + gq + 8 - kj - 2 * t4};
    const int tail = p.T - kj - 2 * t4;
    auto body = [&](auto masked) {
#pragma unroll
      for (int c = 0; c < BN / 8; ++c) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = e >> 1;
          float x = sc[4 * c + e] * sl - lse2[i];
          if constexpr (decltype(masked)::value) {
            const int o = 8 * c + (e & 1);
            x = mask.visible(base[i] - o) && o < tail ? x : -INFINITY;
          }
          dp[4 * c + e] = fast_exp2(x) * (dp[4 * c + e] - dl[i]);     // dS
        }
      }
    };
    if (need_mask) {
      body(Flag<true>());
    } else {
      body(Flag<false>());
    }
    to_a<BN>(sa, dp);
  };
  auto grads = [&](int t) {                    // dQ += dS K
    product_rs<BN, D>(dq, sa, stage(t));
    wgmma_commit();
  };
  auto finish = [&](int t) {
    fence_regs(dq);
    fence_regs(sa);
    release(free_ + 8 * (t % kStages), lane);
  };

  tile_loop<M::kPipe>(n, wg, full_wait, scores, softmax_grad, grads, finish);

  store_rows<D>(p.dq + b * p.dq_b + h * p.dq_h, p.dq_s, dq, sr0, p.S, t4, p.scale);
}

template <int D>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  using M = Cfg<D>;
  const int Hq = p.Hkv * p.G;
  const long long n_rows = static_cast<long long>(p.B) * Hq * p.S;
  bwd_delta_kernel<D><<<static_cast<unsigned>((n_rows + 7) / 8), 256, 0, stream>>>(p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  CUtensorMap tm_k, tm_v, tm_q, tm_do;
  MapSlots ks, vs, qs, ds;
  if (!make_map(&tm_k, p.k, p.k_b, p.k_h, p.k_s, p.B, p.Hkv, p.T, D, kKeys, &ks)
      || !make_map(&tm_v, p.v, p.v_b, p.v_h, p.v_s, p.B, p.Hkv, p.T, D, kKeys, &vs)
      || !make_map(&tm_q, p.q, p.q_b, p.q_h, p.q_s, p.B, Hq, p.S, D, kBM, &qs)
      || !make_map(&tm_do, p.dout, p.do_b, p.do_h, p.do_s, p.B, Hq, p.S, D, kBM, &ds)) {
    return cudaErrorInvalidValue;
  }
  err = cudaFuncSetAttribute(bwd_dkdv_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             M::kDkdv);
  if (err != cudaSuccess) return err;
  const dim3 grid_kv(p.Hkv, p.B, (p.T + kKeys - 1) / kKeys);   // z from 0: heaviest first
  bwd_dkdv_kernel<D><<<grid_kv, kThreads, M::kDkdv, stream>>>(tm_k, tm_v, tm_q, tm_do, p,
                                                              ks, vs, qs, ds);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  if (!make_map(&tm_q, p.q, p.q_b, p.q_h, p.q_s, p.B, Hq, p.S, D, kRows, &qs)
      || !make_map(&tm_do, p.dout, p.do_b, p.do_h, p.do_s, p.B, Hq, p.S, D, kRows, &ds)
      || !make_map(&tm_k, p.k, p.k_b, p.k_h, p.k_s, p.B, p.Hkv, p.T, D, M::BN, &ks)
      || !make_map(&tm_v, p.v, p.v_b, p.v_h, p.v_s, p.B, p.Hkv, p.T, D, M::BN, &vs)) {
    return cudaErrorInvalidValue;
  }
  err = cudaFuncSetAttribute(bwd_dq_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             M::kDq);
  if (err != cudaSuccess) return err;
  const dim3 grid_q(Hq, p.B, (p.S + kRows - 1) / kRows);       // the last tile first
  bwd_dq_kernel<D><<<grid_q, kThreads, M::kDq, stream>>>(tm_q, tm_do, tm_k, tm_v, p,
                                                         qs, ds, ks, vs);
  return cudaGetLastError();
}

}  // namespace

// q, k, v, out, dout bf16 (element stride 1 along D), lse float32 (B, Hq,
// S) from the forward, delta float32 (B, Hq, S) scratch; dq, dk, dv bf16
// outputs. strides[24] = (q, k, v, out, dout, dq, dk, dv) x (batch, head,
// position), in elements, each a multiple of 8, every base pointer 16-byte
// aligned. window <= 0 means no window. Three launches on `stream` (the
// delta pre-pass, dk/dv, dq); returns the first cudaError_t (0 =
// launched).
extern "C" int flash_attention_bwd_bf16(const void* q, const void* k, const void* v,
                                        const void* out, const void* dout, const void* lse,
                                        void* delta, void* dq, void* dk, void* dv,
                                        const long long* strides, int B, int Hkv, int S, int T,
                                        int G, int D, int causal, int window, int q_offset,
                                        float scale, void* stream) {
  if (B <= 0 || B > 65535 || Hkv <= 0 || S <= 0 || T <= 0 || G <= 0
      || static_cast<long long>(Hkv) * G > 2147483647LL
      || (S + kRows - 1) / kRows > 65535 || (T + kKeys - 1) / kKeys > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Params p;
  p.q = static_cast<const __nv_bfloat16*>(q);
  p.k = static_cast<const __nv_bfloat16*>(k);
  p.v = static_cast<const __nv_bfloat16*>(v);
  p.o = static_cast<const __nv_bfloat16*>(out);
  p.dout = static_cast<const __nv_bfloat16*>(dout);
  p.lse = static_cast<const float*>(lse);
  p.delta = static_cast<float*>(delta);
  p.dq = static_cast<__nv_bfloat16*>(dq);
  p.dk = static_cast<__nv_bfloat16*>(dk);
  p.dv = static_cast<__nv_bfloat16*>(dv);
  long long* dst[24] = {&p.q_b, &p.q_h, &p.q_s, &p.k_b, &p.k_h, &p.k_s, &p.v_b, &p.v_h,
                        &p.v_s, &p.o_b, &p.o_h, &p.o_s, &p.do_b, &p.do_h, &p.do_s, &p.dq_b,
                        &p.dq_h, &p.dq_s, &p.dk_b, &p.dk_h, &p.dk_s, &p.dv_b, &p.dv_h, &p.dv_s};
  for (int i = 0; i < 24; ++i) *dst[i] = strides[i];
  p.B = B; p.Hkv = Hkv; p.S = S; p.T = T; p.G = G;
  p.causal = causal; p.window = window; p.q_offset = q_offset;
  p.scale = scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {                                 // the instances
    case 64: return static_cast<int>(launch<64>(p, s));
    case 128: return static_cast<int>(launch<128>(p, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
