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
// in a fixed order, so a replayed step gives the same bits.
//   * bwd_delta_kernel: a warp a row.
//   * bwd_dkdv_kernel: a CTA a (batch, kv head, tile of 64 keys), a warp
//     16 of its keys. It walks the query row tiles of all G heads of the
//     kv head (rows position-major, r = s * G + g, as the forward keeps
//     them), so the GQA sum over heads lands in registers: per tile
//     S^T = K Q^T, dP^T = V dO^T, then dV += P^T dO and dK += dS^T Q.
//   * bwd_dq_kernel: a CTA a (batch, kv head, tile of 64 rows), a warp 16
//     rows; it walks the key tiles (S = Q K^T, dP = dO V^T, dQ += dS K),
//     recomputing S and dP, which the dk/dv pass does not keep: seven
//     products a visible (query, key) pair where an atomic dq would take
//     five.
// Both skip the tiles in which no pair is visible (causal diagonal,
// sliding window), as the forward does, and mask per element on the rest.
// mma.sync m16n8k16 with ldmatrix from padded shared memory, cp.async
// double buffering of the tiles walked.
//
// What bounds it on an H100: operations. At llama3.2-1b's training shape
// (2 x 32 heads of 64 over 4,096 tokens, causal) the backward needs 2.5x
// the forward's 1.37e11 flops of visible pairs; this design runs 3.5x on
// mma.sync, which reaches a fraction of the card's dense bf16 rate that
// wgmma would. What a later design changes: wgmma from shared memory with
// TMA-fed tiles, and the dk/dv and dq passes fused (dq by atomics, or a
// second pass over a stored dS).
//
// Instances: D 64 and 128 (q, k and v of one width). Other widths are
// refused; A13's later halves add them.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>
#include <math.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kKeys = 16 * kWarps;             // keys per dk/dv CTA
constexpr int kRows = 16 * kWarps;             // query rows per dq CTA
constexpr int kBK = 64;                        // keys per dq key tile
constexpr float kLog2e = 1.4426950408889634f;

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

__device__ __forceinline__ uint32_t f2_to_bf2(float x, float y) {
  __nv_bfloat162 h = __floats2bfloat162_rn(x, y);   // x in the low half
  return *reinterpret_cast<uint32_t*>(&h);
}

__device__ __forceinline__ int floor_div(int a, int b) {
  return a >= 0 ? a / b : -((-a + b - 1) / b);
}

__device__ __forceinline__ bool visible(const Params& p, int qp, int kp) {
  return kp < p.T && (!p.causal || kp <= qp) && (p.window <= 0 || qp - kp < p.window);
}

// acc (16 x N) += A (16 x 16k, the warp's rows of `a_rows`, row-major in
// shared memory) . B^T, B's rows (`b_rows`, N of them) row-major in shared
// memory with the same k: S = Q K^T, S^T = K Q^T, dP = dO V^T, dP^T = V dO^T
template <int D, int N>
__device__ __forceinline__ void mma_abt(float (&acc)[N / 8][4], const __nv_bfloat16* a_rows,
                                        const __nv_bfloat16* b_rows, int lane) {
  constexpr int kLd = D + 8;
#pragma unroll
  for (int n = 0; n < N / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.0f;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    uint32_t a[4];
    ldmatrix_x4(a, a_rows + (lane & 15) * kLd + kk * 16 + (lane >> 4) * 8);
#pragma unroll
    for (int n = 0; n < N / 8; n += 2) {
      uint32_t b[4];
      ldmatrix_x4(b, b_rows + (n * 8 + (lane & 7) + ((lane >> 4) << 3)) * kLd + kk * 16
                         + ((lane >> 3) & 1) * 8);
      mma_bf16(acc[n], a, b[0], b[1]);
      mma_bf16(acc[n + 1], a, b[2], b[3]);
    }
  }
}

// acc (16 x D) += bf16(x) (16 x K, accumulator fragments) . B (K x D,
// row-major in shared memory): dV += P^T dO, dK += dS^T Q, dQ += dS K.
// Score tiles 2kk, 2kk + 1 are the A fragment of the kk-th k16 step.
template <int D, int K>
__device__ __forceinline__ void mma_xb(float (&acc)[D / 8][4], const float (&x)[K / 8][4],
                                       const __nv_bfloat16* b_rows, int lane) {
  constexpr int kLd = D + 8;
#pragma unroll
  for (int kk = 0; kk < K / 16; ++kk) {
    uint32_t a[4];
    a[0] = f2_to_bf2(x[2 * kk][0], x[2 * kk][1]);
    a[1] = f2_to_bf2(x[2 * kk][2], x[2 * kk][3]);
    a[2] = f2_to_bf2(x[2 * kk + 1][0], x[2 * kk + 1][1]);
    a[3] = f2_to_bf2(x[2 * kk + 1][2], x[2 * kk + 1][3]);
#pragma unroll
    for (int dt = 0; dt < D / 8; dt += 2) {
      uint32_t b[4];
      ldmatrix_x4_trans(b, b_rows + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * kLd
                               + dt * 8 + (lane >> 4) * 8);
      mma_bf16(acc[dt], a, b[0], b[1]);
      mma_bf16(acc[dt + 1], a, b[2], b[3]);
    }
  }
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

// Shared memory of the dk/dv kernel: K and V of the tile, two stages of Q
// and dO rows, and per stage each row's lse (log2 units), delta and
// position.
template <int D, int BM>
struct DkdvSmem {
  static constexpr int kLd = D + 8;
  static constexpr int kBytes = 2 * (2 * kKeys * kLd + 2 * 2 * BM * kLd)
                                + 2 * (2 * BM * 4 + BM * 4);
};

template <int D, int BM>
__global__ void __launch_bounds__(kThreads) bwd_dkdv_kernel(const Params p) {
  constexpr int kLd = D + 8;
  constexpr int kChunks = D / 8;               // 16-byte chunks per row
  constexpr int kNT = BM / 8;                  // n8 tiles over the rows
  constexpr int kDT = D / 8;                   // n8 tiles over D
  static_assert(BM % 16 == 0 && D % 16 == 0, "whole k16 steps");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* ks = reinterpret_cast<__nv_bfloat16*>(smem_raw);   // kKeys x kLd
  __nv_bfloat16* vs = ks + kKeys * kLd;
  __nv_bfloat16* qs = vs + kKeys * kLd;        // stage s: Q at qs + s*2*BM*kLd, dO after it
  float* rowf = reinterpret_cast<float*>(qs + 2 * 2 * BM * kLd);    // stage s: lse2, delta
  int* rowp = reinterpret_cast<int*>(rowf + 2 * 2 * BM);            // stage s: positions

  const int k0 = blockIdx.x * kKeys;
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int rows = p.S * p.G;
  const int Hq = p.Hkv * p.G;

  // the rows that see some key of this tile: causal, positions from k0;
  // windowed, positions up to the last key + window - 1
  int r_lo = 0, r_hi = rows - 1;
  if (p.causal) r_lo = max(0, k0 - p.q_offset) * p.G;
  if (p.window > 0) {
    const long long s_max = static_cast<long long>(min(k0 + kKeys, p.T) - 1) + p.window - 1
                            - p.q_offset;
    const long long last = (s_max + 1) * p.G - 1;
    r_hi = s_max < 0 ? -1 : (last < rows - 1 ? static_cast<int>(last) : rows - 1);
  }
  const int i_lo = r_lo / BM;
  const int i_hi = (r_lo <= r_hi && r_lo < rows) ? r_hi / BM : i_lo - 1;

  const __nv_bfloat16* kb = p.k + b * p.k_b + kvh * p.k_h;
  const __nv_bfloat16* vb = p.v + b * p.v_b + kvh * p.v_h;
  const __nv_bfloat16* qb = p.q + b * p.q_b + static_cast<long long>(kvh) * p.G * p.q_h;
  const __nv_bfloat16* db = p.dout + b * p.do_b + static_cast<long long>(kvh) * p.G * p.do_h;
  const long long lse0 = (static_cast<long long>(b) * Hq + static_cast<long long>(kvh) * p.G)
                         * p.S;

  auto load_rows = [&](int stage, int i) {
    __nv_bfloat16* qd = qs + stage * 2 * BM * kLd;
    __nv_bfloat16* dd = qd + BM * kLd;
#pragma unroll
    for (int c = tid; c < BM * kChunks; c += kThreads) {
      const int r = c / kChunks, col = (c % kChunks) * 8;
      const int fr = i * BM + r;
      const bool live = fr < rows;
      const long long hh = live ? fr % p.G : 0, ss = live ? fr / p.G : 0;
      cp_async16(qd + r * kLd + col, qb + hh * p.q_h + ss * p.q_s + col, live ? 16 : 0);
      cp_async16(dd + r * kLd + col, db + hh * p.do_h + ss * p.do_s + col, live ? 16 : 0);
    }
    float* lf = rowf + stage * 2 * BM;
    int* pp = rowp + stage * BM;
    for (int r = tid; r < BM; r += kThreads) {
      const int fr = i * BM + r;
      if (fr < rows) {
        const long long idx = lse0 + static_cast<long long>(fr % p.G) * p.S + fr / p.G;
        lf[r] = p.lse[idx] * kLog2e;
        lf[BM + r] = p.delta[idx];
        pp[r] = fr / p.G + p.q_offset;
      } else {                                 // exp2(s - inf) = 0: the row adds nothing
        lf[r] = INFINITY;
        lf[BM + r] = 0.0f;
        pp[r] = 0;
      }
    }
  };

  float dk[kDT][4], dv[kDT][4];
#pragma unroll
  for (int i = 0; i < kDT; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[i][e] = dv[i][e] = 0.0f;
  const int kp0 = k0 + warp * 16 + g;          // this thread's keys: kp0, kp0 + 8
  const float sl = p.scale * kLog2e;

  if (i_lo <= i_hi) {
#pragma unroll
    for (int c = tid; c < kKeys * kChunks; c += kThreads) {
      const int r = c / kChunks, col = (c % kChunks) * 8;
      const int t = k0 + r;
      const bool live = t < p.T;
      const long long tk = live ? t : 0;
      cp_async16(ks + r * kLd + col, kb + tk * p.k_s + col, live ? 16 : 0);
      cp_async16(vs + r * kLd + col, vb + tk * p.v_s + col, live ? 16 : 0);
    }
    load_rows(0, i_lo);
    cp_async_commit();

    for (int i = i_lo; i <= i_hi; ++i) {
      const int stage = (i - i_lo) & 1;
      cp_async_wait_all();                     // tile i (and K, V) landed for this thread
      __syncthreads();                         // ... for all; tile i - 1's stage is free
      if (i < i_hi) load_rows(stage ^ 1, i + 1);
      cp_async_commit();

      const __nv_bfloat16* qd = qs + stage * 2 * BM * kLd;
      const __nv_bfloat16* dd = qd + BM * kLd;
      const float* lf = rowf + stage * 2 * BM;
      const int* pp = rowp + stage * BM;

      float st[kNT][4], dpt[kNT][4];           // S^T, dP^T: this warp's 16 keys x BM rows
      mma_abt<D, BM>(st, ks + warp * 16 * kLd, qd, lane);
      mma_abt<D, BM>(dpt, vs + warp * 16 * kLd, dd, lane);
#pragma unroll
      for (int n = 0; n < kNT; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int lr = n * 8 + 2 * t4 + (e & 1);
          const int kp = kp0 + 8 * (e >> 1);
          const float pv = visible(p, pp[lr], kp) ? exp2f(st[n][e] * sl - lf[lr]) : 0.0f;
          st[n][e] = pv;                                   // P^T
          dpt[n][e] = pv * (dpt[n][e] - lf[BM + lr]);      // dS^T
        }
      }
      mma_xb<D, BM>(dv, st, dd, lane);         // dV += P^T dO
      mma_xb<D, BM>(dk, dpt, qd, lane);        // dK += dS^T Q
    }
    cp_async_wait_all();                       // no copy outlives the CTA
  }

  // rows kp0 and kp0 + 8 of dk (times scale) and dv; columns 8 dt + 2 t4, + 1
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int kp = kp0 + 8 * h;
    if (kp >= p.T) continue;
    __nv_bfloat16* dkd = p.dk + b * p.dk_b + kvh * p.dk_h + kp * p.dk_s + 2 * t4;
    __nv_bfloat16* dvd = p.dv + b * p.dv_b + kvh * p.dv_h + kp * p.dv_s + 2 * t4;
#pragma unroll
    for (int dt = 0; dt < kDT; ++dt) {
      *reinterpret_cast<uint32_t*>(dkd + dt * 8) =
          f2_to_bf2(dk[dt][2 * h] * p.scale, dk[dt][2 * h + 1] * p.scale);
      *reinterpret_cast<uint32_t*>(dvd + dt * 8) = f2_to_bf2(dv[dt][2 * h], dv[dt][2 * h + 1]);
    }
  }
}

template <int D>
struct DqSmem {
  static constexpr int kLd = D + 8;
  static constexpr int kBytes = 2 * (2 * kRows * kLd + 2 * 2 * kBK * kLd);
};

template <int D>
__global__ void __launch_bounds__(kThreads) bwd_dq_kernel(const Params p, int n_tiles) {
  constexpr int kLd = D + 8;
  constexpr int kChunks = D / 8;
  constexpr int kNT = kBK / 8;
  constexpr int kDT = D / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);   // kRows x kLd
  __nv_bfloat16* ds = qs + kRows * kLd;                             // dO rows
  __nv_bfloat16* kvs = ds + kRows * kLd;       // stage s: K at kvs + s*2*kBK*kLd, V after it

  const int tile = n_tiles - 1 - static_cast<int>(blockIdx.x);      // heaviest first
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int rows = p.S * p.G;
  const int Hq = p.Hkv * p.G;
  const int r0 = tile * kRows;
  const int q_lo = r0 / p.G + p.q_offset;
  const int q_hi = (min(r0 + kRows, rows) - 1) / p.G + p.q_offset;
  int j_lo = 0;
  int j_hi = (p.T + kBK - 1) / kBK - 1;
  if (p.causal) j_hi = min(j_hi, floor_div(q_hi, kBK));
  if (p.window > 0) j_lo = max(0, floor_div(q_lo - p.window + 1, kBK));

  const __nv_bfloat16* qb = p.q + b * p.q_b + static_cast<long long>(kvh) * p.G * p.q_h;
  const __nv_bfloat16* db = p.dout + b * p.do_b + static_cast<long long>(kvh) * p.G * p.do_h;
  const __nv_bfloat16* kb = p.k + b * p.k_b + kvh * p.k_h;
  const __nv_bfloat16* vb = p.v + b * p.v_b + kvh * p.v_h;
  const long long lse0 = (static_cast<long long>(b) * Hq + static_cast<long long>(kvh) * p.G)
                         * p.S;

  // this thread's rows fr0, fr0 + 8: positions, lse (log2 units), delta
  const int fr0 = r0 + warp * 16 + g;
  int qp[2];
  float lse2[2], dl[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int fr = fr0 + 8 * h;
    if (fr < rows) {
      const long long idx = lse0 + static_cast<long long>(fr % p.G) * p.S + fr / p.G;
      qp[h] = fr / p.G + p.q_offset;
      lse2[h] = p.lse[idx] * kLog2e;
      dl[h] = p.delta[idx];
    } else {
      qp[h] = 0;
      lse2[h] = INFINITY;
      dl[h] = 0.0f;
    }
  }

  auto load_kv = [&](int stage, int j) {
    __nv_bfloat16* kd = kvs + stage * 2 * kBK * kLd;
    __nv_bfloat16* vd = kd + kBK * kLd;
#pragma unroll
    for (int c = tid; c < kBK * kChunks; c += kThreads) {
      const int r = c / kChunks, col = (c % kChunks) * 8;
      const int t = j * kBK + r;
      const bool live = t < p.T;
      const long long tk = live ? t : 0;
      cp_async16(kd + r * kLd + col, kb + tk * p.k_s + col, live ? 16 : 0);
      cp_async16(vd + r * kLd + col, vb + tk * p.v_s + col, live ? 16 : 0);
    }
  };

  float dq[kDT][4];
#pragma unroll
  for (int i = 0; i < kDT; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq[i][e] = 0.0f;
  const float sl = p.scale * kLog2e;

  if (j_lo <= j_hi) {
#pragma unroll
    for (int c = tid; c < kRows * kChunks; c += kThreads) {
      const int r = c / kChunks, col = (c % kChunks) * 8;
      const int fr = r0 + r;
      const bool live = fr < rows;
      const long long hh = live ? fr % p.G : 0, ss = live ? fr / p.G : 0;
      cp_async16(qs + r * kLd + col, qb + hh * p.q_h + ss * p.q_s + col, live ? 16 : 0);
      cp_async16(ds + r * kLd + col, db + hh * p.do_h + ss * p.do_s + col, live ? 16 : 0);
    }
    load_kv(0, j_lo);
    cp_async_commit();

    for (int j = j_lo; j <= j_hi; ++j) {
      const int stage = (j - j_lo) & 1;
      cp_async_wait_all();
      __syncthreads();
      if (j < j_hi) load_kv(stage ^ 1, j + 1);
      cp_async_commit();

      const __nv_bfloat16* kd = kvs + stage * 2 * kBK * kLd;
      const __nv_bfloat16* vd = kd + kBK * kLd;
      float s[kNT][4], dp[kNT][4];             // S, dP: this warp's 16 rows x kBK keys
      mma_abt<D, kBK>(s, qs + warp * 16 * kLd, kd, lane);
      mma_abt<D, kBK>(dp, ds + warp * 16 * kLd, vd, lane);
      const int k0 = j * kBK;
#pragma unroll
      for (int n = 0; n < kNT; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int h = e >> 1;
          const int kp = k0 + n * 8 + 2 * t4 + (e & 1);
          const float pv = visible(p, qp[h], kp) ? exp2f(s[n][e] * sl - lse2[h]) : 0.0f;
          dp[n][e] = pv * (dp[n][e] - dl[h]);  // dS
        }
      }
      mma_xb<D, kBK>(dq, dp, kd, lane);        // dQ += dS K
    }
    cp_async_wait_all();
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int fr = fr0 + 8 * h;
    if (fr >= rows) continue;
    __nv_bfloat16* dst = p.dq + b * p.dq_b
                         + static_cast<long long>(kvh * p.G + fr % p.G) * p.dq_h
                         + static_cast<long long>(fr / p.G) * p.dq_s + 2 * t4;
#pragma unroll
    for (int dt = 0; dt < kDT; ++dt) {
      *reinterpret_cast<uint32_t*>(dst + dt * 8) =
          f2_to_bf2(dq[dt][2 * h] * p.scale, dq[dt][2 * h + 1] * p.scale);
    }
  }
}

template <int D>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  constexpr int BM = D <= 64 ? 64 : 32;        // query rows per dk/dv step (registers)
  const long long n_rows = static_cast<long long>(p.B) * p.Hkv * p.G * p.S;
  bwd_delta_kernel<D><<<static_cast<unsigned>((n_rows + 7) / 8), 256, 0, stream>>>(p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  constexpr int smem_kv = DkdvSmem<D, BM>::kBytes;
  err = cudaFuncSetAttribute(bwd_dkdv_kernel<D, BM>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem_kv);
  if (err != cudaSuccess) return err;
  const dim3 grid_kv((p.T + kKeys - 1) / kKeys, p.Hkv, p.B);
  bwd_dkdv_kernel<D, BM><<<grid_kv, kThreads, smem_kv, stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  constexpr int smem_q = DqSmem<D>::kBytes;
  err = cudaFuncSetAttribute(bwd_dq_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem_q);
  if (err != cudaSuccess) return err;
  const int n_tiles = (p.S * p.G + kRows - 1) / kRows;
  const dim3 grid_q(n_tiles, p.Hkv, p.B);
  bwd_dq_kernel<D><<<grid_q, kThreads, smem_q, stream>>>(p, n_tiles);
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
  if (B <= 0 || B > 65535 || Hkv <= 0 || Hkv > 65535 || S <= 0 || T <= 0 || G <= 0
      || static_cast<long long>(S) * G > 2147483647LL - kRows) {
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
