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
// and skips every kv tile in which no (query, key) pair of the CTA is
// visible, as the TPU kernel skips its fully masked blocks.
//
// Design (simple: mma.sync on the tensor cores, cp.async staging):
//   * One CTA per (batch, kv head, tile of 64 query rows). The rows of a kv
//     head are its (position, group head) pairs in position-major order,
//     row r = s * G + g, so a tile holds every group head of 64 / G
//     positions (G <= 64) and each K/V tile loaded feeds all 64 rows: the
//     G heads that share it are never loaded apart. At G = 48 (MQA) a tile
//     spans two or three positions; the tile's position range still bounds
//     its visible keys.
//   * 4 warps, 16 rows each. Per kv tile of BK keys: S = Q . K^T by
//     mma.sync.m16n8k16 (bf16 in, f32 out) with Q and K fragments by
//     ldmatrix from shared memory; the mask and the online softmax on the
//     accumulators (a row's four lanes reduce by shuffles); the f32 scores
//     become the A fragments of P . V after rounding to bf16, with V
//     fragments by ldmatrix.trans. The f32 output tile stays in registers:
//     D / 2 a thread.
//   * K/V tiles are double-buffered through cp.async: tile j + 1 lands
//     while tile j is computed. Rows are padded by 16 bytes in shared
//     memory, so ldmatrix reads are free of bank conflicts.
//   * Fixed tiles with masked tails, whatever S and T: rows past S * G and
//     keys past T are zero-filled by cp.async; keys past T score -inf, so
//     they add nothing even to a row that has seen no visible key yet.
//   * Heaviest tiles first: under a causal mask the last query tiles see
//     the most keys, so blockIdx.x walks the tiles from the end.
//   * Tiles: BK = 64 keys for D <= 128; 32 for D = 256, where the output
//     tile alone takes 128 registers a thread. Instances for D in {16, 64,
//     80, 128, 256}: the smoke heads, llama, stablelm, granite, gemma.
//   * Strided q, k, v and out (the element stride along D must be 1): the
//     model passes its (B, S, H, D) projections as (B, H, S, D) views, with
//     no transposing copy.
//
// What bounds it on an H100: operations. At gemma3-4b's prefill of 4,096
// tokens a global layer has 67 M visible (query, key) pairs over 8 heads,
// 4 D = 1,024 flops each: 6.9e10 flops against ~50 MB of q, k, v and out,
// ~1,400 flops a byte, far above the ~295 where the tensor cores and not
// HBM become the limit. mma.sync reaches a fraction of the 989 TFLOP/s
// that wgmma does on Hopper; the design keeps the tensor cores fed from
// shared memory and reads each K/V tile once per 64 query rows.
//
// What a later design changes: TMA loads into a deeper ring, wgmma on
// 64-row warpgroup tiles with a producer warp, exp2 with the scale folded
// into log2(e), and a split of long causal rows across CTAs.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>
#include <math.h>

namespace {

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

template <int D, int BK>
__global__ void __launch_bounds__(kThreads) flash_kernel(const Params p) {
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
cudaError_t launch(const Params& p, int B, int Hkv, cudaStream_t stream) {
  // Q tile and two stages of K and V: 99 KB at D = 256, 85 KB at 128
  constexpr int smem = static_cast<int>(sizeof(__nv_bfloat16)) * (kM + 4 * BK) * (D + 8);
  cudaError_t err = cudaFuncSetAttribute(flash_kernel<D, BK>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(p.n_tiles, Hkv, B);
  flash_kernel<D, BK><<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

// C interface, loaded with ctypes. q, k, v, out bf16 with the element
// stride along D equal to 1; strides[12] = (q, k, v, out) x (batch, head,
// position), in elements, each a multiple of 8, and every base pointer
// 16-byte aligned. window <= 0 means no window. Returns a cudaError_t
// (0 = launched).
extern "C" int flash_attention_bf16(const void* q, const void* k, const void* v, void* out,
                                    const long long* strides, int B, int Hkv, int S, int T,
                                    int G, int D, int causal, int window, int q_offset,
                                    float scale, void* stream) {
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
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 16: return static_cast<int>(launch<16, 64>(p, B, Hkv, s));
    case 64: return static_cast<int>(launch<64, 64>(p, B, Hkv, s));
    case 80: return static_cast<int>(launch<80, 64>(p, B, Hkv, s));
    case 128: return static_cast<int>(launch<128, 64>(p, B, Hkv, s));
    case 256: return static_cast<int>(launch<256, 32>(p, B, Hkv, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
