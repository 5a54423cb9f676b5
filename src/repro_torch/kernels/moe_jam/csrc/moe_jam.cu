// Gated expert FFN over capacity buckets, for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/moe_jam/kernel.py
// (moe_jam_ffn_pallas, body _moe_jam_kernel). Computes what that kernel
// computes, for every expert e of a (E, C, D) bucket tensor x:
//   h[e] = act(x[e] . w_gate[e]) * (x[e] . w_up[e])   f32 accumulation,
//                                                       rounded to bf16
//   y[e] = h[e] . w_down[e]                            f32 accumulation,
//                                                       rounded to bf16
// with act = silu, or gelu in its tanh form (jax.nn.gelu's default).
//
// Design (simple: mma.sync on the tensor cores, cp.async staging):
//   * Two launches of one tiled product, not one fused CTA. Fusing gate,
//     up, act and down in one CTA, as the TPU kernel does with its VMEM
//     accumulator, needs the (rows x D) f32 output tile of the down
//     projection on chip: 128 KB of shared memory for 16 rows at D = 2048,
//     and each CTA would then walk all of an expert's weights alone. Here
//     pass 1 (gated) writes h (E, C, F) in bf16, pass 2 reads it back:
//     h is rounded at the same point as in the TPU kernel, and at the
//     serving engine's shape it is 5.2 MB against 805 MB of expert weights.
//   * Each pass: grid (N / 32, ceil(C / 64), E), 4 warps. A CTA owns 64
//     capacity rows x 32 output columns of one expert; warp w owns the
//     8 columns [8w, 8w + 8) over all of the CTA's 16-row tiles. The
//     reduction runs in stages of 32 through a 4-deep cp.async ring in
//     shared memory (rows padded to 80 bytes, so ldmatrix is free of bank
//     conflicts); fragments come in by ldmatrix (.trans for the weights,
//     which are stored K-major as the JAX layout keeps them) and multiply
//     with mma.sync.m16n8k16 bf16 -> f32.
//   * Empty buckets. counts[e] (optional) is the number of capacity rows
//     of expert e that hold a token: the dispatch fills rows 0, 1, ... in
//     order, so rows >= counts[e] are empty. A tile computes only its
//     16-row groups that hold a kept row; an expert (or a tile) with none
//     reads no weights at all. Pass 2 writes zeros to every empty row,
//     which is what the function gives there, so y equals the plain
//     version over all of (E, C, D). Rows that are read but not kept (the
//     tail of the last 16-row group, and C not a multiple of 16) are
//     zero-filled by cp.async and never read from memory.
//
// What bounds it on an H100: bytes. Each expert's weights (3 x D x F bf16,
// 12.6 MB at olmoe's widths) are used for at most C rows, 2 flops per
// 2-byte weight per row: at C = 40 that is 40 flops per byte, under the
// ~295 flops per byte where the tensor cores, not HBM, would be the
// limit. The design reads each weight once per 64-row tile (once in
// all at the engine's C = 40) and skips the weights of empty experts; x
// and h tiles are re-read by the CTAs of one expert from L2.
//
// What a later design changes: TMA loads of the weight tiles into a deeper
// ring and wgmma on 64-row tiles, more columns per CTA so a weight tile
// feeds more math per byte of shared memory, and pass 2 fused behind
// pass 1 per expert.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>
#include <math.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kBM = 64;                  // capacity rows per CTA: 4 m16 tiles
constexpr int kMT = kBM / 16;
constexpr int kBN = 8 * kWarps;          // output columns per CTA: one n8 tile a warp
constexpr int kBK = 32;                  // reduction depth per stage: two k16 steps
constexpr int kStages = 4;
constexpr int kLd = 32 + 8;              // bf16 per shared row (80 bytes)
constexpr int kATile = kBM * kLd;        // bf16 per A tile (kBM x kBK)
constexpr int kBTile = kBK * kLd;        // bf16 per B tile (kBK x kBN)
static_assert(kBK <= kLd - 8 && kBN <= kLd - 8, "tile wider than its shared row");

struct Params {
  const __nv_bfloat16* a;   // (E, C, K): x for pass 1, h for pass 2
  const __nv_bfloat16* b0;  // (E, K, N): w_gate for pass 1, w_down for pass 2
  const __nv_bfloat16* b1;  // (E, K, N): w_up for pass 1, unused in pass 2
  __nv_bfloat16* out;       // (E, C, N): h for pass 1, y for pass 2
  const int* counts;        // (E,) kept rows per expert, or null: all C
  int C, K, N;
  int act;                  // 0 silu, 1 gelu (tanh form)
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(s), "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
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

__device__ __forceinline__ float act_fn(float g, int act) {
  if (act == 0) return g / (1.0f + expf(-g));                 // silu
  const float k0 = 0.7978845608028654f;                        // sqrt(2 / pi)
  return 0.5f * g * (1.0f + tanhf(k0 * (g + 0.044715f * g * g * g)));
}

__device__ __forceinline__ uint32_t f2_to_bf2(float x, float y) {
  __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  return *reinterpret_cast<uint32_t*>(&h);
}

// out[e, rows of this tile, cols of this tile] = A . B0 (pass 2), or
// act(A . B0) * (A . B1) (pass 1, kGated).
template <bool kGated>
__global__ void __launch_bounds__(kThreads) bucket_gemm_kernel(const Params p) {
  constexpr int kNB = kGated ? 2 : 1;
  constexpr int kStage = kATile + kNB * kBTile;    // bf16 per ring stage
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* smem = reinterpret_cast<__nv_bfloat16*>(smem_raw);

  const int e = blockIdx.z;
  const int m0 = blockIdx.y * kBM;
  const int n0 = blockIdx.x * kBN;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int kept = p.counts ? max(0, min(p.counts[e], p.C)) : p.C;
  const int rows = max(0, min(kBM, kept - m0));    // kept rows of this tile
  const int n_mt = (rows + 15) >> 4;               // 16-row groups computed

  const __nv_bfloat16* a = p.a + (static_cast<size_t>(e) * p.C + m0) * p.K;
  const __nv_bfloat16* b[kNB];
  b[0] = p.b0 + static_cast<size_t>(e) * p.K * p.N + n0;
  if constexpr (kGated) b[1] = p.b1 + static_cast<size_t>(e) * p.K * p.N + n0;

  float acc[kNB][kMT][4];
#pragma unroll
  for (int j = 0; j < kNB; ++j)
#pragma unroll
    for (int i = 0; i < kMT; ++i)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[j][i][r] = 0.0f;

  if constexpr (kGated) {
    if (n_mt == 0) return;                         // nothing kept: h is not read here
  }
  const int nk = p.K / kBK;

  // one ring stage: the A tile (16-byte chunks of the computed row groups;
  // rows past the kept ones zero-filled) and the B tiles
  auto load = [&](int stage, int kt) {
    __nv_bfloat16* as = smem + stage * kStage;
    const int k0 = kt * kBK;
#pragma unroll
    for (int j = 0; j < (kBM * kBK / 8) / kThreads; ++j) {
      const int c = tid + j * kThreads;
      const int r = c >> 2, col = (c & 3) * 8;
      if (r < n_mt * 16) {
        const bool live = r < rows;
        cp_async16(as + r * kLd + col, a + (live ? static_cast<size_t>(r) * p.K + k0 + col : 0),
                   live ? 16 : 0);
      }
    }
#pragma unroll
    for (int jb = 0; jb < kNB; ++jb) {
      __nv_bfloat16* bs = as + kATile + jb * kBTile;
      const int r = tid >> 2, col = (tid & 3) * 8;  // kBK x kBN = one chunk a thread
      cp_async16(bs + r * kLd + col, b[jb] + static_cast<size_t>(k0 + r) * p.N + col, 16);
    }
  };
  static_assert(kBK * kBN / 8 == kThreads, "one B chunk per thread");

  if (n_mt > 0) {
#pragma unroll
    for (int s = 0; s < kStages - 1; ++s) {
      if (s < nk) load(s, s);
      cp_async_commit();
    }
    for (int kt = 0; kt < nk; ++kt) {
      cp_async_wait<kStages - 2>();                // stage kt has landed (this thread)
      __syncthreads();                             // ... for every thread; kt - 1 is free
      const int nxt = kt + kStages - 1;
      if (nxt < nk) load(nxt % kStages, nxt);
      cp_async_commit();

      const __nv_bfloat16* as = smem + (kt % kStages) * kStage;
      // B fragments of this warp's 8 columns for both k16 steps: lane l
      // addresses row k = l of the tile; matrices 0-3 are k 0-7 .. 24-31
      uint32_t bf[kNB][4];
#pragma unroll
      for (int jb = 0; jb < kNB; ++jb)
        ldmatrix_x4_trans(bf[jb], as + kATile + jb * kBTile + lane * kLd + warp * 8);
#pragma unroll
      for (int ks = 0; ks < 2; ++ks) {
#pragma unroll
        for (int i = 0; i < kMT; ++i) {
          if (i < n_mt) {                          // CTA-uniform
            uint32_t af[4];
            ldmatrix_x4(af, as + (i * 16 + (lane & 15)) * kLd + ks * 16 + (lane >> 4) * 8);
#pragma unroll
            for (int jb = 0; jb < kNB; ++jb)
              mma_bf16(acc[jb][i], af, bf[jb][2 * ks], bf[jb][2 * ks + 1]);
          }
        }
      }
    }
    cp_async_wait<0>();                            // no copy outlives the CTA
  }

  // epilogue: lane holds rows g and g + 8 of each 16-row group, columns
  // 2t and 2t + 1 of the warp's 8
  const int g = lane >> 2, t = lane & 3;
  const int col = n0 + warp * 8 + 2 * t;
#pragma unroll
  for (int i = 0; i < kMT; ++i) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = i * 16 + g + 8 * half;         // row inside the tile
      uint32_t* dst = reinterpret_cast<uint32_t*>(
          p.out + (static_cast<size_t>(e) * p.C + m0 + r) * p.N + col);
      if constexpr (kGated) {
        if (r < rows) {
          const float h0 = act_fn(acc[0][i][2 * half], p.act) * acc[1][i][2 * half];
          const float h1 = act_fn(acc[0][i][2 * half + 1], p.act) * acc[1][i][2 * half + 1];
          *dst = f2_to_bf2(h0, h1);
        }
      } else {
        if (m0 + r < p.C) {                        // empty rows get zeros
          const bool live = r < rows;
          *dst = f2_to_bf2(live ? acc[0][i][2 * half] : 0.0f,
                           live ? acc[0][i][2 * half + 1] : 0.0f);
        }
      }
    }
  }
}

template <bool kGated>
cudaError_t launch(const Params& p, int E, cudaStream_t stream) {
  constexpr int kNB = kGated ? 2 : 1;
  // 40 KB (gated) / 30 KB: under the 48 KB a launch gets without opting in
  const size_t smem = sizeof(__nv_bfloat16) * kStages * (kATile + kNB * kBTile);
  const dim3 grid(p.N / kBN, (p.C + kBM - 1) / kBM, E);
  bucket_gemm_kernel<kGated><<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

// C interface, loaded with ctypes. All tensors contiguous bf16 except
// counts (int32, may be null). h is caller-allocated scratch (E, C, F).
// Returns a cudaError_t (0 = both passes launched).
extern "C" int moe_jam_bf16(const void* x, const void* w_gate, const void* w_up,
                            const void* w_down, const void* counts, void* h, void* out,
                            int E, int C, int D, int F, int act, void* stream) {
  if (E <= 0 || E > 65535 || C <= 0 || (C + kBM - 1) / kBM > 65535 || D <= 0
      || F <= 0 || D % kBK != 0 || D % kBN != 0 || F % kBK != 0 || F % kBN != 0
      || (act != 0 && act != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* cnt = static_cast<const int*>(counts);
  Params up;
  up.a = static_cast<const __nv_bfloat16*>(x);
  up.b0 = static_cast<const __nv_bfloat16*>(w_gate);
  up.b1 = static_cast<const __nv_bfloat16*>(w_up);
  up.out = static_cast<__nv_bfloat16*>(h);
  up.counts = cnt;
  up.C = C; up.K = D; up.N = F; up.act = act;
  cudaError_t err = launch<true>(up, E, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  Params down;
  down.a = static_cast<const __nv_bfloat16*>(h);
  down.b0 = static_cast<const __nv_bfloat16*>(w_down);
  down.b1 = nullptr;
  down.out = static_cast<__nv_bfloat16*>(out);
  down.counts = cnt;
  down.C = C; down.K = F; down.N = D; down.act = act;
  return static_cast<int>(launch<false>(down, E, s));
}
