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
// counts[e] (optional) is the number of capacity rows of expert e that hold
// a token (the dispatch fills rows 0, 1, ... in order): rows at or past it
// are exact zeros in y, and an expert with none reads no weights.
//
// What bounds it on an H100: bytes. Each expert's weights (3 x D x F bf16,
// 12.6 MB at olmoe's widths) are used for at most C rows, 2 flops per
// 2-byte weight per row: at C = 40 that is 40 flops per byte, far under
// the ~295 flops per byte where the tensor cores, not HBM, would be the
// limit. The kernel has to stream the busy experts' weights at HBM rate;
// the tensor cores are idle most of the time whatever the design.
//
// v1 (0.3434 ms at chip_smoke's check input on an NVIDIA H100 80GB
// HBM3, 700.00 W, against a 0.1835 ms bytes bound) gave each CTA 64 rows x
// 32 output columns and streamed the reduction in 32-deep cp.async stages
// of 64-byte pieces at a 2-4 KB row pitch. Every one of an expert's 32
// (pass 1) or 64 (pass 2) column CTAs re-read the whole A operand (x, h)
// from L2, so in pass 2 a stage's A tile was twice its weight tile, and the
// weights moved at ~1.8 TB/s.
//
// v2 (this design) is a weight stream:
//   * Two launches, as in v1: pass 1 (gated) writes h (E, C, F) in bf16,
//     rounded where the TPU kernel rounds it; pass 2 reads it back. At the
//     serving engine's shape h is 5.2 MB against 805 MB of weights, so
//     fusing the passes is not where the time is.
//   * Persistent CTAs, one per SM: CTA b takes items b, b + grid, ... of
//     the list (expert, 64-row M tile, column tile), built on the device
//     from counts by every warp alike (a ballot walk over the experts):
//     only M tiles that hold a kept row are items, so empty experts cost
//     nothing and the busy ones spread over the SMs in one list. Items of
//     one (expert, M tile) are neighbours, so the CTAs that share an A tile
//     read it from L2 at about the same time.
//   * An item is 64 rows x 256 output columns: 128 of w_gate and the same
//     128 of w_up (pass 1), or 256 of w_down (pass 2), so each A tile
//     feeds 4x (pass 1) and 8x (pass 2) more weight bytes than in v1. For
//     C <= 64 (the engine's C is 40) every weight byte is read once; each
//     further 64-row tile re-reads the expert's weights, mostly from L2.
//   * One producer warp issues TMA loads into a ring of 5 stages of 40 KB:
//     the 64-row x 64-deep A tile (8 KB) and two 64-deep x 128-column
//     weight tiles (16 KB each). All tiles use the 128-byte swizzle; A is
//     K-major through a 3-D tensor map over (E, C, K), so rows past C are
//     zeros from TMA and never the next expert's; the weights are MN-major
//     (columns contiguous, as the JAX layout keeps them) through a 3-D map
//     over (E, K, N). A 64-column box past N is not loaded; one that
//     crosses N, and the last 64-deep slice past K, are zero-filled.
//   * One consumer warpgroup runs wgmma.mma_async m64n128k16 (both operands
//     from shared memory, the weights transposed by their descriptor) into
//     two f32 accumulators of 64 registers a thread, and frees a stage once
//     its products have read it. 160 threads a CTA leave every thread up to
//     255 registers without setmaxnreg.
//   * Epilogue: act in f32, h rounded to bf16 for kept rows only; in pass 2
//     rows at or past counts[e] are written as zeros by select, not by
//     multiply (h there is the wrapper's uninitialised scratch and may hold
//     NaN, and TMA loads it). Rows of y in no item (an empty expert's, and
//     whole 64-row tiles past counts[e]) are zeroed by the consumers while
//     the ring fills.
//
// What a later design changes: two consumer warpgroups on 128 rows, so
// C in (64, 128] reads the weights once; fusing pass 2 behind pass 1 per
// expert; and an fp8 weight stream, which halves the bytes that bound it.
//
// The item walk, TMA, mbarrier and wgmma helpers are in moe_jam.cuh,
// shared with the backward (moe_jam_bwd.cu).

#include <math.h>

#include "moe_jam.cuh"

namespace {

constexpr int kBM = 64;                    // rows per M tile: one wgmma M
constexpr int kBK = 64;                    // reduction depth per stage: 128 bytes of bf16
constexpr int kBN = 128;                   // columns per weight tile: two 64-column boxes
constexpr int kStages = 5;
constexpr int kConsumers = 128;            // one warpgroup
constexpr int kThreads = kConsumers + 32;  // + one producer warp
constexpr int kATile = kBM * kBK * 2;      // 8 KB
constexpr int kBox = kBK * 64 * 2;         // 8 KB: 64 deep x 64 columns
constexpr int kBTile = 2 * kBox;           // 16 KB
constexpr int kStage = kATile + 2 * kBTile;      // 40 KB
constexpr int kBarOff = kStages * kStage;
constexpr int kSmem = 1024 + kBarOff + 16 * kStages;   // + 1 KB to align the ring

struct Params {
  const int* counts;        // (E,) kept rows per expert, or null: all C
  __nv_bfloat16* out;       // (E, C, N): h for pass 1, y for pass 2
  int E, C, K, N;
  int act;                  // 0 silu, 1 gelu (tanh form)
  int tiles;                // column tiles per M tile
};

__device__ __forceinline__ float act_fn(float g, int act) {
  if (act == 0) return g / (1.0f + expf(-g));                 // silu
  const float k0 = 0.7978845608028654f;                        // sqrt(2 / pi)
  return 0.5f * g * (1.0f + tanhf(k0 * (g + 0.044715f * g * g * g)));
}

// Pass 1 (kGated): out = h = act(A . B0) * (A . B1), B0/B1 the same 128
// columns of w_gate / w_up. Pass 2: out = y = A . W over 256 columns, B0
// the first 128 of them and B1 the next 128 (tm_b1 is tm_b0).
template <bool kGated>
__global__ void __launch_bounds__(kThreads, 1)
moe_stream_kernel(const __grid_constant__ CUtensorMap tm_a,
                  const __grid_constant__ CUtensorMap tm_b0,
                  const __grid_constant__ CUtensorMap tm_b1, const Params p) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  const uint32_t ring = smem_u32(smem);
  const uint32_t full = ring + kBarOff;            // stage landed, one per stage
  const uint32_t empty = full + 8 * kStages;       // stage read, one per stage
  constexpr int kTileN = kGated ? kBN : 2 * kBN;   // output columns per item
  const int lane = threadIdx.x % 32;
  const int nk = (p.K + kBK - 1) / kBK;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, kConsumers / 32);   // one arrival a consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  Walker walk;
  int e, m;
  if (threadIdx.x >= kConsumers) {
    // the producer warp: lane 0 keeps the ring full, item after item
    int it = 0;
    for (long long j = blockIdx.x;; j += gridDim.x) {
      if (!walk.seek(p.counts, p.E, p.C, kBM, j / p.tiles, lane, e, m)) break;
      const int n0 = static_cast<int>(j % p.tiles) * kTileN;
      const int b1 = kGated ? n0 : n0 + kBN;       // B1's first column
      if (lane == 0) {
        for (int kt = 0; kt < nk; ++kt, ++it) {
          const int s = it % kStages;
          const uint32_t st = ring + s * kStage;
          if (it >= kStages) mbar_wait(empty + 8 * s, ((it / kStages) - 1) & 1);
          uint32_t bytes = kATile;
          for (int c = 0; c < 2; ++c) {
            bytes += (n0 + 64 * c < p.N ? kBox : 0) + (b1 + 64 * c < p.N ? kBox : 0);
          }
          mbar_expect(full + 8 * s, bytes);
          tma_load_3d(st, &tm_a, full + 8 * s, kt * kBK, m * kBM, e);
          for (int c = 0; c < 2; ++c) {
            if (n0 + 64 * c < p.N) {
              tma_load_3d(st + kATile + c * kBox, &tm_b0, full + 8 * s, n0 + 64 * c, kt * kBK, e);
            }
            if (b1 + 64 * c < p.N) {
              tma_load_3d(st + kATile + kBTile + c * kBox, &tm_b1, full + 8 * s, b1 + 64 * c,
                          kt * kBK, e);
            }
          }
        }
      }
      __syncwarp();
    }
    return;
  }

  const int warp = threadIdx.x / 32;
  const int g = lane >> 2, t4 = lane & 3;
  if constexpr (!kGated) {
    // rows of y in no item: rows from the end of an expert's last kept M
    // tile to C, all of them for an empty expert; written while the ring
    // fills
    for (int x = blockIdx.x; x < p.E; x += gridDim.x) {
      const int z0 = min(p.C, (kept_rows(p.counts, x, p.C) + kBM - 1) / kBM * kBM);
      uint4* dst = reinterpret_cast<uint4*>(p.out + (static_cast<size_t>(x) * p.C + z0) * p.N);
      const long long chunks = static_cast<long long>(p.C - z0) * p.N / 8;
      for (long long i = threadIdx.x; i < chunks; i += kConsumers) dst[i] = make_uint4(0, 0, 0, 0);
    }
  }

  int it = 0;
  float acc0[64], acc1[64];
  for (long long j = blockIdx.x;; j += gridDim.x) {
    if (!walk.seek(p.counts, p.E, p.C, kBM, j / p.tiles, lane, e, m)) break;
    const int n0 = static_cast<int>(j % p.tiles) * kTileN;
#pragma unroll
    for (int i = 0; i < 64; ++i) {
      acc0[i] = 0.0f;
      acc1[i] = 0.0f;
    }
    for (int kt = 0; kt < nk; ++kt, ++it) {
      const int s = it % kStages;
      const uint32_t st = ring + s * kStage;
      mbar_wait(full + 8 * s, (it / kStages) & 1);
      const uint64_t da = gmma_desc(st, 16, 1024);
      // weights: LBO = the next 64 columns (one box), SBO = the next 8 rows
      const uint64_t d0 = gmma_desc(st + kATile, kBox, 1024);
      const uint64_t d1 = gmma_desc(st + kATile + kBTile, kBox, 1024);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk) {
        // a box past N was not loaded: its columns hold stale bits, and
        // the epilogue stores no column past N
        wgmma<0, 1>(acc0, desc_at(da, kk * 32), desc_at(d0, kk * 2048));
        wgmma<0, 1>(acc1, desc_at(da, kk * 32), desc_at(d1, kk * 2048));
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(acc0);
      fence_regs(acc1);
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + 8 * s);
    }

    // this thread: rows g and g + 8 of its warp's 16, columns 8 c + 2 t4
    // and + 1 of each accumulator
    const int kept = kept_rows(p.counts, e, p.C);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = m * kBM + warp * 16 + g + 8 * h;
      if (r >= (kGated ? kept : p.C)) continue;
      const bool live = r < kept;
      __nv_bfloat16* row = p.out + (static_cast<size_t>(e) * p.C + r) * p.N;
#pragma unroll
      for (int c = 0; c < 16; ++c) {
        const int col = n0 + 8 * c + 2 * t4;
        const float a0 = acc0[4 * c + 2 * h], a1 = acc0[4 * c + 2 * h + 1];
        if constexpr (kGated) {
          const float b0 = acc1[4 * c + 2 * h], b1v = acc1[4 * c + 2 * h + 1];
          if (col < p.N) {
            *reinterpret_cast<uint32_t*>(row + col) =
                f2_to_bf2(act_fn(a0, p.act) * b0, act_fn(a1, p.act) * b1v);
          }
        } else {
          if (col < p.N) {
            *reinterpret_cast<uint32_t*>(row + col) =
                f2_to_bf2(live ? a0 : 0.0f, live ? a1 : 0.0f);
          }
          const float c0 = acc1[4 * c + 2 * h], c1 = acc1[4 * c + 2 * h + 1];
          if (col + kBN < p.N) {
            *reinterpret_cast<uint32_t*>(row + col + kBN) =
                f2_to_bf2(live ? c0 : 0.0f, live ? c1 : 0.0f);
          }
        }
      }
    }
  }
}

// One pass over A (E, C, K) and weights (E, K, N) into out (E, C, N).
template <bool kGated>
cudaError_t launch(const void* a, const void* b0, const void* b1, Params p, cudaStream_t stream) {
  // a runtime call first: it makes the device's context current on this
  // thread (an autograd worker may have none yet), which encoding a
  // tensor map needs
  cudaError_t err = cudaFuncSetAttribute(moe_stream_kernel<kGated>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (err != cudaSuccess) return err;
  CUtensorMap tm_a, tm_b0, tm_b1;
  if (!make_map(&tm_a, a, p.E, p.C, p.K, kBM) || !make_map(&tm_b0, b0, p.E, p.K, p.N, kBK)
      || !make_map(&tm_b1, b1, p.E, p.K, p.N, kBK)) {
    return cudaErrorInvalidValue;
  }
  int dev = 0, sms = 0;
  err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  const int tile_n = kGated ? kBN : 2 * kBN;
  p.tiles = (p.N + tile_n - 1) / tile_n;
  const long long most = static_cast<long long>(p.E) * ((p.C + kBM - 1) / kBM) * p.tiles;
  const unsigned grid = static_cast<unsigned>(most < sms ? most : sms);
  moe_stream_kernel<kGated><<<grid, kThreads, kSmem, stream>>>(tm_a, tm_b0, tm_b1, p);
  return cudaGetLastError();
}

}  // namespace

// C interface, loaded with ctypes. All tensors contiguous bf16 on 16-byte
// boundaries except counts (int32, may be null). h is caller-allocated
// scratch (E, C, F), any contents. Returns a cudaError_t (0 = both passes
// launched).
extern "C" int moe_jam_bf16(const void* x, const void* w_gate, const void* w_up,
                            const void* w_down, const void* counts, void* h, void* out,
                            int E, int C, int D, int F, int act, void* stream) {
  if (E <= 0 || E > 65535 || C <= 0 || D <= 0 || F <= 0 || D % 32 != 0 || F % 32 != 0
      || (act != 0 && act != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  Params up;
  up.counts = static_cast<const int*>(counts);
  up.out = static_cast<__nv_bfloat16*>(h);
  up.E = E; up.C = C; up.K = D; up.N = F; up.act = act;
  cudaError_t err = launch<true>(x, w_gate, w_up, up, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  Params down = up;
  down.out = static_cast<__nv_bfloat16*>(out);
  down.K = F; down.N = D;
  return static_cast<int>(launch<false>(h, w_down, w_down, down, s));
}
