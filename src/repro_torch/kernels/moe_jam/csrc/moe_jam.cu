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

#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>
#include <math.h>

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
constexpr unsigned long long kTimeoutNs = 2000000000ull;   // a lost barrier traps

struct Params {
  const int* counts;        // (E,) kept rows per expert, or null: all C
  __nv_bfloat16* out;       // (E, C, N): h for pass 1, y for pass 2
  int E, C, K, N;
  int act;                  // 0 silu, 1 gelu (tanh form)
  int tiles;                // column tiles per M tile
};

__device__ __forceinline__ int kept_rows(const Params& p, int e) {
  return p.counts ? max(0, min(__ldg(p.counts + e), p.C)) : p.C;
}

// The items' M tiles in expert order, walked by one warp (all lanes alike):
// expert e has ceil(kept / 64) of them. Calls come with r non-decreasing.
struct Walker {
  int base = -32;           // first expert of the chunk of 32 in hand
  long long before = 0;     // M tiles of the experts before it
  int incl = 0;             // this lane's inclusive count in the chunk
  int mine = 0;             // M tiles of expert base + lane
  int total = 0;            // the chunk's M tiles

  // expert e and its M tile m that hold global M tile r; false past the last
  __device__ __forceinline__ bool seek(const Params& p, long long r, int lane, int& e, int& m) {
    while (r >= before + total) {
      before += total;
      base += 32;
      if (base >= p.E) return false;
      const int x = base + lane;
      mine = x < p.E ? (kept_rows(p, x) + kBM - 1) / kBM : 0;
      incl = mine;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int y = __shfl_up_sync(0xffffffffu, incl, o);
        if (lane >= o) incl += y;
      }
      total = __shfl_sync(0xffffffffu, incl, 31);
    }
    const int hit = __ffs(__ballot_sync(0xffffffffu, before + incl > r)) - 1;
    e = base + hit;
    m = static_cast<int>(r - before) - (__shfl_sync(0xffffffffu, incl, hit)
                                        - __shfl_sync(0xffffffffu, mine, hit));
    return true;
  }
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" :: "r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               :: "r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" :: "r"(bar) : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile("{\n\t.reg .pred p;\n\t"
               "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
               "selp.u32 %0, 1, 0, p;\n\t}"
               : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  return done != 0;
}

__device__ __forceinline__ unsigned long long now_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// Wait for the phase of parity `parity` to complete; trap after 2 s so a
// lost arrival fails the launch instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  if (mbar_try_wait(bar, parity)) return;
  const unsigned long long t0 = now_ns();
  while (!mbar_try_wait(bar, parity)) {
    if (now_ns() - t0 > kTimeoutNs) __trap();
  }
}

__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2) {
  asm volatile("cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
               "[%0], [%1, {%2, %3, %4}], [%5];"
               :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
                  "r"(bar)
               : "memory");
}

// A shared-memory matrix descriptor for wgmma, 128-byte swizzle: start
// address, leading and stride byte offsets (16-byte units). The swizzle
// atoms (8 rows x 128 bytes) start 1024-byte aligned, so base offset 0.
__device__ __forceinline__ uint64_t gmma_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4)
         | (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16)
         | (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32)
         | (1ull << 62);
}

// `base` advanced by `bytes`, in an instruction the compiler may neither
// hoist nor share between uses
__device__ __forceinline__ uint64_t desc_at(uint64_t base, uint32_t bytes) {
  uint64_t d;
  asm volatile("add.s64 %0, %1, %2;" : "=l"(d) : "l"(base), "l"(static_cast<uint64_t>(bytes >> 4)));
  return d;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Pin registers that wgmma writes asynchronously: no read is moved above
// the wait that precedes this, no write below the fence that follows.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i]) :: "memory");
}

// d (64 x 128, f32) += A (64 x 16, smem desc, K-major) . B (16 x 128, smem
// desc, MN-major: transposed)
__device__ __forceinline__ void wgmma_ss_t(float (&d)[64], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1));
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
      if (!walk.seek(p, j / p.tiles, lane, e, m)) break;
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
      const int z0 = min(p.C, (kept_rows(p, x) + kBM - 1) / kBM * kBM);
      uint4* dst = reinterpret_cast<uint4*>(p.out + (static_cast<size_t>(x) * p.C + z0) * p.N);
      const long long chunks = static_cast<long long>(p.C - z0) * p.N / 8;
      for (long long i = threadIdx.x; i < chunks; i += kConsumers) dst[i] = make_uint4(0, 0, 0, 0);
    }
  }

  int it = 0;
  float acc0[64], acc1[64];
  for (long long j = blockIdx.x;; j += gridDim.x) {
    if (!walk.seek(p, j / p.tiles, lane, e, m)) break;
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
        wgmma_ss_t(acc0, desc_at(da, kk * 32), desc_at(d0, kk * 2048));
        wgmma_ss_t(acc1, desc_at(da, kk * 32), desc_at(d1, kk * 2048));
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
    const int kept = kept_rows(p, e);
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

// cuTensorMapEncodeTiled, looked up at run time through the CUDA runtime
// (no -lcuda at build time).
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &ptr, 12000,
                                                           cudaEnableDefault, &found);
#else
    const cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr,
                                                  cudaEnableDefault, &found);
#endif
    if (e == cudaSuccess && found == cudaDriverEntryPointSuccess) {
      fn = reinterpret_cast<EncodeTiled>(ptr);
    }
  }
  return fn;
}

// A 3-D map over a contiguous bf16 (outer, mid, inner) tensor: boxes of 64
// inner x 64 mid elements of one outer index, 128-byte swizzle; elements
// past the ends read as zeros.
bool make_map(CUtensorMap* map, const void* base, int outer, int mid, int inner) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(inner), static_cast<cuuint64_t>(mid),
                              static_cast<cuuint64_t>(outer)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(inner) * 2,
                                 static_cast<cuuint64_t>(inner) * mid * 2};
  const cuuint32_t box[3] = {64, 64, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(base), dims, strides,
                box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE)
         == CUDA_SUCCESS;
}

// One pass over A (E, C, K) and weights (E, K, N) into out (E, C, N).
template <bool kGated>
cudaError_t launch(const void* a, const void* b0, const void* b1, Params p, cudaStream_t stream) {
  CUtensorMap tm_a, tm_b0, tm_b1;
  if (!make_map(&tm_a, a, p.E, p.C, p.K) || !make_map(&tm_b0, b0, p.E, p.K, p.N)
      || !make_map(&tm_b1, b1, p.E, p.K, p.N)) {
    return cudaErrorInvalidValue;
  }
  cudaError_t err = cudaFuncSetAttribute(moe_stream_kernel<kGated>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (err != cudaSuccess) return err;
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
