// Backward of the gated expert FFN over capacity buckets (B3b), for Hopper
// (sm_90a).
//
// Replaces no TPU kernel: the JAX package has no backward kernel for
// moe_jam_ffn_pallas and differentiates the einsum form of the expert FFN
// (src/repro/models/moe.py:66, expert_ffn). Training on the card needs the
// gradient of the forward kernel (csrc/moe_jam.cu), so this computes it,
// for every expert e of the (E, C, D) buckets x with weights w_gate, w_up
// (E, D, F) and w_down (E, F, D), from dy (E, C, D), the gradient of the
// forward's output:
//   g  = x . w_gate,  u = x . w_up      recomputed (f32 sums), not kept
//   dh = dy . w_down^T                   f32
//   h  = act(g) * u                      rounded to bf16, as the forward does
//   dg = dh * u * act'(g),  du = dh * act(g)       each rounded to bf16 once
//   dx = dg . w_gate^T + du . w_up^T
//   dw_gate = x^T . dg,  dw_up = x^T . du,  dw_down = h^T . dy
// every product summed in f32, every output bf16; act is silu, or gelu in
// its tanh form. counts[e] (optional, int32) is the number of rows of
// expert e that hold a token: the forward writes rows at or past it as
// constant zeros, so those rows contribute nothing here: dy there is never
// read into a sum, dx there is written as zeros, and an expert with no
// kept row gets exact-zero weight gradients. The plain version,
// ref.py::moe_jam_ffn_bwd_ref, states the same formula.
//
// What bounds it on an H100: operations. Eight products of 2 x rows x D x
// F flops each over the kept rows (at olmoe-1b-7b's training micro-batch,
// ~65,000 kept rows, 2.2e12 flops: ~2.2 ms at 989 TFLOP/s) against the
// weights read and their gradients written once (~4.8 ms of bytes only
// when fewer than ~700 rows an expert are kept). Pass A holds three of the
// products, B two, C three (bench.needed_bwd_work gives each pass's bound).
//
// v1 (11.7351 ms at olmoe's training buckets on an NVIDIA H100 80GB HBM3,
// 700.00 W, 0.19 of its bound) ran the legacy m16n8k16 product on a
// 3-stage cp.async ring, read MN-major operands as 16-bit halves, launched
// a CTA for every (expert, tile) of the capacity and pass C three times.
//
// v2 (this design): three launches, each of persistent CTAs (one per SM)
// fed by TMA and running wgmma, every stage 48 KB of 128-byte-swizzled
// boxes 64 deep in the reduction:
//   * An item list per pass, walked on the device from counts by every warp
//     alike (moe_jam.cuh's Walker, as the forward's): passes A and B take
//     (expert, 128-row M tile, column tile) for the M tiles that hold a
//     kept row, pass C (expert, gradient tile) for the experts that hold
//     one. Items of one expert are neighbours, so the CTAs that share an
//     operand tile read it from L2 at about the same time.
//   * A CTA is one producer warp, whose lane 0 keeps the ring full across
//     items, and two consumer warpgroups, each on 64 of the item's 128 rows
//     against the shared tile of the other operand (128-row items read each
//     weight tile half as often as the forward's 64-row ones), with two
//     m64n128 f32 accumulators a thread. A consumer waits for its products
//     at the end of each stage, then frees it (no product is left pending
//     across a branch: ptxas would serialize them, C7518), and the producer
//     fills the next item's stages during a tile's epilogue.
//   * Pass A (moe_bwd_act), 128 rows x 128 columns of F, two reductions
//     over D: dH (dy by 128 rows of w_down, K-major) first, parked as 64
//     f32 a thread in 64 KB of shared memory (each thread's own: it holds
//     the same elements of G and U), then G and U (x by w_gate, w_up,
//     MN-major), then h, dG and dU in bf16 for kept rows. Three
//     accumulators at once would take 192 registers; at 64 columns they
//     fit, but each stage then moves 56 KB for half the products (v2's
//     first form, slower on the card). 3 stages.
//   * Pass B (moe_bwd_dx), 128 rows x 256 columns of D: one reduction over
//     2F (dG by w_gate, then dU by w_up, both K-major). Rows at or past
//     counts[e] are written as zeros by select (dG there is uninitialised
//     scratch); rows in no item (whole 128-row tiles past counts[e]) are
//     zeroed by the consumers, spread over the grid, while the ring fills.
//     4 stages.
//   * Pass C (moe_bwd_dw), one launch for all three gradients: an item is
//     a 128 x 128 tile of dw_gate and the same tile of dw_up (x^T read once
//     for both), or a 128 x 256 tile of dw_down (h^T . dy). A is MN-major
//     and transposed by its descriptor, as B is. The reduction runs over
//     the expert's kept rows in 64-row stages, in row order, in one CTA.
//     TMA cannot stop at counts[e] inside an expert, so in a last partial
//     stage the consumers write zeros over every box's rows at or past it
//     (x and dy may hold NaN there, and h, dG, dU are scratch; NaN x 0 is
//     NaN, so both operands), then fence.proxy.async and a barrier of both
//     warpgroups before the products. A tile goes out through 32 KB of
//     shared memory a warpgroup, swizzled as the maps are, by TMA stores
//     that drain during the next item (a thread's 4-byte stores straight to
//     memory took 0.73 ms of the engine check's 1.11, where each item is
//     one stage deep; now 0.34). An empty expert's three gradients are
//     zeroed, spread over the grid, while the ring fills. 3 stages.
//   * Edges: 3-D tensor maps over (E, rows, cols) zero-fill past C, D and
//     F, never reading the next expert, and TMA stores clip at them; a box
//     wholly past the edge is not loaded, and what its slot holds reaches
//     only columns or rows that are never stored. D and F need only be
//     multiples of 32.
// Every output element is summed by one thread in a fixed order: no
// atomics, and a repeated launch gives the same bits.
//
// Tried on the card at olmoe's shape and not kept: CTA pairs in 2-CTA
// clusters sharing the weight (or dG / dU) boxes by TMA multicast (slower:
// every stage then waits for the slower CTA of the pair); warpgroups
// taking turns to issue, and pass C on 4 stages with half the staging (no
// gain); one product group left pending across stages (slower: ptxas
// serialized every product, C7518).
//
// What a later design changes: h, dG and dU go through device memory
// between the passes (about 1.2 GB of traffic at olmoe's shape); keeping
// them on chip (pass A's epilogue feeding B and C), staging pass A's and
// B's outputs through shared memory as pass C does, and fp8.

#include <math.h>

#include "moe_jam.cuh"

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kRows = 128;                  // rows of an item of pass A or B: two warpgroups of 64
constexpr int kConsumers = 256;             // two warpgroups
constexpr int kThreads = kConsumers + 32;   // + one producer warp
constexpr int kBox = 64 * 64 * 2;           // 8 KB: 64 rows of 128 bytes
constexpr int kRowTile = 2 * kBox;          // 16 KB: 128 rows x 64 deep
constexpr int kStage = 3 * kRowTile;        // 48 KB, every pass
constexpr int kActN = 128;                  // pass A: columns of F an item
constexpr int kActStages = 3;               // pass A: + 64 KB of dH
constexpr int kDH = kConsumers * 64 * 4;    // 64 KB: 64 f32 a consumer thread
constexpr int kStages = 4;                  // pass B
constexpr int kDxN = 256;                   // pass B: columns of D an item
constexpr int kDwStages = 3;                // pass C: + 64 KB to stage the gradient tiles
constexpr int kOut = 4 * kBox;              // 32 KB a warpgroup: 64 x 256 bf16

constexpr int smem_bytes(int stages, int extra) {
  return 1024 + stages * kStage + extra + 16 * stages;
}

struct Params {
  const int* counts;        // (E,) kept rows per expert, or null: all C
  bf16 *h, *dg, *du;        // (E, C, F) scratch: pass A writes the kept rows
  bf16* dx;                 // (E, C, D)
  bf16 *dw_gate, *dw_up, *dw_down;
  int E, C, D, F, act;
};

// The ring: kDepth stages of kStage bytes at the 1 KB-aligned start of
// dynamic shared memory, then kExtra bytes the kernel keeps for itself
// (`after`, 1 KB-aligned), then a `full` barrier a stage (the producer's
// expect_tx, completed by TMA's bytes) and an `empty` one (one arrival a
// consumer warp). Step `it` uses stage it % kDepth.
template <int kDepth, int kExtra>
struct Ring {
  unsigned char* smem;
  uint32_t base, full, empty;
  unsigned char* after;

  __device__ __forceinline__ explicit Ring(unsigned char* raw) {
    smem = reinterpret_cast<unsigned char*>(
        (reinterpret_cast<uintptr_t>(raw) + 1023) & ~static_cast<uintptr_t>(1023));
    base = smem_u32(smem);
    after = smem + kDepth * kStage;
    full = base + kDepth * kStage + kExtra;
    empty = full + 8 * kDepth;
    if (threadIdx.x == 0) {
      for (int s = 0; s < kDepth; ++s) {
        mbar_init(full + 8 * s, 1);
        mbar_init(empty + 8 * s, kConsumers / 32);
      }
      asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    }
    __syncthreads();
  }

  __device__ __forceinline__ uint32_t stage(int it) const {
    return base + (it % kDepth) * kStage;
  }
  __device__ __forceinline__ uint32_t full_bar(int it) const { return full + 8 * (it % kDepth); }

  // producer: wait until step it's stage is free, then arm it for `bytes`
  __device__ __forceinline__ void acquire(int it, uint32_t bytes) const {
    const int s = it % kDepth;
    if (it >= kDepth) mbar_wait(empty + 8 * s, ((it / kDepth) - 1) & 1);
    mbar_expect(full + 8 * s, bytes);
  }

  __device__ __forceinline__ void wait_full(int it) const {
    mbar_wait(full_bar(it), (it / kDepth) & 1);
  }

  // a consumer warp is done reading step it's stage
  __device__ __forceinline__ void release(int it, int lane) const {
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + 8 * (it % kDepth));
  }
};

__device__ __forceinline__ void act_grad(float g, int act, float& a, float& da) {
  if (act == 0) {                                             // silu
    const float s = 1.0f / (1.0f + expf(-g));
    a = g * s;
    da = s * (1.0f + g * (1.0f - s));
  } else {                                                    // gelu, tanh form
    const float k0 = 0.7978845608028654f, k1 = 0.044715f;     // sqrt(2 / pi)
    const float t = tanhf(k0 * (g + k1 * g * g * g));
    a = 0.5f * g * (1.0f + t);
    da = 0.5f * (1.0f + t) + 0.5f * g * (1.0f - t * t) * k0 * (1.0f + 3.0f * k1 * g * g);
  }
}

// a 64 x 64 box of shared memory (128-byte swizzle) to global memory
__device__ __forceinline__ void tma_store_3d(const CUtensorMap* map, uint32_t src, int c0, int c1,
                                             int c2) {
  asm volatile("cp.async.bulk.tensor.3d.global.shared::cta.bulk_group [%0, {%2, %3, %4}], [%1];"
               :: "l"(reinterpret_cast<uint64_t>(map)), "r"(src), "r"(c0), "r"(c1), "r"(c2)
               : "memory");
}

template <int N>
__device__ __forceinline__ void zero(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) r[i] = 0.0f;
}

// n 16-byte chunks at dst, written as zeros by the consumers of every CTA
__device__ __forceinline__ void zero_spread(uint4* dst, long long n) {
  for (long long i = static_cast<long long>(blockIdx.x) * kConsumers + threadIdx.x; i < n;
       i += static_cast<long long>(gridDim.x) * kConsumers) {
    dst[i] = make_uint4(0, 0, 0, 0);
  }
}

// ---- pass A: h, dG, dU for 128 rows x 128 columns of (C, F) ---------------
// Two reductions over D an item: first dH (dy by w_down, K-major), kept as
// 64 f32 a thread in shared memory, each thread's own (it holds the same
// elements of G and U); then G and U (x by w_gate, w_up, MN-major). Stages:
// dy and 128 rows of w_down (32 KB), then x and 128 columns of w_gate and
// of w_up (48 KB).
__global__ void __launch_bounds__(kThreads, 1)
moe_bwd_act(const __grid_constant__ CUtensorMap tm_x, const __grid_constant__ CUtensorMap tm_dy,
            const __grid_constant__ CUtensorMap tm_wg, const __grid_constant__ CUtensorMap tm_wu,
            const __grid_constant__ CUtensorMap tm_wd, const Params p) {
  extern __shared__ unsigned char smem_raw[];
  const Ring<kActStages, kDH> ring(smem_raw);
  const int lane = threadIdx.x % 32;
  const int nk = (p.D + 63) / 64;
  const int tiles = (p.F + kActN - 1) / kActN;
  Walker walk;
  int e, m;

  if (threadIdx.x >= kConsumers) {
    int it = 0;
    for (long long j = blockIdx.x;; j += gridDim.x) {
      if (!walk.seek(p.counts, p.E, p.C, kRows, j / tiles, lane, e, m)) break;
      const int n0 = static_cast<int>(j % tiles) * kActN;
      if (lane == 0) {
        const int boxes = n0 + 64 < p.F ? 2 : 1;    // w_gate's, w_up's: the second past F?
        for (int kt = 0; kt < nk; ++kt, ++it) {
          ring.acquire(it, 2 * kRowTile);
          const uint32_t st = ring.stage(it), bar = ring.full_bar(it);
          tma_load_3d(st, &tm_dy, bar, kt * 64, m * kRows, e);
          tma_load_3d(st + kRowTile, &tm_wd, bar, kt * 64, n0, e);
        }
        for (int kt = 0; kt < nk; ++kt, ++it) {
          ring.acquire(it, kRowTile + 2 * boxes * kBox);
          const uint32_t st = ring.stage(it), bar = ring.full_bar(it);
          tma_load_3d(st, &tm_x, bar, kt * 64, m * kRows, e);
          for (int i = 0; i < boxes; ++i) {
            tma_load_3d(st + kRowTile + i * kBox, &tm_wg, bar, n0 + 64 * i, kt * 64, e);
            tma_load_3d(st + 2 * kRowTile + i * kBox, &tm_wu, bar, n0 + 64 * i, kt * 64, e);
          }
        }
      }
      __syncwarp();
    }
    return;
  }

  const int wg = threadIdx.x / 128, warp = (threadIdx.x / 32) % 4;
  const int g = lane >> 2, t4 = lane & 3;
  float* dh = reinterpret_cast<float*>(ring.after) + threadIdx.x;   // stride kConsumers
  int it = 0;
  float acc0[64], acc1[64];
  for (long long j = blockIdx.x;; j += gridDim.x) {
    if (!walk.seek(p.counts, p.E, p.C, kRows, j / tiles, lane, e, m)) break;
    const int n0 = static_cast<int>(j % tiles) * kActN;
    const int kept = kept_rows(p.counts, e, p.C);
    const int row0 = m * kRows + wg * 64;          // this warpgroup's first row
    const bool live = row0 < kept;
    zero(acc0);
    for (int kt = 0; kt < nk; ++kt, ++it) {       // dH
      ring.wait_full(it);
      if (live) {
        const uint32_t st = ring.stage(it);
        const uint64_t da = gmma_desc(st + wg * kBox, 16, 1024);
        const uint64_t db = gmma_desc(st + kRowTile, 16, 1024);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          wgmma<0, 0>(acc0, desc_at(da, kk * 32), desc_at(db, kk * 32));
        }
        wgmma_commit();
        wgmma_wait_all();
        fence_regs(acc0);
      }
      ring.release(it, lane);
    }
#pragma unroll
    for (int i = 0; i < 64; ++i) dh[i * kConsumers] = acc0[i];
    zero(acc0);
    zero(acc1);
    for (int kt = 0; kt < nk; ++kt, ++it) {       // G, U
      ring.wait_full(it);
      if (live) {
        const uint32_t st = ring.stage(it);
        const uint64_t da = gmma_desc(st + wg * kBox, 16, 1024);
        const uint64_t dg = gmma_desc(st + kRowTile, kBox, 1024);
        const uint64_t du = gmma_desc(st + 2 * kRowTile, kBox, 1024);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          wgmma<0, 1>(acc0, desc_at(da, kk * 32), desc_at(dg, kk * 2048));
          wgmma<0, 1>(acc1, desc_at(da, kk * 32), desc_at(du, kk * 2048));
        }
        wgmma_commit();
        wgmma_wait_all();
        fence_regs(acc0);
        fence_regs(acc1);
      }
      ring.release(it, lane);
    }
    if (!live) continue;

    // this thread: rows g and g + 8 of its warp's 16, columns 8 c + 2 t4
    // and + 1 of each accumulator
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int r = row0 + warp * 16 + g + 8 * hh;
      if (r >= kept) continue;
      const size_t row = (static_cast<size_t>(e) * p.C + r) * p.F;
#pragma unroll
      for (int c = 0; c < kActN / 8; ++c) {
        const int col = n0 + 8 * c + 2 * t4;
        if (col >= p.F) continue;
        float hv[2], dgv[2], duv[2];
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          const int i = 4 * c + 2 * hh + q;
          const float d = dh[i * kConsumers];
          float a, da;
          act_grad(acc0[i], p.act, a, da);
          hv[q] = a * acc1[i];
          dgv[q] = d * acc1[i] * da;
          duv[q] = d * a;
        }
        *reinterpret_cast<uint32_t*>(p.h + row + col) = f2_to_bf2(hv[0], hv[1]);
        *reinterpret_cast<uint32_t*>(p.dg + row + col) = f2_to_bf2(dgv[0], dgv[1]);
        *reinterpret_cast<uint32_t*>(p.du + row + col) = f2_to_bf2(duv[0], duv[1]);
      }
    }
  }
}

// ---- pass B: dx for 128 rows x 256 columns of (C, D) -----------------------
__global__ void __launch_bounds__(kThreads, 1)
moe_bwd_dx(const __grid_constant__ CUtensorMap tm_dg, const __grid_constant__ CUtensorMap tm_du,
           const __grid_constant__ CUtensorMap tm_wg, const __grid_constant__ CUtensorMap tm_wu,
           const Params p) {
  extern __shared__ unsigned char smem_raw[];
  const Ring<kStages, 0> ring(smem_raw);
  const int lane = threadIdx.x % 32;
  const int nf = (p.F + 63) / 64, nk = 2 * nf;
  const int tiles = (p.D + kDxN - 1) / kDxN;
  Walker walk;
  int e, m;

  if (threadIdx.x >= kConsumers) {
    int it = 0;
    for (long long j = blockIdx.x;; j += gridDim.x) {
      if (!walk.seek(p.counts, p.E, p.C, kRows, j / tiles, lane, e, m)) break;
      const int n0 = static_cast<int>(j % tiles) * kDxN;
      if (lane == 0) {
        for (int kt = 0; kt < nk; ++kt, ++it) {
          const bool up = kt >= nf;                // dU . w_up^T after dG . w_gate^T
          const int k0 = (up ? kt - nf : kt) * 64;
          ring.acquire(it, kStage);
          const uint32_t st = ring.stage(it), bar = ring.full_bar(it);
          tma_load_3d(st, up ? &tm_du : &tm_dg, bar, k0, m * kRows, e);
          tma_load_3d(st + kRowTile, up ? &tm_wu : &tm_wg, bar, k0, n0, e);
        }
      }
      __syncwarp();
    }
    return;
  }

  // rows of dx in no item: from the end of an expert's last kept M tile to
  // C, all of them for an empty expert
  for (int x = 0; x < p.E; ++x) {
    const int z0 = min(p.C, (kept_rows(p.counts, x, p.C) + kRows - 1) / kRows * kRows);
    zero_spread(reinterpret_cast<uint4*>(p.dx + (static_cast<size_t>(x) * p.C + z0) * p.D),
                static_cast<long long>(p.C - z0) * p.D / 8);
  }

  const int wg = threadIdx.x / 128, warp = (threadIdx.x / 32) % 4;
  const int g = lane >> 2, t4 = lane & 3;
  int it = 0;
  float acc0[64], acc1[64];
  for (long long j = blockIdx.x;; j += gridDim.x) {
    if (!walk.seek(p.counts, p.E, p.C, kRows, j / tiles, lane, e, m)) break;
    const int n0 = static_cast<int>(j % tiles) * kDxN;
    const int kept = kept_rows(p.counts, e, p.C);
    const int row0 = m * kRows + wg * 64;
    const bool live = row0 < kept;
    zero(acc0);
    zero(acc1);
    for (int kt = 0; kt < nk; ++kt, ++it) {
      ring.wait_full(it);
      if (live) {
        const uint32_t st = ring.stage(it);
        const uint64_t da = gmma_desc(st + wg * kBox, 16, 1024);
        const uint64_t d0 = gmma_desc(st + kRowTile, 16, 1024);       // columns 0-127
        const uint64_t d1 = gmma_desc(st + 2 * kRowTile, 16, 1024);   // columns 128-255
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          wgmma<0, 0>(acc0, desc_at(da, kk * 32), desc_at(d0, kk * 32));
          wgmma<0, 0>(acc1, desc_at(da, kk * 32), desc_at(d1, kk * 32));
        }
        wgmma_commit();
        wgmma_wait_all();
        fence_regs(acc0);
        fence_regs(acc1);
      }
      ring.release(it, lane);
    }

    // every row below C of the tile is written: kept rows from the sums,
    // the rest (and a warpgroup with no kept row: its sums stayed 0) zeros
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int r = row0 + warp * 16 + g + 8 * hh;
      if (r >= p.C) continue;
      const bool ok = r < kept;
      bf16* row = p.dx + (static_cast<size_t>(e) * p.C + r) * p.D;
#pragma unroll
      for (int c = 0; c < 16; ++c) {
        const int col = n0 + 8 * c + 2 * t4;
        const int i = 4 * c + 2 * hh;
        if (col < p.D) {
          *reinterpret_cast<uint32_t*>(row + col) =
              f2_to_bf2(ok ? acc0[i] : 0.0f, ok ? acc0[i + 1] : 0.0f);
        }
        if (col + 128 < p.D) {
          *reinterpret_cast<uint32_t*>(row + col + 128) =
              f2_to_bf2(ok ? acc1[i] : 0.0f, ok ? acc1[i + 1] : 0.0f);
        }
      }
    }
  }
}

// ---- pass C: dw_gate and dw_up, or dw_down, over an expert's kept rows -----
struct DwItem {
  int e, kept;
  bool down;     // a dw_down tile (h^T . dy), else one of dw_gate and dw_up (x^T . dG, dU)
  int m0, n0;    // first row (of D, or of F for dw_down) and first column of the tile
};

// Item j of pass C: per expert with a kept row, ceil(D / 128) x ceil(F /
// 128) tiles of dw_gate / dw_up, then ceil(F / 128) x ceil(D / 256) of
// dw_down; false past the last
__device__ __forceinline__ bool dw_item(Walker& walk, const Params& p, long long j, int lane,
                                        DwItem& q) {
  const int gn = (p.F + 127) / 128, dn = (p.D + 255) / 256;
  const int gate = (p.D + 127) / 128 * gn, per = gate + (p.F + 127) / 128 * dn;
  int m;
  if (!walk.seek(p.counts, p.E, p.C, p.C, j / per, lane, q.e, m)) return false;
  int sub = static_cast<int>(j % per);
  q.down = sub >= gate;
  if (q.down) {
    sub -= gate;
    q.m0 = sub / dn * 128;
    q.n0 = sub % dn * 256;
  } else {
    q.m0 = sub / gn * 128;
    q.n0 = sub % gn * 128;
  }
  q.kept = kept_rows(p.counts, q.e, p.C);
  return true;
}

__global__ void __launch_bounds__(kThreads, 1)
moe_bwd_dw(const __grid_constant__ CUtensorMap tm_x, const __grid_constant__ CUtensorMap tm_h,
           const __grid_constant__ CUtensorMap tm_dg, const __grid_constant__ CUtensorMap tm_du,
           const __grid_constant__ CUtensorMap tm_dy, const __grid_constant__ CUtensorMap tm_ogate,
           const __grid_constant__ CUtensorMap tm_oup, const __grid_constant__ CUtensorMap tm_odown,
           const Params p) {
  extern __shared__ unsigned char smem_raw[];
  const Ring<kDwStages, 2 * kOut> ring(smem_raw);
  const int lane = threadIdx.x % 32;
  Walker walk;
  DwItem q;

  if (threadIdx.x >= kConsumers) {
    int it = 0;
    for (long long j = blockIdx.x; dw_item(walk, p, j, lane, q); j += gridDim.x) {
      if (lane == 0) {
        // stage: A^T's two 64-row boxes, then B0's and B1's two 64-column
        // boxes, every box 64 kept rows deep
        const int mlim = q.down ? p.F : p.D, nlim = q.down ? p.D : p.F;
        const CUtensorMap* a = q.down ? &tm_h : &tm_x;
        const CUtensorMap* b0m = q.down ? &tm_dy : &tm_dg;
        const CUtensorMap* b1m = q.down ? &tm_dy : &tm_du;
        const int c1 = q.down ? q.n0 + 128 : q.n0;    // B1's first column
        uint32_t bytes = 0;
        for (int i = 0; i < 2; ++i) {
          bytes += (q.m0 + 64 * i < mlim ? kBox : 0) + (q.n0 + 64 * i < nlim ? kBox : 0)
                   + (c1 + 64 * i < nlim ? kBox : 0);
        }
        const int nk = (q.kept + 63) / 64;
        for (int kt = 0; kt < nk; ++kt, ++it) {
          ring.acquire(it, bytes);
          const uint32_t st = ring.stage(it), bar = ring.full_bar(it);
          for (int i = 0; i < 2; ++i) {
            if (q.m0 + 64 * i < mlim) {
              tma_load_3d(st + i * kBox, a, bar, q.m0 + 64 * i, kt * 64, q.e);
            }
            if (q.n0 + 64 * i < nlim) {
              tma_load_3d(st + (2 + i) * kBox, b0m, bar, q.n0 + 64 * i, kt * 64, q.e);
            }
            if (c1 + 64 * i < nlim) {
              tma_load_3d(st + (4 + i) * kBox, b1m, bar, c1 + 64 * i, kt * 64, q.e);
            }
          }
        }
      }
      __syncwarp();
    }
    return;
  }

  // an empty expert's three gradients
  const long long n = static_cast<long long>(p.D) * p.F / 8;   // 16-byte chunks of one
  for (int x = 0; x < p.E; ++x) {
    if (kept_rows(p.counts, x, p.C) > 0) continue;
    const size_t off = static_cast<size_t>(x) * p.D * p.F;
    zero_spread(reinterpret_cast<uint4*>(p.dw_gate + off), n);
    zero_spread(reinterpret_cast<uint4*>(p.dw_up + off), n);
    zero_spread(reinterpret_cast<uint4*>(p.dw_down + off), n);
  }

  const int wg = threadIdx.x / 128, warp = (threadIdx.x / 32) % 4;
  const int g = lane >> 2, t4 = lane & 3;
  int it = 0;
  float acc0[64], acc1[64];
  for (long long j = blockIdx.x; dw_item(walk, p, j, lane, q); j += gridDim.x) {
    const int mlim = q.down ? p.F : p.D, nlim = q.down ? p.D : p.F;
    const int row0 = q.m0 + wg * 64;               // this warpgroup's first gradient row
    const bool live = row0 < mlim;
    const int nk = (q.kept + 63) / 64;
    zero(acc0);
    zero(acc1);
    for (int kt = 0; kt < nk; ++kt, ++it) {
      ring.wait_full(it);
      const int rem = q.kept - kt * 64;            // kept rows in this stage
      if (rem < 64) {
        // rows at or past counts[e] of every box: zeros, made visible to
        // the tensor cores' reads before either warpgroup's products
        uint4* st = reinterpret_cast<uint4*>(ring.smem + (it % kDwStages) * kStage);
        const int per_box = (64 - rem) * 8;
        for (int i = threadIdx.x; i < 6 * per_box; i += kConsumers) {
          st[(i / per_box) * (kBox / 16) + rem * 8 + i % per_box] = make_uint4(0, 0, 0, 0);
        }
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        asm volatile("bar.sync 1, %0;\n" :: "n"(kConsumers) : "memory");
      }
      if (live) {
        const uint32_t st = ring.stage(it);
        const uint64_t da = gmma_desc(st + wg * kBox, kBox, 1024);
        const uint64_t d0 = gmma_desc(st + 2 * kBox, kBox, 1024);
        const uint64_t d1 = gmma_desc(st + 4 * kBox, kBox, 1024);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          wgmma<1, 1>(acc0, desc_at(da, kk * 2048), desc_at(d0, kk * 2048));
          wgmma<1, 1>(acc1, desc_at(da, kk * 2048), desc_at(d1, kk * 2048));
        }
        wgmma_commit();
        wgmma_wait_all();
        fence_regs(acc0);
        fence_regs(acc1);
      }
      ring.release(it, lane);
    }
    if (!live) continue;

    // The tile goes out through shared memory: acc0 as boxes 0-1 (dw_gate,
    // or dw_down's first 128 columns), acc1 as boxes 2-3 (dw_up, or
    // dw_down's next 128), written in the 128-byte swizzle the maps use (a
    // warp's stores hit distinct banks), then TMA stores (rows and columns
    // past the gradient's edge are not written) that drain while the next
    // item runs. The buffer is written again once its last stores have
    // read it.
    const uint32_t tid = threadIdx.x % 128;
    if (tid == 0) asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
    asm volatile("bar.sync %0, 128;" :: "r"(2 + wg) : "memory");
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int r = warp * 16 + g + 8 * hh;
      unsigned char* line = ring.after + wg * kOut + r * 128 + 4 * t4;
#pragma unroll
      for (int c = 0; c < 16; ++c) {
        const int i = 4 * c + 2 * hh, at = (c / 8) * kBox + (((c % 8) ^ (r % 8)) << 4);
        *reinterpret_cast<uint32_t*>(line + at) = f2_to_bf2(acc0[i], acc0[i + 1]);
        *reinterpret_cast<uint32_t*>(line + 2 * kBox + at) = f2_to_bf2(acc1[i], acc1[i + 1]);
      }
    }
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    asm volatile("bar.sync %0, 128;" :: "r"(2 + wg) : "memory");
    if (tid == 0) {
      const uint32_t out = smem_u32(ring.after + wg * kOut);
      const CUtensorMap* o0 = q.down ? &tm_odown : &tm_ogate;
      const CUtensorMap* o1 = q.down ? &tm_odown : &tm_oup;
      const int c1 = q.down ? q.n0 + 128 : q.n0;
      for (int i = 0; i < 2; ++i) {
        if (q.n0 + 64 * i < nlim) tma_store_3d(o0, out + i * kBox, q.n0 + 64 * i, row0, q.e);
        if (c1 + 64 * i < nlim) tma_store_3d(o1, out + (2 + i) * kBox, c1 + 64 * i, row0, q.e);
      }
      asm volatile("cp.async.bulk.commit_group;" ::: "memory");
    }
  }
  // the last stores complete before the CTA's shared memory goes
  if (threadIdx.x % 128 == 0) asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
}

inline long long ceil_div(long long a, long long b) { return (a + b - 1) / b; }

template <class K>
cudaError_t allow_smem(K kernel, int bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

}  // namespace

// C interface, loaded with ctypes. All tensors contiguous bf16 on 16-byte
// boundaries except counts (int32, may be null). h, dg and du are
// caller-allocated (E, C, F) scratch, any contents. Returns a cudaError_t
// (0 = all three launches issued).
extern "C" int moe_jam_bwd_bf16(const void* x, const void* w_gate, const void* w_up,
                                const void* w_down, const void* dy, const void* counts,
                                void* h, void* dg, void* du, void* dx, void* dw_gate,
                                void* dw_up, void* dw_down, int E, int C, int D, int F,
                                int act, void* stream) {
  if (E <= 0 || E > 65535 || C <= 0 || D <= 0 || F <= 0 || D % 32 != 0 || F % 32 != 0
      || (act != 0 && act != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // runtime calls first: they make the device's context current on this
  // thread (an autograd worker may have none yet), which encoding a tensor
  // map needs
  cudaError_t err = allow_smem(moe_bwd_act, smem_bytes(kActStages, kDH));
  if (err == cudaSuccess) err = allow_smem(moe_bwd_dx, smem_bytes(kStages, 0));
  if (err == cudaSuccess) err = allow_smem(moe_bwd_dw, smem_bytes(kDwStages, 2 * kOut));
  int dev = 0, sms = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  // pass A: x, dy 128 rows a box, w_down 128 rows of F, w_gate, w_up 64 x
  // 64. Pass B: dG, dU 128 rows; w_gate, w_up 256 rows of D. Pass C: 64
  // rows of each, and the three gradients as 64 x 64 boxes.
  CUtensorMap a_x, a_dy, a_wg, a_wu, a_wd, b_dg, b_du, b_wg, b_wu, c_x, c_h, c_dg, c_du, c_dy,
      o_gate, o_up, o_down;
  if (!make_map(&a_x, x, E, C, D, kRows) || !make_map(&a_dy, dy, E, C, D, kRows)
      || !make_map(&a_wg, w_gate, E, D, F, 64) || !make_map(&a_wu, w_up, E, D, F, 64)
      || !make_map(&a_wd, w_down, E, F, D, kActN) || !make_map(&b_dg, dg, E, C, F, kRows)
      || !make_map(&b_du, du, E, C, F, kRows) || !make_map(&b_wg, w_gate, E, D, F, kDxN)
      || !make_map(&b_wu, w_up, E, D, F, kDxN) || !make_map(&c_x, x, E, C, D, 64)
      || !make_map(&c_h, h, E, C, F, 64) || !make_map(&c_dg, dg, E, C, F, 64)
      || !make_map(&c_du, du, E, C, F, 64) || !make_map(&c_dy, dy, E, C, D, 64)
      || !make_map(&o_gate, dw_gate, E, D, F, 64) || !make_map(&o_up, dw_up, E, D, F, 64)
      || !make_map(&o_down, dw_down, E, F, D, 64)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Params p;
  p.counts = static_cast<const int*>(counts);
  p.h = static_cast<bf16*>(h);
  p.dg = static_cast<bf16*>(dg);
  p.du = static_cast<bf16*>(du);
  p.dx = static_cast<bf16*>(dx);
  p.dw_gate = static_cast<bf16*>(dw_gate);
  p.dw_up = static_cast<bf16*>(dw_up);
  p.dw_down = static_cast<bf16*>(dw_down);
  p.E = E; p.C = C; p.D = D; p.F = F; p.act = act;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // one CTA an SM, at most one an item (counted as if every row were kept)
  const auto grid = [sms](long long most) {
    return static_cast<unsigned>(most < sms ? most : sms);
  };
  const long long mtiles = E * ceil_div(C, kRows);
  moe_bwd_act<<<grid(mtiles * ceil_div(F, kActN)), kThreads, smem_bytes(kActStages, kDH), s>>>(
      a_x, a_dy, a_wg, a_wu, a_wd, p);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  moe_bwd_dx<<<grid(mtiles * ceil_div(D, kDxN)), kThreads, smem_bytes(kStages, 0), s>>>(
      b_dg, b_du, b_wg, b_wu, p);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  const long long per = ceil_div(D, 128) * ceil_div(F, 128) + ceil_div(F, 128) * ceil_div(D, 256);
  moe_bwd_dw<<<grid(E * per), kThreads, smem_bytes(kDwStages, 2 * kOut), s>>>(
      c_x, c_h, c_dg, c_du, c_dy, o_gate, o_up, o_down, p);
  return static_cast<int>(cudaGetLastError());
}
