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
// when fewer than ~700 rows an expert are kept).
//
// v1 (this design) is simple and right first; speed is later work. Each
// pass is a tiled product on mma.sync m16n8k16 (bf16 in, f32 sums): a CTA
// of 8 warps owns one output tile, streams the reduction through a 3-stage
// ring of cp.async copies (16 bytes a thread, zero-filled past an edge)
// and keeps each operand's tile in shared memory as it lies in device
// memory (padded rows); a fragment is read as one 32-bit word where the
// reduction is contiguous and as two 16-bit halves where it is not. Every
// output element is summed by one thread in a fixed order: no atomics, and
// a repeated launch gives the same bits.
//   * pass A (moe_bwd_act), per (expert, 64-row tile, 128 columns of F):
//     G, U and dH together (x and dy read K-major, w_gate / w_up MN-major,
//     w_down K-major as the transpose it is), then h, dG and dU in bf16
//     for kept rows. G and U are recomputed rather than kept from the
//     forward, so the forward keeps nothing but its inputs.
//   * pass B (moe_bwd_dx), per (expert, 128-row tile, 128 columns of D):
//     dx = dG . w_gate^T + dU . w_up^T, one reduction over 2F; rows at or
//     past counts[e] are written as zeros by select (dG there is
//     uninitialised scratch); whole 128-row tiles past it only write zeros.
//   * pass C (moe_bwd_dw, three launches), per (expert, 128 x 128 tile of
//     the weight gradient): the deterministic cross-row reduction, each CTA
//     looping over its expert's kept rows alone (rows at or past counts[e]
//     are zero-filled by the copy, both operands, so scratch never reaches a
//     sum), all of it in one CTA; an empty expert's CTAs write zeros.
// F 1,408 (deepseek-v2-lite-16b) is 11 tiles of 128; a width that is a
// multiple of 32 but not of 128 leaves a last tile whose columns past the
// edge are zero-filled and never stored.
//
// What a later design changes: wgmma from TMA-fed rings (the forward's
// machinery) for every pass, pass A's epilogue feeding pass B and C from
// shared memory, and a persistent item list that skips the tiles past
// counts[e] without launching them.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>
#include <math.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kBK = 32;          // reduction depth of one ring stage
constexpr int kStages = 3;
constexpr int kThreads = 256;    // 8 warps: 2 along the tile's rows x 4 along its columns
constexpr int kPad = 8;          // bf16 elements after each shared-memory row

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool ok) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  const int n = ok ? 16 : 0;     // 0 source bytes: the 16 bytes are zero-filled
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(s), "l"(gmem), "r"(n) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// d (16 x 8, f32) += a (16 x 16, row-major) . b (16 x 8, column-major)
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// One operand's tile of a ring stage: R rows (of the product's M or N) by
// kBK of the reduction, kept in shared memory as it lies in device memory:
// K-major (the reduction contiguous) as [R][kBK + kPad], MN-major (the
// rows contiguous) as [kBK][R + kPad]. Rows start on 16-byte boundaries
// and a warp's fragment reads fall in distinct banks.
template <int R, bool KMajor>
struct Tile {
  static constexpr int kLd = KMajor ? kBK + kPad : R + kPad;
  static constexpr int kElems = KMajor ? R * kLd : kBK * kLd;

  // Copy rows [r0, r0 + R) x reduction [k0, k0 + kBK) of the matrix at src
  // (ld elements between consecutive rows of its contiguous axis) into
  // dst; rows >= rlim and reduction indices >= klim are zeros. The
  // contiguous axis's limit and ld are multiples of 8.
  __device__ static void load(bf16* dst, const bf16* src, int ld, int r0, int rlim,
                              int k0, int klim) {
    constexpr int kVecs = R * kBK / 8;            // 16-byte copies
    static_assert(kVecs % kThreads == 0, "every thread copies as many");
#pragma unroll
    for (int v = 0; v < kVecs / kThreads; ++v) {
      const int i = threadIdx.x + v * kThreads;
      int r, k;
      if (KMajor) {
        r = i / (kBK / 8);
        k = (i % (kBK / 8)) * 8;
      } else {
        k = i / (R / 8);
        r = (i % (R / 8)) * 8;
      }
      const int gr = r0 + r, gk = k0 + k;
      const bool ok = gr < rlim && gk < klim;
      const size_t off = KMajor ? static_cast<size_t>(gr) * ld + gk
                                : static_cast<size_t>(gk) * ld + gr;
      cp_async16(dst + (KMajor ? r * kLd + k : k * kLd + r), ok ? src + off : src, ok);
    }
  }

  // the bf16 pair at (r, k) and (r, k + 1), packed low to high
  __device__ static uint32_t pair(const bf16* t, int r, int k) {
    if (KMajor) return *reinterpret_cast<const uint32_t*>(t + r * kLd + k);
    const unsigned short* u = reinterpret_cast<const unsigned short*>(t);
    return static_cast<uint32_t>(u[k * kLd + r])
           | (static_cast<uint32_t>(u[(k + 1) * kLd + r]) << 16);
  }
};

// acc (this warp's MI x 16 rows from wm, NI x 8 columns from wn) += the
// stage's A tile . B tile^T over its kBK reduction. Fragments of
// m16n8k16: lane = 4 g + t holds A rows g and g + 8 at reduction 2t, 2t+1
// and 2t+8, 2t+9; B column g at the same; C rows g, g + 8 at columns 2t,
// 2t + 1.
template <int MI, int NI, class TA, class TB>
__device__ __forceinline__ void warp_mma(float (&acc)[MI][NI][4], const bf16* sa,
                                         const bf16* sb, int wm, int wn) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int ks = 0; ks < kBK; ks += 16) {
    uint32_t a[MI][4], b[NI][2];
#pragma unroll
    for (int i = 0; i < MI; ++i) {
      const int r = wm + i * 16 + g;
      a[i][0] = TA::pair(sa, r, ks + 2 * t);
      a[i][1] = TA::pair(sa, r + 8, ks + 2 * t);
      a[i][2] = TA::pair(sa, r, ks + 2 * t + 8);
      a[i][3] = TA::pair(sa, r + 8, ks + 2 * t + 8);
    }
#pragma unroll
    for (int j = 0; j < NI; ++j) {
      const int n = wn + j * 8 + g;
      b[j][0] = TB::pair(sb, n, ks + 2 * t);
      b[j][1] = TB::pair(sb, n, ks + 2 * t + 8);
    }
#pragma unroll
    for (int i = 0; i < MI; ++i) {
#pragma unroll
      for (int j = 0; j < NI; ++j) mma_bf16(acc[i][j], a[i], b[j]);
    }
  }
}

// The ring: nk stages of the reduction, load(slot, kt) issuing stage kt's
// copies into ring slot `slot`, compute(slot) its products. Stage kt + 2
// is in flight while stage kt is multiplied.
template <class Load, class Compute>
__device__ __forceinline__ void run_ring(int nk, Load load, Compute compute) {
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nk) load(s, s);
    cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<kStages - 2>();
    __syncthreads();               // stage kt landed; slot (kt - 1) % kStages is free
    const int next = kt + kStages - 1;
    if (next < nk) load(next % kStages, next);
    cp_async_commit();
    compute(kt % kStages);
  }
}

__device__ __forceinline__ int kept_rows(const int* counts, int e, int C) {
  return counts ? max(0, min(__ldg(counts + e), C)) : C;
}

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

__device__ __forceinline__ uint32_t bf2(float x, float y) {
  __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  return *reinterpret_cast<uint32_t*>(&h);
}

struct Params {
  const bf16 *x, *w_gate, *w_up, *w_down, *dy;
  const int* counts;               // (E,) or null: every row kept
  bf16 *h, *dg, *du, *dx;          // h, dg, du: (E, C, F) scratch
  int E, C, D, F, act;
};

// ---- pass A: h, dG, dU for a 64-row x 128-column tile of (C, F) ----------
constexpr int kActRows = 64, kActCols = 128;
using ActX = Tile<kActRows, true>;     // x, dy: rows c, reduction d
using ActWd = Tile<kActCols, true>;    // w_down[e] (F, D): rows f, reduction d
using ActW = Tile<kActCols, false>;    // w_gate[e], w_up[e] (D, F): reduction d, rows f
constexpr int kActStage = 2 * ActX::kElems + ActWd::kElems + 2 * ActW::kElems;
constexpr int kActSmem = kStages * kActStage * 2;

__global__ void __launch_bounds__(kThreads, 1) moe_bwd_act(const Params p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* smem = reinterpret_cast<bf16*>(smem_raw);
  const int e = blockIdx.z, m0 = blockIdx.y * kActRows, n0 = blockIdx.x * kActCols;
  const int kept = kept_rows(p.counts, e, p.C);
  if (m0 >= kept) return;          // no kept row: pass B and C never read this tile
  const size_t xo = static_cast<size_t>(e) * p.C * p.D, wo = static_cast<size_t>(e) * p.D * p.F;
  const bf16 *x = p.x + xo, *dy = p.dy + xo;
  const bf16 *wg = p.w_gate + wo, *wu = p.w_up + wo, *wd = p.w_down + wo;
  const int warp = threadIdx.x >> 5;
  const int wm = (warp >> 2) * 32, wn = (warp & 3) * 32;
  float ag[2][4][4] = {}, au[2][4][4] = {}, ad[2][4][4] = {};

  run_ring(
      p.D / kBK,
      [&](int s, int kt) {
        bf16* st = smem + s * kActStage;
        const int k0 = kt * kBK;
        ActX::load(st, x, p.D, m0, kept, k0, p.D);
        ActX::load(st + ActX::kElems, dy, p.D, m0, kept, k0, p.D);
        ActWd::load(st + 2 * ActX::kElems, wd, p.D, n0, p.F, k0, p.D);
        ActW::load(st + 2 * ActX::kElems + ActWd::kElems, wg, p.F, n0, p.F, k0, p.D);
        ActW::load(st + 2 * ActX::kElems + ActWd::kElems + ActW::kElems, wu, p.F, n0, p.F,
                   k0, p.D);
      },
      [&](int s) {
        const bf16* st = smem + s * kActStage;
        const bf16* swg = st + 2 * ActX::kElems + ActWd::kElems;
        warp_mma<2, 4, ActX, ActW>(ag, st, swg, wm, wn);
        warp_mma<2, 4, ActX, ActW>(au, st, swg + ActW::kElems, wm, wn);
        warp_mma<2, 4, ActX, ActWd>(ad, st + ActX::kElems, st + 2 * ActX::kElems, wm, wn);
      });

  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int r = m0 + wm + i * 16 + g + 8 * hh;
      if (r >= kept) continue;
      const size_t row = (static_cast<size_t>(e) * p.C + r) * p.F;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = n0 + wn + j * 8 + 2 * t;
        if (col >= p.F) continue;
        float hv[2], dgv[2], duv[2];
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          float a, da;
          act_grad(ag[i][j][2 * hh + c], p.act, a, da);
          const float u = au[i][j][2 * hh + c], dh = ad[i][j][2 * hh + c];
          hv[c] = a * u;
          dgv[c] = dh * u * da;
          duv[c] = dh * a;
        }
        *reinterpret_cast<uint32_t*>(p.h + row + col) = bf2(hv[0], hv[1]);
        *reinterpret_cast<uint32_t*>(p.dg + row + col) = bf2(dgv[0], dgv[1]);
        *reinterpret_cast<uint32_t*>(p.du + row + col) = bf2(duv[0], duv[1]);
      }
    }
  }
}

// ---- pass B: dx for a 128-row x 128-column tile of (C, D) ----------------
constexpr int kTile = 128;
using DxA = Tile<kTile, true>;     // dG, dU (C, F): rows c, reduction f
using DxB = Tile<kTile, true>;     // w_gate[e], w_up[e] (D, F) as their transposes: rows d, reduction f
constexpr int kDxStage = DxA::kElems + DxB::kElems;
constexpr int kDxSmem = kStages * kDxStage * 2;

__global__ void __launch_bounds__(kThreads, 2) moe_bwd_dx(const Params p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* smem = reinterpret_cast<bf16*>(smem_raw);
  const int e = blockIdx.z, m0 = blockIdx.y * kTile, n0 = blockIdx.x * kTile;
  const int kept = kept_rows(p.counts, e, p.C);
  bf16* dx = p.dx + static_cast<size_t>(e) * p.C * p.D;
  if (m0 >= kept) {                // no kept row: the tile is zeros
    const int rows = min(kTile, p.C - m0), vecs = min(kTile, p.D - n0) / 8;
    for (int i = threadIdx.x; i < rows * vecs; i += kThreads) {
      *reinterpret_cast<uint4*>(dx + static_cast<size_t>(m0 + i / vecs) * p.D + n0
                                + (i % vecs) * 8) = make_uint4(0, 0, 0, 0);
    }
    return;
  }
  const size_t go = static_cast<size_t>(e) * p.C * p.F, wo = static_cast<size_t>(e) * p.D * p.F;
  const int warp = threadIdx.x >> 5;
  const int wm = (warp >> 2) * 64, wn = (warp & 3) * 32;
  const int nf = p.F / kBK;
  float acc[4][4][4] = {};

  run_ring(
      2 * nf,
      [&](int s, int kt) {
        bf16* st = smem + s * kDxStage;
        const bool up = kt >= nf;
        const int k0 = (up ? kt - nf : kt) * kBK;
        DxA::load(st, (up ? p.du : p.dg) + go, p.F, m0, kept, k0, p.F);
        DxB::load(st + DxA::kElems, (up ? p.w_up : p.w_gate) + wo, p.F, n0, p.D, k0, p.F);
      },
      [&](int s) {
        const bf16* st = smem + s * kDxStage;
        warp_mma<4, 4, DxA, DxB>(acc, st, st + DxA::kElems, wm, wn);
      });

  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int r = m0 + wm + i * 16 + g + 8 * hh;
      if (r >= p.C) continue;
      const bool live = r < kept;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = n0 + wn + j * 8 + 2 * t;
        if (col >= p.D) continue;
        *reinterpret_cast<uint32_t*>(dx + static_cast<size_t>(r) * p.D + col) =
            bf2(live ? acc[i][j][2 * hh] : 0.0f, live ? acc[i][j][2 * hh + 1] : 0.0f);
      }
    }
  }
}

// ---- pass C: out[e] (M, N) = a[e]^T . b[e] over the kept rows -------------
struct DwParams {
  const bf16* a;                   // (E, C, M)
  const bf16* b;                   // (E, C, N)
  const int* counts;
  bf16* out;                       // (E, M, N)
  int C, M, N;
};

using DwT = Tile<kTile, false>;    // rows m (or n) contiguous, reduction c
constexpr int kDwStage = 2 * DwT::kElems;
constexpr int kDwSmem = kStages * kDwStage * 2;

__global__ void __launch_bounds__(kThreads, 2) moe_bwd_dw(const DwParams p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* smem = reinterpret_cast<bf16*>(smem_raw);
  const int e = blockIdx.z, m0 = blockIdx.y * kTile, n0 = blockIdx.x * kTile;
  const int kept = kept_rows(p.counts, e, p.C);
  const bf16* a = p.a + static_cast<size_t>(e) * p.C * p.M;
  const bf16* b = p.b + static_cast<size_t>(e) * p.C * p.N;
  const int warp = threadIdx.x >> 5;
  const int wm = (warp >> 2) * 64, wn = (warp & 3) * 32;
  float acc[4][4][4] = {};

  run_ring(
      (kept + kBK - 1) / kBK,
      [&](int s, int kt) {
        bf16* st = smem + s * kDwStage;
        DwT::load(st, a, p.M, m0, p.M, kt * kBK, kept);
        DwT::load(st + DwT::kElems, b, p.N, n0, p.N, kt * kBK, kept);
      },
      [&](int s) {
        const bf16* st = smem + s * kDwStage;
        warp_mma<4, 4, DwT, DwT>(acc, st, st + DwT::kElems, wm, wn);
      });

  bf16* out = p.out + static_cast<size_t>(e) * p.M * p.N;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int r = m0 + wm + i * 16 + g + 8 * hh;
      if (r >= p.M) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = n0 + wn + j * 8 + 2 * t;
        if (col >= p.N) continue;
        *reinterpret_cast<uint32_t*>(out + static_cast<size_t>(r) * p.N + col) =
            bf2(acc[i][j][2 * hh], acc[i][j][2 * hh + 1]);
      }
    }
  }
}

inline unsigned tiles(int n, int t) { return static_cast<unsigned>((n + t - 1) / t); }

cudaError_t launch_dw(const bf16* a, const bf16* b, bf16* out, const Params& p, int M, int N,
                      cudaStream_t stream) {
  DwParams q;
  q.a = a; q.b = b; q.counts = p.counts; q.out = out;
  q.C = p.C; q.M = M; q.N = N;
  moe_bwd_dw<<<dim3(tiles(N, kTile), tiles(M, kTile), p.E), kThreads, kDwSmem, stream>>>(q);
  return cudaGetLastError();
}

}  // namespace

// C interface, loaded with ctypes. All tensors contiguous bf16 on 16-byte
// boundaries except counts (int32, may be null). h, dg and du are
// caller-allocated (E, C, F) scratch, any contents. Returns a cudaError_t
// (0 = all five launches issued).
extern "C" int moe_jam_bwd_bf16(const void* x, const void* w_gate, const void* w_up,
                                const void* w_down, const void* dy, const void* counts,
                                void* h, void* dg, void* du, void* dx, void* dw_gate,
                                void* dw_up, void* dw_down, int E, int C, int D, int F,
                                int act, void* stream) {
  if (E <= 0 || E > 65535 || C <= 0 || D <= 0 || F <= 0 || D % 32 != 0 || F % 32 != 0
      || (act != 0 && act != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaFuncSetAttribute(moe_bwd_act, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         kActSmem);
  if (err == cudaSuccess) {
    err = cudaFuncSetAttribute(moe_bwd_dx, cudaFuncAttributeMaxDynamicSharedMemorySize, kDxSmem);
  }
  if (err == cudaSuccess) {
    err = cudaFuncSetAttribute(moe_bwd_dw, cudaFuncAttributeMaxDynamicSharedMemorySize, kDwSmem);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  Params p;
  p.x = static_cast<const bf16*>(x);
  p.w_gate = static_cast<const bf16*>(w_gate);
  p.w_up = static_cast<const bf16*>(w_up);
  p.w_down = static_cast<const bf16*>(w_down);
  p.dy = static_cast<const bf16*>(dy);
  p.counts = static_cast<const int*>(counts);
  p.h = static_cast<bf16*>(h);
  p.dg = static_cast<bf16*>(dg);
  p.du = static_cast<bf16*>(du);
  p.dx = static_cast<bf16*>(dx);
  p.E = E; p.C = C; p.D = D; p.F = F; p.act = act;
  moe_bwd_act<<<dim3(tiles(F, kActCols), tiles(C, kActRows), E), kThreads, kActSmem, s>>>(p);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  moe_bwd_dx<<<dim3(tiles(D, kTile), tiles(C, kTile), E), kThreads, kDxSmem, s>>>(p);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  if ((err = launch_dw(p.x, p.dg, static_cast<bf16*>(dw_gate), p, D, F, s)) != cudaSuccess) {
    return static_cast<int>(err);
  }
  if ((err = launch_dw(p.x, p.du, static_cast<bf16*>(dw_up), p, D, F, s)) != cudaSuccess) {
    return static_cast<int>(err);
  }
  return static_cast<int>(launch_dw(p.h, p.dy, static_cast<bf16*>(dw_down), p, F, D, s));
}
