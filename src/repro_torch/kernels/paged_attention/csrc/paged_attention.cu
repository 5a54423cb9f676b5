// Paged GQA attention through a block table, for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/paged_attention/kernel.py
// (paged_attention_pallas, body _paged_kernel). Computes what that kernel
// computes: flash-style online-softmax attention of a (B, C, H, D) query
// chunk against the shared pools (N, bs, K, D), addressed through
// block_tables (B, M); causal on absolute positions starts + c, optional
// sliding window, and k_pos < seq_end (stale rows of reused blocks). Only
// the live block range [lo, last] of each request is read.
//
// Design (simple: CUDA cores, no tensor cores):
//   * grid (B * K, ceil(G * C / 32)): one CTA per (request, kv head, tile of
//     32 query rows). Row r = g * C + c is query head k * G + g at column c,
//     read straight from q's (B, C, H, D) layout. The rows of a CTA are the
//     valid ones first (c < n_valid); columns >= n_valid are garbage by
//     contract and are written as zeros without being computed, so decode
//     rows (n_valid == 1) cost G rows, not G * C.
//   * 8 warps, up to 4 rows per warp, the tile computation instantiated
//     per row count; q is staged once in shared memory as f32. Keys go through a 3-stage ring of shared-memory tiles of 32
//     logical positions, filled with cp.async, so two tiles are in flight
//     while one is computed. Each position finds its own pool row through
//     the table, so any block size works; a -1 table entry (or an id past
//     the pool) is masked and never dereferenced.
//   * Q.K: one key per lane, all of a warp's rows at once against the lane's
//     K row (the K tile is padded one word per row so the lanes hit
//     distinct banks). P.V: lanes over D, each V word read once for all of
//     the warp's rows.
//   * Online softmax in f32 with the TPU kernel's constants: masked scores
//     are the finite NEG_INF = -2^30, m starts at -1e30, the output is
//     acc / max(l, 1e-30). A wholly masked early tile is wiped by alpha = 0
//     once a real score arrives; rows that see no key write zeros. p is
//     rounded to bf16 before P.V, as the TPU kernel casts it to v.dtype.
//
// What bounds it on an H100: the operation is bound by bytes. Per KV
// element pair it does 4 flops for every query row that sees it (Q.K and
// P.V): at the engine's prefill shape (G = 4, C = 32, D = 64) about 128
// flops per KV byte, under the ~295 bf16 flops per byte where tensor cores
// would stop being memory-bound. This form is bound by latency instead:
// one CTA walks a row's whole live range, 32 keys at a time, through a
// chain of shared-memory loads, shuffles and f32 FMAs on the CUDA cores
// with few warps to hide it, so a launch takes as long as its longest row
// (a decode row has one CTA per kv head and 4 busy warps).
//
// What a later design changes: wgmma over (64-row Q tile) x (key tile)
// with TMA-staged K/V, split-K over blocks for long sequences with a second
// reduction pass, and a decode path that spreads one request's blocks over
// several CTAs.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>
#include <math.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kRowsPerWarp = 4;
constexpr int kRowsPerCta = kWarps * kRowsPerWarp;   // 32
constexpr int kKeysPerTile = 32;                     // one key per lane in Q.K
constexpr int kStages = 3;                           // K/V tiles in the ring
constexpr float kNegInf = -1073741824.0f;            // -2^30, as the reference
constexpr float kMInit = -1e30f;
constexpr unsigned kFull = 0xffffffffu;

struct Params {
  const uint32_t* q;        // bf16 pairs
  const uint32_t* k_pool;
  const uint32_t* v_pool;
  const int* tables;
  const int* starts;
  const int* n_valid;
  uint32_t* out;
  int B, C, H, K, D, bs, M, N;
  int window;               // <= 0: no window
  float scale;
};

__device__ __forceinline__ float2 bf2_to_f2(uint32_t w) {
  __nv_bfloat162 h = *reinterpret_cast<__nv_bfloat162*>(&w);
  return __bfloat1622float2(h);
}

__device__ __forceinline__ uint32_t f2_to_bf2(float x, float y) {
  __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  return *reinterpret_cast<uint32_t*>(&h);
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

__device__ __forceinline__ void cp_async4(uint32_t* dst, const uint32_t* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" :: "r"(s), "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

// Linear row index li of a (request, kv head) maps valid rows first:
// li < G * ncols -> (g = li / ncols, c = li % ncols), then the garbage
// columns c >= ncols of every group head.
__device__ __forceinline__ void row_of(int li, int G, int C, int ncols,
                                       int* g, int* c) {
  const int nvr = G * ncols;
  if (li < nvr) {
    *g = li / ncols;
    *c = li % ncols;
  } else {
    const int rest = C - ncols;
    *g = (li - nvr) / rest;
    *c = ncols + (li - nvr) % rest;
  }
}

// Shared-memory layout, in 4-byte words: q tile (f32), then kStages times
// {K tile [32][DW + 1], V tile [32][DW], key state [32]}.
__host__ __device__ __forceinline__ int stage_words(int DW) {
  return kKeysPerTile * (DW + 1) + kKeysPerTile * DW + kKeysPerTile;
}

// Start the copies of the tile of logical positions [t0, t0 + 32) into one
// ring stage. Key state: 0 past the live range, 1 table hole (masked),
// 2 present. Absent rows are zero-filled so P.V never reads garbage.
__device__ __forceinline__ void issue_tile(const Params& p, const int* table,
                                           int kh, int t0, int kv_hi, int DW,
                                           uint32_t* stage) {
  uint32_t* k_s = stage;
  uint32_t* v_s = k_s + kKeysPerTile * (DW + 1);
  int* st_s = reinterpret_cast<int*>(v_s + kKeysPerTile * DW);
  for (int idx = threadIdx.x; idx < kKeysPerTile * DW; idx += kThreads) {
    const int key = idx / DW, w = idx - key * DW;
    const int pos = t0 + key;
    int st = 0;
    if (pos < kv_hi) {
      const int blk = table[pos / p.bs];
      st = (blk >= 0 && blk < p.N) ? 2 : 1;
      if (st == 2) {
        const size_t row = static_cast<size_t>(blk) * p.bs + pos % p.bs;
        const size_t o = (row * p.K + kh) * DW + w;
        cp_async4(k_s + key * (DW + 1) + w, p.k_pool + o);
        cp_async4(v_s + key * DW + w, p.v_pool + o);
      }
    }
    if (st != 2) {
      k_s[key * (DW + 1) + w] = 0u;
      v_s[key * DW + w] = 0u;
    }
    if (w == 0) st_s[key] = st;
  }
}

// One key tile for the first NR row slots of a warp (slot i is CTA row
// i * kWarps + warp). NR is a template argument so the loops over rows carry
// no guard: guarded, each row's shared-memory load and shuffle is waited on
// before the next row's is issued, and a decode warp (one row) must not pay
// for four.
template <int NW, int NR>
__device__ __forceinline__ void attend_tile(
    const Params& p, const float* q_w, const uint32_t* k_s, const uint32_t* v_s,
    int st, int kpos, int n_keys, const int (&q_pos)[kRowsPerWarp],
    float (&m)[kRowsPerWarp], float (&l)[kRowsPerWarp],
    float (&acc)[kRowsPerWarp][2 * NW]) {
  const int DW = p.D / 2;
  const int lane = threadIdx.x & 31;

  // Q.K: this lane's key against every row
  float sa[NR], sb[NR];
#pragma unroll
  for (int i = 0; i < NR; ++i) sa[i] = sb[i] = 0.f;
  const uint32_t* krow = k_s + lane * (DW + 1);
#pragma unroll 4
  for (int w = 0; w < DW; ++w) {
    const float2 kf = bf2_to_f2(krow[w]);
#pragma unroll
    for (int i = 0; i < NR; ++i) {
      const float2 qf = *reinterpret_cast<const float2*>(q_w + i * kWarps * p.D + 2 * w);
      sa[i] = fmaf(qf.x, kf.x, sa[i]);
      sb[i] = fmaf(qf.y, kf.y, sb[i]);
    }
  }

  // online softmax over the tile
  float pb[NR];
#pragma unroll
  for (int i = 0; i < NR; ++i) {
    float s = (sa[i] + sb[i]) * p.scale;
    const int rel = q_pos[i] - kpos;
    const bool ok = st == 2 && rel >= 0 && (p.window <= 0 || rel < p.window);
    s = (st == 0) ? -INFINITY : (ok ? s : kNegInf);
    const float m_new = fmaxf(m[i], warp_max(s));
    const float pr = expf(s - m_new);
    const float alpha = expf(m[i] - m_new);
    l[i] = l[i] * alpha + warp_sum(pr);
    m[i] = m_new;
    pb[i] = __bfloat162float(__float2bfloat16(pr));
#pragma unroll
    for (int j = 0; j < 2 * NW; ++j) acc[i][j] *= alpha;
  }

  // P.V: lanes over D, each V word read once for all rows
#pragma unroll 4
  for (int key = 0; key < n_keys; ++key) {
    float2 vf[NW];
#pragma unroll
    for (int n = 0; n < NW; ++n) {
      const int w = lane + 32 * n;
      vf[n] = w < DW ? bf2_to_f2(v_s[key * DW + w]) : make_float2(0.f, 0.f);
    }
#pragma unroll
    for (int i = 0; i < NR; ++i) {
      const float pk = __shfl_sync(kFull, pb[i], key);
#pragma unroll
      for (int n = 0; n < NW; ++n) {
        acc[i][2 * n] = fmaf(pk, vf[n].x, acc[i][2 * n]);
        acc[i][2 * n + 1] = fmaf(pk, vf[n].y, acc[i][2 * n + 1]);
      }
    }
  }
}

// NW: 32-bit words (bf16 pairs) of one head row each lane holds in P.V,
// ceil(D / 64).
template <int NW>
__global__ void __launch_bounds__(kThreads)
paged_attention_kernel(const Params p) {
  extern __shared__ uint32_t smem[];
  const int DW = p.D / 2;
  float* q_s = reinterpret_cast<float*>(smem);                 // [32][D]
  uint32_t* ring = smem + kRowsPerCta * p.D;

  const int b = blockIdx.x / p.K;
  const int kh = blockIdx.x % p.K;
  const int G = p.H / p.K;
  const int R = G * p.C;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  const int start = p.starts[b];
  const int nv = p.n_valid[b];
  const int seq_end = start + nv;
  const int ncols = min(max(nv, 0), p.C);
  const int n_rows = G * ncols;
  const int row0 = blockIdx.y * kRowsPerCta;
  // this warp's rows: slot i -> CTA row i * kWarps + warp; the valid ones
  // are a prefix i < nrow
  const int rem = n_rows - row0 - warp;
  const int nrow = rem <= 0 ? 0 : min(kRowsPerWarp, (rem + kWarps - 1) / kWarps);

  int q_pos[kRowsPerWarp];
  size_t off[kRowsPerWarp];     // word offset of the row in q / out
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    const int li = row0 + i * kWarps + warp;
    int g = 0, c = 0;
    if (li < R) row_of(li, G, p.C, ncols, &g, &c);
    q_pos[i] = start + c;
    off[i] = ((static_cast<size_t>(b) * p.C + c) * p.H + kh * G + g) * DW;
    if (li >= n_rows && li < R) {
      for (int w = lane; w < DW; w += 32) p.out[off[i] + w] = 0u;
    }
  }

  // live key range [kv_lo, kv_hi): blocks lo..last of the request
  int kv_lo = 0, kv_hi = 0;
  if (row0 < n_rows && seq_end > 0) {
    const int last = (seq_end + p.bs - 1) / p.bs - 1;
    int lo = 0;
    if (p.window > 0) {
      const int x = start - (p.window - 1);
      lo = min(x > 0 ? x / p.bs : 0, last);
    }
    kv_lo = lo * p.bs;
    kv_hi = min(seq_end, p.M * p.bs);
  }
  const int n_tiles = kv_lo < kv_hi ? (kv_hi - kv_lo + kKeysPerTile - 1) / kKeysPerTile : 0;
  const int* table = p.tables + static_cast<size_t>(b) * p.M;
  const int sw = stage_words(DW);

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < n_tiles) issue_tile(p, table, kh, kv_lo + s * kKeysPerTile, kv_hi, DW, ring + s * sw);
    cp_async_commit();
  }
  if (n_tiles > 0) {
    for (int idx = tid; idx < kRowsPerCta * DW; idx += kThreads) {
      const int s = idx / DW, w = idx - s * DW;
      const int li = row0 + s;
      float2 val = make_float2(0.f, 0.f);
      if (li < n_rows) {
        int g, c;
        row_of(li, G, p.C, ncols, &g, &c);
        val = bf2_to_f2(p.q[((static_cast<size_t>(b) * p.C + c) * p.H + kh * G + g) * DW + w]);
      }
      q_s[s * p.D + 2 * w] = val.x;
      q_s[s * p.D + 2 * w + 1] = val.y;
    }
  }

  float m[kRowsPerWarp], l[kRowsPerWarp], acc[kRowsPerWarp][2 * NW];
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    m[i] = kMInit;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < 2 * NW; ++j) acc[i][j] = 0.f;
  }

  for (int it = 0; it < n_tiles; ++it) {
    cp_async_wait<kStages - 2>();    // this thread's copies of tile it landed
    __syncthreads();                 // everyone's; and tile it - 1 is consumed
    {
      const int nt = it + kStages - 1;   // refills the stage of tile it - 1
      if (nt < n_tiles)
        issue_tile(p, table, kh, kv_lo + nt * kKeysPerTile, kv_hi, DW, ring + (nt % kStages) * sw);
      cp_async_commit();
    }
    if (nrow == 0) continue;         // warp-uniform

    const uint32_t* k_s = ring + (it % kStages) * sw;
    const uint32_t* v_s = k_s + kKeysPerTile * (DW + 1);
    const int* st_s = reinterpret_cast<const int*>(v_s + kKeysPerTile * DW);
    const int t0 = kv_lo + it * kKeysPerTile;
    const int n_keys = min(kKeysPerTile, kv_hi - t0);
    const int kpos = t0 + lane;
    const int st = st_s[lane];
    const float* q_w = q_s + warp * p.D;   // slot i: q_w + i * kWarps * D

    switch (nrow) {                  // warp-uniform
      case 1: attend_tile<NW, 1>(p, q_w, k_s, v_s, st, kpos, n_keys, q_pos, m, l, acc); break;
      case 2: attend_tile<NW, 2>(p, q_w, k_s, v_s, st, kpos, n_keys, q_pos, m, l, acc); break;
      case 3: attend_tile<NW, 3>(p, q_w, k_s, v_s, st, kpos, n_keys, q_pos, m, l, acc); break;
      default: attend_tile<NW, 4>(p, q_w, k_s, v_s, st, kpos, n_keys, q_pos, m, l, acc); break;
    }
  }
  cp_async_wait<0>();                // no copy outlives the CTA

#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    if (i >= nrow) continue;
    const float den = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int n = 0; n < NW; ++n) {
      const int w = lane + 32 * n;
      if (w < DW) p.out[off[i] + w] = f2_to_bf2(acc[i][2 * n] / den, acc[i][2 * n + 1] / den);
    }
  }
}

template <int NW>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  const size_t smem = sizeof(uint32_t) * (static_cast<size_t>(kRowsPerCta) * p.D
                                          + static_cast<size_t>(kStages) * stage_words(p.D / 2));
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        paged_attention_kernel<NW>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  const int G = p.H / p.K;
  const dim3 grid(p.B * p.K, (G * p.C + kRowsPerCta - 1) / kRowsPerCta);
  paged_attention_kernel<NW><<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

// C interface, loaded with ctypes. All tensors contiguous; q/k_pool/v_pool/out
// bf16, tables/starts/n_valid int32. Returns a cudaError_t (0 = launched).
extern "C" int paged_attention_bf16(
    const void* q, const void* k_pool, const void* v_pool, const void* tables,
    const void* starts, const void* n_valid, void* out,
    int B, int C, int H, int K, int D, int bs, int M, int N, int window,
    float scale, void* stream) {
  if (B <= 0 || C <= 0 || K <= 0 || H % K != 0 || D <= 0 || D % 2 != 0 || D > 256
      || bs <= 0 || M <= 0 || N <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Params p;
  p.q = static_cast<const uint32_t*>(q);
  p.k_pool = static_cast<const uint32_t*>(k_pool);
  p.v_pool = static_cast<const uint32_t*>(v_pool);
  p.tables = static_cast<const int*>(tables);
  p.starts = static_cast<const int*>(starts);
  p.n_valid = static_cast<const int*>(n_valid);
  p.out = static_cast<uint32_t*>(out);
  p.B = B; p.C = C; p.H = H; p.K = K; p.D = D; p.bs = bs; p.M = M; p.N = N;
  p.window = window;
  p.scale = scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch ((D / 2 + 31) / 32) {
    case 1: return static_cast<int>(launch<1>(p, s));
    case 2: return static_cast<int>(launch<2>(p, s));
    case 3: return static_cast<int>(launch<3>(p, s));
    default: return static_cast<int>(launch<4>(p, s));
  }
}
