// Paged GQA attention through a block table, for Hopper (sm_90a): v5,
// split-K over the live key range (flash-decoding).
//
// Replaces the TPU kernel src/repro/kernels/paged_attention/kernel.py
// (paged_attention_pallas, body _paged_kernel). Computes what that kernel
// computes: flash-style online-softmax attention of a (B, C, H, D) query
// chunk against the shared pools (N, bs, K, D), addressed through
// block_tables (B, M); causal on absolute positions starts + c, optional
// sliding window, and k_pos < seq_end (stale rows of reused blocks). Only
// the live key range [kv_lo, kv_hi) of each request is read: kv_lo is the
// first key of the block holding the window's lower edge for the chunk's
// first column (0 without a window), kv_hi = min(seq_end, M * bs).
//
// Design:
//   * Split-K. The grid is (B * K, ceil(G * C / 64), n_splits). Split s
//     owns the absolute keys [s * kps, (s + 1) * kps) of the table; a CTA
//     walks their intersection with its request's live range. kps (keys
//     per split) comes from the table's width (ops.split_plan), never from
//     starts / n_valid, so the wrapper does not read them on the host. A
//     CTA whose split misses its request's live range writes an empty
//     partial (m = -1e30, l = 0) and exits.
//   * Each CTA writes, for each of its rows, a float32 partial (m, l,
//     acc[D]); a second kernel merges the partials of a (request, column,
//     head) row by the log-sum-exp rule: m = max m_s, w_s = exp(m_s - m)
//     over the splits with l_s > 0, l = sum l_s w_s, acc = sum acc_s w_s,
//     out = bf16(acc / max(l, 1e-30)). Every launch, one split too,
//     writes partials and merges them.
//   * Rows: a CTA holds 64 query rows of one (request, kv head), 16 a warp.
//     Row r = g * ncols + c (ncols = n_valid) is query head k * G + g at
//     column c: the valid rows come first, so a decode row (n_valid == 1)
//     costs G rows, not G * C. Columns >= n_valid are written as zeros.
//   * Every row goes through the tensor cores: Q.K^T and P.V by
//     mma.sync.m16n8k16 (bf16 in, float32 out) with fragments by ldmatrix
//     from bf16 shared memory, as in flash_attention.cu. A decode row fills
//     1 to 4 of a warp's 16 MMA rows; the op is bound by bytes, so the idle
//     MMA rows cost no measurable time. D is zero-padded in shared memory
//     to the next instance (16, 32, 64, 128, 256), so any even D <= 256
//     runs (66, say, as 128); the padding is never read from or written to
//     device memory.
//   * Loads: the CTA reads the table entries of its split's blocks once,
//     into shared memory. Keys go through a 3-stage ring of 32-key tiles,
//     two tiles in flight while one is computed; a key row of one kv head
//     (D * 2 contiguous bytes of the pool) moves as 16-byte cp.async.cg
//     chunks (4-byte copies when D is not a multiple of 8). A table entry
//     of -1 or >= N inside the live range is masked and never dereferenced:
//     its K and V rows are zero-filled.
//   * Numerics are the TPU kernel's: scores q.k * scale in float32; a
//     masked score (causal, window, table hole) is the finite -2^30 and a
//     key past the split's end or the live range is -inf; m starts at
//     -1e30; p = exp(s - m) (as exp2 with log2(e) folded in) is summed into
//     l unrounded and rounded to bf16 before P.V. A split whose keys are
//     all masked holds m_s = -2^30 and is wiped in the merge once a real
//     score exists, as alpha = 0 wipes a masked early tile; a row that sees
//     no key at all gets the mean of the V rows of its live range, table
//     holes counting as zero rows (v4's result).
//
// What bounds it on an H100: bytes. Per KV element pair it does 4 flops for
// every query row that sees it: at the engine's prefill shape (G = 4,
// C = 32, D = 64) about 128 flops per KV byte, under the ~295 bf16 flops a
// byte where the tensor cores, not HBM, would be the limit. v4 ran one CTA
// per request over its whole live range (~32 dependent tiles for a
// 1,000-key row) on the CUDA cores with 4-byte copies; v5 spreads a row's
// keys over up to 32 CTAs and moves them in 16-byte chunks, so a launch is
// no longer as long as its longest row.
//
// What a later design changes: TMA per block (a 2-D tensor map over the
// pool viewed as (N * bs, K * D)), and the merge fused into the last CTA
// of each row tile through an atomic ticket.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>
#include <math.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kRows = 16 * kWarps;                   // query rows per CTA
constexpr int kKeys = 32;                            // keys per ring stage
constexpr int kStages = 3;
constexpr int kMaxSplits = 32;                       // one per lane in the merge
constexpr float kNegInf = -1073741824.0f;            // -2^30, as the reference
constexpr float kMInit = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr unsigned kFull = 0xffffffffu;

struct Params {
  const __nv_bfloat16* q;
  const __nv_bfloat16* k_pool;
  const __nv_bfloat16* v_pool;
  const int* tables;
  const int* starts;
  const int* n_valid;
  __nv_bfloat16* out;
  float* part_ml;           // (n_splits, B, K, G * C, 2): m, l
  float* part_acc;          // (n_splits, B, K, G * C, D)
  int B, C, H, K, D, bs, M, N;
  int window;               // <= 0: no window
  int kps, n_splits;        // keys per split, splits
  int wide;                 // 16-byte copies: D % 8 == 0 and 16-byte aligned bases
  float scale;
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(s), "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src, int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
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

__device__ __forceinline__ uint32_t f2_to_bf2(float x, float y) {
  __nv_bfloat162 h = __floats2bfloat162_rn(x, y);   // x in the low half
  return *reinterpret_cast<uint32_t*>(&h);
}

// Row li < G * ncols of a (request, kv head) with ncols valid columns:
// query head k * G + g at column c, the valid rows first.
__device__ __forceinline__ void row_of(int li, int ncols, int* g, int* c) {
  *g = li / ncols;
  *c = li - *g * ncols;
}

// The request's live key range [lo, hi): blocks from the window's lower
// edge (for the chunk's first column) to the last resident key.
__device__ __forceinline__ void live_range(const Params& p, int start, int seq_end,
                                           int* lo, int* hi) {
  *lo = 0;
  *hi = 0;
  if (seq_end <= 0) return;
  const int last = (seq_end + p.bs - 1) / p.bs - 1;
  int lb = 0;
  if (p.window > 0) {
    const int x = start - (p.window - 1);
    lb = min(x > 0 ? x / p.bs : 0, last);
  }
  *lo = lb * p.bs;
  *hi = min(seq_end, p.M * p.bs);
}

__host__ __device__ __forceinline__ int table_slots(int kps, int bs) {
  return ((kps / bs + 2) + 3) & ~3;                  // whole 16-byte words
}

// Start the copies of the keys [t0, t0 + 32) into one ring stage and set
// each key's state: 0 past the split's end (or the live range), 1 table
// hole (masked, rows zero-filled), 2 present.
template <int LD>
__device__ __forceinline__ void load_tile(const Params& p, const int* tab, int blk_first,
                                           int kh, int t0, int k_end, bool wide,
                                           __nv_bfloat16* ks, __nv_bfloat16* vs,
                                           unsigned char* st) {
  const int nch = wide ? p.D / 8 : p.D / 2;
  for (int idx = threadIdx.x; idx < kKeys * nch; idx += kThreads) {
    const int key = idx / nch, ch = idx - key * nch;
    const int pos = t0 + key;
    int state = 0;
    size_t off = 0;
    if (pos < k_end) {
      const int blk = tab[pos / p.bs - blk_first];
      state = (blk >= 0 && blk < p.N) ? 2 : 1;
      if (state == 2) {
        off = ((static_cast<size_t>(blk) * p.bs + pos % p.bs) * p.K + kh) * p.D;
      }
    }
    const int n = state == 2;
    if (wide) {
      cp_async16(ks + key * LD + ch * 8, p.k_pool + off + ch * 8, n * 16);
      cp_async16(vs + key * LD + ch * 8, p.v_pool + off + ch * 8, n * 16);
    } else {
      cp_async4(ks + key * LD + ch * 2, p.k_pool + off + ch * 2, n * 4);
      cp_async4(vs + key * LD + ch * 2, p.v_pool + off + ch * 2, n * 4);
    }
    if (ch == 0) st[key] = static_cast<unsigned char>(state);
  }
}

// DP: D zero-padded to the instance's width (a multiple of 16).
template <int DP>
__global__ void __launch_bounds__(kThreads)
paged_split_kernel(const Params p) {
  constexpr int LD = DP + 8;                 // bf16 per shared row (+16 bytes)
  constexpr int kNT = kKeys / 8;             // n8 score tiles per warp
  constexpr int kDT = DP / 8;                // n8 output tiles per warp
  extern __shared__ __align__(16) unsigned char smem_raw[];
  int* tab = reinterpret_cast<int*>(smem_raw);
  unsigned char* st_all = smem_raw + 4 * table_slots(p.kps, p.bs);
  __nv_bfloat16* q_s = reinterpret_cast<__nv_bfloat16*>(st_all + kStages * kKeys);
  __nv_bfloat16* ring = q_s + kRows * LD;    // stage i: K (32 x LD), then V (32 x LD)

  const int b = blockIdx.x / p.K;
  const int kh = blockIdx.x % p.K;
  const int split = blockIdx.z;
  const int G = p.H / p.K;
  const int R = G * p.C;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;

  const int start = p.starts[b];
  const int nv = p.n_valid[b];
  const int ncols = min(max(nv, 0), p.C);
  const int n_rows = G * ncols;
  const int row0 = blockIdx.y * kRows;
  const int row_end = min(row0 + kRows, n_rows);

  if (row0 >= n_rows) return;

  int kv_lo, kv_hi;
  live_range(p, start, start + nv, &kv_lo, &kv_hi);
  const int k_begin = max(kv_lo, split * p.kps);
  const int k_end = min(kv_hi, (split + 1) * p.kps);
  if (k_begin >= k_end) {                    // an empty partial
    for (int li = row0 + tid; li < row_end; li += kThreads) {
      const size_t i = ((static_cast<size_t>(split) * p.B + b) * p.K + kh) * R + li;
      p.part_ml[2 * i] = kMInit;
      p.part_ml[2 * i + 1] = 0.0f;
    }
    return;
  }

  const int blk_first = k_begin / p.bs;
  const int n_tab = (k_end - 1) / p.bs - blk_first + 1;
  const int* table = p.tables + static_cast<size_t>(b) * p.M;
  for (int i = tid; i < n_tab; i += kThreads) tab[i] = table[blk_first + i];
  if (p.D < DP) {                            // zero the padding columns once
    constexpr int kRowsAll = kRows + kStages * 2 * kKeys;
    const int pad = DP - p.D;
    for (int idx = tid; idx < kRowsAll * pad; idx += kThreads) {
      const int r = idx / pad;
      q_s[r * LD + p.D + idx % pad] = __float2bfloat16(0.0f);
    }
  }
  const bool wide = p.wide != 0;
  {                                          // the Q tile, zero rows past n_rows
    const int nch = wide ? p.D / 8 : p.D / 2;
    for (int idx = tid; idx < kRows * nch; idx += kThreads) {
      const int r = idx / nch, ch = idx - r * nch;
      const int li = row0 + r;
      size_t off = 0;
      if (li < n_rows) {
        int g, c;
        row_of(li, ncols, &g, &c);
        off = ((static_cast<size_t>(b) * p.C + c) * p.H + kh * G + g) * p.D;
      }
      const int n = li < n_rows;
      if (wide) cp_async16(q_s + r * LD + ch * 8, p.q + off + ch * 8, n * 16);
      else cp_async4(q_s + r * LD + ch * 2, p.q + off + ch * 2, n * 4);
    }
  }
  __syncthreads();                           // the table entries are in

  const int n_tiles = (k_end - k_begin + kKeys - 1) / kKeys;
  auto stage_k = [&](int s) { return ring + s * 2 * kKeys * LD; };
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < n_tiles)
      load_tile<LD>(p, tab, blk_first, kh, k_begin + s * kKeys, k_end, wide, stage_k(s),
                     stage_k(s) + kKeys * LD, st_all + s * kKeys);
    cp_async_commit();                       // group 0 also holds the Q tile
  }

  // this thread's two rows of its warp's 16: g and g + 8
  const int gq = lane >> 2, t4 = lane & 3;
  const int fr0 = row0 + warp * 16 + gq;
  const int fr1 = fr0 + 8;
  int qp[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int fr = h ? fr1 : fr0;
    int g = 0, c = 0;
    if (fr < n_rows) row_of(fr, ncols, &g, &c);
    qp[h] = start + c;
  }
  const bool busy = row0 + warp * 16 < n_rows;   // warp-uniform

  float acc[kDT][4];
#pragma unroll
  for (int i = 0; i < kDT; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[i][e] = 0.0f;
  float m_r[2] = {kMInit, kMInit};
  float l_r[2] = {0.0f, 0.0f};               // this lane's part of the row sums

  for (int it = 0; it < n_tiles; ++it) {
    cp_async_wait<kStages - 2>();            // this thread's copies of tile it landed
    __syncthreads();                         // everyone's; tile it - 1 is consumed
    {
      const int nt = it + kStages - 1;       // refills the stage of tile it - 1
      if (nt < n_tiles) {
        const int s = nt % kStages;
        load_tile<LD>(p, tab, blk_first, kh, k_begin + nt * kKeys, k_end, wide, stage_k(s),
                       stage_k(s) + kKeys * LD, st_all + s * kKeys);
      }
      cp_async_commit();
    }
    if (!busy) continue;

    const int s = it % kStages;
    const __nv_bfloat16* ks = stage_k(s);
    const __nv_bfloat16* vs = ks + kKeys * LD;
    const unsigned char* st = st_all + s * kKeys;
    const int t0 = k_begin + it * kKeys;

    // S = Q . K^T: this warp's 16 rows x 32 keys
    float sc[kNT][4];
#pragma unroll
    for (int n = 0; n < kNT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[n][e] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
      uint32_t a[4];
      ldmatrix_x4(a, q_s + (warp * 16 + (lane & 15)) * LD + kk * 16 + (lane >> 4) * 8);
#pragma unroll
      for (int n = 0; n < kNT; n += 2) {
        uint32_t bk[4];
        ldmatrix_x4(bk, ks + (n * 8 + (lane & 7) + ((lane >> 4) << 3)) * LD + kk * 16
                            + ((lane >> 3) & 1) * 8);
        mma_bf16(sc[n], a, bk[0], bk[1]);
        mma_bf16(sc[n + 1], a, bk[2], bk[3]);
      }
    }

    // scale and mask (natural-log units); the new running max of each row
    float mx[2] = {m_r[0], m_r[1]};
#pragma unroll
    for (int n = 0; n < kNT; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = n * 8 + 2 * t4 + (e & 1);
        const int kp = t0 + key;
        const int q = qp[e >> 1];
        const int state = st[key];
        float x = sc[n][e] * p.scale;
        if (state == 0) {
          x = -INFINITY;
        } else if (state == 1 || kp > q || (p.window > 0 && q - kp >= p.window)) {
          x = kNegInf;
        }
        sc[n][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    }
    float alpha[2], ml[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(kFull, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(kFull, mx[h], 2));
      alpha[h] = exp2f((m_r[h] - mx[h]) * kLog2e);
      m_r[h] = mx[h];
      ml[h] = mx[h] * kLog2e;
    }
    float ps[2] = {0.0f, 0.0f};
#pragma unroll
    for (int n = 0; n < kNT; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float pv = exp2f(fmaf(sc[n][e], kLog2e, -ml[e >> 1]));
        sc[n][e] = pv;
        ps[e >> 1] += pv;
      }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) l_r[h] = l_r[h] * alpha[h] + ps[h];
#pragma unroll
    for (int i = 0; i < kDT; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][e] *= alpha[e >> 1];

    // acc += bf16(P) . V: score tiles 2kk, 2kk + 1 are the kk-th k16 step
#pragma unroll
    for (int kk = 0; kk < kKeys / 16; ++kk) {
      uint32_t a[4];
      a[0] = f2_to_bf2(sc[2 * kk][0], sc[2 * kk][1]);
      a[1] = f2_to_bf2(sc[2 * kk][2], sc[2 * kk][3]);
      a[2] = f2_to_bf2(sc[2 * kk + 1][0], sc[2 * kk + 1][1]);
      a[3] = f2_to_bf2(sc[2 * kk + 1][2], sc[2 * kk + 1][3]);
#pragma unroll
      for (int dt = 0; dt < kDT; dt += 2) {
        uint32_t bv[4];
        ldmatrix_x4_trans(bv, vs + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LD
                                  + dt * 8 + (lane >> 4) * 8);
        mma_bf16(acc[dt], a, bv[0], bv[1]);
        mma_bf16(acc[dt + 1], a, bv[2], bv[3]);
      }
    }
  }
  cp_async_wait<0>();                        // no copy outlives the CTA

  // the rows' partials (m, l, acc)
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float l = l_r[h];
    l += __shfl_xor_sync(kFull, l, 1);
    l += __shfl_xor_sync(kFull, l, 2);
    const int fr = h ? fr1 : fr0;
    if (!busy || fr >= n_rows) continue;
    const size_t i0 = ((static_cast<size_t>(split) * p.B + b) * p.K + kh) * R + fr;
    float* dst = p.part_acc + i0 * p.D;
#pragma unroll
    for (int i = 0; i < kDT; ++i) {
      const int d = i * 8 + 2 * t4;
      if (d < p.D)
        *reinterpret_cast<float2*>(dst + d) = make_float2(acc[i][2 * h], acc[i][2 * h + 1]);
    }
    if (t4 == 0) {
      p.part_ml[2 * i0] = m_r[h];
      p.part_ml[2 * i0 + 1] = l;
    }
  }
}

// One warp per (request, column, head) output row: merge the splits'
// partials, or write zeros for a column >= n_valid.
__global__ void __launch_bounds__(256) paged_merge_kernel(const Params p) {
  const int w = blockIdx.x * 8 + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (w >= p.B * p.C * p.H) return;
  const int h = w % p.H;
  const int c = (w / p.H) % p.C;
  const int b = w / (p.H * p.C);
  const int G = p.H / p.K;
  const int kh = h / G, g = h % G;
  const int ncols = min(max(p.n_valid[b], 0), p.C);
  const int DW = p.D / 2;
  uint32_t* dst = reinterpret_cast<uint32_t*>(p.out) + static_cast<size_t>(w) * DW;
  if (c >= ncols) {
    for (int i = lane; i < DW; i += 32) dst[i] = 0u;
    return;
  }
  const int R = G * p.C;
  const int li = g * ncols + c;
  auto row = [&](int s) {
    return ((static_cast<size_t>(s) * p.B + b) * p.K + kh) * R + li;
  };
  float ms = -INFINITY, ls = 0.0f;
  if (lane < p.n_splits) {
    ls = p.part_ml[2 * row(lane) + 1];
    if (ls > 0.0f) ms = p.part_ml[2 * row(lane)];
  }
  float m = ms;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(kFull, m, o));
  const float ws = ls > 0.0f ? expf(ms - m) : 0.0f;
  float l = ls * ws;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) l += __shfl_xor_sync(kFull, l, o);
  const float den = fmaxf(l, 1e-30f);
  for (int base = 0; base < DW; base += 32) {        // every lane takes each shuffle
    const int d2 = base + lane;
    float ax = 0.0f, ay = 0.0f;
    for (int s = 0; s < p.n_splits; ++s) {
      const float wt = __shfl_sync(kFull, ws, s);
      if (wt == 0.0f || d2 >= DW) continue;
      const float2 v = reinterpret_cast<const float2*>(p.part_acc + row(s) * p.D)[d2];
      ax = fmaf(v.x, wt, ax);
      ay = fmaf(v.y, wt, ay);
    }
    if (d2 < DW) dst[d2] = f2_to_bf2(ax / den, ay / den);
  }
}

template <int DP>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  const size_t smem = 4 * static_cast<size_t>(table_slots(p.kps, p.bs)) + kStages * kKeys
                      + sizeof(__nv_bfloat16) * static_cast<size_t>(kRows + kStages * 2 * kKeys)
                            * (DP + 8);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        paged_split_kernel<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  const int G = p.H / p.K;
  const dim3 grid(p.B * p.K, (G * p.C + kRows - 1) / kRows, p.n_splits);
  paged_split_kernel<DP><<<grid, kThreads, smem, stream>>>(p);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const int rows = p.B * p.C * p.H;
  paged_merge_kernel<<<(rows + 7) / 8, 256, 0, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

// C interface, loaded with ctypes. All tensors contiguous; q/k_pool/v_pool/out
// bf16, tables/starts/n_valid int32, part_ml (n_splits, B, K, G*C, 2) and
// part_acc (n_splits, B, K, G*C, D) float32 scratch.
// Split s covers the keys [s * kps, (s + 1) * kps); the splits must cover
// the table, M * bs keys. Returns a cudaError_t (0 = launched).
extern "C" int paged_attention_bf16(
    const void* q, const void* k_pool, const void* v_pool, const void* tables,
    const void* starts, const void* n_valid, void* out, void* part_ml, void* part_acc,
    int B, int C, int H, int K, int D, int bs, int M, int N, int window, int kps,
    int n_splits, float scale, void* stream) {
  if (B <= 0 || C <= 0 || K <= 0 || H % K != 0 || D <= 0 || D % 2 != 0 || D > 256
      || bs <= 0 || M <= 0 || N <= 0 || kps <= 0 || n_splits <= 0 || n_splits > kMaxSplits
      || static_cast<long long>(n_splits) * kps < static_cast<long long>(M) * bs
      || static_cast<long long>(n_splits - 1) * kps >= static_cast<long long>(M) * bs
      || (H / K) * C > 65535 * kRows) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Params p;
  p.q = static_cast<const __nv_bfloat16*>(q);
  p.k_pool = static_cast<const __nv_bfloat16*>(k_pool);
  p.v_pool = static_cast<const __nv_bfloat16*>(v_pool);
  p.tables = static_cast<const int*>(tables);
  p.starts = static_cast<const int*>(starts);
  p.n_valid = static_cast<const int*>(n_valid);
  p.out = static_cast<__nv_bfloat16*>(out);
  p.part_ml = static_cast<float*>(part_ml);
  p.part_acc = static_cast<float*>(part_acc);
  p.B = B; p.C = C; p.H = H; p.K = K; p.D = D; p.bs = bs; p.M = M; p.N = N;
  p.window = window;
  p.kps = kps;
  p.n_splits = n_splits;
  p.wide = D % 8 == 0 && (reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k_pool)
                          | reinterpret_cast<uintptr_t>(v_pool)) % 16 == 0;
  p.scale = scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D <= 16) return static_cast<int>(launch<16>(p, s));
  if (D <= 32) return static_cast<int>(launch<32>(p, s));
  if (D <= 64) return static_cast<int>(launch<64>(p, s));
  if (D <= 128) return static_cast<int>(launch<128>(p, s));
  return static_cast<int>(launch<256>(p, s));
}
