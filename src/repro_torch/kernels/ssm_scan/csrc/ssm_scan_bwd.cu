// The selective scan's gradient, gated per row, for Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package differentiates the lax.scan of
// src/repro/models/ssm.py (ssm_forward) by autograd, and
// src/repro/kernels/ssm_scan/kernel.py (ssm_scan_pallas) has no backward.
// Training SSM and hybrid stacks on the card needs it. For every row b and
// channel i, with the float32 state h of the forward (ssm_scan.cu),
// da_t = exp(dt_t a[i, :]) and the cotangent g of the state carried
// backwards through time from dh_last (or zero):
//   g     += dy_t[i] c_t
//   dc_t  += h_t dy_t[i]                       summed over i
//   s      = sum_n g b_t
//   dx_t   = dt_t s
//   ddt_t  = x_t s + sum_n g h_{t-1} a da_t
//   db_t  += g dt_t x_t                        summed over i
//   da    += g h_{t-1} dt_t da_t               summed over t and b
//   g     *= da_t
// and at the end dh0 = g. A column t >= n_valid[b] is the identity: g
// passes through it and its gradients are zero.
//
// Inputs dt, x, dy (B, S, I) and b, c (B, S, N) bf16; a (I, N) f32; the
// forward's chunk states (B, ceil(S / 32), I, N) f32, the state entering
// each chunk of kChunk steps (ssm_scan.cu's kSave instance); dh_last
// (B, I, N) f32 or null; n_valid (B,) int32. Outputs ddt, dx (B, S, I) and
// db, dc (B, S, N) bf16; da (I, N) and dh0 (B, I, N) f32.
//
// What bounds it on an H100: the exponentials and the instructions around
// them. At mamba-130m's training micro-batch (2 x 4,096 tokens x 1,536
// channels, N 16: 201 M state elements) the bytes the function must move
// (0.13 GB) take 0.038 ms at 3.35 TB/s and its float32 operations (20 an
// element) 0.061 ms at 67 TFLOP/s; v2 takes 3.75 exponentials an element
// (below), 0.18 ms on the SFUs at 16 an SM a clock and 1.98 GHz.
//
// What held v1 back (1.7620 ms at mamba's micro-batch, 1.7988 at
// hymba-1.5b's 3,200 channels; NVIDIA H100 80GB HBM3, 700.00 W; PERF.md):
// the chain. A CTA (one row x 64 channels) walked all of its row's 128
// chunks of 32 steps last to first, recomputing each into 128 KB of shared
// memory, then reversing it: 4,096 dependent steps at ~430 ns each, so
// twice the channels took the same time. The grid was 48 CTAs at mamba's
// shape and 100 at hymba's for 132 SMs, and 184 KB of shared memory a CTA
// held an SM to one CTA of 4 warps, with a block barrier pair every 8
// steps and synchronous loads in front of every chunk.
//
// v2 (this design; 0.43 ms at mamba's micro-batch, 0.86 at hymba's, time
// now in proportion to the channels; PERF.md): g follows a linear
// recurrence with a diagonal decay, so a chunk maps the g at its end to the
// g at its start as g_start = P g_end + L, P the product of its decays,
// exp(a sum_t dt_t), and L its g_start from g_end = 0. Every (row, chunk)
// runs at once:
//   * Pass 1, ssm_scan_bwd_local, grid (channel blocks, chunks, rows): a
//     CTA runs g's recurrence alone over its chunk from zero (dt, dy and c;
//     no h) and writes L (B, n_chunks, I, N) and the chunk's sum of dt a
//     channel (B, n_chunks, I) f32; P is rebuilt from it by one
//     exponential. A chunk past n_valid writes nothing; a partial one
//     counts its valid columns only. One exponential an element: the SFUs
//     bound it.
//   * Pass 2, ssm_scan_bwd_carry: a thread a (row, channel, lane of 4 state
//     elements) walks its row's valid chunks last to first,
//     G_end(last) = dh_last (or 0), G_end(k - 1) = P_k G_end(k) + L_k,
//     writing each G_end over L in place and dh0 = P_0 G_end(0) + L_0; the
//     next 8 chunks' loads are in flight while a batch's FMAs run. A row
//     with n_valid == 0 walks nothing: dh0 is dh_last bit for bit.
//   * Pass 3, ssm_scan_bwd_kernel, the grid of pass 1 in the forward's
//     layout (N/4 lanes a channel pair, each lane a float4 of the state of
//     each of its two channels; 128 threads at N 16): a CTA copies its
//     chunk's dt, x and dy into shared memory with 16-byte cp.async (all in
//     flight at once; 2-byte loads where I is not a multiple of 8 or a base
//     is off 16 bytes), loads b and c as float32, its start state and its
//     G_end; sweeps the chunk once with the forward's own step
//     (ssm_scan.cuh, so the same bits) to keep the state entering each
//     8-step stage in shared memory; then walks the stages last to first,
//     recomputing a stage's 8 states into registers (64 floats a thread)
//     and running the reverse recurrence over them. Exponentials an
//     element: 0.75 in the sweep, 1 in the recompute and 1 in the reverse
//     step. 64 KB of shared memory and at most 168 registers a thread at
//     N 16: three CTAs, 12 warps, an SM.
//   * dx = dt s and ddt = x s + r of a channel are sums over its lanes:
//     each lane forms its parts of s and of x s + r for both channels, and
//     a reduce-scatter over the lanes (3 shuffles at N 16) leaves each of
//     the four sums on one lane, which writes it.
//   * No atomics: db and dc of a stage are staged in shared memory a pair
//     at a time and, between a pair of block barriers every 8 steps, summed
//     over the CTA's 32 pairs in a fixed order (two threads an output, even
//     and odd pairs, joined by one shuffle) into a partial a channel
//     block, (I/64, B, S, N); da's partial a (row, chunk) goes over G_end
//     in place. The fold launch sums db and dc over channel blocks and da
//     over (row, chunk), each in order: two launches give the same bits.
//   * Tried on the card and slower (PERF.md): db and dc summed every 4
//     steps (48 KB, four CTAs an SM, but spills at 128 registers); 4-step
//     stages; keeping the recompute's decays in registers for the reverse
//     step (0.75 fewer exponentials an element), at 4-step stages or at
//     two CTAs an SM. The SFUs are not what bounds pass 3.
//   * Not kept: a step's db and dc summed over a warp's 8 pairs by a
//     reduce-scatter of shuffles before shared memory (7 shuffles, 7 adds
//     and 14 selects a step a thread), the chunk's warp sums added over the
//     warps after its last stage, so no barrier inside the chunk (48 KB).
//     A build without that barrier pair (wrong sums, a gauge) had shown
//     14% of the gradient pass in it, yet the shuffle sums took the pass
//     from 0.3220 to 0.3404 ms at mamba's micro-batch (0.3348 at four CTAs
//     an SM, with spills; PERF.md): with 12 warps an SM the barriers' wait
//     is partly hidden, and the shuffles' instructions cost more.

#include "ssm_scan.cuh"

namespace {

constexpr int kPairs = kChannels / 2;    // channel pairs of a CTA
constexpr int kStages = kChunk / kSteps; // stages of a chunk
constexpr int kBatch = 8;                // chunks whose loads the carry has in flight at once

struct BwdArgs {
  const __nv_bfloat16* dt;
  const __nv_bfloat16* x;
  const __nv_bfloat16* b;
  const __nv_bfloat16* c;
  const __nv_bfloat16* dy;
  const float* a;
  const float* states;       // (B, n_chunks, I, N)
  const float* dh_last;      // (B, I, N) or null
  const int* n_valid;
  __nv_bfloat16* ddt;
  __nv_bfloat16* dx;
  float* dh0;                // (B, I, N)
  float* part_db;            // (ceil(I / 64), B, S, N)
  float* part_dc;
  float* carry;              // (B, n_chunks, I, N): L, then G_end, then da's partials
  float* dtsum;              // (B, n_chunks, I)
  int S, I, n_chunks;
};

// pass 3's shared memory: the state entering each stage, the db and dc of
// a stage's steps a pair, the chunk's b and c (f32) and dt, x, dy (bf16)
template <int N>
constexpr int bwd_smem_bytes() {
  return kStages * 2 * kPairs * N * 4 + 2 * kSteps * kPairs * N * 4 + 2 * kChunk * N * 4
         + 3 * kChunk * kChannels * 2;
}

__device__ __forceinline__ float4 zero4() { return make_float4(0.0f, 0.0f, 0.0f, 0.0f); }

// The chunk of a CTA of passes 1 and 3: channels from c0, columns [t0, t0
// + span), the first len of them valid.
struct Chunk {
  int c0, t0, span, len;
  __device__ Chunk(const BwdArgs& p) {
    c0 = blockIdx.x * kChannels;
    t0 = blockIdx.y * kChunk;
    const int nv = min(max(p.n_valid[blockIdx.z], 0), p.S);
    span = min(kChunk, p.S - t0);
    len = min(max(nv - t0, 0), span);
  }
};

__device__ __forceinline__ bool aligned16(const void* ptr) {
  return (reinterpret_cast<uintptr_t>(ptr) & 15) == 0;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(static_cast<unsigned>(__cvta_generic_to_shared(dst))), "l"(src)
               : "memory");
}

// every cp.async of this thread landed
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
}

// len steps of a (B, S, I) bf16 tensor from column t0 of row, the CTA's 64
// channels, into sm[len][64] (zeros past I): 16-byte cp.async copies, all in
// flight at once, where I is a multiple of 8 and src 16-byte aligned (a
// step's 64 channels are then 8 aligned pieces), else 2-byte loads. The
// caller waits (cp_async_wait_all) before its barrier.
template <int T>
__device__ __forceinline__ void load_cols(__nv_bfloat16* sm, const __nv_bfloat16* src,
                                          const BwdArgs& p, const Chunk& k) {
  const __nv_bfloat16* from = src + (static_cast<size_t>(blockIdx.z) * p.S + k.t0) * p.I;
  if (p.I % 8 == 0 && aligned16(src)) {
    for (int e = threadIdx.x; e < k.len * (kChannels / 8); e += T) {
      const int t = e / (kChannels / 8), col = k.c0 + e % (kChannels / 8) * 8;
      __nv_bfloat16* to = sm + t * kChannels + col - k.c0;
      if (col < p.I) {
        cp_async16(to, from + static_cast<size_t>(t) * p.I + col);
      } else {
        *reinterpret_cast<uint4*>(to) = make_uint4(0u, 0u, 0u, 0u);
      }
    }
    return;
  }
  for (int e = threadIdx.x; e < k.len * kChannels; e += T) {
    const int col = k.c0 + e % kChannels;
    sm[e] = col < p.I ? from[static_cast<size_t>(e / kChannels) * p.I + col]
                      : __float2bfloat16(0.0f);
  }
}

// len steps of a (B, S, N) bf16 tensor from column t0 of row into sm[len][N]
// (f32): 16-byte loads where N is a multiple of 8 and src 16-byte aligned,
// else 2-byte ones
template <int T, int N>
__device__ __forceinline__ void load_state_cols(float* sm, const __nv_bfloat16* src,
                                                const BwdArgs& p, const Chunk& k) {
  const __nv_bfloat16* from = src + (static_cast<size_t>(blockIdx.z) * p.S + k.t0) * N;
  if (N % 8 == 0 && aligned16(src)) {
    for (int e = threadIdx.x; e < k.len * N / 8; e += T) {
      const uint4 w = *reinterpret_cast<const uint4*>(from + 8 * e);
      float4* to = reinterpret_cast<float4*>(sm + 8 * e);
      to[0] = make_float4(bf_lo(w.x), bf_hi(w.x), bf_lo(w.y), bf_hi(w.y));
      to[1] = make_float4(bf_lo(w.z), bf_hi(w.z), bf_lo(w.w), bf_hi(w.w));
    }
    return;
  }
  for (int e = threadIdx.x; e < k.len * N; e += T) sm[e] = __bfloat162float(from[e]);
}

// Pass 1: g's recurrence over one chunk from g_end = 0 -> L, and the sum of
// the chunk's dt a channel.
template <int N>
__global__ void __launch_bounds__(kPairs * N / 4) ssm_scan_bwd_local(const BwdArgs p) {
  constexpr int kLanes = N / 4;
  constexpr int kThreads = kPairs * kLanes;
  __shared__ __align__(16) __nv_bfloat16 dts[kChunk * kChannels];
  __shared__ __align__(16) __nv_bfloat16 dys[kChunk * kChannels];
  __shared__ __align__(16) float cf[kChunk * N];
  const Chunk k(p);
  if (k.len == 0) return;                  // past n_valid: the carry skips the chunk
  const int tid = threadIdx.x, pair = tid / kLanes, q = tid % kLanes;
  const int i0 = k.c0 + 2 * pair;
  load_cols<kThreads>(dts, p.dt, p, k);
  load_cols<kThreads>(dys, p.dy, p, k);
  load_state_cols<kThreads, N>(cf, p.c, p, k);
  cp_async_wait_all();
  float4 a2[2], g[2];
  float sd[2] = {0.0f, 0.0f};
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    g[j] = zero4();
    a2[j] = i0 + j < p.I ? log2e_scaled(*reinterpret_cast<const float4*>(
                               p.a + static_cast<size_t>(i0 + j) * N + 4 * q))
                         : zero4();
  }
  __syncthreads();
#pragma unroll 4
  for (int t = k.len - 1; t >= 0; --t) {
    const uint32_t dw = *reinterpret_cast<const uint32_t*>(dts + t * kChannels + 2 * pair);
    const uint32_t yw = *reinterpret_cast<const uint32_t*>(dys + t * kChannels + 2 * pair);
    const float4 cv = *reinterpret_cast<const float4*>(cf + t * N + 4 * q);
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const float d = j ? bf_hi(dw) : bf_lo(dw);
      const float dyv = j ? bf_hi(yw) : bf_lo(yw);
      float4& gj = g[j];
      gj.x = __fmul_rn(__fmaf_rn(dyv, cv.x, gj.x), ex2(__fmul_rn(d, a2[j].x)));
      gj.y = __fmul_rn(__fmaf_rn(dyv, cv.y, gj.y), ex2(__fmul_rn(d, a2[j].y)));
      gj.z = __fmul_rn(__fmaf_rn(dyv, cv.z, gj.z), ex2(__fmul_rn(d, a2[j].z)));
      gj.w = __fmul_rn(__fmaf_rn(dyv, cv.w, gj.w), ex2(__fmul_rn(d, a2[j].w)));
      sd[j] = __fadd_rn(sd[j], d);
    }
  }
  const size_t at = (static_cast<size_t>(blockIdx.z) * p.n_chunks + blockIdx.y) * p.I;
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    if (i0 + j < p.I) {
      *reinterpret_cast<float4*>(p.carry + (at + i0 + j) * N + 4 * q) = g[j];
      if (q == 0) p.dtsum[at + i0 + j] = sd[j];
    }
  }
}

// Pass 2: g carried over each row's valid chunks, last to first. A thread
// a (row, channel, lane): 4 state elements; G_end written over L in place.
// The next kBatch chunks' L and dt sums load while this batch's FMAs run.
__global__ void __launch_bounds__(128) ssm_scan_bwd_carry(const BwdArgs p, int B, int N) {
  const int lanes = N / 4;
  const long long in4 = static_cast<long long>(p.I) * lanes;
  const long long e = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (e >= B * in4) return;
  const int row = static_cast<int>(e / in4);
  const long long rest = e - row * in4;
  const int i = static_cast<int>(rest / lanes);
  const int nv = min(max(p.n_valid[row], 0), p.S);
  const float4 a2 = log2e_scaled(reinterpret_cast<const float4*>(p.a)[rest]);
  float4* cr = reinterpret_cast<float4*>(p.carry) + static_cast<size_t>(row) * p.n_chunks * in4
               + rest;
  const float* sr = p.dtsum + static_cast<size_t>(row) * p.n_chunks * p.I + i;
  float4 G = p.dh_last != nullptr ? reinterpret_cast<const float4*>(p.dh_last)[e] : zero4();
  float4 l[kBatch];
  float sd[kBatch];
  auto fetch = [&](int hi, float4* lv, float* sv) {
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int k = hi - 1 - u;
      lv[u] = k >= 0 ? cr[k * in4] : zero4();
      sv[u] = k >= 0 ? sr[static_cast<size_t>(k) * p.I] : 0.0f;
    }
  };
  const int nk = (nv + kChunk - 1) / kChunk;
  fetch(nk, l, sd);
  for (int hi = nk; hi > 0; hi -= kBatch) {
    float4 ln[kBatch];
    float sn[kBatch];
    fetch(hi - kBatch, ln, sn);
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int k = hi - 1 - u;
      if (k >= 0) {
        cr[k * in4] = G;
        G.x = __fmaf_rn(ex2(__fmul_rn(sd[u], a2.x)), G.x, l[u].x);
        G.y = __fmaf_rn(ex2(__fmul_rn(sd[u], a2.y)), G.y, l[u].y);
        G.z = __fmaf_rn(ex2(__fmul_rn(sd[u], a2.z)), G.z, l[u].z);
        G.w = __fmaf_rn(ex2(__fmul_rn(sd[u], a2.w)), G.w, l[u].w);
      }
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      l[u] = ln[u];
      sd[u] = sn[u];
    }
  }
  reinterpret_cast<float4*>(p.dh0)[e] = G;
}

// A stage's db and dc (kSteps steps from column col0, valid of them valid)
// summed over the CTA's pairs: two threads an output float4, one over the
// even pairs and one over the odd, joined by a shuffle (a + b is b + a, so
// both hold the same bits); the first stores it.
template <int N>
__device__ __forceinline__ void reduce_steps(const float* red, float* pdb, float* pdc,
                                             int col0, int valid) {
  constexpr int kLanes = N / 4, kParts = kPairs * kLanes / (2 * kSteps * kLanes);
  const int part = threadIdx.x % kParts, o = threadIdx.x / kParts;
  const int oq = o / (kSteps * kLanes), ou = (o / kLanes) % kSteps, on = o % kLanes;
  float4 v = zero4();
  if (ou < valid) {
    const float4* src = reinterpret_cast<const float4*>(red + (oq * kSteps + ou) * kPairs * N)
                        + part * kLanes + on;
#pragma unroll 4
    for (int pp = 0; pp < kPairs / kParts; ++pp) {
      const float4 e4 = src[pp * kParts * kLanes];
      v.x = __fadd_rn(v.x, e4.x);
      v.y = __fadd_rn(v.y, e4.y);
      v.z = __fadd_rn(v.z, e4.z);
      v.w = __fadd_rn(v.w, e4.w);
    }
  }
#pragma unroll
  for (int m = 1; m < kParts; m <<= 1) {
    v.x = __fadd_rn(v.x, __shfl_xor_sync(0xffffffffu, v.x, m));
    v.y = __fadd_rn(v.y, __shfl_xor_sync(0xffffffffu, v.y, m));
    v.z = __fadd_rn(v.z, __shfl_xor_sync(0xffffffffu, v.z, m));
    v.w = __fadd_rn(v.w, __shfl_xor_sync(0xffffffffu, v.w, m));
  }
  if (part == 0 && ou < valid) {
    *reinterpret_cast<float4*>((oq ? pdc : pdb) + (col0 + ou) * N + 4 * on) = v;
  }
}

// Pass 3: one chunk's gradients, from its start state and G_end.
template <int N>
__global__ void __launch_bounds__(kPairs * N / 4, 3)
    ssm_scan_bwd_kernel(const BwdArgs p) {
  constexpr int kLanes = N / 4;
  constexpr int kThreads = kPairs * kLanes;
  extern __shared__ __align__(16) unsigned char smem[];
  float4* st = reinterpret_cast<float4*>(smem);                    // [kStages][2][kThreads]
  float* red = reinterpret_cast<float*>(st + kStages * 2 * kThreads);  // [2][kSteps][kPairs][N]
  float* bf = red + 2 * kSteps * kPairs * N;                         // [kChunk][N]
  float* cf = bf + kChunk * N;
  __nv_bfloat16* dts = reinterpret_cast<__nv_bfloat16*>(cf + kChunk * N);  // [kChunk][64]
  __nv_bfloat16* xs = dts + kChunk * kChannels;
  __nv_bfloat16* dys = xs + kChunk * kChannels;

  const Chunk k(p);
  const int row = blockIdx.z, B = gridDim.z, S = p.S, I = p.I;
  const int tid = threadIdx.x, pair = tid / kLanes, q = tid % kLanes;
  const int i0 = k.c0 + 2 * pair;          // the thread's first channel
  const size_t row0 = static_cast<size_t>(row) * S;
  float* pdb = p.part_db + (static_cast<size_t>(blockIdx.x) * B + row) * S * N;
  float* pdc = p.part_dc + (static_cast<size_t>(blockIdx.x) * B + row) * S * N;
  float* cr = p.carry + (static_cast<size_t>(row) * p.n_chunks + blockIdx.y) * I * N;

  // columns past n_valid: zero gradients
  const __nv_bfloat16 zero = __float2bfloat16(0.0f);
  for (int e = tid; e < (k.span - k.len) * kChannels; e += kThreads) {
    const int t = k.t0 + k.len + e / kChannels, col = k.c0 + e % kChannels;
    if (col < I) {
      p.ddt[(row0 + t) * I + col] = zero;
      p.dx[(row0 + t) * I + col] = zero;
    }
  }
  for (int e = tid; e < (k.span - k.len) * N; e += kThreads) {
    pdb[(k.t0 + k.len) * N + e] = 0.0f;
    pdc[(k.t0 + k.len) * N + e] = 0.0f;
  }
  float4 g[2], h[2], a2[2], av[2], dA[2];
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    g[j] = zero4();
    h[j] = zero4();
    av[j] = zero4();
    dA[j] = zero4();
    if (i0 + j < I && k.len > 0) {
      const size_t at = static_cast<size_t>(i0 + j) * N + 4 * q;
      av[j] = *reinterpret_cast<const float4*>(p.a + at);
      g[j] = *reinterpret_cast<const float4*>(cr + at);
      h[j] = *reinterpret_cast<const float4*>(
          p.states + (static_cast<size_t>(row) * p.n_chunks + blockIdx.y) * I * N + at);
    }
    a2[j] = log2e_scaled(av[j]);
  }
  if (k.len == 0) {                        // past n_valid: da's partial is zero
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      if (i0 + j < I) *reinterpret_cast<float4*>(cr + (i0 + j) * N + 4 * q) = zero4();
    }
    return;
  }
  load_cols<kThreads>(dts, p.dt, p, k);
  load_cols<kThreads>(xs, p.x, p, k);
  load_cols<kThreads>(dys, p.dy, p, k);
  load_state_cols<kThreads, N>(bf, p.b, p, k);
  load_state_cols<kThreads, N>(cf, p.c, p, k);
  cp_async_wait_all();
  __syncthreads();

  // the state entering each stage, by the forward's step
  const int n_st = (k.len + kSteps - 1) / kSteps;
  for (int s = 0; s < n_st; ++s) {
    st[(s * 2) * kThreads + tid] = h[0];
    st[(s * 2 + 1) * kThreads + tid] = h[1];
    if (s + 1 == n_st) break;
#pragma unroll
    for (int u = 0; u < kSteps; ++u) {     // a stage before the last is whole
      const int t = s * kSteps + u;
      const uint32_t dw = *reinterpret_cast<const uint32_t*>(dts + t * kChannels + 2 * pair);
      const uint32_t xw = *reinterpret_cast<const uint32_t*>(xs + t * kChannels + 2 * pair);
      const float4 bv = *reinterpret_cast<const float4*>(bf + t * N + 4 * q);
      advance(h[0], a2[0], bf_lo(dw), __fmul_rn(bf_lo(dw), bf_lo(xw)), bv);
      advance(h[1], a2[1], bf_hi(dw), __fmul_rn(bf_hi(dw), bf_hi(xw)), bv);
    }
  }

  // the stages last to first: recompute the stage's states into registers,
  // then the reverse recurrence over them
  for (int s = n_st - 1; s >= 0; --s) {
    const int ts = s * kSteps, cnt = min(kSteps, k.len - ts);
    float4 hs[kSteps][2];                  // the state before each step
    h[0] = st[(s * 2) * kThreads + tid];
    h[1] = st[(s * 2 + 1) * kThreads + tid];
#pragma unroll
    for (int u = 0; u < kSteps; ++u) {
      if (u < cnt) {
        const int t = ts + u;
        const uint32_t dw = *reinterpret_cast<const uint32_t*>(dts + t * kChannels + 2 * pair);
        const uint32_t xw = *reinterpret_cast<const uint32_t*>(xs + t * kChannels + 2 * pair);
        const float4 bv = *reinterpret_cast<const float4*>(bf + t * N + 4 * q);
        hs[u][0] = h[0];
        hs[u][1] = h[1];
        advance(h[0], a2[0], bf_lo(dw), __fmul_rn(bf_lo(dw), bf_lo(xw)), bv);
        advance(h[1], a2[1], bf_hi(dw), __fmul_rn(bf_hi(dw), bf_hi(xw)), bv);
      }
    }
    // h holds the state after step t
#pragma unroll
    for (int u = kSteps - 1; u >= 0; --u) {
      if (u < cnt) {
        const int t = ts + u;
        const uint32_t dw = *reinterpret_cast<const uint32_t*>(dts + t * kChannels + 2 * pair);
        const uint32_t xw = *reinterpret_cast<const uint32_t*>(xs + t * kChannels + 2 * pair);
        const uint32_t yw = *reinterpret_cast<const uint32_t*>(dys + t * kChannels + 2 * pair);
        const float4 bv = *reinterpret_cast<const float4*>(bf + t * N + 4 * q);
        const float4 cv = *reinterpret_cast<const float4*>(cf + t * N + 4 * q);
        float4 dbp = zero4(), dcp = zero4();
        float sv[2], rv[2];
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const float4 hp = hs[u][j];      // h_{t-1}
          const float d = j ? bf_hi(dw) : bf_lo(dw);
          const float dyv = j ? bf_hi(yw) : bf_lo(yw);
          const float dxv = __fmul_rn(d, j ? bf_hi(xw) : bf_lo(xw));
          float4& gj = g[j];
          gj.x = __fmaf_rn(dyv, cv.x, gj.x);
          gj.y = __fmaf_rn(dyv, cv.y, gj.y);
          gj.z = __fmaf_rn(dyv, cv.z, gj.z);
          gj.w = __fmaf_rn(dyv, cv.w, gj.w);
          dcp.x = __fmaf_rn(h[j].x, dyv, dcp.x);
          dcp.y = __fmaf_rn(h[j].y, dyv, dcp.y);
          dcp.z = __fmaf_rn(h[j].z, dyv, dcp.z);
          dcp.w = __fmaf_rn(h[j].w, dyv, dcp.w);
          dbp.x = __fmaf_rn(gj.x, dxv, dbp.x);
          dbp.y = __fmaf_rn(gj.y, dxv, dbp.y);
          dbp.z = __fmaf_rn(gj.z, dxv, dbp.z);
          dbp.w = __fmaf_rn(gj.w, dxv, dbp.w);
          float sj = __fmul_rn(gj.x, bv.x);
          sj = __fmaf_rn(gj.y, bv.y, sj);
          sj = __fmaf_rn(gj.z, bv.z, sj);
          sv[j] = __fmaf_rn(gj.w, bv.w, sj);
          const float4 da = make_float4(ex2(__fmul_rn(d, a2[j].x)), ex2(__fmul_rn(d, a2[j].y)),
                                        ex2(__fmul_rn(d, a2[j].z)), ex2(__fmul_rn(d, a2[j].w)));
          // w = g h_{t-1} da: the gradient of the decay's exponent over dt_t a
          const float4 w = make_float4(__fmul_rn(__fmul_rn(gj.x, hp.x), da.x),
                                       __fmul_rn(__fmul_rn(gj.y, hp.y), da.y),
                                       __fmul_rn(__fmul_rn(gj.z, hp.z), da.z),
                                       __fmul_rn(__fmul_rn(gj.w, hp.w), da.w));
          float rj = __fmul_rn(w.x, av[j].x);
          rj = __fmaf_rn(w.y, av[j].y, rj);
          rj = __fmaf_rn(w.z, av[j].z, rj);
          rv[j] = __fmaf_rn(w.w, av[j].w, rj);
          dA[j].x = __fmaf_rn(w.x, d, dA[j].x);
          dA[j].y = __fmaf_rn(w.y, d, dA[j].y);
          dA[j].z = __fmaf_rn(w.z, d, dA[j].z);
          dA[j].w = __fmaf_rn(w.w, d, dA[j].w);
          gj.x = __fmul_rn(gj.x, da.x);
          gj.y = __fmul_rn(gj.y, da.y);
          gj.z = __fmul_rn(gj.z, da.z);
          gj.w = __fmul_rn(gj.w, da.w);
          h[j] = hp;
        }
        const size_t gi = (row0 + k.t0 + t) * I + i0;
        // dx = dt s and ddt = x s + r a channel: s and x s + r (linear in the
        // lanes' parts) summed over the pair's lanes by a reduce-scatter, after
        // which lane q holds one of the four and writes it
        float v[4] = {sv[0], sv[1], __fmaf_rn(bf_lo(xw), sv[0], rv[0]),
                      __fmaf_rn(bf_hi(xw), sv[1], rv[1])};
        int which = 0;                     // the value this lane ends with
        if (kLanes == 4) {
          const bool hi = q & 2, lo = q & 1;
          float ka = hi ? v[2] : v[0], kb = hi ? v[3] : v[1];
          const float sa = hi ? v[0] : v[2], sb = hi ? v[1] : v[3];
          ka = __fadd_rn(ka, __shfl_xor_sync(0xffffffffu, sa, 2));
          kb = __fadd_rn(kb, __shfl_xor_sync(0xffffffffu, sb, 2));
          v[0] = __fadd_rn(lo ? kb : ka, __shfl_xor_sync(0xffffffffu, lo ? ka : kb, 1));
          which = q;
        } else if (kLanes == 2) {
          const bool lo = q & 1;
          const float sa = lo ? v[0] : v[2], sb = lo ? v[1] : v[3];
          v[0] = __fadd_rn(lo ? v[2] : v[0], __shfl_xor_sync(0xffffffffu, sa, 1));
          v[1] = __fadd_rn(lo ? v[3] : v[1], __shfl_xor_sync(0xffffffffu, sb, 1));
          which = 2 * q;
        }
#pragma unroll
        for (int m = 0; m < 4 / kLanes; ++m) {
          const int w = which + m, ch = w & 1;
          if (i0 + ch < I) {
            const float d = ch ? bf_hi(dw) : bf_lo(dw);
            (w < 2 ? p.dx : p.ddt)[gi + ch] = __float2bfloat16(w < 2 ? __fmul_rn(d, v[m]) : v[m]);
          }
        }
        *reinterpret_cast<float4*>(red + (u % kSteps * kPairs + pair) * N + 4 * q) = dbp;
        *reinterpret_cast<float4*>(red + ((kSteps + u % kSteps) * kPairs + pair) * N + 4 * q) = dcp;
      }
      if (u % kSteps == 0 && u < cnt) {      // steps [u, u + kSteps) done: their db and dc
        __syncthreads();
        reduce_steps<N>(red, pdb, pdc, k.t0 + ts + u, cnt - u);
        __syncthreads();
      }
    }
  }
  // da's partial of this (row, chunk), over G_end
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    if (i0 + j < I) *reinterpret_cast<float4*>(cr + (i0 + j) * N + 4 * q) = dA[j];
  }
}

// The fourth launch: db and dc, the sums of pass 3's partials over the
// channel blocks (the first db_blocks CTAs, a thread an element), and da,
// the sum of its (row, chunk) partials (the rest, a CTA 32 elements: warp w
// sums parts w, w + 8, ..., then warp 0 the eight in order).
__global__ void __launch_bounds__(256) ssm_scan_bwd_fold(
    const float* part_db, const float* part_dc, const float* part_da, __nv_bfloat16* db,
    __nv_bfloat16* dc, float* da, int blocks, int parts, long long bsn, long long in_,
    int db_blocks) {
  if (static_cast<int>(blockIdx.x) < db_blocks) {
    const long long e = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
    if (e >= bsn) return;
    float sb = 0.0f, sc = 0.0f;
#pragma unroll 8
    for (int k = 0; k < blocks; ++k) {
      sb = __fadd_rn(sb, part_db[k * bsn + e]);
      sc = __fadd_rn(sc, part_dc[k * bsn + e]);
    }
    db[e] = __float2bfloat16(sb);
    dc[e] = __float2bfloat16(sc);
    return;
  }
  __shared__ float sums[8][32];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const long long k = (static_cast<long long>(blockIdx.x) - db_blocks) * 32 + lane;
  float sa = 0.0f;
  if (k < in_) {
#pragma unroll 8
    for (int r = warp; r < parts; r += 8) sa = __fadd_rn(sa, part_da[r * in_ + k]);
  }
  sums[warp][lane] = sa;
  __syncthreads();
  if (warp == 0 && k < in_) {
    float t = sums[0][lane];
#pragma unroll
    for (int w = 1; w < 8; ++w) t = __fadd_rn(t, sums[w][lane]);
    da[k] = t;
  }
}

template <int N>
cudaError_t set_smem() {
  return cudaFuncSetAttribute(ssm_scan_bwd_kernel<N>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize, bwd_smem_bytes<N>());
}

template <int N>
cudaError_t launch_bwd(const BwdArgs& args, int B, cudaStream_t stream) {
  // a runtime call before the launches: autograd runs the backward on a
  // thread of its own, which this makes the device's context current on
  cudaError_t e = set_smem<N>();
  if (e != cudaSuccess) return e;
  constexpr int kThreads = kPairs * N / 4;
  const dim3 grid((args.I + kChannels - 1) / kChannels, args.n_chunks, B);
  ssm_scan_bwd_local<N><<<grid, kThreads, 0, stream>>>(args);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  const long long lanes = static_cast<long long>(B) * args.I * (N / 4);
  ssm_scan_bwd_carry<<<static_cast<unsigned>((lanes + 127) / 128), 128, 0, stream>>>(args, B, N);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  ssm_scan_bwd_kernel<N><<<grid, kThreads, bwd_smem_bytes<N>(), stream>>>(args);
  return cudaGetLastError();
}

template <int N>
int resident() {
  cudaError_t e = set_smem<N>();
  int n = 0;
  if (e == cudaSuccess) {
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, ssm_scan_bwd_kernel<N>, kPairs * N / 4,
                                                      bwd_smem_bytes<N>());
  }
  return e == cudaSuccess ? n : -static_cast<int>(e);
}

}  // namespace

// C interface, loaded with ctypes. All tensors contiguous; dt, x, b, c, dy,
// ddt, dx, db, dc bf16; a, states, dh_last, dh0, the scratch and da f32,
// 16-byte aligned; n_valid int32; dh_last may be null (zero). Scratch:
// part_db and part_dc (ceil(I / 64), B, S, N), carry (B, n_chunks, I, N),
// dtsum (B, n_chunks, I), n_chunks = ceil(S / kChunk). N must be 4, 8 or
// 16; states (B, n_chunks, I, N). Launches the three passes, then the fold.
// Returns a cudaError_t (0 = launched).
extern "C" int ssm_scan_bwd_bf16(const void* dt, const void* x, const void* b, const void* c,
                                 const void* dy, const void* a, const void* states,
                                 const void* dh_last, const void* n_valid, void* ddt, void* dx,
                                 void* dh0, void* part_db, void* part_dc, void* carry,
                                 void* dtsum, void* db, void* dc, void* da, int B, int S, int I,
                                 int N, void* stream) {
  const int n_chunks = (S + kChunk - 1) / kChunk;
  if (B <= 0 || B > 65535 || S <= 0 || n_chunks > 65535 || I <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  BwdArgs args;
  args.dt = static_cast<const __nv_bfloat16*>(dt);
  args.x = static_cast<const __nv_bfloat16*>(x);
  args.b = static_cast<const __nv_bfloat16*>(b);
  args.c = static_cast<const __nv_bfloat16*>(c);
  args.dy = static_cast<const __nv_bfloat16*>(dy);
  args.a = static_cast<const float*>(a);
  args.states = static_cast<const float*>(states);
  args.dh_last = static_cast<const float*>(dh_last);
  args.n_valid = static_cast<const int*>(n_valid);
  args.ddt = static_cast<__nv_bfloat16*>(ddt);
  args.dx = static_cast<__nv_bfloat16*>(dx);
  args.dh0 = static_cast<float*>(dh0);
  args.part_db = static_cast<float*>(part_db);
  args.part_dc = static_cast<float*>(part_dc);
  args.carry = static_cast<float*>(carry);
  args.dtsum = static_cast<float*>(dtsum);
  args.S = S;
  args.I = I;
  args.n_chunks = n_chunks;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  switch (N) {
    case 4: e = launch_bwd<4>(args, B, s); break;
    case 8: e = launch_bwd<8>(args, B, s); break;
    case 16: e = launch_bwd<16>(args, B, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  if (e != cudaSuccess) return static_cast<int>(e);
  const long long bsn = static_cast<long long>(B) * S * N, in_ = static_cast<long long>(I) * N;
  const int db_blocks = static_cast<int>((bsn + 255) / 256);
  ssm_scan_bwd_fold<<<db_blocks + static_cast<int>((in_ + 31) / 32), 256, 0, s>>>(
      static_cast<const float*>(part_db), static_cast<const float*>(part_dc),
      static_cast<const float*>(carry), static_cast<__nv_bfloat16*>(db),
      static_cast<__nv_bfloat16*>(dc), static_cast<float*>(da), (I + kChannels - 1) / kChannels,
      B * n_chunks, bsn, in_, db_blocks);
  return static_cast<int>(cudaGetLastError());
}

// Pass 3's resident CTAs an SM at state width N (the card has no ncu), or
// minus a cudaError_t.
extern "C" int ssm_scan_bwd_occupancy(int N) {
  switch (N) {
    case 4: return resident<4>();
    case 8: return resident<8>();
    case 16: return resident<16>();
    default: return -static_cast<int>(cudaErrorInvalidValue);
  }
}
