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
// What bounds it on an H100: the chain. A CTA walks its row's S steps one
// after the other (twice: the recompute, then the reverse recurrence), and
// a training micro-batch of 2 x 4,096 tokens gives 48 CTAs (mamba-130m,
// 1,536 channels) or 100 (hymba-1.5b, 3,200) for 132 SMs, one warpgroup
// each at N = 16. The bytes (~0.1 GB at mamba's micro-batch) take ~0.03
// ms and the float32 operations ~0.05 ms; a warp's own step, its
// dependent shared-memory loads, shuffles and exponentials in sequence,
// takes several hundred cycles, as in the forward's single-row prefill
// (PERF.md, row 4: 43x its bound).
//
// Design (a simple kernel that is right; a chunked parallel scan over
// time is a later design):
//   * The forward's layout: a CTA is one row x 64 channels; N/4 lanes hold
//     a channel pair, each lane one float4 of the state of each of the two
//     channels (128 threads at N = 16).
//   * The CTA walks its row's chunks of kChunk steps from last to first.
//     For each it loads the chunk's dt, x, dy, b and c into shared memory,
//     reloads the chunk's start state, recomputes the chunk's states with
//     the forward's own step (ssm_scan.cuh: the same rounding, so the same
//     bits) into shared memory (the state before every step, each thread
//     its own 32 bytes a step), then runs the reverse recurrence over the
//     chunk with g in registers.
//   * s and the ddt term are sums over the state: a butterfly over the
//     channel's lanes, which leaves every lane the same bits. db and dc are
//     sums over channels: each thread adds its two channels, then every 8
//     steps the CTA sums its 32 channel pairs in a fixed order in shared
//     memory and writes its partial (I/64, B, S, N). da is a sum over
//     rows: each CTA writes its row's (B, I, N). A second launch from this
//     source folds both in a fixed order. No atomics: two launches give
//     the same bits.

#include "ssm_scan.cuh"

namespace {

constexpr int kPairs = kChannels / 2;    // channel pairs of a CTA
constexpr int kSub = 8;                  // steps between two channel reductions of db, dc

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
  float* part_da;            // (B, I, N)
  int S, I, n_chunks;
};

// shared memory of a CTA: the states before each step of a chunk, the
// chunk's dt, x, dy (bf16) and b, c (f32), its dx and ddt, and the per-pair
// db and dc of kSub steps
template <int N>
constexpr int bwd_smem_bytes() {
  return kChunk * kChannels * N * 4 + 3 * kChunk * kChannels * 2 + 2 * kChunk * N * 4
         + 2 * kChunk * kChannels * 2 + 2 * kSub * kPairs * N * 4;
}

__device__ __forceinline__ float4 zero4() { return make_float4(0.0f, 0.0f, 0.0f, 0.0f); }

// the sum over a channel's kLanes lanes, the same bits on every lane
template <int L>
__device__ __forceinline__ float lanes_sum(float v) {
#pragma unroll
  for (int o = 1; o < L; o <<= 1) v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

template <int N>
__global__ void __launch_bounds__(kPairs * N / 4, 1) ssm_scan_bwd_kernel(const BwdArgs p) {
  constexpr int kLanes = N / 4;
  constexpr int kThreads = kPairs * kLanes;
  extern __shared__ __align__(16) unsigned char smem[];
  float4* st = reinterpret_cast<float4*>(smem);                      // [kChunk][2][kThreads]
  __nv_bfloat16* dts = reinterpret_cast<__nv_bfloat16*>(smem + kChunk * kChannels * N * 4);
  __nv_bfloat16* xs = dts + kChunk * kChannels;
  __nv_bfloat16* dys = xs + kChunk * kChannels;
  float* bf = reinterpret_cast<float*>(dys + kChunk * kChannels);    // [kChunk][N]
  float* cf = bf + kChunk * N;
  __nv_bfloat16* dxs = reinterpret_cast<__nv_bfloat16*>(cf + kChunk * N);
  __nv_bfloat16* ddts = dxs + kChunk * kChannels;
  float* red_db = reinterpret_cast<float*>(ddts + kChunk * kChannels);   // [kSub][kPairs][N]
  float* red_dc = red_db + kSub * kPairs * N;

  const int cb = blockIdx.x, c0 = cb * kChannels, row = blockIdx.y, B = gridDim.y;
  const int tid = threadIdx.x, pair = tid / kLanes, q = tid % kLanes;
  const int i0 = c0 + 2 * pair;            // the thread's first channel
  const int S = p.S, I = p.I;
  const int nv = min(max(p.n_valid[row], 0), S);
  const size_t row0 = static_cast<size_t>(row) * S;
  float* pdb = p.part_db + (static_cast<size_t>(cb) * B + row) * S * N;
  float* pdc = p.part_dc + (static_cast<size_t>(cb) * B + row) * S * N;

  float4 g[2], a2[2], av[2], dA[2];
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    g[j] = zero4();
    av[j] = zero4();
    dA[j] = zero4();
    if (i0 + j < I) {
      av[j] = *reinterpret_cast<const float4*>(p.a + static_cast<size_t>(i0 + j) * N + 4 * q);
      if (p.dh_last != nullptr) {
        g[j] = *reinterpret_cast<const float4*>(
            p.dh_last + (static_cast<size_t>(row) * I + i0 + j) * N + 4 * q);
      }
    }
    a2[j] = log2e_scaled(av[j]);
  }
  // columns past n_valid: zero gradients
  const __nv_bfloat16 zero = __float2bfloat16(0.0f);
  for (int k = tid; k < (S - nv) * kChannels; k += kThreads) {
    const int t = nv + k / kChannels, col = c0 + k % kChannels;
    if (col < I) {
      p.ddt[(row0 + t) * I + col] = zero;
      p.dx[(row0 + t) * I + col] = zero;
    }
  }
  for (int k = tid; k < (S - nv) * N; k += kThreads) {
    pdb[nv * N + k] = 0.0f;
    pdc[nv * N + k] = 0.0f;
  }

  for (int ck = (nv + kChunk - 1) / kChunk - 1; ck >= 0; --ck) {
    const int t0 = ck * kChunk;
    const int len = min(kChunk, nv - t0);
    __syncthreads();                       // the last chunk's shared memory is read
    for (int k = tid; k < len * kChannels; k += kThreads) {
      const int col = c0 + k % kChannels;
      const size_t gi = (row0 + t0 + k / kChannels) * I + col;
      dts[k] = col < I ? p.dt[gi] : zero;
      xs[k] = col < I ? p.x[gi] : zero;
      dys[k] = col < I ? p.dy[gi] : zero;
    }
    for (int k = tid; k < len * N; k += kThreads) {
      bf[k] = __bfloat162float(p.b[(row0 + t0) * N + k]);
      cf[k] = __bfloat162float(p.c[(row0 + t0) * N + k]);
    }
    __syncthreads();

    // the chunk's states, from its start state, by the forward's step
    float4 h[2];
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      h[j] = zero4();
      if (i0 + j < I) {
        h[j] = *reinterpret_cast<const float4*>(
            p.states + ((static_cast<size_t>(row) * p.n_chunks + ck) * I + i0 + j) * N + 4 * q);
      }
    }
    for (int t = 0; t < len; ++t) {
      const uint32_t dw = *reinterpret_cast<const uint32_t*>(dts + t * kChannels + 2 * pair);
      const uint32_t xw = *reinterpret_cast<const uint32_t*>(xs + t * kChannels + 2 * pair);
      const float4 bv = *reinterpret_cast<const float4*>(bf + t * N + 4 * q);
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        st[(t * 2 + j) * kThreads + tid] = h[j];
        const float d = j ? bf_hi(dw) : bf_lo(dw);
        advance(h[j], a2[j], d, __fmul_rn(d, j ? bf_hi(xw) : bf_lo(xw)), bv);
      }
    }

    // the reverse recurrence; h holds the state after step t
    for (int t = len - 1; t >= 0; --t) {
      const uint32_t dw = *reinterpret_cast<const uint32_t*>(dts + t * kChannels + 2 * pair);
      const uint32_t xw = *reinterpret_cast<const uint32_t*>(xs + t * kChannels + 2 * pair);
      const uint32_t yw = *reinterpret_cast<const uint32_t*>(dys + t * kChannels + 2 * pair);
      const float4 bv = *reinterpret_cast<const float4*>(bf + t * N + 4 * q);
      const float4 cv = *reinterpret_cast<const float4*>(cf + t * N + 4 * q);
      float4 dbp = zero4(), dcp = zero4();
      float s[2], r[2];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const float4 hp = st[(t * 2 + j) * kThreads + tid];        // h_{t-1}
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
        s[j] = __fmaf_rn(gj.w, bv.w, sj);
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
        r[j] = __fmaf_rn(w.w, av[j].w, rj);
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
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        s[j] = lanes_sum<kLanes>(s[j]);
        r[j] = lanes_sum<kLanes>(r[j]);
      }
      if (q == 0) {
        const float d0 = bf_lo(dw), d1 = bf_hi(dw);
        *reinterpret_cast<__nv_bfloat162*>(dxs + t * kChannels + 2 * pair) =
            __floats2bfloat162_rn(__fmul_rn(d0, s[0]), __fmul_rn(d1, s[1]));
        *reinterpret_cast<__nv_bfloat162*>(ddts + t * kChannels + 2 * pair) =
            __floats2bfloat162_rn(__fmaf_rn(bf_lo(xw), s[0], r[0]),
                                  __fmaf_rn(bf_hi(xw), s[1], r[1]));
      }
      const int u = t % kSub;
      *reinterpret_cast<float4*>(red_db + (u * kPairs + pair) * N + 4 * q) = dbp;
      *reinterpret_cast<float4*>(red_dc + (u * kPairs + pair) * N + 4 * q) = dcp;
      if (u == 0) {                        // steps [t, t + cnt): their sums over the pairs
        __syncthreads();
        const int cnt = min(kSub, len - t);
        for (int o = tid; o < cnt * N; o += kThreads) {
          float sb = 0.0f, sc = 0.0f;
#pragma unroll 8
          for (int pp = 0; pp < kPairs; ++pp) {
            sb = __fadd_rn(sb, red_db[((o / N) * kPairs + pp) * N + o % N]);
            sc = __fadd_rn(sc, red_dc[((o / N) * kPairs + pp) * N + o % N]);
          }
          pdb[(t0 + t) * N + o] = sb;
          pdc[(t0 + t) * N + o] = sc;
        }
        __syncthreads();
      }
    }
    // the chunk's dx and ddt (staged before the last reduction's barrier)
    for (int k = tid; k < len * kChannels; k += kThreads) {
      const int col = c0 + k % kChannels;
      if (col < I) {
        const size_t gi = (row0 + t0 + k / kChannels) * I + col;
        p.ddt[gi] = ddts[k];
        p.dx[gi] = dxs[k];
      }
    }
  }
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    if (i0 + j < I) {
      const size_t at = (static_cast<size_t>(row) * I + i0 + j) * N + 4 * q;
      *reinterpret_cast<float4*>(p.dh0 + at) = g[j];
      *reinterpret_cast<float4*>(p.part_da + at) = dA[j];
    }
  }
}

// The second launch: db and dc, the sums of the CTAs' partials over the
// channel blocks, and da, the sum of the rows' partials, each in order.
__global__ void __launch_bounds__(256) ssm_scan_bwd_fold(
    const float* part_db, const float* part_dc, const float* part_da, __nv_bfloat16* db,
    __nv_bfloat16* dc, float* da, int blocks, int B, long long bsn, long long in_) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long e = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
       e < bsn + in_; e += stride) {
    if (e < bsn) {
      float sb = 0.0f, sc = 0.0f;
      for (int k = 0; k < blocks; ++k) {
        sb = __fadd_rn(sb, part_db[k * bsn + e]);
        sc = __fadd_rn(sc, part_dc[k * bsn + e]);
      }
      db[e] = __float2bfloat16(sb);
      dc[e] = __float2bfloat16(sc);
    } else {
      const long long k = e - bsn;
      float sa = 0.0f;
      for (int r = 0; r < B; ++r) sa = __fadd_rn(sa, part_da[r * in_ + k]);
      da[k] = sa;
    }
  }
}

template <int N>
cudaError_t launch_bwd(const BwdArgs& args, int B, cudaStream_t stream) {
  // a runtime call before the launch: autograd runs the backward on a
  // thread of its own, which this makes the device's context current on
  constexpr int kBytes = bwd_smem_bytes<N>();
  cudaError_t e = cudaFuncSetAttribute(ssm_scan_bwd_kernel<N>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, kBytes);
  if (e != cudaSuccess) return e;
  const dim3 grid((args.I + kChannels - 1) / kChannels, B);
  ssm_scan_bwd_kernel<N><<<grid, kPairs * N / 4, kBytes, stream>>>(args);
  return cudaGetLastError();
}

}  // namespace

// C interface, loaded with ctypes. All tensors contiguous; dt, x, b, c, dy,
// ddt, dx, db, dc bf16; a, states, dh_last, dh0, the partials and da f32,
// 16-byte aligned; n_valid int32; dh_last may be null (zero). part_db and
// part_dc are (ceil(I / 64), B, S, N), part_da (B, I, N): scratch. N must
// be 4, 8 or 16; states (B, ceil(S / kChunk), I, N). Launches the
// backward, then the fold.
// Returns a cudaError_t (0 = launched).
extern "C" int ssm_scan_bwd_bf16(const void* dt, const void* x, const void* b, const void* c,
                                 const void* dy, const void* a, const void* states,
                                 const void* dh_last, const void* n_valid, void* ddt, void* dx,
                                 void* dh0, void* part_db, void* part_dc, void* part_da,
                                 void* db, void* dc, void* da, int B, int S, int I, int N,
                                 void* stream) {
  if (B <= 0 || B > 65535 || S <= 0 || I <= 0) {
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
  args.part_da = static_cast<float*>(part_da);
  args.S = S;
  args.I = I;
  args.n_chunks = (S + kChunk - 1) / kChunk;
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
  const long long blocks = (bsn + in_ + 255) / 256;
  ssm_scan_bwd_fold<<<static_cast<int>(blocks < 132 * 16 ? blocks : 132 * 16), 256, 0, s>>>(
      static_cast<const float*>(part_db), static_cast<const float*>(part_dc),
      static_cast<const float*>(part_da), static_cast<__nv_bfloat16*>(db),
      static_cast<__nv_bfloat16*>(dc), static_cast<float*>(da), (I + kChannels - 1) / kChannels,
      B, bsn, in_);
  return static_cast<int>(cudaGetLastError());
}
