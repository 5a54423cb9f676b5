// Selective scan over a chunk of time steps, gated per row, for Hopper
// (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/ssm_scan/kernel.py
// (ssm_scan_pallas, body _ssm_scan_kernel), with the per-column valid gate
// of src/repro/models/ssm.py (ssm_forward) folded in. For every row b and
// channel i, with the (N,) state h kept in float32:
//   h_t = exp(dt_t * a[i, :]) * h_{t-1} + (dt_t * x_t) * b_t[:]
//   y_t = sum_n h_t[n] * c_t[n]                      for t < n_valid[b]
// Inputs dt, x (B, S, I) and b, c (B, S, N) bf16; a (I, N) f32; h0
// (B, I, N) f32; n_valid (B,) int32. The serving layout is always a valid
// prefix, so n_valid carries the whole mask. Outputs y (B, S, I) bf16,
// zero at t >= n_valid[b] (garbage by contract), and h_last (B, I, N) f32,
// the state after column n_valid[b] - 1, or h0 bit for bit where
// n_valid[b] == 0.
//
// Design (simple first: one thread per (row, channel)):
//   * Grid (B, ceil(I / 128)), 128 threads. Thread i of a CTA owns channel
//     i of one row and keeps its N state values and a[i, :] in registers
//     for the whole scan; the TPU kernel keeps the (I, N) state in VMEM
//     scratch across a sequential grid axis, here no state leaves the
//     thread until h_last.
//   * The row's b and c, and the CTA's dt and x, are staged into shared
//     memory 32 time steps at a time, every load issued before the first
//     step needs one (the steps depend on each other, the loads do not);
//     every thread then reads the same b_t, c_t (broadcast) and its own
//     column of dt and x. dt, x and y are read and written once,
//     coalesced across channels; h0, a and h_last move as float4.
//   * The loop runs only to n_valid[b]: a decode row (n_valid 1) does one
//     step, an idle row none, and neither reads dt or x past it.
//   * exp is expf (the accurate one, not __expf); the products are left to
//     the compiler's fused multiply-adds, so h differs from the plain
//     version (separate multiply and add, y as an einsum) in the last bits.
//
// What bounds it on an H100: bytes. At the serving engine's full prefill
// (32 rows x 32 steps x 1536 channels, N = 16) it must move ~15.9 MB (dt,
// x, y, h0, h_last), 4.7 us at 3.35 TB/s, against ~176 M float32
// operations (2.6 us at 67 TFLOP/s); its 25.2 M exponentials alone take
// ~6 us on the SFUs (16 per SM per clock). A decode step moves ~6.7 MB,
// nearly all of it state (h0 in, h_last out).
//
// What a later design changes: split N over lanes (more threads in flight
// per row, fewer registers each), a chunked parallel scan over time for
// long prefill chunks, and fusing the causal conv, dt's softplus and the
// d_skip / silu(z) gate around the scan so dt, x and y never round-trip
// through device memory.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;   // channels per CTA
constexpr int kTile = 32;       // time steps of b and c staged per round

template <int N>
__device__ __forceinline__ void load_row(float (&dst)[N], const float* src) {
  const float4* v = reinterpret_cast<const float4*>(src);
#pragma unroll
  for (int q = 0; q < N / 4; ++q) {
    const float4 f = v[q];
    dst[4 * q] = f.x; dst[4 * q + 1] = f.y; dst[4 * q + 2] = f.z; dst[4 * q + 3] = f.w;
  }
}

template <int N>
__global__ void __launch_bounds__(kThreads)
ssm_scan_kernel(const __nv_bfloat16* __restrict__ dt,
                const __nv_bfloat16* __restrict__ x,
                const __nv_bfloat16* __restrict__ bm,
                const __nv_bfloat16* __restrict__ cm,
                const float* __restrict__ a, const float* __restrict__ h0,
                const int* __restrict__ n_valid, __nv_bfloat16* __restrict__ y,
                float* __restrict__ h_last, int S, int I) {
  static_assert(N % 4 == 0, "h0, a and h_last move as float4");
  __shared__ float b_s[kTile * N];
  __shared__ float c_s[kTile * N];
  __shared__ __nv_bfloat16 dt_s[kTile][kThreads];
  __shared__ __nv_bfloat16 x_s[kTile][kThreads];

  const int row = blockIdx.x;
  const int i = blockIdx.y * kThreads + threadIdx.x;
  const bool live = i < I;
  const int nv = min(max(n_valid[row], 0), S);

  float h[N] = {};
  float an[N] = {};
  const size_t state = (static_cast<size_t>(row) * I + i) * N;
  if (live) {
    load_row<N>(h, h0 + state);
    load_row<N>(an, a + static_cast<size_t>(i) * N);
  }

  const size_t base = static_cast<size_t>(row) * S * I + i;   // (row, t=0, i)
  for (int t0 = 0; t0 < nv; t0 += kTile) {                     // nv is uniform in the CTA
    const int len = min(kTile, nv - t0);
    const size_t bc = (static_cast<size_t>(row) * S + t0) * N;
    for (int k = threadIdx.x; k < len * N; k += kThreads) {
      b_s[k] = __bfloat162float(bm[bc + k]);
      c_s[k] = __bfloat162float(cm[bc + k]);
    }
    if (live) {
#pragma unroll 8
      for (int tt = 0; tt < len; ++tt) {
        const size_t g = base + static_cast<size_t>(t0 + tt) * I;
        dt_s[tt][threadIdx.x] = dt[g];
        x_s[tt][threadIdx.x] = x[g];
      }
    }
    __syncthreads();
    if (live) {
      for (int tt = 0; tt < len; ++tt) {
        const size_t g = base + static_cast<size_t>(t0 + tt) * I;
        const float d = __bfloat162float(dt_s[tt][threadIdx.x]);
        const float dx = d * __bfloat162float(x_s[tt][threadIdx.x]);
        float acc = 0.0f;
#pragma unroll
        for (int n = 0; n < N; ++n) {
          h[n] = expf(d * an[n]) * h[n] + dx * b_s[tt * N + n];
          acc += h[n] * c_s[tt * N + n];
        }
        y[g] = __float2bfloat16(acc);
      }
    }
    __syncthreads();
  }

  if (live) {
    const __nv_bfloat16 zero = __float2bfloat16(0.0f);
    for (int t = nv; t < S; ++t) y[base + static_cast<size_t>(t) * I] = zero;
    float4* out = reinterpret_cast<float4*>(h_last + state);
#pragma unroll
    for (int q = 0; q < N / 4; ++q) {
      out[q] = make_float4(h[4 * q], h[4 * q + 1], h[4 * q + 2], h[4 * q + 3]);
    }
  }
}

template <int N>
cudaError_t launch(const void* dt, const void* x, const void* b, const void* c,
                   const void* a, const void* h0, const void* n_valid, void* y,
                   void* h_last, int B, int S, int I, cudaStream_t stream) {
  const dim3 grid(B, (I + kThreads - 1) / kThreads);
  ssm_scan_kernel<N><<<grid, kThreads, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(dt), static_cast<const __nv_bfloat16*>(x),
      static_cast<const __nv_bfloat16*>(b), static_cast<const __nv_bfloat16*>(c),
      static_cast<const float*>(a), static_cast<const float*>(h0),
      static_cast<const int*>(n_valid), static_cast<__nv_bfloat16*>(y),
      static_cast<float*>(h_last), S, I);
  return cudaGetLastError();
}

}  // namespace

// C interface, loaded with ctypes. All tensors contiguous; dt, x, b, c, y
// bf16, a, h0, h_last f32 and 16-byte aligned, n_valid int32. N must be 4,
// 8 or 16. Returns a cudaError_t (0 = launched).
extern "C" int ssm_scan_bf16(const void* dt, const void* x, const void* b,
                             const void* c, const void* a, const void* h0,
                             const void* n_valid, void* y, void* h_last,
                             int B, int S, int I, int N, void* stream) {
  if (B <= 0 || S <= 0 || I <= 0 || (I + kThreads - 1) / kThreads > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (N) {
    case 4: return static_cast<int>(launch<4>(dt, x, b, c, a, h0, n_valid, y, h_last, B, S, I, s));
    case 8: return static_cast<int>(launch<8>(dt, x, b, c, a, h0, n_valid, y, h_last, B, S, I, s));
    case 16: return static_cast<int>(launch<16>(dt, x, b, c, a, h0, n_valid, y, h_last, B, S, I, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
