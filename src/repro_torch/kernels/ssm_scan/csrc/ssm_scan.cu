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
// What bounds it on an H100: bytes, and next to them the exponentials. At
// the serving engine's full prefill (32 rows x 32 steps x 1536 channels,
// N = 16) it must move ~15.9 MB (dt, x, y, h0, h_last), 4.7 us at 3.35
// TB/s, against ~176 M float32 operations (2.6 us at 67 TFLOP/s); its
// 25.2 M exponentials take ~6.0 us on the SFUs (16 per SM per clock at
// 1.98 GHz). A decode step moves ~6.7 MB, nearly all of it state (h0 in,
// h_last out), plus the 3.05 MB of zeros past n_valid that the contract
// asks for and the bound does not count.
//
// What held v1 back (0.0267 ms on chip_smoke's check input, bench 0.0276
// full and 0.0115 decode; NVIDIA H100 80GB HBM3, 700.00 W): one thread per
// (row, channel) holding all N states, so 49,152 threads at the engine's
// shape (12 warps an SM, ~18% of the warp slots), each running 32 steps x
// 16 accurate expf in sequence; h0, a and h_last moved as float4 at a
// 64-byte stride between lanes (32 half-used sectors a warp access); dt,
// x, b and c were staged in one synchronous round of 2-byte loads before
// the first step, so loads and the recurrence never overlapped; and the
// zero tail went out one bf16 per thread per step.
//
// v2 (this design):
//   * Lanes across the state, two channels a lane: N/4 lanes hold a pair of
//     channels, each lane one float4 of h and of a * log2(e) for each of
//     the two (8 states; 4 lanes, 8 channel pairs a warp at N = 16). The
//     pair shares each step's b and c loads from shared memory: one lane a
//     channel issued twice the shared-memory loads per state, and those, not
//     the exponentials, bounded it. h0, a and h_last move as 16-byte
//     accesses a lane. y of 4 steps (N/4 at N < 16) is reduced over the
//     lanes in one butterfly (3 shuffles at N = 16), after which lane q
//     holds step q's sum for both channels. A CTA is one row x 64 channels
//     (128 threads at N = 16): 768 CTAs at the engine's shape, all
//     resident at once (at most 80 registers a thread).
//   * Rows longest first: warp 0 ranks the rows by n_valid (B <= 32) and
//     the CTA takes the one ranked blockIdx.y. CTAs reach the SMs in launch
//     order, so every SM gets a share of the long rows; in row order an SM
//     drew whichever rows its CTA numbers fell on, and the most loaded SMs
//     set the time.
//   * Stages of 8 time steps in a ring of 4 slots of shared memory (18 KB
//     a CTA). Route "tma": one thread issues TMA box loads for the row's
//     valid prefix only, a stage completing on its own mbarrier, so step 0
//     starts while later stages are in flight; dt and x come as boxes of 8
//     steps x 64 channels over (B*S, I) (1 step a box for a ragged last
//     stage), b and c as boxes of 8 steps x N over (B*S, N), converted to
//     float32 once a stage. A slot is loaded again once every thread has
//     passed the stage that read it. Route "direct", where a map cannot
//     take the inputs (N = 4, I not a multiple of 8, a base off 16 bytes):
//     the CTA's threads load each stage into the same slots themselves,
//     then compute it. At the engine's shape the direct route takes 8-21%
//     longer than the TMA route (ssm_scan bench, x 2 bytes off a 16-byte
//     boundary; PERF.md): its loads and steps do not overlap.
//   * y is staged in shared memory (8 steps x 64 channels a stage) and
//     written out with 16-byte stores (2-byte ones on the direct route),
//     zero tail included.
//   * exp is ex2.approx.ftz of dt * (a * log2 e), one MUFU.EX2 with no
//     range reduction; 16 of them an SM a clock bound the busy phase.
//     Every step's products are explicit (__fmul_rn, __fmaf_rn) and summed
//     in one fixed order, so a step's arithmetic is the same wherever a
//     stage boundary falls, and a scan split in two equals the whole one
//     bit for bit.
//
// The training forward is a second instance of the same kernel
// (kSave): it also writes h where each chunk of kChunk = 32 steps starts,
// (B, ceil(S / 32), I, N) float32 (h0 for the first; h_last for chunks
// past the row's last stage), which the backward (ssm_scan_bwd.cu)
// recomputes each chunk's states from. A state is written at the end of
// the stage before its chunk, after that stage's y: written at the top of
// the chunk's first stage, just before the wait for its inputs, the same
// stores made the instance 20% slower than the serving one at a training
// micro-batch (2 x 4,096 x 1,536); here it is 3.5% slower (NVIDIA H100
// 80GB HBM3, 700 W; the instruction mix is the same). The serving
// instances compile to the code they had: the writes are under
// `if constexpr`. The step itself lives in ssm_scan.cuh, which both
// kernels include.
//
// What a later design changes: the state's load (h0 is most of the bytes,
// and no step starts before it lands) overlapped with the previous layer's
// work, a chunked parallel scan over time for long prefill chunks, and
// fusing the causal conv, dt's softplus and the d_skip / silu(z) gate
// around the scan so dt, x and y never round-trip through device memory.

#include "ssm_scan.cuh"

namespace {

constexpr int kStages = 4;        // slots of the ring
constexpr int kRowBytes = kChannels * 2;                 // one step of dt, x or y
constexpr int kTileBytes = kSteps * kRowBytes;           // 1 KB
constexpr int kBcBytes = kSteps * 16 * 2;                // b or c of a stage, N <= 16
constexpr int kBcFloatBytes = kSteps * 16 * 4;           // the same in float32
// a slot: dt, x, b, c (bf16, as loaded), b and c in float32, y; every
// part 128-byte aligned (TMA destinations)
constexpr int kDtOff = 0, kXOff = kTileBytes, kBOff = 2 * kTileBytes,
              kCOff = kBOff + kBcBytes, kBfOff = kCOff + kBcBytes,
              kCfOff = kBfOff + kBcFloatBytes, kYOff = kCfOff + kBcFloatBytes,
              kSlotBytes = kYOff + kTileBytes;
constexpr unsigned long long kTimeoutNs = 2000000000ull;   // a lost barrier traps

struct Maps {                     // TMA maps (route "tma"; unused on "direct")
  CUtensorMap dt8, dt1, x8, x1, b8, c8;
};

struct Args {
  const __nv_bfloat16* dt;
  const __nv_bfloat16* x;
  const __nv_bfloat16* b;
  const __nv_bfloat16* c;
  const float* a;
  const float* h0;
  const int* n_valid;
  __nv_bfloat16* y;
  float* h_last;
  float* states;                  // (B, n_chunks, I, N) f32, kSave only
  int S, I, n_chunks;
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

__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1) {
  asm volatile("cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
               "[%0], [%1, {%2, %3}], [%4];"
               :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(bar)
               : "memory");
}

// Stage s (steps [8 s, 8 s + len)) of a row into its slot by TMA: dt and x
// as one 8-step box each (one 1-step box a step when len < 8), b and c as
// one 8-step box each.
template <int N>
__device__ __forceinline__ void issue_stage(const Maps& m, uint32_t slot, uint32_t bar,
                                            int c0, int r0, int len) {
  const uint32_t tile = len == kSteps ? kTileBytes : len * kRowBytes;
  mbar_expect(bar, 2 * tile + 2 * kSteps * N * 2);
  if (len == kSteps) {
    tma_load_2d(slot + kDtOff, &m.dt8, bar, c0, r0);
    tma_load_2d(slot + kXOff, &m.x8, bar, c0, r0);
  } else {
    for (int k = 0; k < len; ++k) {
      tma_load_2d(slot + kDtOff + k * kRowBytes, &m.dt1, bar, c0, r0 + k);
      tma_load_2d(slot + kXOff + k * kRowBytes, &m.x1, bar, c0, r0 + k);
    }
  }
  tma_load_2d(slot + kBOff, &m.b8, bar, 0, r0);
  tma_load_2d(slot + kCOff, &m.c8, bar, 0, r0);
}

// y of steps [t, t + L) of a channel, L = N / 4 (the channel's lanes):
// lane q holds its partial dots acc[0..L) of those steps; after log2(L)
// exchanges lane q holds the whole sum of step t + q. A step's sum is
// (a0 + a2) + (a1 + a3) of the lanes' partials (a0 + a1 at N = 8) whichever
// lane ends with it, so it does not depend on where the step falls.
template <int L>
__device__ __forceinline__ float lane_sums(const float (&acc)[L], int q) {
  if constexpr (L == 4) {
    const bool hi = q & 2;
    float k0 = hi ? acc[2] : acc[0], k1 = hi ? acc[3] : acc[1];
    k0 = __fadd_rn(k0, __shfl_xor_sync(0xffffffffu, hi ? acc[0] : acc[2], 2));
    k1 = __fadd_rn(k1, __shfl_xor_sync(0xffffffffu, hi ? acc[1] : acc[3], 2));
    const bool odd = q & 1;
    return __fadd_rn(odd ? k1 : k0, __shfl_xor_sync(0xffffffffu, odd ? k0 : k1, 1));
  } else if constexpr (L == 2) {
    const bool odd = q & 1;
    return __fadd_rn(odd ? acc[1] : acc[0],
                     __shfl_xor_sync(0xffffffffu, odd ? acc[0] : acc[1], 1));
  } else {
    return acc[0];
  }
}

// One step t of a lane: advance the four states it holds of each of its
// two channels (2 pair, 2 pair + 1), return their partial dots with c_t.
template <int N>
__device__ __forceinline__ float2 scan_step(float4 (&h)[2], const float4 (&a2)[2],
                                            const __nv_bfloat16* dts, const __nv_bfloat16* xs,
                                            const float* bf, const float* cf, int t, int pair,
                                            int q) {
  const uint32_t dw = *reinterpret_cast<const uint32_t*>(dts + t * kChannels + 2 * pair);
  const uint32_t xw = *reinterpret_cast<const uint32_t*>(xs + t * kChannels + 2 * pair);
  const float4 bv = *reinterpret_cast<const float4*>(bf + t * N + 4 * q);
  const float4 cv = *reinterpret_cast<const float4*>(cf + t * N + 4 * q);
  float acc[2];
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const float d = j ? bf_hi(dw) : bf_lo(dw);
    advance(h[j], a2[j], d, __fmul_rn(d, j ? bf_hi(xw) : bf_lo(xw)), bv);
    acc[j] = __fmul_rn(h[j].x, cv.x);
    acc[j] = __fmaf_rn(h[j].y, cv.y, acc[j]);
    acc[j] = __fmaf_rn(h[j].z, cv.z, acc[j]);
    acc[j] = __fmaf_rn(h[j].w, cv.w, acc[j]);
  }
  return make_float2(acc[0], acc[1]);
}

// The state entering chunk k of a row: the thread's four states of each
// of its two channels.
template <int N>
__device__ __forceinline__ void save_state(const Args& p, const float4 (&h)[2], int row, int k,
                                           int i0, int q) {
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    if (i0 + j < p.I) {
      *reinterpret_cast<float4*>(
          p.states + ((static_cast<size_t>(row) * p.n_chunks + k) * p.I + i0 + j) * N + 4 * q)
          = h[j];
    }
  }
}

// One CTA: one row, channels [64 blockIdx.x, + 64). Thread t holds state
// elements [4 q, 4 q + 4) of channels 2 pair and 2 pair + 1, pair = t / (N
// / 4), q = t % (N / 4): the two channels share each step's b and c loads.
// kSave: also write h where each chunk starts (Args::states).
template <int N, bool kTma, bool kSave>
__global__ void __launch_bounds__(kChannels / 2 * N / 4, 768 / (kChannels / 2 * N / 4))
ssm_scan_kernel(const __grid_constant__ Maps maps, const Args p) {
  constexpr int kLanes = N / 4;                 // lanes a channel pair, steps a y exchange
  constexpr int kThreads = kChannels / 2 * kLanes;
  __shared__ __align__(128) unsigned char smem[kStages * kSlotBytes];
  __shared__ __align__(8) unsigned long long bars[kStages];
  __shared__ int rank_row;

  const int c0 = blockIdx.x * kChannels;
  const int tid = threadIdx.x, lane = tid % 32;
  const int pair = tid / kLanes, q = tid % kLanes;
  const int i0 = c0 + 2 * pair;                 // the thread's first channel
  const int S = p.S, I = p.I, B = gridDim.y;
  const uint32_t ring = smem_u32(smem);
  const uint32_t full = smem_u32(bars);

  if constexpr (kTma) {
    if (tid == 0) {
      for (int s = 0; s < kStages; ++s) mbar_init(full + 8 * s, 1);
      asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    }
  }
  // Rows longest first (B <= 32; else in order): CTAs are dealt to the SMs
  // in launch order, so each SM gets a share of the long rows instead of
  // whichever rows its CTA numbers fall on. Warp 0 ranks the rows by
  // (n_valid descending, index) and draws the one ranked blockIdx.y.
  int row = blockIdx.y;
  if (B <= 32) {
    if (tid < 32) {
      const int v = lane < B ? min(max(p.n_valid[lane], 0), S) : -1;
      int rank = 0;
#pragma unroll
      for (int o = 0; o < 32; ++o) {
        const int w = __shfl_sync(0xffffffffu, v, o);
        rank += o < B && (w > v || (w == v && o < lane));
      }
      const unsigned hit = __ballot_sync(0xffffffffu, lane < B && rank == row);
      if (lane == 0) rank_row = __ffs(hit) - 1;
    }
    __syncthreads();                            // also publishes the barriers' init
    row = rank_row;
  } else {
    __syncthreads();
  }
  const int nv = min(max(p.n_valid[row], 0), S);
  const int stages = (nv + kSteps - 1) / kSteps;
  const size_t y_row0 = static_cast<size_t>(row) * S;       // y row of (row, t = 0)
  const size_t state0 = (static_cast<size_t>(row) * I + i0) * N + 4 * q;   // h0 of channel i0

  if constexpr (kTma) {
    if (tid == 0) {
      for (int s = 0; s < min(stages, kStages); ++s) {
        issue_stage<N>(maps, ring + s * kSlotBytes, full + 8 * s, c0, row * S + s * kSteps,
                       min(kSteps, nv - s * kSteps));
      }
    }
  }
  float4 h[2], a2[2];
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    h[j] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    a2[j] = h[j];
    if (i0 + j < I) {
      h[j] = *reinterpret_cast<const float4*>(p.h0 + state0 + j * N);
      a2[j] = log2e_scaled(*reinterpret_cast<const float4*>(
          p.a + static_cast<size_t>(i0 + j) * N + 4 * q));
    }
  }
  // y past n_valid is zero; written while the loads are in flight (16-byte
  // stores on the TMA route, where I % 8 == 0: a row's 64 channels start on
  // a 16-byte boundary and end on one)
  if constexpr (kTma) {
    for (int k = tid; k < (S - nv) * (kChannels / 8); k += kThreads) {
      const int t = nv + k / (kChannels / 8), col = c0 + (k % (kChannels / 8)) * 8;
      if (col < I) {
        *reinterpret_cast<uint4*>(p.y + (y_row0 + t) * I + col) = make_uint4(0, 0, 0, 0);
      }
    }
  } else {
    for (int k = tid; k < (S - nv) * kChannels; k += kThreads) {
      const int t = nv + k / kChannels, col = c0 + k % kChannels;
      if (col < I) p.y[(y_row0 + t) * I + col] = __float2bfloat16(0.0f);
    }
  }

  if constexpr (kSave) save_state<N>(p, h, row, 0, i0, q);
  for (int s = 0; s < stages; ++s) {
    const int t0 = s * kSteps;
    const int len = min(kSteps, nv - t0);
    unsigned char* slot = smem + (s % kStages) * kSlotBytes;
    const __nv_bfloat16* dts = reinterpret_cast<const __nv_bfloat16*>(slot + kDtOff);
    const __nv_bfloat16* xs = reinterpret_cast<const __nv_bfloat16*>(slot + kXOff);
    const __nv_bfloat16* bs = reinterpret_cast<const __nv_bfloat16*>(slot + kBOff);
    const __nv_bfloat16* cs = reinterpret_cast<const __nv_bfloat16*>(slot + kCOff);
    float* bf = reinterpret_cast<float*>(slot + kBfOff);
    float* cf = reinterpret_cast<float*>(slot + kCfOff);
    __nv_bfloat16* ys = reinterpret_cast<__nv_bfloat16*>(slot + kYOff);
    if constexpr (kTma) {
      mbar_wait(full + 8 * (s % kStages), (s / kStages) & 1);
    } else {
      __nv_bfloat16* dtw = reinterpret_cast<__nv_bfloat16*>(slot + kDtOff);
      __nv_bfloat16* xw = reinterpret_cast<__nv_bfloat16*>(slot + kXOff);
      for (int k = tid; k < len * kChannels; k += kThreads) {
        const int t = k / kChannels, col = c0 + k % kChannels;
        const size_t g = (y_row0 + t0 + t) * I + col;
        const __nv_bfloat16 zero = __float2bfloat16(0.0f);
        dtw[k] = col < I ? p.dt[g] : zero;
        xw[k] = col < I ? p.x[g] : zero;
      }
      __nv_bfloat16* bw = reinterpret_cast<__nv_bfloat16*>(slot + kBOff);
      __nv_bfloat16* cw = reinterpret_cast<__nv_bfloat16*>(slot + kCOff);
      for (int k = tid; k < len * N; k += kThreads) {
        bw[k] = p.b[(y_row0 + t0) * N + k];
        cw[k] = p.c[(y_row0 + t0) * N + k];
      }
      __syncthreads();
    }
    // b and c to float32 once a stage, not once a lane a step
    for (int k = tid; k < kSteps * N; k += kThreads) {
      bf[k] = __bfloat162float(bs[k]);
      cf[k] = __bfloat162float(cs[k]);
    }
    __syncthreads();

    // kLanes steps a round; steps past len change no state and write no y
    for (int tt = 0; tt < len; tt += kLanes) {
      float acc0[kLanes], acc1[kLanes];
      if (tt + kLanes <= len) {                 // uniform: no step of the round is masked
#pragma unroll
        for (int u = 0; u < kLanes; ++u) {
          const float2 a = scan_step<N>(h, a2, dts, xs, bf, cf, tt + u, pair, q);
          acc0[u] = a.x;
          acc1[u] = a.y;
        }
      } else {
#pragma unroll
        for (int u = 0; u < kLanes; ++u) {
          float2 a = make_float2(0.0f, 0.0f);
          if (tt + u < len) a = scan_step<N>(h, a2, dts, xs, bf, cf, tt + u, pair, q);
          acc0[u] = a.x;
          acc1[u] = a.y;
        }
      }
      const float y0 = lane_sums<kLanes>(acc0, q), y1 = lane_sums<kLanes>(acc1, q);
      if (tt + q < len) {
        *reinterpret_cast<__nv_bfloat162*>(ys + (tt + q) * kChannels + 2 * pair) =
            __floats2bfloat162_rn(y0, y1);
      }
    }
    __syncthreads();                            // the slot is read; its y is written
    if constexpr (kTma) {
      if (tid == 0 && s + kStages < stages) {
        const int t1 = (s + kStages) * kSteps;
        issue_stage<N>(maps, ring + (s % kStages) * kSlotBytes, full + 8 * (s % kStages), c0,
                       row * S + t1, min(kSteps, nv - t1));
      }
      for (int k = tid; k < len * (kChannels / 8); k += kThreads) {
        const int t = k / (kChannels / 8), col = c0 + (k % (kChannels / 8)) * 8;
        if (col < I) {
          *reinterpret_cast<uint4*>(p.y + (y_row0 + t0 + t) * I + col) =
              *reinterpret_cast<const uint4*>(ys + t * kChannels + col - c0);
        }
      }
    } else {
      for (int k = tid; k < len * kChannels; k += kThreads) {
        const int t = k / kChannels, col = c0 + k % kChannels;
        if (col < I) p.y[(y_row0 + t0 + t) * I + col] = ys[k];
      }
    }
    if constexpr (kSave) {
      if ((t0 + kSteps) % kChunk == 0 && (t0 + kSteps) / kChunk < p.n_chunks) {
        save_state<N>(p, h, row, (t0 + kSteps) / kChunk, i0, q);
      }
    }
  }
  if constexpr (kSave) {             // chunks that start past the last stage
    for (int k = kSteps * stages / kChunk + 1; k < p.n_chunks; ++k) {
      save_state<N>(p, h, row, k, i0, q);
    }
  }
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    if (i0 + j < I) {
      *reinterpret_cast<float4*>(p.h_last + state0 + j * N) = h[j];
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

// A 2-D map over a contiguous bf16 (rows, cols) tensor: boxes of box_cols x
// box_rows, no swizzle; elements past the ends read as zeros.
bool make_map(CUtensorMap* map, const void* base, long long rows, int cols, int box_cols,
              int box_rows) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(cols) * 2};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(box_cols),
                             static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t elem[2] = {1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(base), dims, strides,
                box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE)
         == CUDA_SUCCESS;
}

bool aligned16(const void* ptr) { return reinterpret_cast<uintptr_t>(ptr) % 16 == 0; }

template <int N, bool kSave>
cudaError_t launch(const Args& args, int B, bool tma, cudaStream_t stream) {
  const dim3 grid((args.I + kChannels - 1) / kChannels, B);
  constexpr int kThreads = kChannels / 2 * N / 4;
  if constexpr (kSave) {
    // autograd may run this (a recompute under remat) on a thread with no
    // current context, where no tensor map can be encoded: a runtime call
    // first makes the device's primary context current
    cudaFuncAttributes attr;
    const cudaError_t e = cudaFuncGetAttributes(&attr, ssm_scan_kernel<N, true, kSave>);
    if (e != cudaSuccess) return e;
  }
  Maps maps = {};
  if (tma) {
    const long long rows = static_cast<long long>(B) * args.S;
    if (!make_map(&maps.dt8, args.dt, rows, args.I, kChannels, kSteps)
        || !make_map(&maps.dt1, args.dt, rows, args.I, kChannels, 1)
        || !make_map(&maps.x8, args.x, rows, args.I, kChannels, kSteps)
        || !make_map(&maps.x1, args.x, rows, args.I, kChannels, 1)
        || !make_map(&maps.b8, args.b, rows, N, N, kSteps)
        || !make_map(&maps.c8, args.c, rows, N, N, kSteps)) {
      return cudaErrorInvalidValue;
    }
    ssm_scan_kernel<N, true, kSave><<<grid, kThreads, 0, stream>>>(maps, args);
  } else {
    ssm_scan_kernel<N, false, kSave><<<grid, kThreads, 0, stream>>>(maps, args);
  }
  return cudaGetLastError();
}

}  // namespace

// C interface, loaded with ctypes. All tensors contiguous; dt, x, b, c, y
// bf16, a, h0, h_last f32 and 16-byte aligned, n_valid int32. N must be 4,
// 8 or 16. route 1 ("tma") needs N in {8, 16}, I % 8 == 0 and dt, x, b, c
// and y on 16-byte boundaries; route 0 ("direct") takes any input.
// states: null (serving), or (B, ceil(S / kChunk), I, N) f32, 16-byte
// aligned, for the state entering each chunk of kChunk steps.
// Returns a cudaError_t (0 = launched).
extern "C" int ssm_scan_bf16(const void* dt, const void* x, const void* b, const void* c,
                             const void* a, const void* h0, const void* n_valid, void* y,
                             void* h_last, void* states, int B, int S, int I, int N,
                             int route, void* stream) {
  const bool tma = route == 1;
  if (B <= 0 || B > 65535 || S <= 0 || I <= 0 || (route != 0 && route != 1)
      || (tma && (N == 4 || I % 8 != 0 || !aligned16(dt) || !aligned16(x) || !aligned16(b)
                  || !aligned16(c) || !aligned16(y)))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Args args;
  args.dt = static_cast<const __nv_bfloat16*>(dt);
  args.x = static_cast<const __nv_bfloat16*>(x);
  args.b = static_cast<const __nv_bfloat16*>(b);
  args.c = static_cast<const __nv_bfloat16*>(c);
  args.a = static_cast<const float*>(a);
  args.h0 = static_cast<const float*>(h0);
  args.n_valid = static_cast<const int*>(n_valid);
  args.y = static_cast<__nv_bfloat16*>(y);
  args.h_last = static_cast<float*>(h_last);
  args.states = static_cast<float*>(states);
  args.S = S;
  args.I = I;
  args.n_chunks = (S + kChunk - 1) / kChunk;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool save = states != nullptr;
  switch (N) {
    case 4: return static_cast<int>(save ? launch<4, true>(args, B, tma, s)
                                         : launch<4, false>(args, B, tma, s));
    case 8: return static_cast<int>(save ? launch<8, true>(args, B, tma, s)
                                         : launch<8, false>(args, B, tma, s));
    case 16: return static_cast<int>(save ? launch<16, true>(args, B, tma, s)
                                          : launch<16, false>(args, B, tma, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
