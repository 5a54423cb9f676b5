// What the selective scan's forward (ssm_scan.cu) and its backward
// (ssm_scan_bwd.cu) share: the tile sizes, the bf16 unpacking, and the
// step of the recurrence itself. The backward recomputes the forward's
// states from saved chunk states with this same step, so every state it
// differentiates at is bit for bit the one the forward computed.
#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kChannels = 64;     // channels of one row per CTA
constexpr int kSteps = 8;         // time steps per stage
// steps between two saved states: the training forward writes h where a
// chunk starts, (B, ceil(S / kChunk), I, N) float32, and the backward
// recomputes one chunk's states at a time from there (the wrappers'
// ref.CHUNK, which a CPU test holds to this line)
constexpr int kChunk = 32;
static_assert(kChunk % kSteps == 0, "a chunk is whole stages");
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float bf_lo(uint32_t w) { return __uint_as_float(w << 16); }
__device__ __forceinline__ float bf_hi(uint32_t w) { return __uint_as_float(w & 0xffff0000u); }

// One step of the four states a lane holds of one channel:
//   h = exp(d a) h + (d x) b,
// exp as ex2.approx of d * (a log2 e) (a2 holds a * log2 e), dx = d * x
// already rounded. Every product explicit and in one order, so the step
// gives the same bits wherever it runs.
__device__ __forceinline__ void advance(float4& h, const float4& a2, float d, float dx,
                                        const float4& bv) {
  h.x = __fmaf_rn(ex2(__fmul_rn(d, a2.x)), h.x, __fmul_rn(dx, bv.x));
  h.y = __fmaf_rn(ex2(__fmul_rn(d, a2.y)), h.y, __fmul_rn(dx, bv.y));
  h.z = __fmaf_rn(ex2(__fmul_rn(d, a2.z)), h.z, __fmul_rn(dx, bv.z));
  h.w = __fmaf_rn(ex2(__fmul_rn(d, a2.w)), h.w, __fmul_rn(dx, bv.w));
}

// a * log2 e, as both kernels scale a once
__device__ __forceinline__ float4 log2e_scaled(const float4& a) {
  return make_float4(__fmul_rn(a.x, kLog2e), __fmul_rn(a.y, kLog2e), __fmul_rn(a.z, kLog2e),
                     __fmul_rn(a.w, kLog2e));
}

}  // namespace
