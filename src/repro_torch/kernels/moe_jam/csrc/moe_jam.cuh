// Hopper (sm_90a) building blocks shared by the moe_jam kernels: the
// forward (moe_jam.cu) and its backward (moe_jam_bwd.cu). The item walk
// over the experts' kept rows, mbarriers with a timeout that traps, 3-D TMA
// loads, wgmma shared-memory descriptors (128-byte swizzle), the m64n128k16
// product with either operand K-major or MN-major, and the
// tensor maps over contiguous (E, rows, cols) bf16 tensors. Each source is
// its own library, so the helpers live in an unnamed namespace.
#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr unsigned long long kTimeoutNs = 2000000000ull;   // a lost barrier traps

// counts[e] clamped to [0, C], or C without counts
__device__ __forceinline__ int kept_rows(const int* counts, int e, int C) {
  return counts ? max(0, min(__ldg(counts + e), C)) : C;
}

// The items' M tiles in expert order, walked by one warp (all lanes alike):
// expert e has ceil(kept / rows) of them (rows = C: one for every expert
// with a kept row). Calls come with r non-decreasing.
struct Walker {
  int base = -32;           // first expert of the chunk of 32 in hand
  long long before = 0;     // M tiles of the experts before it
  int incl = 0;             // this lane's inclusive count in the chunk
  int mine = 0;             // M tiles of expert base + lane
  int total = 0;            // the chunk's M tiles

  // expert e and its M tile m that hold global M tile r; false past the last
  __device__ __forceinline__ bool seek(const int* counts, int E, int C, int rows, long long r,
                                       int lane, int& e, int& m) {
    while (r >= before + total) {
      before += total;
      base += 32;
      if (base >= E) return false;
      const int x = base + lane;
      mine = x < E ? (kept_rows(counts, x, C) + rows - 1) / rows : 0;
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
// K-major: SBO 1024 (the next 8 rows), LBO unused; a k16 step is +32
// bytes. MN-major (a TMA box of 64 contiguous M or N elements by 64 rows
// of the reduction): LBO the next 64 elements' box, SBO 1024 (the next 8
// rows of the reduction); a k16 step is +2048 bytes.
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

// d (64 x 128, f32) += A (64 x 16) . B (16 x 128), both from shared memory;
// kTA / kTB: A / B MN-major (transposed by the descriptor), else K-major
template <int kTA, int kTB>
__device__ __forceinline__ void wgmma(float (&d)[64], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, %67, %68;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1), "n"(kTA), "n"(kTB));
}

__device__ __forceinline__ uint32_t f2_to_bf2(float x, float y) {
  __nv_bfloat162 h = __floats2bfloat162_rn(x, y);   // x in the low half
  return *reinterpret_cast<uint32_t*>(&h);
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
// inner x box_mid mid elements of one outer index, 128-byte swizzle;
// elements past the ends read as zeros.
bool make_map(CUtensorMap* map, const void* base, int outer, int mid, int inner, int box_mid) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(inner), static_cast<cuuint64_t>(mid),
                              static_cast<cuuint64_t>(outer)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(inner) * 2,
                                 static_cast<cuuint64_t>(inner) * mid * 2};
  const cuuint32_t box[3] = {64, static_cast<cuuint32_t>(box_mid), 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(base), dims, strides,
                box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE)
         == CUDA_SUCCESS;
}

}  // namespace
