// The two active-message handlers of the paper (§VI-B), over blocks of
// frames, for Hopper (sm_90a).
//
// Replaces the TPU kernels of src/repro/kernels/mailbox/kernel.py:
//   * sum_drain_pallas (body _sum_kernel): Server-Side Sum. Frames (N, W)
//     int32 -> sums (N,) int32, the wrap-around sum of each frame's USR
//     words [usr_off, usr_off + pw).
//   * indirect_put_pallas (body _indirect_put_kernel): Indirect Put (Fig. 4).
//     USR = [key, data...]. Frame i, in order, writes
//       idx = floormod(floormod(key, slots) + got[0], slots)
//       table[idx] = [key, idx];  heap[idx, :] = data
//     into the server's table (slots, 2) and heap (slots, pw - 1) int32, in
//     place (the TPU kernel aliases them in and out: the server's memory
//     mutates). got[0] is the GOT-resolved heap base, read on the device.
//
// What bounds them on an H100: bytes; neither does arithmetic worth
// counting. At the frame path of chip_smoke.py (2^20 frames of 32 words,
// pw 16): the sum must read 64 B of USR and write 4 B per frame (~71 MB,
// ~21 us at 3.35 TB/s); the put must read every key and, for each row's
// last writer, its data, and write that row's 68 B (at most ~138 MB,
// ~41 us). Neither uses a tensor core.
//
// Design (simple first; v2 after the first measurement):
//   * Sum: one group of G lanes per frame, G = 16 when pw <= 16 (two frames
//     per warp) else 32. Lane l loads USR words l, l + G, ... (neighbouring
//     lanes on neighbouring words; scalar loads, since usr_off need not be
//     16-byte aligned), accumulates in uint32 (signed overflow is undefined
//     in C++, unsigned wraps, which is the int32 wrap of the reference) and
//     the group reduces with __shfl_xor_sync. v2: each group takes 4 frames
//     a round and issues all their loads before the first shuffle (v1 had
//     one load in flight per lane). The TPU kernel pads N to a tile of 8
//     rows (_drain_geometry); here any N, any pw, any usr_off.
//   * Put, last writer wins, in parallel: three launches on one stream over
//     an int32 scratch of one word per table row (4 B per slot, allocated by
//     the wrapper, nothing kept between calls, nothing cleared over all rows):
//       1. mark:  last[row_i] = -1 for every frame i;
//       2. claim: atomicMax(&last[row_i], i): each touched row ends with the
//          index of its last frame;
//       3. write: one group of lanes per frame; the frame with
//          i == last[row_i] writes its table row and pw - 1 heap words.
//     That is the sequential result exactly, and only the winners write.
//     Each pass reads the key again (its sector mostly still in L2). The
//     row is a floor modulo: CUDA's % truncates, so a negative key would
//     index below the table, and key % slots + got[0] may leave int32's
//     range. v1 took two 64-bit modulos per frame and pass; v2 one 32-bit
//     modulo and a subtraction (put_row). (A v2 candidate that kept each
//     frame's row in a second scratch, read back coalesced, was slower:
//     the key reads it saved were L2 hits.)
//
// What a later design changes: mark, claim and the check in write are
// random 4-byte accesses into a scratch far larger than L2 (256 MiB at
// 2^26 rows), a 32-byte sector each; sorting the frames by row (or
// claiming per block in shared memory first) would make them local. The
// sum also runs fused into the receive of the ring put (ring_put.cu, the
// TPU kernel's stash path); here it is the drain of the non-stash route.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kSumFrames = 4;   // frames per lane group per round of the sum

// Frames [first, first + kPerWarp * kSumFrames) of a warp: group g of the
// warp takes frames first + g, first + g + kPerWarp, ... All loads of a
// round are issued before the first shuffle, so each lane has kSumFrames
// loads in flight instead of one.
template <int G>
__global__ void __launch_bounds__(kThreads)
server_sum_kernel(const int32_t* __restrict__ frames, int32_t* __restrict__ sums,
                  long long n, int w, int usr_off, int pw) {
  constexpr int kPerWarp = 32 / G;
  const int lane = threadIdx.x % G;
  const int group = (threadIdx.x % 32) / G;
  const long long warp = (static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x) / 32;
  const long long stride =
      static_cast<long long>(gridDim.x) * (kThreads / 32) * kPerWarp * kSumFrames;
  // the loop bound is the warp's first frame, the same for all its lanes,
  // so every lane reaches every shuffle
  for (long long first = warp * kPerWarp * kSumFrames; first < n; first += stride) {
    uint32_t acc[kSumFrames];
#pragma unroll
    for (int u = 0; u < kSumFrames; ++u) {
      const long long f = first + u * kPerWarp + group;
      acc[u] = 0;
      if (f < n) {
        const int32_t* usr = frames + f * w + usr_off;
        for (int k = lane; k < pw; k += G) acc[u] += static_cast<uint32_t>(usr[k]);
      }
    }
#pragma unroll
    for (int u = 0; u < kSumFrames; ++u) {
#pragma unroll
      for (int off = G / 2; off > 0; off >>= 1) {
        acc[u] += __shfl_xor_sync(0xffffffffu, acc[u], off);
      }
      const long long f = first + u * kPerWarp + group;
      if (lane == 0 && f < n) sums[f] = static_cast<int32_t>(acc[u]);
    }
  }
}

// floormod(floormod(key, slots) + base, slots) for 0 < slots < 2^31, in 32
// bits: with bm = floormod(base, slots), the sum of the two residues lies
// in [0, 2 slots - 2], which fits a uint32 and needs one subtraction.
__device__ __forceinline__ int32_t put_row(int32_t key, int32_t slots, int32_t bm) {
  int32_t m = key % slots;                    // truncates toward zero
  if (m < 0) m += slots;
  const uint32_t t = static_cast<uint32_t>(m) + static_cast<uint32_t>(bm);
  return static_cast<int32_t>(t >= static_cast<uint32_t>(slots) ? t - slots : t);
}

__device__ __forceinline__ int32_t base_mod(const int32_t* got, int32_t slots) {
  int32_t bm = got[0] % slots;
  return bm < 0 ? bm + slots : bm;
}

// Pass 1: last[row] = -1 at every frame's row.
__global__ void __launch_bounds__(kThreads)
put_mark_kernel(const int32_t* __restrict__ frames, const int32_t* __restrict__ got,
                int32_t* __restrict__ last, long long n, int w, int usr_off, int32_t slots) {
  const int32_t bm = base_mod(got, slots);
  for (long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x; i < n;
       i += static_cast<long long>(gridDim.x) * kThreads) {
    last[put_row(frames[i * w + usr_off], slots, bm)] = -1;
  }
}

// Pass 2: each touched row ends with the index of its last frame.
__global__ void __launch_bounds__(kThreads)
put_claim_kernel(const int32_t* __restrict__ frames, const int32_t* __restrict__ got,
                 int32_t* __restrict__ last, long long n, int w, int usr_off, int32_t slots) {
  const int32_t bm = base_mod(got, slots);
  for (long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x; i < n;
       i += static_cast<long long>(gridDim.x) * kThreads) {
    atomicMax(last + put_row(frames[i * w + usr_off], slots, bm), static_cast<int32_t>(i));
  }
}

// Pass 3: a group of G lanes per frame; the frame that owns its row writes
// the table row and its pw - 1 heap words.
template <int G>
__global__ void __launch_bounds__(kThreads)
put_write_kernel(const int32_t* __restrict__ frames, const int32_t* __restrict__ got,
                 const int32_t* __restrict__ last, int32_t* __restrict__ table,
                 int32_t* __restrict__ heap, long long n, int w, int usr_off, int pw,
                 int32_t slots) {
  const int32_t bm = base_mod(got, slots);
  const int lane = threadIdx.x % G;
  const int data = pw - 1;
  for (long long f = (static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x) / G; f < n;
       f += static_cast<long long>(gridDim.x) * (kThreads / G)) {
    const int32_t* usr = frames + f * w + usr_off;
    const int32_t key = usr[0];
    const long long row = put_row(key, slots, bm);
    if (last[row] != static_cast<int32_t>(f)) continue;      // a later frame owns the row
    if (lane == 0) {
      table[2 * row] = key;
      table[2 * row + 1] = static_cast<int32_t>(row);
    }
    int32_t* dst = heap + row * data;
    for (int k = lane; k < data; k += G) dst[k] = usr[1 + k];
  }
}

unsigned blocks_for(long long items, int per_block) {
  const long long b = (items + per_block - 1) / per_block;
  return static_cast<unsigned>(b < 0x7fffffffLL ? b : 0x7fffffffLL);
}

}  // namespace

// C interface, loaded with ctypes. frames (n, w) int32 contiguous; sums (n,)
// int32. Needs 0 <= usr_off, 0 <= pw, usr_off + pw <= w. Launches nothing
// when n == 0. Returns a cudaError_t (0 = launched).
extern "C" int mailbox_server_sum(const void* frames, void* sums, long long n, int w,
                                  int usr_off, int pw, void* stream) {
  if (n < 0 || w <= 0 || usr_off < 0 || pw < 0 || usr_off + pw > w) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int32_t* f = static_cast<const int32_t*>(frames);
  int32_t* out = static_cast<int32_t*>(sums);
  if (pw <= 16) {
    server_sum_kernel<16><<<blocks_for(n, kThreads / 16 * kSumFrames), kThreads, 0, s>>>(
        f, out, n, w, usr_off, pw);
  } else {
    server_sum_kernel<32><<<blocks_for(n, kThreads / 32 * kSumFrames), kThreads, 0, s>>>(
        f, out, n, w, usr_off, pw);
  }
  return static_cast<int>(cudaGetLastError());
}

// frames (n, w) int32; got (>= 1,) int32, got[0] the heap base; last
// (slots,) int32 scratch, any contents; table (slots, 2) and heap (slots,
// pw - 1) int32, updated in place.
// Needs pw >= 1 (the key), usr_off + pw <= w, 1 <= slots < 2^31, n < 2^31
// (frame indices are int32 in the scratch). Launches nothing when n == 0.
// Returns a cudaError_t (0 = launched).
extern "C" int mailbox_indirect_put(const void* frames, const void* got, void* last,
                                    void* table, void* heap, long long n, int w,
                                    int usr_off, int pw, long long slots, void* stream) {
  if (n < 0 || n > 0x7fffffffLL || w <= 0 || usr_off < 0 || pw < 1 || usr_off + pw > w ||
      slots < 1 || slots > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int32_t* f = static_cast<const int32_t*>(frames);
  const int32_t* g = static_cast<const int32_t*>(got);
  int32_t* l = static_cast<int32_t*>(last);
  int32_t* t = static_cast<int32_t*>(table);
  int32_t* h = static_cast<int32_t*>(heap);
  const int32_t sl = static_cast<int32_t>(slots);
  put_mark_kernel<<<blocks_for(n, kThreads), kThreads, 0, s>>>(f, g, l, n, w, usr_off, sl);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  put_claim_kernel<<<blocks_for(n, kThreads), kThreads, 0, s>>>(f, g, l, n, w, usr_off, sl);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  if (pw - 1 <= 16) {
    put_write_kernel<16><<<blocks_for(n, kThreads / 16), kThreads, 0, s>>>(
        f, g, l, t, h, n, w, usr_off, pw, sl);
  } else {
    put_write_kernel<32><<<blocks_for(n, kThreads / 32), kThreads, 0, s>>>(
        f, g, l, t, h, n, w, usr_off, pw, sl);
  }
  return static_cast<int>(cudaGetLastError());
}
