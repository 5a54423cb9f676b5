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
// ~21 us at 3.35 TB/s); counted in the 32-byte sectors the USR words span
// (bytes 48-111 of each 128-byte frame: three sectors, mailbox/bench.py,
// sum_sector_work), ~105 MB, ~31 us. The put must read every key and, for
// each row's last writer, its data, and write that row's 68 B (at most
// ~138 MB, ~41 us); counted in the whole 32-byte sectors its random
// accesses move (put_sector_work), ~205 MB, ~61 us. Neither uses a tensor
// core.
//
// Design:
//   * Sum v3, two routes chosen by shape (the wrapper picks one and names
//     it). Route "wide", for calls of few frames (at most 4 an SM, as the
//     ring's latency frames) or of wide ones (more than 128 USR words)
//     whose USR words sit on 16-byte boundaries (a 16-byte-aligned base;
//     w, usr_off and pw multiples of 4): a CTA a frame, thread t loading
//     16-byte chunks t, t + 256, ... with loads that skip L1, reduced over
//     the CTA; at most 4 CTAs an SM, each walking its frames. Route
//     "scalar" (v2) takes every other call, the frame path's many frames
//     of 16 USR words among them: one group of G lanes per frame, G = 16
//     when pw <= 16 else 32, lane l loading USR words l, l + G, ... (4-byte
//     loads), each group taking 4 frames a round with all their loads
//     issued before the first shuffle. Sums in uint32 on both routes
//     (signed overflow is undefined in C++, unsigned wraps, which is the
//     int32 wrap of the reference), reduced by __shfl_xor_sync. The TPU
//     kernel pads N to a tile of 8 rows (_drain_geometry); here any N, any
//     pw, any usr_off.
//     What held v2 back on few or wide frames: a group of 16 or 32 lanes
//     walks a frame alone, so 16 frames of 8,192 USR words kept 16 groups
//     busy and the rest of the card idle (0.118 ms; the wide route 0.0074
//     ms, mailbox bench, PERF.md). On the frame path (2^20 frames of 16
//     USR words) v2 stays: a TMA stream of the USR columns (persistent
//     CTAs, a producer thread, an 8-stage ring of boxes of 128 frames x
//     16 words) and lane groups making 16-byte loads, 8 frames in flight a
//     group, were both measured there and neither beat it, so both were
//     dropped. It runs at ~61% of the bound of the 32-byte sectors the USR
//     words span.
//   * Put, last writer wins, in parallel (v3): three launches on one stream
//     over a claim table sized by the frames, not by the server's table:
//     H = the power of two >= 2 min(n, slots) entries of 8 bytes and a
//     contest flag byte each (18 MiB at 2^20 frames), allocated by the
//     wrapper, nothing kept between calls. An entry is (row << 32) | frame
//     index; ~0 is empty (rows are < 2^31).
//       1. clear: every entry to ~0, every flag to 0 (16-byte stores);
//       2. claim: a group of G lanes per frame, frames in order, loads the
//          frame's USR words together (the frames stream). The leader
//          hashes the row (murmur3's finalizer, linear probing, load <=
//          1/2) and takes an empty entry by atomicCAS, or finds its row's
//          entry, flags it contested and raises the index by a 64-bit
//          atomicMax (the row half is equal, so the larger word is the
//          later frame; a frame that reads a later index already there
//          skips the atomic). A frame that is its row's latest so far
//          writes the row at once: the table row as one 8-byte store
//          [key, row], the pw - 1 heap words from the lanes that hold them.
//          An uncontested row (nearly all) gets exactly that one write,
//          from its only frame;
//       3. fix: a contested row's writes in pass 2 may have landed in any
//          order; the frame left in its entry, the last writer, writes it
//          once more. A warp reads 32 flags and its lane groups copy the
//          flagged entries' frames.
//     That is the sequential result exactly, and deterministic. The row is
//     a floor modulo: CUDA's % truncates, so a negative key would index
//     below the table, and key % slots + got[0] may leave int32's range;
//     put_row takes one 32-bit modulo and a subtraction. Hot rows: ~100
//     frames a hot row per 2^20-frame delivery reach the same entry; its
//     atomics serialize in L2, but 1,024 hot entries spread over the L2's
//     slices, and a hot row gets a few optimistic writes and one fix.
//
// What held v2 back (measured on an NVIDIA H100 80GB HBM3, 700.00 W,
// 0.4712 ms at 2^20 frames: mark 0.097 + claim 0.088 + write 0.282
// ms): its scratch had one int32 per table row, 256 MiB at 2^26 rows, five
// times the 50 MB L2, so mark and claim each took 2^20 random DRAM
// sectors, and the write pass read last[row] from DRAM in front of every
// frame's random row write. v3's claim table stays in L2 and the claim
// writes the rows it wins at once. What bounds v3 is the random row
// writes themselves: two index_put_ of the same rows, given the winners,
// take ~0.24 ms on the same card, and the put must also stream the frames
// (128 MiB) to find them (PERF.md, the Indirect Put's findings).
//
// What a later design changes: the sum also runs fused into the receive
// of the ring put (ring_put.cu, the TPU kernel's stash path); here it is
// the drain of the non-stash route, and the drain itself could hand the
// USR words to the sum without a round trip through device memory. The
// put's writes land in frame order, random rows; writes in row order would
// save a DRAM row opening now and then (the library's writes are a little
// faster in row order than in the kernel's; PERF.md).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kSumFrames = 4;   // frames per lane group a round of the scalar sum

// The scalar route (v2): frames [first, first + kPerWarp * kSumFrames) of a
// warp: group g of the warp takes frames first + g, first + g + kPerWarp,
// ... All loads of a round are issued before the first shuffle, so each
// lane has kSumFrames loads in flight.
template <int G>
__global__ void __launch_bounds__(kThreads)
server_sum_scalar_kernel(const int32_t* __restrict__ frames, int32_t* __restrict__ sums,
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

// The wide route (v3): calls of few frames (at most kWideCtasPerSm an SM,
// as the ring's latency frames are) or of wide ones (more than 128 USR
// words), on frames whose USR words sit on 16-byte boundaries. A CTA a
// frame, thread t loading 16-byte chunks t, t + 256, ... four at a time,
// reduced over the CTA; at most kWideCtasPerSm CTAs an SM, each walking
// its frames. Lane groups would leave most of the card idle on the few
// frames such a call brings, and a group's lanes would each walk a long
// frame alone. The loads skip L1 (ld.global.nc.L1::no_allocate): every
// byte is read once.
constexpr int kWideCtasPerSm = 4;

__device__ __forceinline__ uint4 load_stream(const uint4* p) {
  uint4 v;
  asm volatile("ld.global.nc.L1::no_allocate.v4.u32 {%0, %1, %2, %3}, [%4];"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w) : "l"(p));
  return v;
}

__global__ void __launch_bounds__(kThreads)
server_sum_wide_kernel(const uint4* __restrict__ frames, int32_t* __restrict__ sums,
                       long long n, int w4, int off4, int chunks) {
  __shared__ uint32_t part[kThreads / 32];
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  for (long long f = blockIdx.x; f < n; f += gridDim.x) {   // the same for the whole CTA
    const uint4* usr = frames + f * w4 + off4;
    uint32_t acc = 0;
    for (int c = threadIdx.x; c < chunks; c += 4 * kThreads) {
      uint4 v[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int cu = c + u * kThreads;
        v[u] = cu < chunks ? load_stream(usr + cu) : make_uint4(0, 0, 0, 0);
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) acc += v[u].x + v[u].y + v[u].z + v[u].w;
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
    if (lane == 0) part[warp] = acc;
    __syncthreads();
    if (warp == 0) {
      acc = lane < kThreads / 32 ? part[lane] : 0;
#pragma unroll
      for (int off = kThreads / 64; off > 0; off >>= 1) {
        acc += __shfl_xor_sync(0xffffffffu, acc, off);
      }
      if (lane == 0) sums[f] = static_cast<int32_t>(acc);
    }
    __syncthreads();                                         // part is reused
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

constexpr unsigned long long kEmpty = ~0ull;   // a claim entry no row has taken

__device__ __forceinline__ uint32_t hash_row(int32_t row) {   // murmur3's finalizer
  uint32_t h = static_cast<uint32_t>(row);
  h ^= h >> 16;
  h *= 0x85ebca6bu;
  h ^= h >> 13;
  h *= 0xc2b2ae35u;
  h ^= h >> 16;
  return h;
}

// Pass 1: every claim entry empty, every contest flag clear.
__global__ void __launch_bounds__(kThreads)
put_clear_kernel(ulonglong2* __restrict__ claims, uint4* __restrict__ flags, long long pairs) {
  for (long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x; i < pairs;
       i += static_cast<long long>(gridDim.x) * kThreads) {
    claims[i] = make_ulonglong2(kEmpty, kEmpty);
    if (i < pairs / 8) flags[i] = make_uint4(0, 0, 0, 0);     // 2 pairs a flag byte
  }
}

// The frame's USR words from a group of G lanes: lane k0 holds word k0.
// Copies the frame to its row: the table row as one 8-byte store, the
// heap words by the lanes that hold them (and, past G, loaded again).
template <int G>
__device__ __forceinline__ void put_copy(const int32_t* usr, int32_t v, int k0, int32_t key,
                                         int32_t row, int pw, int32_t* table, int32_t* heap) {
  if (k0 == 0) {
    *reinterpret_cast<int2*>(table + 2 * static_cast<long long>(row)) = make_int2(key, row);
  }
  int32_t* dst = heap + static_cast<long long>(row) * (pw - 1);
  if (k0 >= 1 && k0 < pw) dst[k0 - 1] = v;
  for (int k = k0 + G; k < pw; k += G) dst[k - 1] = usr[k];
}

// Pass 2: a group of G lanes per frame, frames in order (they stream). The
// group's leader claims the row's entry: an empty one by atomicCAS, or its
// row's one by a 64-bit atomicMax (the row half is equal, so the larger
// word is the later frame); a frame that finds its row taken flags the
// entry as contested. A frame that is the row's latest so far writes its
// row at once: on an uncontested row (nearly all) that is the last
// writer's row, and the only write it gets.
template <int G>
__global__ void __launch_bounds__(kThreads)
put_claim_kernel(const int32_t* __restrict__ frames, const int32_t* __restrict__ got,
                 unsigned long long* __restrict__ claims, uint8_t* __restrict__ flags,
                 int32_t* __restrict__ table, int32_t* __restrict__ heap, long long n, int w,
                 int usr_off, int pw, int32_t slots, unsigned long long mask) {
  const int32_t bm = base_mod(got, slots);
  const int lane = threadIdx.x % 32;
  const int k0 = lane % G;
  const int leader = lane - k0;
  const unsigned group = G == 32 ? 0xffffffffu : ((1u << G) - 1) << leader;
  for (long long f = (static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x) / G; f < n;
       f += static_cast<long long>(gridDim.x) * (kThreads / G)) {
    const int32_t* usr = frames + f * w + usr_off;
    const int32_t v = k0 < pw ? usr[k0] : 0;
    const int32_t key = __shfl_sync(group, v, leader);       // the group shares f
    const int32_t row = put_row(key, slots, bm);
    int latest = 0;
    if (k0 == 0) {
      const unsigned long long mine = (static_cast<unsigned long long>(row) << 32)
                                      | static_cast<unsigned long long>(f);
      unsigned long long h = hash_row(row) & mask;
      for (;;) {
        unsigned long long seen = __ldcg(claims + h);    // L2: a taken entry keeps its row
        if (seen == kEmpty) {
          seen = atomicCAS(claims + h, kEmpty, mine);
          if (seen == kEmpty) {
            latest = 1;
            break;
          }
        }
        if ((seen >> 32) == static_cast<unsigned long long>(row)) {
          flags[h] = 1;
          latest = seen < mine && atomicMax(claims + h, mine) < mine;   // indices only grow
          break;
        }
        h = (h + 1) & mask;
      }
    }
    if (__shfl_sync(group, latest, leader)) put_copy<G>(usr, v, k0, key, row, pw, table, heap);
  }
}

// Pass 3: a contested row's writes in pass 2 may have landed in any order;
// its last writer, the frame in its claim entry, writes it once more. A
// warp reads 32 flags; a group of G lanes copies each flagged entry's frame.
template <int G>
__global__ void __launch_bounds__(kThreads)
put_fix_kernel(const int32_t* __restrict__ frames,
               const unsigned long long* __restrict__ claims, const uint8_t* __restrict__ flags,
               int32_t* __restrict__ table, int32_t* __restrict__ heap, long long entries, int w,
               int usr_off, int pw) {
  constexpr int kGroups = 32 / G;
  const int lane = threadIdx.x % 32;
  const int group = lane / G;
  const int k0 = lane % G;
  const long long warps = static_cast<long long>(gridDim.x) * (kThreads / 32);
  for (long long first = (static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x) / 32 * 32;
       first < entries; first += warps * 32) {               // entries % 32 == 0
    unsigned flagged = __ballot_sync(0xffffffffu, flags[first + lane] != 0);
    while (flagged) {                                      // warp-uniform
      int src = -1;
#pragma unroll
      for (int g = 0; g < kGroups; ++g) {                  // group g takes the g-th next entry
        const int next = flagged ? __ffs(flagged) - 1 : -1;
        if (g == group) src = next;
        if (flagged) flagged &= flagged - 1;
      }
      if (src < 0) continue;                               // group-uniform
      const unsigned long long e = claims[first + src];
      const int32_t row = static_cast<int32_t>(e >> 32);
      const int32_t* usr = frames + static_cast<long long>(e & 0xffffffffull) * w + usr_off;
      const int32_t v = k0 < pw ? usr[k0] : 0;
      put_copy<G>(usr, v, k0, usr[0], row, pw, table, heap);
    }
  }
}

unsigned blocks_for(long long items, int per_block) {
  const long long b = (items + per_block - 1) / per_block;
  return static_cast<unsigned>(b < 0x7fffffffLL ? b : 0x7fffffffLL);
}

}  // namespace

// C interface, loaded with ctypes. frames (n, w) int32 contiguous; sums (n,)
// int32. Needs 0 <= usr_off, 0 <= pw, usr_off + pw <= w. route 1 ("wide")
// needs frames on a 16-byte boundary and w, usr_off and pw multiples of 4,
// pw >= 4; route 0 ("scalar") takes any frames. The caller picks the route
// (kernel.py, sum_route). Launches nothing when n == 0. Returns a
// cudaError_t (0 = launched).
extern "C" int mailbox_server_sum(const void* frames, void* sums, long long n, int w,
                                  int usr_off, int pw, int route, void* stream) {
  if (n < 0 || w <= 0 || usr_off < 0 || pw < 0 || usr_off + pw > w
      || (route != 0 && route != 1)
      || (route == 1 && (reinterpret_cast<uintptr_t>(frames) % 16 != 0 || w % 4 != 0
                         || usr_off % 4 != 0 || pw % 4 != 0 || pw < 4))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int32_t* f = static_cast<const int32_t*>(frames);
  int32_t* out = static_cast<int32_t*>(sums);
  if (route == 1) {
    int dev = 0, sms = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return static_cast<int>(err);
    const long long most = static_cast<long long>(kWideCtasPerSm) * sms;
    server_sum_wide_kernel<<<static_cast<unsigned>(n < most ? n : most), kThreads, 0, s>>>(
        reinterpret_cast<const uint4*>(f), out, n, w / 4, usr_off / 4, pw / 4);
  } else if (pw <= 16) {
    server_sum_scalar_kernel<16><<<blocks_for(n, kThreads / 16 * kSumFrames), kThreads, 0, s>>>(
        f, out, n, w, usr_off, pw);
  } else {
    server_sum_scalar_kernel<32><<<blocks_for(n, kThreads / 32 * kSumFrames), kThreads, 0, s>>>(
        f, out, n, w, usr_off, pw);
  }
  return static_cast<int>(cudaGetLastError());
}

// frames (n, w) int32; got (>= 1,) int32, got[0] the heap base; claims
// (entries + entries / 8,) 8-byte scratch, any contents: the claim table
// (entries a power of two >= 2 min(n, slots) and >= 32) and a flag byte an
// entry, 16-byte aligned; table (slots, 2) (8-byte aligned) and heap
// (slots, pw - 1) int32, updated in place.
// Needs pw >= 1 (the key), usr_off + pw <= w, 1 <= slots < 2^31, n < 2^31
// (frame indices are the low half of a claim entry). Launches nothing when
// n == 0. Returns a cudaError_t (0 = launched).
extern "C" int mailbox_indirect_put(const void* frames, const void* got, void* claims,
                                    void* table, void* heap, long long n, int w,
                                    int usr_off, int pw, long long slots, long long entries,
                                    void* stream) {
  const long long distinct = n < slots ? n : slots;
  if (n < 0 || n > 0x7fffffffLL || w <= 0 || usr_off < 0 || pw < 1 || usr_off + pw > w ||
      slots < 1 || slots > 0x7fffffffLL || entries < 32 || (entries & (entries - 1)) != 0 ||
      entries < 2 * distinct) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int32_t* f = static_cast<const int32_t*>(frames);
  const int32_t* g = static_cast<const int32_t*>(got);
  unsigned long long* c = static_cast<unsigned long long*>(claims);
  uint8_t* flags = reinterpret_cast<uint8_t*>(c + entries);
  int32_t* t = static_cast<int32_t*>(table);
  int32_t* h = static_cast<int32_t*>(heap);
  const int32_t sl = static_cast<int32_t>(slots);
  const unsigned long long mask = static_cast<unsigned long long>(entries - 1);
  put_clear_kernel<<<blocks_for(entries / 2, kThreads), kThreads, 0, s>>>(
      reinterpret_cast<ulonglong2*>(c), reinterpret_cast<uint4*>(flags), entries / 2);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  if (pw <= 16) {
    put_claim_kernel<16><<<blocks_for(n, kThreads / 16), kThreads, 0, s>>>(
        f, g, c, flags, t, h, n, w, usr_off, pw, sl, mask);
  } else {
    put_claim_kernel<32><<<blocks_for(n, kThreads / 32), kThreads, 0, s>>>(
        f, g, c, flags, t, h, n, w, usr_off, pw, sl, mask);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  if (pw <= 16) {
    put_fix_kernel<16><<<blocks_for(entries, kThreads), kThreads, 0, s>>>(
        f, c, flags, t, h, entries, w, usr_off, pw);
  } else {
    put_fix_kernel<32><<<blocks_for(entries, kThreads), kThreads, 0, s>>>(
        f, c, flags, t, h, entries, w, usr_off, pw);
  }
  return static_cast<int>(cudaGetLastError());
}
