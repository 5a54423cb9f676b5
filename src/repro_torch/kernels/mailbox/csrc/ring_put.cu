// The one-sided ring put of the paper (Fig. 1) on one Hopper card (sm_90a):
// the ranks of the ring are the CTAs of a thread-block cluster.
//
// Replaces the TPU kernel mailbox_put_pallas (body _mailbox_kernel) of
// src/repro/kernels/mailbox/kernel.py. Rank r puts its frames (N, W) int32
// into the mailbox of rank (r + shift) % n, which waits for them, writes
// them to arrivals[r] and, with the fused handler, takes each frame's
// Server-Side Sum (the wrap-around int32 sum of its USR words) on arrival.
//
// The TPU's parts and theirs here:
//   rank                      -> %cluster_ctarank
//   remote DMA + recv_sem     -> cp.async.bulk.shared::cluster.shared::cta
//                                with mbarrier::complete_tx on an mbarrier in
//                                the receiver's shared memory
//   VMEM mailbox (stash)      -> the receiver's shared memory
//   HBM mailbox (no stash)    -> arrivals[dst] in device memory, written by
//                                the sender with 16-byte stores; the wait is
//                                a cluster barrier (release / acquire)
//   wait_recv (WFE)           -> mbarrier.try_wait.parity, which the hardware
//                                suspends: 0 spins
//   SIG poll                  -> an acquire load of frame N-1's SIG word in
//                                the receiver's shared memory, counted and
//                                capped at 2^20; then the same mbarrier wait
//                                before the data is touched (the TPU kernel
//                                also takes wait_recv first)
//   credit return (§VI-A2)    -> a remote mbarrier.arrive on the sender's
//                                credit barrier
//
// Stash design. The mailbox holds two chunks of whole frames (at most
// 48 KiB each); chunking lets N be any size. Warp 0's first lane sends: it
// stages a chunk of its rank's frames in its own shared memory (a bulk load
// completing on a stage barrier) and puts it to the peer address from
// mapa.shared::cluster. Warps 1-7 receive: they arm the chunk's full
// barrier with expect_tx of its bytes, wait, store the chunk to arrivals[r]
// with one bulk store, sum the USR words from shared memory, and return the
// buffer's credit once the store has read it. The sender does not reuse a
// buffer before its credit is back. Several clusters run side by side, each
// carrying a contiguous range of chunks of every rank (as many clusters as
// fit on the card at once); only the one holding frame N-1 polls.
//
// What bounds it on an H100: bytes. Every frame is read once and written
// once (and a sum written per frame): at chip_smoke.py's ring, 8 ranks of
// 131,072 frames of 128 B, 2 x 128 MiB + 4 MiB, ~81 us at 3.35 TB/s. The
// copy between shared memories stays on the SMs' network and costs no
// device-memory bytes; the fused sum reads shared memory only, where the
// non-stash route reads the frames back from device memory to drain them.
// What the design does about the bound: bulk copies (TMA) move the bytes,
// so no thread spends registers or instructions on them, and two chunks
// per rank are in flight on every SM of every cluster. v2 indexes the
// fused sum's items in 32 bits and divides only when a frame spans several
// (v1 took a 64-bit division and modulo per frame: 0.148 ms against the
// bare put's 0.110 at that ring on an H100; v2 0.125).
//
// No hang: every mbarrier wait traps after 2 s (torch.cuda.synchronize
// then raises), and no CTA exits before a cluster barrier at the end, so
// nothing writes into the shared memory of a CTA that has gone.

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int kThreads = 256;                  // warp 0 sends, warps 1-7 receive
constexpr int kConsumers = kThreads - 32;
constexpr int kMaxChunkBytes = 48 * 1024;
constexpr int kHeader = 128;                   // six mbarriers, padded
constexpr uint32_t kSigMagic = 0x516A22u;
constexpr uint32_t kMaxSpins = 1u << 20;
constexpr unsigned long long kTimeoutNs = 2000000000ull;

struct RingArgs {
  const int32_t* frames;   // (n, N, W)
  int32_t* arrivals;       // (n, N, W)
  int32_t* spins;          // (n,)
  int32_t* sums;           // (n, N) or null
  long long n_frames;      // N
  long long chunks;        // chunks per rank, ceil(N / chunk)
  int words;               // W, a multiple of 4
  int n;                   // ranks = cluster size
  int shift;
  int stash;
  int poll;
  int sig_off;
  int usr_off;
  int pw;
  int chunk;               // frames per chunk
  int clusters;
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(r));
  return r;
}

__device__ __forceinline__ uint32_t cluster_index() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%clusterid.x;" : "=r"(r));
  return r;
}

// The shared::cluster address of `local` (a shared::cta address) in CTA `rank`.
__device__ __forceinline__ uint32_t peer(uint32_t local, uint32_t rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(r) : "r"(local), "r"(rank));
  return r;
}

__device__ __forceinline__ unsigned long long now_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release;\n\tbarrier.cluster.wait.acquire;" ::: "memory");
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" :: "r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               :: "r"(bar), "r"(bytes) : "memory");
}

// Arrive on an mbarrier of another CTA (`bar` from peer()).
__device__ __forceinline__ void mbar_arrive_remote(uint32_t bar) {
  asm volatile("mbarrier.arrive.release.cluster.shared::cluster.b64 _, [%0];"
               :: "r"(bar) : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile("{\n\t.reg .pred p;\n\t"
               "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], %2;\n\t"
               "selp.u32 %0, 1, 0, p;\n\t}"
               : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  return done != 0;
}

// Wait for the phase of parity `parity` to complete: the hardware suspends
// the thread inside try_wait (no spin count); traps after kTimeoutNs.
__device__ void mbar_wait(uint32_t bar, uint32_t parity) {
  if (mbar_try_wait(bar, parity)) return;
  const unsigned long long t0 = now_ns();
  while (!mbar_try_wait(bar, parity)) {
    if (now_ns() - t0 > kTimeoutNs) __trap();
  }
}

// Global -> own shared memory, completing on `bar`.
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
               "[%0], [%1], %2, [%3];"
               :: "r"(dst), "l"(src), "r"(bytes), "r"(bar) : "memory");
}

// Own shared memory -> a peer's (`dst`, `bar` from peer()), completing on
// the peer's barrier: the one-sided put.
__device__ __forceinline__ void bulk_put(uint32_t dst, uint32_t src, uint32_t bytes,
                                         uint32_t bar) {
  asm volatile("cp.async.bulk.shared::cluster.shared::cta.mbarrier::complete_tx::bytes "
               "[%0], [%1], %2, [%3];"
               :: "r"(dst), "r"(src), "r"(bytes), "r"(bar) : "memory");
}

// Own shared memory -> global, as one bulk group.
__device__ __forceinline__ void bulk_store(void* dst, uint32_t src, uint32_t bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;"
               :: "l"(dst), "r"(src), "r"(bytes) : "memory");
  asm volatile("cp.async.bulk.commit_group;" ::: "memory");
}

__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
}

__device__ __forceinline__ void bulk_wait_all() {
  asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
}

__device__ __forceinline__ uint32_t ld_acquire(uint32_t addr) {
  uint32_t v;
  asm volatile("ld.acquire.cta.shared::cta.u32 %0, [%1];" : "=r"(v) : "r"(addr) : "memory");
  return v;
}

// Zero a word of own shared memory before a bulk copy (the async proxy)
// writes it.
__device__ __forceinline__ void clear_for_async(uint32_t addr) {
  asm volatile("st.shared::cta.u32 [%0], %1;" :: "r"(addr), "r"(0u) : "memory");
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;" :: "n"(kConsumers) : "memory");
}

// Server-Side Sum of the nf frames in a mailbox buffer into acc[0, nf)
// (zero on entry), by the consumer threads. An item is (frame, segment of
// G * 8 USR words); a group of G lanes takes one item a round. The loop
// bound is the warp's first item, the same for all its lanes, so every lane
// reaches every shuffle. uint32 sums wrap as the reference's int32 ones.
template <int G>
__device__ void sum_chunk(const int32_t* box, uint32_t* acc, int nf, int words, int usr_off,
                          int pw, int ctid) {
  constexpr int kSeg = G * 8;
  constexpr int kPerWarp = 32 / G;
  const int nseg = (pw + kSeg - 1) / kSeg;
  const int items = nf * nseg;                     // < 2^16: nf * words <= 12,288
  const int warp = ctid / 32, group = (ctid % 32) / G, lane = ctid % G;
  for (int first = warp * kPerWarp; first < items; first += (kConsumers / 32) * kPerWarp) {
    const int item = first + group;
    uint32_t v = 0;
    int f = 0;
    if (item < items) {
      f = nseg == 1 ? item : item / nseg;
      const int s = item - f * nseg;
      const int32_t* usr = box + f * words + usr_off;
      const int end = min(pw, (s + 1) * kSeg);
      for (int j = s * kSeg + lane; j < end; j += G) v += static_cast<uint32_t>(usr[j]);
    }
#pragma unroll
    for (int off = G / 2; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
    if (lane == 0 && item < items) atomicAdd(acc + f, v);
  }
}

// Non-stash: the sender writes its frames straight into arrivals[dst]
// (coalesced 16-byte stores, kUnroll loads in flight a thread); the wait is
// the cluster barrier.
__device__ void put_to_device_memory(const RingArgs& a, uint32_t rank, uint32_t dst,
                                     long long f_lo, long long f_hi, bool last_cluster) {
  constexpr int kUnroll = 8;
  const long long words = a.words;
  const int4* src = reinterpret_cast<const int4*>(a.frames + (rank * a.n_frames + f_lo) * words);
  int4* out = reinterpret_cast<int4*>(a.arrivals + (dst * a.n_frames + f_lo) * words);
  const long long nvec = (f_hi - f_lo) * words / 4;
  const long long stride = static_cast<long long>(kThreads) * kUnroll;
  for (long long base = threadIdx.x; base < nvec; base += stride) {
    int4 v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long i = base + static_cast<long long>(u) * kThreads;
      if (i < nvec) v[u] = src[i];
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long i = base + static_cast<long long>(u) * kThreads;
      if (i < nvec) out[i] = v[u];
    }
  }
  cluster_sync();                                // the put has landed: 0 spins
  if (last_cluster && threadIdx.x == 0) a.spins[rank] = 0;
}

__global__ void __launch_bounds__(kThreads, 1) ring_put_kernel(RingArgs a) {
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t rank = cluster_rank();
  const uint32_t cid = cluster_index();
  const uint32_t dst = (rank + static_cast<uint32_t>(a.shift)) % a.n;
  const uint32_t src = (rank + a.n - static_cast<uint32_t>(a.shift) % a.n) % a.n;
  // this cluster's chunks [k0, k0 + K) of every rank
  const long long k0 = a.chunks * cid / a.clusters;
  const long long K = a.chunks * (cid + 1) / a.clusters - k0;
  const bool last_cluster = cid == static_cast<uint32_t>(a.clusters) - 1;
  const long long words = a.words;
  const long long N = a.n_frames;
  if (!a.stash) {
    put_to_device_memory(a, rank, dst, k0 * a.chunk, min((k0 + K) * a.chunk, N), last_cluster);
    return;
  }

  const uint32_t chunk_bytes = static_cast<uint32_t>(a.chunk) * a.words * 4;
  const uint32_t full = smem_addr(smem);           // full[b]   at +8b: the mailbox's
  const uint32_t credit = full + 16;               // credit[b] at +8b: the sender's
  const uint32_t stage = full + 32;                // stage[b]  at +8b: the sender's
  unsigned char* staging = smem + kHeader;         // 2 chunks, the sender's
  unsigned char* mailbox = staging + 2 * chunk_bytes;   // 2 chunks, the receiver's
  uint32_t* acc = reinterpret_cast<uint32_t*>(mailbox + 2 * chunk_bytes);   // 2 x chunk
  const bool summing = a.sums != nullptr;
  auto frames_in = [&](long long k) {               // frames of this cluster's chunk k
    return static_cast<int>(min(static_cast<long long>(a.chunk), N - (k0 + k) * a.chunk));
  };
  // the poll watches frame N-1's SIG word, in the buffer of the last chunk
  const bool polls = a.poll && last_cluster;
  const long long last_first = (k0 + K - 1) * a.chunk;
  const uint32_t sig = smem_addr(mailbox) + ((K - 1) & 1) * chunk_bytes
                       + 4 * static_cast<uint32_t>((N - 1 - last_first) * words + a.sig_off);

  if (threadIdx.x == 0) {
    for (int b = 0; b < 2; ++b) {
      mbar_init(full + 8 * b, 1);
      mbar_init(credit + 8 * b, 1);
      mbar_init(stage + 8 * b, 1);
    }
    if (polls) clear_for_async(sig);               // no stale SIG from an earlier launch
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  if (summing) {
    for (int i = threadIdx.x; i < 2 * a.chunk; i += kThreads) acc[i] = 0;
  }
  cluster_sync();                                  // every rank's barriers are ready

  if (threadIdx.x == 0) {
    // the sender: chunks k of its rank into dst's mailbox buffer k % 2
    uint32_t box[2], box_full[2];
    for (int b = 0; b < 2; ++b) {
      box[b] = peer(smem_addr(mailbox) + b * chunk_bytes, dst);
      box_full[b] = peer(full + 8 * b, dst);
    }
    auto load = [&](long long k) {
      const int b = static_cast<int>(k & 1);
      const uint32_t bytes = static_cast<uint32_t>(frames_in(k)) * a.words * 4;
      mbar_expect(stage + 8 * b, bytes);
      bulk_load(smem_addr(staging) + b * chunk_bytes,
                a.frames + (rank * N + (k0 + k) * a.chunk) * words, bytes, stage + 8 * b);
    };
    load(0);
    if (K > 1) load(1);
    for (long long k = 0; k < K; ++k) {
      const int b = static_cast<int>(k & 1);
      mbar_wait(stage + 8 * b, static_cast<uint32_t>((k >> 1) & 1));
      bulk_put(box[b], smem_addr(staging) + b * chunk_bytes,
               static_cast<uint32_t>(frames_in(k)) * a.words * 4, box_full[b]);
      if (k >= 1 && k + 1 < K) {
        // chunk k + 1 goes where chunk k - 1 went, once dst has drained it
        mbar_wait(credit + 8 * ((k - 1) & 1), static_cast<uint32_t>(((k - 1) >> 1) & 1));
        load(k + 1);
      }
    }
  } else if (threadIdx.x >= 32) {
    // the receiver: chunks k from src, in buffer k % 2
    const int ctid = threadIdx.x - 32;
    const uint32_t src_credit[2] = {peer(credit, src), peer(credit + 8, src)};
    uint32_t spins = 0;
    for (long long k = 0; k < K; ++k) {
      const int b = static_cast<int>(k & 1);
      const int nf = frames_in(k);
      const uint32_t bytes = static_cast<uint32_t>(nf) * a.words * 4;
      const long long f0 = (k0 + k) * a.chunk;
      unsigned char* buf = mailbox + b * chunk_bytes;
      if (ctid == 0) {
        mbar_expect(full + 8 * b, bytes);
        if (polls && k == K - 1) {
          bool found = false;
          while (!found && spins < kMaxSpins) {
            found = ld_acquire(sig) == kSigMagic;
            ++spins;
          }
        }
      }
      mbar_wait(full + 8 * b, static_cast<uint32_t>((k >> 1) & 1));
      if (ctid == 0) bulk_store(a.arrivals + (rank * N + f0) * words, smem_addr(buf), bytes);
      uint32_t* acc_b = acc + b * a.chunk;
      if (summing) {
        const int32_t* box = reinterpret_cast<const int32_t*>(buf);
        if (a.pw <= 64) {
          sum_chunk<8>(box, acc_b, nf, a.words, a.usr_off, a.pw, ctid);
        } else {
          sum_chunk<32>(box, acc_b, nf, a.words, a.usr_off, a.pw, ctid);
        }
      }
      consumers_sync();                            // every thread is done reading buf
      if (summing) {
        for (int i = ctid; i < nf; i += kConsumers) {
          a.sums[rank * N + f0 + i] = static_cast<int32_t>(acc_b[i]);
          acc_b[i] = 0;
        }
      }
      if (ctid == 0 && k + 2 < K) {                // the sender will wait for this credit
        bulk_wait_read();                          // the store has read buf
        if (polls && k + 2 == K - 1) clear_for_async(sig);
        mbar_arrive_remote(src_credit[b]);
      }
    }
    if (ctid == 0) {
      bulk_wait_all();
      if (last_cluster) a.spins[rank] = static_cast<int32_t>(spins);
    }
  }
  __syncwarp();
  cluster_sync();                                  // no peer writes into a CTA that has gone
}

}  // namespace

// C interface, loaded with ctypes. frames and arrivals (n, n_frames, words)
// int32 contiguous, 16-byte aligned; spins (n,) int32; sums (n, n_frames)
// int32 or null (no handler). Needs 1 <= n <= 8, n_frames >= 1, words a
// positive multiple of 4, shift >= 0, 0 <= sig_off < words, usr_off + pw <=
// words, 1 <= chunk with chunk * words * 4 <= 48 KiB, and no sums without
// stash. Runs as many clusters as fit on the card at once (at most one per
// chunk). Returns a cudaError_t (0 = launched).
extern "C" int mailbox_ring_put(const void* frames, void* arrivals, void* spins, void* sums,
                                int n, long long n_frames, int words, int shift, int stash,
                                int poll, int sig_off, int usr_off, int pw, int chunk,
                                void* stream) {
  if (n < 1 || n > 8 || n_frames < 1 || words < 4 || words % 4 != 0 || shift < 0 ||
      sig_off < 0 || sig_off >= words || usr_off < 0 || pw < 0 || usr_off + pw > words ||
      chunk < 1 || static_cast<long long>(chunk) * words * 4 > kMaxChunkBytes ||
      (sums != nullptr && !stash)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  RingArgs a;
  a.frames = static_cast<const int32_t*>(frames);
  a.arrivals = static_cast<int32_t*>(arrivals);
  a.spins = static_cast<int32_t*>(spins);
  a.sums = static_cast<int32_t*>(sums);
  a.n_frames = n_frames;
  a.chunks = (n_frames + chunk - 1) / chunk;
  a.words = words;
  a.n = n;
  a.shift = shift % n;
  a.stash = stash;
  a.poll = poll;
  a.sig_off = sig_off;
  a.usr_off = usr_off;
  a.pw = pw;
  a.chunk = chunk;
  const size_t smem = stash ? kHeader + 4 * static_cast<size_t>(chunk) * words * 4 +
                                  (sums != nullptr ? 2 * static_cast<size_t>(chunk) * 4 : 0)
                            : 0;
  cudaError_t err = cudaFuncSetAttribute(ring_put_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = n;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(n, 1, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int clusters = 0;
  err = cudaOccupancyMaxActiveClusters(&clusters, ring_put_kernel, &cfg);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (clusters < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  a.clusters = static_cast<int>(std::min(static_cast<long long>(clusters), a.chunks));
  cfg.gridDim = dim3(n * a.clusters, 1, 1);
  err = cudaLaunchKernelEx(&cfg, ring_put_kernel, a);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
