// Identity copies of a device buffer for Hopper: the copy-bandwidth probe.
//
// Replaces the Pallas TPU kernels of the JAX package's two DMA probes:
//   tools/probe_pallas_dma.py::pallas_copy (:34; pallas_call :36, body
//     copy_kernel :30): a row-block copy through Pallas's auto-pipeline;
//   tools/probe_dma_manual.py::_call (:132; pallas_call :133): the same copy
//     driven by hand, through an n_slots-deep HBM->VMEM->HBM ring
//     (_bounce_kernel :54) or HBM->HBM with 8 copies in flight
//     (_hbm2hbm_kernel :105).
// On the TPU they asked whether the cap on streaming from a hand-written
// kernel was set by the auto-pipeliner or by the DMA engine. Here they ask
// the same of Hopper: does a hand-written kernel stream at what torch's own
// copy does, at what share of 3.35 TB/s, and does TMA (Hopper's DMA engine)
// beat plain SM loads and stores? None copies the TPU's chunking.
//
// Bound: a copy of N bytes reads N and writes N bytes and does no
// arithmetic, so each kernel is bound by bytes: 2 N / 3.35 TB/s, 0.160 ms
// for the probe's 256 MB. A copy that keeps enough bytes in flight streams
// at about 0.89 of that on an H100, as torch's own copy_ does; what holds a
// design below that is its last microseconds: SMs do not all stream at the
// same rate, so work split evenly over the SMs up front ends on the slowest
// one. Each design therefore hands out work in small units, to the SMs that
// are free:
//   copy_block   one 16-byte load and store per thread, neighbouring threads
//                on neighbouring addresses; a plain grid of 4 KB blocks
//                (65,536 blocks for 256 MB), handed to the SMs by the block
//                scheduler as they free up. The counterpart of Pallas's row
//                blocks, whose 256-row blocks would give only 64 blocks here.
//   copy_direct  the TPU's "8 DMAs in flight" done with SM registers, since
//                Hopper has no global-to-global TMA. A tile is 8 16-byte
//                vectors per thread of a 128-thread block (16 KB). The
//                wrapper sizes the grid from the work (direct_geometry: about
//                tiles_per_block tiles a block, never fewer blocks than are
//                resident at once) and gives each block one contiguous span
//                of whole tiles; spans differ by at most one tile, and the
//                block scheduler hands blocks to the SMs as they free up. A
//                block with more than one tile is software-pipelined: tile
//                t + 1's 8 loads go out before tile t's 8 stores. Only the
//                ragged last tile is masked. The default is one tile a block
//                (no pipelining): on an H100 that is fastest (PERF.md §6).
//   copy_bounce  a persistent grid of one or two blocks per SM. One thread
//                walks the block's chunks through an NS-deep ring in dynamic
//                shared memory: TMA 1-D bulk loads signal one mbarrier per
//                slot (complete_tx, with a phase bit per use of the slot),
//                TMA bulk stores go out one bulk group each. The ring is
//                split between loads ahead and stores not yet read out: up
//                to S stores are left reading their slots while NS - S
//                slots fill. S = 1 drains every store before each refill;
//                S = NS - 1 starts one load ahead, the TPU ring's own
//                balance (tools/probe_dma_manual.py:76-91). Chunks are
//                claimed one at a time from a global counter as slots free
//                up (dynamic), or split over the blocks up front (static).
//                No register or SM instruction touches the data.
// Every size and address is a multiple of 16 bytes (the rule of TMA and of
// 16-byte vectors); the wrapper (ops/cuda/copy_probe.py) checks it, and the
// buffers must not overlap.

#include <cuda_runtime.h>
#include <stdint.h>

#include "tma_ring.cuh"

namespace {

using namespace tma_ring;

constexpr int kBlockThreads = 256;
constexpr int kDirectDepth = 8;     // 16-byte loads per thread per tile
constexpr int kDirectThreads = 128;  // threads of a copy_direct block
constexpr int kDirectTile = kDirectDepth * kDirectThreads;  // vectors
constexpr int kRingOffset = 128;    // the ring starts after the mbarriers
constexpr int kSmemLimit = 232448;  // dynamic shared memory of one block

__global__ void __launch_bounds__(kBlockThreads)
copy_block_kernel(const uint4* __restrict__ src, uint4* __restrict__ dst,
                  int64_t n) {
  const int64_t i = (int64_t)blockIdx.x * kBlockThreads + threadIdx.x;
  if (i < n) dst[i] = src[i];
}

// A whole tile: p points at this thread's first vector of the tile, its
// 8 vectors are kDirectThreads apart (neighbouring threads on neighbouring
// addresses); the offsets are constants of the instructions.
__device__ __forceinline__ void load_tile(uint4 (&v)[kDirectDepth],
                                          const uint4* p) {
#pragma unroll
  for (int j = 0; j < kDirectDepth; ++j) v[j] = p[j * kDirectThreads];
}

__device__ __forceinline__ void store_tile(uint4* p,
                                           const uint4 (&v)[kDirectDepth]) {
#pragma unroll
  for (int j = 0; j < kDirectDepth; ++j) p[j * kDirectThreads] = v[j];
}

// Block b copies the span of tiles [b * base + min(b, extra), + base + (b <
// extra)): the split of ops/cuda/copy_probe.py::direct_geometry. Two
// register sets (a, c) take turns: the loads of the next tile go out
// before the stores of this one. Only the last block can own the ragged
// last tile of the buffer.
__global__ void __launch_bounds__(kDirectThreads, 6)
copy_direct_kernel(const uint4* __restrict__ src, uint4* __restrict__ dst,
                   int64_t n, int64_t base, int extra) {
  const int64_t b = blockIdx.x;
  const int64_t first = b * base + (b < extra ? b : extra);
  const int64_t stop = first + base + (b < extra ? 1 : 0);
  const bool ragged = stop * kDirectTile > n;
  const int64_t count = stop - first - (ragged ? 1 : 0);
  const uint4* s = src + first * kDirectTile + threadIdx.x;
  uint4* d = dst + first * kDirectTile + threadIdx.x;
  if (count > 0) {
    uint4 a[kDirectDepth], c[kDirectDepth];
    load_tile(a, s);
    for (int64_t t = 0;;) {
      if (t + 1 < count) load_tile(c, s + (t + 1) * kDirectTile);
      store_tile(d + t * kDirectTile, a);
      if (++t == count) break;
      if (t + 1 < count) load_tile(a, s + (t + 1) * kDirectTile);
      store_tile(d + t * kDirectTile, c);
      if (++t == count) break;
    }
  }
  if (ragged) {
    const int64_t i0 = (stop - 1) * kDirectTile + threadIdx.x;
    uint4 v[kDirectDepth];
#pragma unroll
    for (int j = 0; j < kDirectDepth; ++j)
      if (i0 + j * kDirectThreads < n) v[j] = src[i0 + j * kDirectThreads];
#pragma unroll
    for (int j = 0; j < kDirectDepth; ++j)
      if (i0 + j * kDirectThreads < n) dst[i0 + j * kDirectThreads] = v[j];
  }
}

// One thread per block. The block's k-th chunk lives in slot k % NS; its
// load is the (k / NS)-th completion of that slot's mbarrier, so the
// wait's parity is (k / NS) & 1. Which global chunk it is: statically,
// blockIdx.x + k * gridDim.x; dynamically (claims != nullptr), the first
// kAhead are static too, and each later one is claimed from a global
// counter when its slot is refilled, so the SMs that stream faster take
// more chunks, and every SM works near the same front of the buffer. A
// slot's global chunk index is kept in shared memory beside its mbarrier.
//
// Chunks 0 .. NS - S are loaded up front. Step k waits for chunk k, issues
// its store as bulk group k, then refills the slot of chunk k - S + 1 with
// chunk k - S + 1 + NS. Before the refill, wait_group.read S - 1 returns
// once every bulk group but the S - 1 most recent has finished reading
// shared memory: groups 0 .. k - S + 1 are read out, so that slot is free
// (for k < S - 1 the slot has never held a chunk, and fewer than S groups
// exist, so the wait returns at once). Its mbarrier's last phase, chunk
// k - S + 1's load, was waited for at step k - S + 1, so the barrier is
// never more than one phase ahead of its waiter. So up to S stores read
// and NS - S loads fill while the thread waits, and every slot is in use.
//
// claims[0] counts the chunks claimed, claims[1] the blocks finished; the
// last block to finish sets both back to 0, so the next launch (after this
// one in stream order) starts from 0. Launches sharing a counter must not
// run at the same time.
template <int NS, int S, bool kDynamic>
__global__ void __launch_bounds__(1)
copy_bounce_kernel(const char* __restrict__ src, char* __restrict__ dst,
                   int64_t nbytes, int chunk,
                   unsigned long long* __restrict__ claims) {
  static_assert(1 <= S && S < NS, "stores left unread: 1 .. NS - 1");
  static_assert(16 * NS <= kRingOffset, "barriers and indices fit");
  constexpr int kAhead = NS - S + 1;  // chunks loaded before the first store
  extern __shared__ __align__(128) unsigned char smem[];
  int64_t* index = reinterpret_cast<int64_t*>(smem + 8 * NS);
  const int64_t n_chunks = (nbytes + chunk - 1) / chunk;
  const uint32_t bars = smem_addr(smem);
  const uint32_t ring = bars + kRingOffset;
  for (int s = 0; s < NS; ++s) mbar_init(bars + 8 * s, 1);
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");

  // the block's k-th chunk (k >= kAhead claims one when dynamic), or
  // n_chunks and beyond when there is none
  const int64_t first_claimed = (int64_t)kAhead * gridDim.x;
  auto chunk_index = [&](int64_t k) -> int64_t {
    if (kDynamic && k >= kAhead)
      return first_claimed + (int64_t)atomicAdd(claims, 1ull);
    return (int64_t)blockIdx.x + k * gridDim.x;
  };
  auto load = [&](int64_t k, int64_t g) {
    const uint32_t s = (uint32_t)(k % NS);
    const int64_t off = g * chunk;
    const int64_t left = nbytes - off;
    const uint32_t bytes = (uint32_t)(left < chunk ? left : chunk);
    index[s] = g;
    mbar_expect_tx(bars + 8 * s, bytes);
    bulk_load(ring + s * chunk, src + off, bytes, bars + 8 * s);
  };

  int64_t loaded = 0;  // chunks of this block whose load was issued
  for (; loaded < kAhead; ++loaded) {
    const int64_t g = chunk_index(loaded);
    if (g >= n_chunks) break;
    load(loaded, g);
  }
  bool more = loaded == kAhead;
  // a dynamic claim goes out one step before its refill, so its latency
  // is spent while the thread waits for a load
  int64_t next = more ? chunk_index(loaded) : n_chunks;
  for (int64_t k = 0; k < loaded; ++k) {
    const uint32_t s = (uint32_t)(k % NS);
    mbar_wait(bars + 8 * s, (uint32_t)((k / NS) & 1));
    const int64_t off = index[s] * chunk;
    const int64_t left = nbytes - off;
    bulk_store(dst + off, ring + s * chunk,
               (uint32_t)(left < chunk ? left : chunk));
    if (more && next < n_chunks) {
      asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(S - 1)
                   : "memory");
      load(loaded, next);
      ++loaded;
      next = chunk_index(loaded);
    } else {
      more = false;
    }
  }
  // the stores must be complete before the block (and its ring) goes away
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
  if (kDynamic) {
    __threadfence();
    if (atomicAdd(claims + 1, 1ull) == gridDim.x - 1) {
      claims[0] = 0;
      claims[1] = 0;
      __threadfence();
    }
  }
}

// The shared-memory attributes are set once per kernel instance, at its
// first launch, not on every launch: the ring may take all 227 KB, and the
// SM gives shared memory its whole carveout (TMA does not use L1), so two
// rings of up to half of it fit on one SM.
template <int NS, int S, bool kDynamic>
int launch_bounce(const void* src, void* dst, int64_t nbytes, int chunk,
                  int grid, unsigned long long* claims, cudaStream_t stream) {
  static const cudaError_t attributes = [] {
    cudaError_t err = cudaFuncSetAttribute(
        copy_bounce_kernel<NS, S, kDynamic>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemLimit);
    if (err != cudaSuccess) return err;
    return cudaFuncSetAttribute(copy_bounce_kernel<NS, S, kDynamic>,
                                cudaFuncAttributePreferredSharedMemoryCarveout,
                                (int)cudaSharedmemCarveoutMaxShared);
  }();
  if (attributes != cudaSuccess) return (int)attributes;
  copy_bounce_kernel<NS, S, kDynamic>
      <<<grid, 1, kRingOffset + NS * chunk, stream>>>(
          (const char*)src, (char*)dst, nbytes, chunk, claims);
  return (int)cudaGetLastError();
}

// The instance of (NS, stores, dynamic): stores runs over 1 .. NS - 1.
template <int NS, int S = 1>
int dispatch_bounce(int stores, const void* src, void* dst, int64_t nbytes,
                    int chunk, int grid, unsigned long long* claims,
                    cudaStream_t stream) {
  if constexpr (S >= NS) {
    return (int)cudaErrorInvalidValue;
  } else {
    if (stores != S)
      return dispatch_bounce<NS, S + 1>(stores, src, dst, nbytes, chunk, grid,
                                        claims, stream);
    return claims ? launch_bounce<NS, S, true>(src, dst, nbytes, chunk, grid,
                                               claims, stream)
                  : launch_bounce<NS, S, false>(src, dst, nbytes, chunk, grid,
                                                claims, stream);
  }
}

}  // namespace

// n16: the buffer's size in 16-byte vectors.
extern "C" int copy_block(const void* src, void* dst, long long n16,
                          void* stream) {
  if (n16 == 0) return (int)cudaSuccess;
  const int64_t blocks = (n16 + kBlockThreads - 1) / kBlockThreads;
  copy_block_kernel<<<(unsigned)blocks, kBlockThreads, 0,
                      (cudaStream_t)stream>>>((const uint4*)src, (uint4*)dst,
                                              n16);
  return (int)cudaGetLastError();
}

// grid, base, extra: ops/cuda/copy_probe.py::direct_geometry of n16 (block b
// copies a span of base + (b < extra) whole tiles of kDirectTile vectors).
extern "C" int copy_direct(const void* src, void* dst, long long n16,
                           int grid, long long base, int extra,
                           void* stream) {
  if (n16 == 0) return (int)cudaSuccess;
  if (grid <= 0 || base <= 0 || extra < 0 || extra >= grid)
    return (int)cudaErrorInvalidValue;
  copy_direct_kernel<<<grid, kDirectThreads, 0, (cudaStream_t)stream>>>(
      (const uint4*)src, (uint4*)dst, n16, base, extra);
  return (int)cudaGetLastError();
}

// nbytes and chunk: multiples of 16; kRingOffset + n_slots * chunk bytes of
// dynamic shared memory per block; n_slots is 2 or 8, stores 1 .. n_slots -
// 1; blocks: the most blocks to launch (the card's SMs times the blocks per
// SM); claims: two zeroed 64-bit counters on the card for dynamic chunks
// (the kernel leaves them zeroed), or null for a static split.
extern "C" int copy_bounce(const void* src, void* dst, long long nbytes,
                           int n_slots, int stores, int chunk, int blocks,
                           void* claims, void* stream) {
  if (nbytes == 0) return (int)cudaSuccess;
  const int64_t n_chunks = (nbytes + chunk - 1) / chunk;
  const int grid = (int)(n_chunks < blocks ? n_chunks : blocks);
  const cudaStream_t s = (cudaStream_t)stream;
  unsigned long long* c = (unsigned long long*)claims;
  switch (n_slots) {
    case 2:
      return dispatch_bounce<2>(stores, src, dst, nbytes, chunk, grid, c, s);
    case 8:
      return dispatch_bounce<8>(stores, src, dst, nbytes, chunk, grid, c, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
