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
// for the probe's 256 MB. The three designs differ only in how they keep
// enough bytes in flight to cover the memory latency:
//   copy_block   one 16-byte load and store per thread, neighbouring threads
//                on neighbouring addresses; a plain grid of 4 KB blocks
//                (65,536 blocks for 256 MB, about 500 per SM, so the last
//                wave is short). The counterpart of Pallas's row blocks,
//                whose 256-row blocks would give only 64 blocks here.
//   copy_direct  a persistent grid; each thread issues 8 independent
//                16-byte loads into registers before it stores them: the
//                TPU's "8 DMAs in flight", done with SM registers, since
//                Hopper has no global-to-global TMA.
//   copy_bounce  a persistent grid of one block per SM. One thread walks the
//                block's chunks through an n_slots-deep ring in dynamic
//                shared memory: TMA 1-D bulk loads signal one mbarrier per
//                slot (complete_tx, with a phase bit per use of the slot),
//                TMA bulk stores go out as bulk groups, and a slot is
//                refilled only after cp.async.bulk.wait_group.read says its
//                store has read it. No register or SM instruction touches the
//                data.
// Every size and address is a multiple of 16 bytes (the rule of TMA and of
// 16-byte vectors); the wrapper (ops/cuda/copy_probe.py) checks it, and the
// buffers must not overlap.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlockThreads = 256;
constexpr int kDirectDepth = 8;     // 16-byte loads in flight per thread
constexpr int kDirectBlocksPerSm = 8;
constexpr int kRingOffset = 128;    // the ring starts after the mbarriers

__global__ void __launch_bounds__(kBlockThreads)
copy_block_kernel(const uint4* __restrict__ src, uint4* __restrict__ dst,
                  int64_t n) {
  const int64_t i = (int64_t)blockIdx.x * kBlockThreads + threadIdx.x;
  if (i < n) dst[i] = src[i];
}

__global__ void __launch_bounds__(kBlockThreads)
copy_direct_kernel(const uint4* __restrict__ src, uint4* __restrict__ dst,
                   int64_t n) {
  const int64_t tile = (int64_t)kDirectDepth * kBlockThreads;
  for (int64_t base = (int64_t)blockIdx.x * tile + threadIdx.x; base < n;
       base += (int64_t)gridDim.x * tile) {
    uint4 v[kDirectDepth];
#pragma unroll
    for (int j = 0; j < kDirectDepth; ++j) {
      const int64_t i = base + (int64_t)j * kBlockThreads;
      if (i < n) v[j] = src[i];
    }
#pragma unroll
    for (int j = 0; j < kDirectDepth; ++j) {
      const int64_t i = base + (int64_t)j * kBlockThreads;
      if (i < n) dst[i] = v[j];
    }
  }
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   bar),
               "r"(bytes)
               : "memory");
}

// Spin until the phase of parity `parity` of the barrier has completed. A
// chunk arrives in microseconds; a wait of 2^32 cycles (over 2 s) can only be
// a fault, and traps, so that it ends the launch with an error instead of
// holding the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  const long long start = clock64();
  uint32_t done = 0;
  while (!done) {
    if (clock64() - start > (1ll << 32)) __trap();
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

// TMA 1-D bulk load global -> shared; completion is counted on `bar`.
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// TMA 1-D bulk store shared -> global, as one bulk group.
__device__ __forceinline__ void bulk_store(void* dst, uint32_t src,
                                           uint32_t bytes) {
  asm volatile(
      "cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n" ::"l"(
          dst),
      "r"(src), "r"(bytes)
      : "memory");
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// Chunk k of this block: its byte offset and size (the last one is ragged).
struct Chunk {
  int64_t off;
  uint32_t bytes;
};

__device__ __forceinline__ Chunk chunk_of(int64_t k, int64_t nbytes,
                                          int chunk) {
  const int64_t off = ((int64_t)blockIdx.x + k * gridDim.x) * chunk;
  const int64_t left = nbytes - off;
  return {off, (uint32_t)(left < chunk ? left : chunk)};
}

// One thread per block. Chunk k of the block (global chunk blockIdx.x +
// k * gridDim.x) lives in slot k % NS; its load is the (k / NS)-th
// completion of that slot's mbarrier, so the wait's parity is (k / NS) & 1.
template <int NS>
__global__ void __launch_bounds__(1)
copy_bounce_kernel(const char* __restrict__ src, char* __restrict__ dst,
                   int64_t nbytes, int chunk) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int64_t n_chunks = (nbytes + chunk - 1) / chunk;
  if ((int64_t)blockIdx.x >= n_chunks) return;
  const int64_t mine = (n_chunks - blockIdx.x + gridDim.x - 1) / gridDim.x;
  const uint32_t bars = smem_addr(smem);
  const uint32_t ring = bars + kRingOffset;
  for (int s = 0; s < NS; ++s) mbar_init(bars + 8 * s, 1);
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");

  const int64_t ahead = mine < NS ? mine : NS;
  for (int64_t k = 0; k < ahead; ++k) {
    const Chunk c = chunk_of(k, nbytes, chunk);
    const uint32_t bar = bars + 8 * (uint32_t)k;
    mbar_expect_tx(bar, c.bytes);
    bulk_load(ring + (uint32_t)k * chunk, src + c.off, c.bytes, bar);
  }
  for (int64_t k = 0; k < mine; ++k) {
    const uint32_t s = (uint32_t)(k % NS);
    const uint32_t bar = bars + 8 * s;
    const uint32_t slot = ring + s * chunk;
    mbar_wait(bar, (uint32_t)((k / NS) & 1));
    const Chunk c = chunk_of(k, nbytes, chunk);
    bulk_store(dst + c.off, slot, c.bytes);
    if (k + NS < mine) {
      // the slot is refilled only once its store has read it
      asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
      const Chunk next = chunk_of(k + NS, nbytes, chunk);
      mbar_expect_tx(bar, next.bytes);
      bulk_load(slot, src + next.off, next.bytes, bar);
    }
  }
  // the stores must be complete before the block (and its ring) goes away
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

template <int NS>
int launch_bounce(const void* src, void* dst, int64_t nbytes, int chunk,
                  int grid, void* stream) {
  const int smem = kRingOffset + NS * chunk;
  cudaError_t err = cudaFuncSetAttribute(
      copy_bounce_kernel<NS>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return (int)err;
  copy_bounce_kernel<NS><<<grid, 1, smem, (cudaStream_t)stream>>>(
      (const char*)src, (char*)dst, nbytes, chunk);
  return (int)cudaGetLastError();
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

// sms: the card's streaming multiprocessors (the persistent grid's size).
extern "C" int copy_direct(const void* src, void* dst, long long n16, int sms,
                           void* stream) {
  if (n16 == 0) return (int)cudaSuccess;
  const int64_t tile = (int64_t)kDirectDepth * kBlockThreads;
  int64_t blocks = (n16 + tile - 1) / tile;
  if (blocks > (int64_t)sms * kDirectBlocksPerSm)
    blocks = (int64_t)sms * kDirectBlocksPerSm;
  copy_direct_kernel<<<(unsigned)blocks, kBlockThreads, 0,
                       (cudaStream_t)stream>>>((const uint4*)src, (uint4*)dst,
                                               n16);
  return (int)cudaGetLastError();
}

// nbytes and chunk: multiples of 16; kRingOffset + n_slots * chunk bytes of
// dynamic shared memory per block; n_slots is 2 or 8.
extern "C" int copy_bounce(const void* src, void* dst, long long nbytes,
                           int n_slots, int chunk, int sms, void* stream) {
  if (nbytes == 0) return (int)cudaSuccess;
  const int64_t n_chunks = (nbytes + chunk - 1) / chunk;
  const int grid = (int)(n_chunks < sms ? n_chunks : sms);
  switch (n_slots) {
    case 2:
      return launch_bounce<2>(src, dst, nbytes, chunk, grid, stream);
    case 8:
      return launch_bounce<8>(src, dst, nbytes, chunk, grid, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
