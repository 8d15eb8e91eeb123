// The TMA ring's building blocks for Hopper, shared by the kernels of this
// directory that stream through shared memory with bulk copies:
// copy_probe.cu (the copy probe's ring) and fused_stdc.cu (the
// CatBottleneck's weight ring). Each helper is one PTX instruction, or a
// loop around one: an mbarrier's init, its arrive with a byte count, a
// wait on the parity of one of its phases, and 1-D bulk copies between
// device and shared memory (cp.async.bulk, Hopper's TMA without a tensor
// map), completing on an mbarrier (load) or as a bulk group (store).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace tma_ring {

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

}  // namespace tma_ring
