// Asynchronous bulk copies from device memory into shared memory on Hopper
// (cp.async.bulk, the copy engine of the Tensor Memory Accelerator without
// a tensor map) and the transaction barriers (mbarrier) that report their
// completion, plus the split cluster barrier.
//
// tensor_load_3d is the same engine with a tensor map (cp.async.bulk.tensor):
// one instruction copies a box of a 3-D tensor, zeros where the box lies
// outside it, and counts the whole box's bytes on the barrier.
//
// Use: one thread initialises a barrier with one arrival (mbar_init), then
// fence_mbar_init() and __syncthreads(). Per use, one thread arms it with
// the bytes to come (mbar_expect_tx), and the copies (bulk_load: 16-byte
// aligned addresses, sizes a multiple of 16) count those bytes off; every
// thread that reads the data first waits for the phase (mbar_wait with the
// use's parity: 0, 1, 0, ...). Before a buffer that threads have read or
// written is refilled asynchronously, the issuing thread calls
// fence_proxy_async() after the block's barrier.
#pragma once

#include <cstdint>

#include <cuda_runtime.h>

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}

// makes the barriers' initialisation visible to the copy engine and to the
// other thread blocks of a cluster
__device__ __forceinline__ void fence_mbar_init() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

// orders this thread's earlier shared-memory accesses before the copy
// engine's later writes
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// one arrival, and `bytes` more to come from bulk copies in this phase
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

// blocks until the barrier's phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_addr(bar);
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  } while (!done);
}

// bytes from global src to shared dst, completion counted on bar
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
      ::"r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// the box of `map` (a CUtensorMap in kernel parameter space) at coordinates
// (c0, c1, c2), innermost first, to shared dst (128-byte aligned),
// completion counted on bar
__device__ __forceinline__ void tensor_load_3d(void* dst, const void* map, int c0, int c1,
                                               int c2, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];"
      ::"r"(smem_addr(dst)), "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)),
      "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// The cluster barrier in two halves: every thread of every block of the
// cluster arrives (releasing its earlier memory accesses, shared memory of
// other blocks included), and a wait returns once all have arrived
// (acquiring theirs). Arrive and wait alternate in each thread.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;" ::: "memory");
}
