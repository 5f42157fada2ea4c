// Hopper's asynchronous copies and barriers, as inline PTX, shared by the
// persistent decode step (decode.cu) and the probes (dma_probe.cu,
// lowering_probe.cu):
//
// - cp.async: 16-byte copies from device memory into shared memory, in
//   commit groups;
// - mbarriers in shared memory: arrivals, and the transaction bytes a bulk
//   copy reports to them;
// - bulk copies (the TMA engine, no tensor map): device memory to shared
//   memory, completing on an mbarrier, and shared memory to device memory,
//   completing in bulk groups;
// - a grid-wide barrier for the blocks of a cooperative launch, and the
//   device's nanosecond clock.
//
// A bulk copy needs both addresses 16-byte aligned and a size that is a
// multiple of 16 bytes.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most n groups are pending (n is an immediate in PTX)
__device__ __forceinline__ void cp_async_wait(int n) {
  switch (n) {
    case 0: asm volatile("cp.async.wait_group 0;\n" ::: "memory"); break;
    case 1: asm volatile("cp.async.wait_group 1;\n" ::: "memory"); break;
    case 2: asm volatile("cp.async.wait_group 2;\n" ::: "memory"); break;
    case 3: asm volatile("cp.async.wait_group 3;\n" ::: "memory"); break;
    case 4: asm volatile("cp.async.wait_group 4;\n" ::: "memory"); break;
    case 5: asm volatile("cp.async.wait_group 5;\n" ::: "memory"); break;
    case 6: asm volatile("cp.async.wait_group 6;\n" ::: "memory"); break;
    default: asm volatile("cp.async.wait_group 7;\n" ::: "memory"); break;
  }
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(count)
               : "memory");
}

// after the initialising thread's mbar_init calls, before any use
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

// wait for the completion of the barrier's phase of parity `parity`
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  const unsigned a = smem_addr(bar);
  unsigned done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
  }
}

// device memory -> shared memory; the bytes complete on `bar`
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          unsigned bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// Make this thread's ordinary shared-memory writes visible to the async
// proxy (bulk copies out of shared memory, wgmma): after the writes, before
// the barrier that precedes the copy.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// shared memory -> device memory, in the thread's current bulk group
__device__ __forceinline__ void bulk_store(void* dst, const void* src,
                                           unsigned bytes) {
  asm volatile(
      "cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n" ::"l"(
          dst),
      "r"(smem_addr(src)), "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// wait until the thread's bulk groups have read their shared memory (it
// may be written again)
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

// wait until the thread's bulk groups are complete (their writes done)
__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// a hint that the line holding p is read soon: fetch it into the L2
__device__ __forceinline__ void prefetch_l2(const void* p) {
  asm volatile("prefetch.global.L2 [%0];" ::"l"(p));
}

// the device's global clock, in ns
__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// All blocks of a cooperative launch wait here for each other: *count
// counts every block's arrivals at every barrier of the launch, so the
// k-th barrier (from 1) is passed when it reaches k gridDim.x. One
// release-add an arrival (after the block's __syncthreads, so it releases
// every thread's writes), acquire loads while waiting. The count starts at
// 0 and its launch leaves it 0 (each kernel says how). A block may work
// between its arrival and its wait (grid_arrive, then grid_wait) on what
// no other block reads. A block that waits more than 10 s traps, so a
// barrier some block never reaches fails the launch instead of holding
// the card.
__device__ __forceinline__ void grid_arrive(unsigned* count) {
  __syncthreads();
  if (threadIdx.x == 0)
    asm volatile("red.release.gpu.global.add.u32 [%0], 1;\n" ::"l"(count)
                 : "memory");
}

__device__ __forceinline__ void grid_wait(unsigned* count, unsigned target) {
  if (threadIdx.x == 0) {
    unsigned seen = 0, polls = 0;
    unsigned long long t0 = 0;
    do {
      asm volatile("ld.acquire.gpu.global.u32 %0, [%1];\n"
                   : "=r"(seen)
                   : "l"(count)
                   : "memory");
      if ((++polls & 0xffffu) == 0) {
        const unsigned long long now = global_ns();
        if (t0 == 0)
          t0 = now;
        else if (now - t0 > 10000000000ull)
          __trap();
      }
    } while (seen < target);
  }
  __syncthreads();
}

__device__ __forceinline__ void grid_barrier(unsigned* count,
                                             unsigned target) {
  grid_arrive(count);
  grid_wait(count, target);
}
