// Hopper's asynchronous copies and barriers, as inline PTX, shared by the
// persistent decode step (decode.cu) and the probes (dma_probe.cu,
// lowering_probe.cu):
//
// - cp.async: 16-byte (and 4-byte) copies from device memory into shared
//   memory, in commit groups;
// - mbarriers in shared memory: arrivals, and the transaction bytes a bulk
//   copy reports to them;
// - bulk copies (the TMA engine, no tensor map): device memory to shared
//   memory, completing on an mbarrier, and shared memory to device memory,
//   completing in bulk groups;
// - a grid-wide barrier for the blocks of a cooperative launch, and the
//   device's nanosecond clock;
// - tensor copies (TMA through a CUtensorMap: 2-D and 3-D boxes, device
//   memory to shared memory, completing on an mbarrier) and the warpgroup
//   matrix multiply (wgmma) over 128-byte swizzled bf16 tiles, which the
//   prefill's GEMM (prefill.cu) is built from.
//
// A bulk copy needs both addresses 16-byte aligned and a size that is a
// multiple of 16 bytes.
#pragma once

#include <cuda.h>  // CUtensorMap (the type only: nothing links libcuda)
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

// 4 bytes (a row scale), through the L1
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
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

// ------------------------------------------------------------ TMA, wgmma

// A box of the 2-D tensor map `map` at coordinates (c0 innermost, c1) into
// shared memory at dst; its bytes complete on `bar`. The map lives in
// kernel parameter space (a `const __grid_constant__ CUtensorMap`).
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map,
                                            int c0, int c1, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1),
      "r"(smem_addr(bar))
      : "memory");
}

__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map,
                                            int c0, int c1, int c2,
                                            uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
      "r"(smem_addr(bar))
      : "memory");
}

// Ask the TMA engine to bring `bytes` (a multiple of 16) from p (16-byte
// aligned) into the L2: one instruction for a contiguous run (no shared
// memory, no completion).
__device__ __forceinline__ void bulk_prefetch_l2(const void* p,
                                                 unsigned bytes) {
  asm volatile("cp.async.bulk.prefetch.L2.global [%0], %1;\n" ::"l"(p),
               "r"(bytes)
               : "memory");
}

// Ask the TMA engine to bring a box of a 3-D tensor map into the L2 (no
// shared memory, no completion).
__device__ __forceinline__ void tma_prefetch_3d(const CUtensorMap* map,
                                                int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.prefetch.tensor.3d.L2.global [%0, {%1, %2, %3}];\n" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// A wgmma matrix descriptor of a bf16 operand tile written by TMA with
// 128-byte swizzling: rows of 128 bytes, 8-row swizzle atoms of 1024 bytes
// (the tile 1024-byte aligned, so the base offset is 0). K-major (A): `sbo`
// is the stride between 8-row groups (1024), `lbo` unused; the k16 step
// advances the address by 32 bytes inside the row. MN-major (B read with
// the transpose bit): 64 N values a row, `sbo` between 8-row groups of K,
// `lbo` between 64-column atoms of N; the k16 step advances by 2048 bytes.
__device__ __forceinline__ uint64_t wgmma_desc_sw128(const void* p,
                                                     unsigned lbo,
                                                     unsigned sbo) {
  return (uint64_t)((smem_addr(p) & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

// Keep the compiler from moving a use of an accumulator register across
// the asynchronous wgmma that writes it.
__device__ __forceinline__ void fence_operand(float& r) {
  asm volatile("" : "+f"(r)::"memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// wait until at most N of the warpgroup's wgmma groups are pending
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// d += A B over a 64 x 64 x 16 step: A K-major, B MN-major (transposed),
// both bf16 from shared memory, d f32 in registers (32 a thread: register
// 4 n8 + 2 h + e is row 16 warp + lane / 4 + 8 h, column 8 n8 + 2 (lane %
// 4) + e of the warpgroup's tile).
__device__ __forceinline__ void wgmma_m64n64k16_tb(float (&d)[32],
                                                   uint64_t da, uint64_t db) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, 1, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      " %8, %9, %10, %11, %12, %13, %14, %15, "
      " %16, %17, %18, %19, %20, %21, %22, %23, "
      " %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db)
      : "memory");
}

// A barrier among `count` threads of the block (a multiple of 32), id
// 1-15 (0 is __syncthreads'). The id is a constant, so that the kernel
// reserves only the barriers it names.
template <int ID>
__device__ __forceinline__ void named_barrier(int count) {
  asm volatile("bar.sync %0, %1;\n" ::"n"(ID), "r"(count) : "memory");
}

// ------------------------------------------------------------ mma.sync

// Four 8x8 bf16 matrices from shared memory, a row address from each
// thread (threads 8 i .. 8 i + 7 give matrix i's rows); `trans` loads
// each matrix transposed.
__device__ __forceinline__ void ldmatrix_x4(unsigned (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(unsigned (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// d += a b over a 16 x 8 x 16 step, bf16 operands, f32 accumulate
__device__ __forceinline__ void mma_16816(float (&d)[4], const unsigned (&a)[4],
                                          unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a b over a 16 x 8 x 32 step, int8 operands, exact int32 accumulate.
// Its fragments hold, byte for byte, what mma_16816's hold (A: rows
// lane / 4 and + 8, bytes 4 (lane % 4) .. + 3 and + 16 of each 32-byte
// k-step; B: key lane / 4, the same bytes), so ldmatrix_x4 loads them from
// rows of 16 bytes as it loads the bf16 ones.
__device__ __forceinline__ void mma_16832_s8(int (&d)[4],
                                             const unsigned (&a)[4],
                                             unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
