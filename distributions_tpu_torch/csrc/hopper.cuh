// Hopper's asynchronous machinery (sm_90a) in inline PTX, for the kernels
// that stream through shared memory (roofline.cu's B3 and B4):
//
//   - mbarriers: a phase completes when its arrivals and its expected
//     transaction bytes are all in; waits name the parity of the phase;
//   - TMA: 2-D tiled loads through a tensor map, and 1-D bulk copies
//     (global -> shared with an mbarrier, shared -> global in bulk groups),
//     with an L2 cache policy;
//   - wgmma: the warpgroup's asynchronous bf16 product m64n64k16 with f32
//     sums, its fence, commit and wait, and the shared-memory descriptor of
//     a 128-byte-swizzled tile;
//   - proxy fences between thread accesses and the asynchronous units;
//   - arrival counters in global memory for kernels whose blocks are all
//     resident (a cooperative launch).
//
// Every wait traps after HOPPER_SPIN_CYCLES (about 10 s): a protocol fault
// ends the launch with an error instead of hanging the card.

#pragma once

#include <cuda.h>           // CUtensorMap (the type only: no driver call)
#include <cuda_runtime.h>
#include <stdint.h>

#define HOPPER_SPIN_CYCLES (1LL << 34)

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// the block's dynamic shared memory
__device__ __forceinline__ uint8_t* dynamic_smem() {
  extern __shared__ __align__(1024) uint8_t hopper_dynamic_smem[];
  return hopper_dynamic_smem;
}

__device__ __forceinline__ void spin_guard(long long t0) {
  if (clock64() - t0 > HOPPER_SPIN_CYCLES) __trap();
}

// -- mbarriers ----------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}

// makes the initialised barriers visible to the asynchronous units
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(
                   smem_u32(bar))
               : "memory");
}

// one arrival that also expects `bytes` of transactions in this phase
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar,
                                                      unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint64_t* bar,
                                              unsigned parity) {
  uint32_t done;
  asm volatile(
      "{\n .reg .pred p;\n"
      " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      " selp.u32 %0, 1, 0, p;\n}"
      : "=r"(done)
      : "r"(smem_u32(bar)), "r"(parity)
      : "memory");
  return done != 0;
}

// returns once the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  if (mbar_try_wait(bar, parity)) return;
  const long long t0 = clock64();
  while (!mbar_try_wait(bar, parity)) spin_guard(t0);
}

// -- TMA ---------------------------------------------------------------------

// the box of `map` at (c0 inner, c1 outer) into shared memory, completing
// its bytes on `bar`
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];" ::"r"(smem_u32(dst)),
      "l"((uint64_t)map), "r"(smem_u32(bar)), "r"(c0), "r"(c1)
      : "memory");
}

// an L2 policy that evicts these lines first: for data streamed once
__device__ __forceinline__ uint64_t l2_evict_first() {
  uint64_t policy;
  asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;"
               : "=l"(policy));
  return policy;
}

// `bytes` (a multiple of 16, both addresses 16-byte aligned) from global
// to shared memory, completing on `bar`
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          unsigned bytes, uint64_t* bar,
                                          uint64_t policy) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      ".L2::cache_hint [%0], [%1], %2, [%3], %4;" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar)), "l"(policy)
      : "memory");
}

// `bytes` from shared to global memory, in the thread's open bulk group
__device__ __forceinline__ void bulk_store(void* dst, const void* src,
                                           unsigned bytes, uint64_t policy) {
  asm volatile(
      "cp.async.bulk.global.shared::cta.bulk_group.L2::cache_hint"
      " [%0], [%1], %2, %3;" ::"l"(dst),
      "r"(smem_u32(src)), "r"(bytes), "l"(policy)
      : "memory");
}

__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;" ::: "memory");
}

// at most N of the thread's bulk groups still read shared memory
template <int N>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;" ::"n"(N) : "memory");
}

// at most N of the thread's bulk groups incomplete
template <int N>
__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group %0;" ::"n"(N) : "memory");
}

// -- proxy fences ------------------------------------------------------------

// this thread's shared-memory writes before it, visible to bulk copies
// and wgmma after it
__device__ __forceinline__ void fence_proxy_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// global memory between thread accesses and TMA
__device__ __forceinline__ void fence_proxy_async_global() {
  asm volatile("fence.proxy.async.global;" ::: "memory");
}

// -- named barriers ----------------------------------------------------------

// `count` threads (a multiple of 32) of the block meet at barrier `id`
// (1-15; 0 is __syncthreads)
__device__ __forceinline__ void named_barrier(int id, int count) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(count) : "memory");
}

// -- arrival counters in global memory ---------------------------------------

// one thread of a block, after its block's writes
__device__ __forceinline__ void counter_arrive(unsigned* counter) {
  __threadfence();
  atomicAdd(counter, 1u);
}

// one thread: returns once `target` arrivals are in, with acquire order
__device__ __forceinline__ void counter_wait(const unsigned* counter,
                                          unsigned target) {
  const long long t0 = clock64();
  for (;;) {
    unsigned v;
    asm volatile("ld.acquire.gpu.global.u32 %0, [%1];"
                 : "=r"(v)
                 : "l"(counter)
                 : "memory");
    if (v >= target) return;
    __nanosleep(64);
    spin_guard(t0);
  }
}

// -- wgmma -------------------------------------------------------------------

// Descriptor of a tile in shared memory in the 128-byte swizzle, at a
// 1024-byte-aligned atom of 8 rows x 128 bytes: the start address, the
// leading and the stride byte offsets (16-byte units), layout type B128.
__device__ __forceinline__ uint64_t wgmma_desc(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

// orders register and shared-memory accesses before it with the wgmma
// after it
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}

// at most N of the warpgroup's committed groups still running
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// keeps the compiler from moving accesses of the accumulators across the
// asynchronous product
__device__ __forceinline__ void wgmma_fence_regs(float (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d[64 x 64] += A[64 x 16] . B[16 x 64], bf16 in, f32 sums, warpgroup-wide.
// A K-major (rows of K), B MN-major (rows of N: the transposed-B mode).
// Thread t of the warpgroup holds d[r] at row 16 (t / 32) + (t % 32) / 4
// + 8 ((r / 2) % 2), column 8 (r / 4) + 2 (t % 4) + r % 2.
__device__ __forceinline__ void wgmma_m64n64k16_bf16_tb(float (&d)[32],
                                                        uint64_t da,
                                                        uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(1));
}
