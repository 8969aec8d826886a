// Asynchronous copies into shared memory on Hopper (sm_90a), shared by the
// kernels that stage operands ahead of their arithmetic: the fp32 chain
// (wide_chain.cu), the in-place fp32 mat step (split_block.cu), the "high"
// kernels on wgmma and the copy probes (copy_probe.cu).
//
// Two mechanisms, which complete independently of each other:
//   cp.async (16 bytes a thread, per-thread commit groups): table and row
//     slices.  A thread waits for its own groups only, in the order it
//     committed them, so a long copy in a group blocks every later wait.
//   TMA bulk copies (cp.async.bulk, completion counted in bytes on an
//     mbarrier): whole state rows, which come from device memory and may
//     take many slices' time to land without holding up the slices.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace async {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, cached in L2 only; zeros when !valid (src is
// then not read but must still be a mapped address).
__device__ __forceinline__ void cp16(void* dst, const void* src,
                                     bool valid = true) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               ::"r"(smem_u32(dst)), "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// every group of this thread but the newest n has landed
template <int n>
__device__ __forceinline__ void wait_groups() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(n) : "memory");
}

// a barrier whose phase completes after `count` arrivals (and the bytes
// its arrivals expect)
__device__ __forceinline__ void bar_init(uint64_t* bar, uint32_t count = 1) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

// one arrival (release: this thread's earlier accesses happen before the
// phase completes)
__device__ __forceinline__ void bar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               ::"r"(smem_u32(bar))
               : "memory");
}

// make initialised mbarriers visible to the async proxy (then a CTA barrier)
__device__ __forceinline__ void bar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void bar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

// the one arrival of the barrier's phase, expecting `bytes` of bulk copies
__device__ __forceinline__ void bar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               ::"r"(smem_u32(bar)), "r"(bytes)
               : "memory");
}

// order this thread's generic accesses to shared memory (and, after a CTA
// barrier, every thread's) before async-proxy writes issued after it
__device__ __forceinline__ void fence_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// TMA bulk copy global -> shared of `bytes` (a multiple of 16, both ends
// 16-byte aligned), counted on `bar`, which expects it
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// one bulk copy that is its barrier phase's whole expectation
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  bar_expect(bar, bytes);
  bulk_copy(dst, src, bytes, bar);
}

// Let `kernel` take `bytes` of dynamic shared memory (above 48 KB) on the
// current device, once a device: the attribute belongs to the device, and
// the shards of a mesh may sit on several cards.  *done holds one bit a
// device ordinal, set when the attribute has been set there.
template <typename K>
inline cudaError_t allow_smem(K kernel, size_t bytes, unsigned* done) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  const unsigned bit = dev < 32 ? 1u << dev : 0u;
  if (*done & bit) return cudaSuccess;
  e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (e == cudaSuccess) *done |= bit;
  return e;
}

// The CTAs of `kernel` that fit on the current device at once: the grid of
// a persistent kernel.
template <typename K>
inline cudaError_t persistent_slots(K kernel, int threads, size_t smem,
                                   int* slots) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess ||
      (e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                  dev)) != cudaSuccess ||
      (e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, kernel, threads, smem)) != cudaSuccess)
    return e;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  *slots = sms * per_sm;
  return cudaSuccess;
}

}  // namespace async
