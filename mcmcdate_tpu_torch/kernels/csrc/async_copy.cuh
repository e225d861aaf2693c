// Asynchronous global -> shared copies (cp.async, sm_80 and later), shared
// by the kernels that stage tiles through shared memory (K2 whiten, K4
// point_scan, K5 range_scan).  4-byte copies stage rows of any length and alignment, and
// a false predicate writes a zero without reading global memory (the zero
// fill of ragged and padded tiles); bulk copies (below) move whole rows
// whose pitch is a multiple of 16 bytes.

#pragma once

#include <cuda_runtime.h>

namespace mcmcdate {

// Copy one float from global ``src`` to shared ``dst``, or write 0.0f to
// ``dst`` when ``pred`` is false (``src`` is not read then, but must be a
// valid address).
__device__ __forceinline__ void cp_async_f32(float* dst, const float* src, bool pred) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int n = pred ? 4 : 0;
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(src), "r"(n));
}

// Copy 16 bytes (4 floats) from global ``src`` to shared ``dst``, both
// 16-byte aligned, or write zeros when ``pred`` is false.  Bypasses L1.
__device__ __forceinline__ void cp_async_f32x4(float* dst, const float* src, bool pred) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int n = pred ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// Wait until at most ``N`` of this thread's committed groups are pending.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Bulk copies (the Tensor Memory Accelerator's 1-D form, sm_90): one thread
// moves a contiguous run of bytes (16-byte aligned, a multiple of 16 long)
// into shared memory, and the copy reports its bytes to an mbarrier, on
// which the consumers wait.  No per-thread copy instructions, no register
// or in-flight request per 16 bytes.

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// Initialise an mbarrier that expects one arrival per phase (the thread
// that announces the bytes of a stage).
__device__ __forceinline__ void mbar_init(unsigned long long* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_addr(bar)));
}

// Make barrier initialisations and generic-proxy writes to shared memory
// visible to the bulk copies that follow.
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Arrive on ``bar`` announcing ``bytes`` still to land in this phase.
__device__ __forceinline__ void mbar_expect_bytes(unsigned long long* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void bulk_copy(void* dst, const void* src, unsigned bytes,
                                          unsigned long long* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// Wait until phase ``parity`` of ``bar`` has completed.
__device__ __forceinline__ void mbar_wait(unsigned long long* bar, unsigned parity) {
  unsigned done = 0;
  do {
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

}  // namespace mcmcdate
