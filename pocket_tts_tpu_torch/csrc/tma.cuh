// Hopper's asynchronous copies, shared by the port's persistent kernels
// (decode_stack.cu, gemv_stack.cu): mbarriers in shared memory, 1-D bulk
// copies (TMA without a tensor map), 2-D tensor copies (TMA through a
// tensor map) and the L2 policies they carry.
#pragma once

#include <cuda.h>  // CUtensorMap
#include <cuda_runtime.h>
#include <stdint.h>

namespace pt {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* b, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(b)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* b, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(b)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* b) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(b)) : "memory");
}

// A wait that outlasts this many cycles (~10 s) is a fault: trap, so the
// launch fails with an error instead of hanging the card.
constexpr long long kSpinLimit = 20000000000LL;

__device__ __forceinline__ void watchdog(long long t0) {
  if (clock64() - t0 > kSpinLimit) __trap();
}

__device__ __forceinline__ void mbar_wait(uint64_t* b, uint32_t parity) {
  const uint32_t a = smem_u32(b);
  const long long t0 = clock64();
  uint32_t done = 0;
  while (!done) {
    watchdog(t0);
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
  }
}

// 1-D TMA: `bytes` (a multiple of 16, both addresses 16-byte aligned) from
// global to shared memory, counted on the mbarrier as they land.
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* b, uint64_t policy) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes.L2::cache_hint"
      " [%0], [%1], %2, [%3], %4;\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(b)), "l"(policy)
      : "memory");
}

// 2-D TMA: the box of the tensor map at (column c0, row c1) to shared
// memory, laid out (and swizzled) as the map says; the box's full size is
// counted on the mbarrier, out-of-bounds elements landing as zeros.
__device__ __forceinline__ void tensor_load_2d(void* dst, const CUtensorMap* map, int c0, int c1,
                                               uint64_t* b, uint64_t policy) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      ".L2::cache_hint [%0], [%1, {%2, %3}], [%4], %5;\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(smem_u32(b)), "l"(policy)
      : "memory");
}

// Data read once and larger than the L2 (weights) goes in evict-first, so
// that what is read again (activations, caches) stays; data every block
// reads goes in evict-last.
__device__ __forceinline__ uint64_t evict_first_policy() {
  uint64_t policy;
  asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;\n" : "=l"(policy));
  return policy;
}
__device__ __forceinline__ uint64_t evict_last_policy() {
  uint64_t policy;
  asm volatile("createpolicy.fractional.L2::evict_last.b64 %0, 1.0;\n" : "=l"(policy));
  return policy;
}

}  // namespace pt
