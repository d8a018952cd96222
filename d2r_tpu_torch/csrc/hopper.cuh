// Hopper pieces that the warpgroup kernels share (W8A16 and K3's wgmma
// body): mbarriers, wgmma's shared-memory descriptors and its register
// fences, and cuTensorMapEncodeTiled looked up through the runtime (no link
// against libcuda).

#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_bf16.cuh"

namespace d2r {

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count));
}

// one arrival that also expects `bytes` of TMA transactions this phase
__device__ __forceinline__ void mbar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(bar)) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
#ifdef D2R_MBAR_TRAP
  // a build for checking new code (k3_sweep.py --check): a wait still
  // open after about a second of SM clocks traps, so a barrier that is
  // never completed fails the launch instead of hanging the card
  const long long t0 = clock64();
  for (uint32_t done = 0; !done;) {
    asm volatile(
        "{\n.reg .pred P1;\nmbarrier.try_wait.parity.shared::cta.b64 P1, [%1], %2;\n"
        "selp.u32 %0, 1, 0, P1;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
    if (!done && clock64() - t0 > 2000000000LL) asm volatile("trap;");
  }
  return;
#endif
  asm volatile(
      "{\n.reg .pred P1;\nLAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\nbra LAB_WAIT;\nDONE:\n}\n" ::"r"(smem_addr(bar)),
      "r"(parity)
      : "memory");
}

// a K-major, 128-byte swizzle descriptor: start address, LBO 1 (unused),
// SBO 1,024 bytes (the next 8 rows), layout B128
__device__ __forceinline__ uint64_t desc_b128(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) | ((uint64_t)64 << 32) |
         ((uint64_t)1 << 62);
}

// keeps the compiler from moving accesses to v across the wgmma bracket
template <int N>
__device__ __forceinline__ void fence_regs(float (&v)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(v[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&v)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(v[i])::"memory");
}

// the generic proxy's shared-memory writes made visible to wgmma's reads
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// cuTensorMapEncodeTiled, or null where the driver does not offer it
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

inline EncodeTiled encode_tiled() {
  static EncodeTiled encode = nullptr;
  if (encode == nullptr) {
    cudaDriverEntryPointQueryResult found;
    void* fn = nullptr;
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &found);
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      encode = reinterpret_cast<EncodeTiled>(fn);
  }
  return encode;
}

}  // namespace d2r
