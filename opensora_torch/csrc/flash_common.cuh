// Device helpers shared by the port's kernels (sm_90a): shared-memory
// addresses, bf16 packing, exp2, the backward's exp2-domain LSE and the
// dynamic shared-memory limit.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace flash {

typedef __nv_bfloat16 bf16;

constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// The backward's LSE in the exp2 domain: lse * log2(e), with fully masked
// rows (lse <= -5e29) anchored at 0 as the TPU kernels do.
__device__ __forceinline__ float lse_log2_safe(float l) { return l <= NEG_INF * 0.5f ? 0.f : l * LOG2E; }

__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// The dynamic shared-memory limit of a kernel is raised once per device, at
// its first launch there. SEEN is a per-instantiation bit set of devices.
template <typename Kernel>
cudaError_t raise_smem_limit(Kernel kern, int smem, unsigned& seen) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (!(__atomic_load_n(&seen, __ATOMIC_ACQUIRE) >> dev & 1u)) {
    err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    __atomic_fetch_or(&seen, 1u << dev, __ATOMIC_ACQ_REL);
  }
  return cudaSuccess;
}

}  // namespace flash
