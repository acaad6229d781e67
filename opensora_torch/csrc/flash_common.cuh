// Device helpers shared by the port's kernels (sm_90a): cp.async tile loads
// with zero-fill, ldmatrix, the bf16 m16n8k16 tensor-core MMA, bf16
// packing, exp2 and the backward's exp2-domain LSE.
//
// Fragment layouts of mma.m16n8k16 (g = lane / 4, t = lane % 4):
//   A 16x16 row-major: a0 (row g, k 2t..2t+1), a1 (row g+8, k 2t..),
//                      a2 (row g, k 2t+8..),  a3 (row g+8, k 2t+8..)
//   B 16x8 "col":      b0 (k 2t..2t+1, col g), b1 (k 2t+8.., col g)
//   C 16x8 fp32:       c0, c1 (row g, cols 2t, 2t+1), c2, c3 (row g+8, ...)
// so a C tile of scores, packed pairwise to bf16, is directly the A
// fragment of the next product.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace flash {

typedef __nv_bfloat16 bf16;

constexpr int PAD = 8;  // row padding (bf16), keeps ldmatrix conflict-free
constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte async copy; src_bytes = 0 zero-fills the destination.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool valid) {
  int n = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src), "r"(n));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t& r0, uint32_t& r1, uint32_t& r2, uint32_t& r3,
                                            uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
               : "r"(addr));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t& r0, uint32_t& r1, uint32_t& r2,
                                                  uint32_t& r3, uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
               : "r"(addr));
}

// c += a (16x16, row) * b (16x8, col), bf16 inputs, fp32 accumulator.
__device__ __forceinline__ void mma_bf16(float (&c)[4], uint32_t a0, uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
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

// Async-copy a ROWS x COLS bf16 tile (rows row0.. of a row-major matrix with
// leading dimension ld) into shared memory with row stride COLS + PAD, by
// THREADS threads. Rows at or past nrows are zero-filled.
template <int ROWS, int COLS, int THREADS>
__device__ __forceinline__ void load_tile(bf16* smem, const bf16* g, int row0, int nrows, int ld) {
  constexpr int CHUNKS = COLS / 8;
#pragma unroll 4
  for (int i = threadIdx.x; i < ROWS * CHUNKS; i += THREADS) {
    const int r = i / CHUNKS;
    const int c = (i % CHUNKS) * 8;
    const bool valid = row0 + r < nrows;
    const bf16* src = g + (size_t)(valid ? row0 + r : 0) * ld + c;
    cp_async16(smem_u32(smem + r * (COLS + PAD) + c), src, valid);
  }
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
