// Flash-attention backward at head dim 128 for Hopper (sm_90a): one fused
// warp-specialised kernel (wgmma + TMA) and a small dQ epilogue kernel.
//
// Replaces the two Pallas TPU backward kernels of
// opensora_tpu/ops/flash_attention.py at D = 128:
//   - _dkv_kernel (:425)  dV = sum_q P^T dO,  dK = sm_scale * sum_q dS^T Q
//   - _dq_kernel  (:497)  dQ = sm_scale * sum_k dS K
// with the TPU kernels' rounding points: P recomputed from the forward's
// LSE in the exp2 domain, p = exp2(s * c - lse_safe * log2(e)) with
// c = sm_scale * log2(e) and lse_safe = 0 for fully masked rows
// (lse <= -5e29); P rounded to bf16 before the dV product and
// dS = P (dP - delta) before the dK and dQ products; sm_scale multiplies the
// fp32 sums once, at the end (dK here, dQ in the epilogue kernel). Query rows
// past Lq, keys past Lk and keys of later frames (causal_block) give P = 0
// exactly; rows outside the tensors are zero-filled by the TMA, so no
// garbage reaches a product. delta = rowsum(dO * O) comes from the caller.
// D = 512 (the VAE mid-block) stays on csrc/flash_attention_bwd.cu.
//
// Design. One CTA owns 128 keys of one (b, h) (grid ceil(Lk / 128) x B*H)
// and walks that (b, h)'s query rows in tiles of 64. Three warpgroups:
//   - the producer (setmaxnreg down to 24): one thread keeps K and V
//     resident and 2 stages of Q and dO in flight by TMA (128-byte
//     swizzle); one warp copies the stage's LSE (as lse_safe * log2 e) and
//     delta into shared memory;
//   - two consumers (setmaxnreg up to 240), each owning 64 of the 128 keys.
//     Per query tile each runs the 5 products of the minimal backward on
//     wgmma:
//       S^T = K_wg Q^T,  dP^T = V_wg dO^T        (m64n64, both from smem)
//       P^T = exp2(S^T c - lse)                  (masked only where needed)
//       dV_wg += P^T dO                          (m64n128, P^T from registers)
//       dS^T = P^T (dP^T - delta)
//       dK_wg += dS^T Q                          (m64n128, dS^T from registers)
//     then writes dS^T (bf16) to shared memory; after a named barrier each
//     consumer computes 64 of the 128 columns of the tile's dQ partial,
//     dS K_cols (m64n64, both operands MN-major from smem), stages it in
//     shared memory and adds it into the fp32 dq_accum with one 16 KB bulk
//     reduce-add.
// Shared memory: K, V 32 KB each; Q, dO 2 stages x 16 KB each; dS^T 2 x
// 16 KB (two buffers, so one named barrier a tile suffices); a 16 KB dQ
// staging tile per consumer; LSE and delta 1 KB: 193 KB, one CTA per SM. Registers of a
// consumer thread: dK and dV 64 each, S^T and dP^T 32 each, the bf16 P^T
// fragments 16, the dQ partial 32 (after S^T and dP^T die).
//
// dq_accum is not row-major: each (query tile, consumer) owns 16 KB in the
// wgmma accumulator's order, [j 0..7][thread 0..127][4 floats], so every
// thread stages its fragment with conflict-free 16-byte stores and the
// reduce-add moves one contiguous block; flash_bwd_dq_convert_kernel maps
// it back to rows and columns, multiplies by sm_scale and rounds to bf16.
// The reduce-adds of different CTAs into one tile land in an order that
// changes from run to run, so dQ is not bitwise reproducible: fp32 sums of
// Lk / 128 partials, the spread a few fp32 ulps before the bf16 rounding.
//
// What bounds it, at the MMDiT shape (B=3, H=24, L=8828, D=128): the 5
// products of 2 * B * H * L^2 * D = 1.436 TFLOP each, 7.18 TFLOP, 7.26 ms
// at 989 TFLOP/s, on 0.98 GB of q/k/v/dO/dq/dk/dv: ~10^4 flops a byte, so
// operations bound it. The dQ reduce traffic is the design's main risk:
// 69 key blocks x 138 query tiles x 72 (b, h) = 685,584 tile pairs x 32 KB
// = 22.5 GB of fp32 adds into L2 a call (dq_accum, 0.33 GB, stays in L2
// only in part).
//
// What the design does about the split kernels it replaces (two kernels,
// mma.sync from ldmatrix): it computes 5 products where they computed 7
// (S and dP once, for dV, dK and dQ), and exp2 once per (query, key) where
// they did it twice; wgmma from 128-byte-swizzled shared memory replaces
// mma.sync m16n8k16 fed by ldmatrix, and a 64-row warpgroup tile reads each
// operand once per product instead of once per warp; TMA with mbarriers and
// a producer warpgroup replace cp.async and two __syncthreads a step.
//
// The main loop (bwd_mainloop, in flash_bwd_sm90.cuh) is a device template
// over the query and key offsets of the causal mask (global positions of
// local row 0) and over the dK/dV epilogue: StoreBf16 here; the ring
// backward's hop kernel (ring_flash_attention.cu) adds into its travelling
// fp32 accumulators instead.
//
// Layout: q, k, v, dout, dk, dv are (B, H, L, 128) contiguous bf16; lse
// and delta (B, H, Lq) fp32; dq_accum (B, H, ceil(Lq / 64) * 64, 128)
// fp32, zeroed by the caller; dq (B, H, Lq, 128) bf16.

#include "flash_bwd_sm90.cuh"

namespace {

using namespace fbwd;

// dK, dV of one consumer's 64 keys written as bf16 (dK times sm_scale).
struct StoreBf16 {
  static constexpr bool kSkipEmpty = false;  // keys no query sees get zero gradients
  bf16* dk;
  bf16* dv;
  float sm_scale;
  int Lk;
  // rows key0 + g (+ 8) of (b, h) bh hold d[4 j + 2 i + e], column 8 j + 2 q + e
  __device__ __forceinline__ void operator()(const float (&dk_acc)[64], const float (&dv_acc)[64], int bh, int key0,
                                             int g, int q) const {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int key = key0 + g + 8 * i;
      if (key >= Lk) continue;
      const size_t base = ((size_t)bh * Lk + key) * D + 2 * q;
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        *reinterpret_cast<__nv_bfloat162*>(dk + base + 8 * j) =
            __floats2bfloat162_rn(dk_acc[4 * j + 2 * i] * sm_scale, dk_acc[4 * j + 2 * i + 1] * sm_scale);
        *reinterpret_cast<__nv_bfloat162*>(dv + base + 8 * j) =
            __floats2bfloat162_rn(dv_acc[4 * j + 2 * i], dv_acc[4 * j + 2 * i + 1]);
      }
    }
  }
};

template <bool CAUSAL>
__global__ void __launch_bounds__(NTHREADS, 1)
    flash_bwd_fused_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                           const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap tdo,
                           const BwdParams p, const StoreBf16 epilogue) {
  bwd_mainloop<CAUSAL>(&tq, &tk, &tv, &tdo, p, blockIdx.x * BLOCK_N, blockIdx.y, epilogue);
}

// dq = bf16(dq_accum * sm_scale): one thread per float4 of dq_accum, which
// holds rows 16 w + g and + 8, columns 64 h + 8 j + 2 q and + 1 of its tile
// (thread t = 32 w + 4 g + q of consumer h, float4 j).
__global__ void __launch_bounds__(256)
    flash_bwd_dq_convert_kernel(const float4* __restrict__ dq_accum, bf16* __restrict__ dq, int Lq, int n_qtiles,
                                long long n, float sm_scale) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int t = i % 128, j = (i / 128) % 8, h = (i / 1024) % 2;
  const long long tile = i / 2048;  // (b, h) * n_qtiles + query tile
  const int qt = tile % n_qtiles;
  const long long bh = tile / n_qtiles;
  const int row = qt * BLOCK_M + 16 * (t / 32) + (t % 32) / 4;
  const int col = 64 * h + 8 * j + 2 * (t % 4);
  const float4 a = dq_accum[i];
  bf16* out = dq + (bh * Lq + row) * D + col;
  if (row < Lq) *reinterpret_cast<__nv_bfloat162*>(out) = __floats2bfloat162_rn(a.x * sm_scale, a.y * sm_scale);
  if (row + 8 < Lq)
    *reinterpret_cast<__nv_bfloat162*>(out + 8 * D) = __floats2bfloat162_rn(a.z * sm_scale, a.w * sm_scale);
}

}  // namespace

// q, k, v, dout: (B, H, L, 128) bf16 contiguous, 16-byte aligned; lse
// (natural log, from the forward) and delta = rowsum(dout * out): (B, H, Lq)
// fp32; dq_accum: (B, H, ceil(Lq / 64) * 64, 128) fp32, zeroed; dk, dv:
// (B, H, Lk, 128) bf16. causal_block <= 0 means bidirectional. Returns the
// cudaError_t of the launch (0 on success).
extern "C" int flash_attention_bwd_fused(const void* q, const void* k, const void* v, const void* dout,
                                         const void* lse, const void* delta, void* dk, void* dv, void* dq_accum,
                                         int B, int H, int Lq, int Lk, int d, float sm_scale, int causal_block,
                                         void* stream) {
  if (d != D || Lq <= 0 || Lk <= 0) return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap maps[4];
  cudaError_t err = encode_maps(maps, q, k, v, dout, B * H, Lq, Lk);
  if (err != cudaSuccess) return static_cast<int>(err);
  const bool causal = causal_block > 0;
  BwdParams p{static_cast<const float*>(lse), static_cast<const float*>(delta), static_cast<float*>(dq_accum),
              Lq, Lk, (Lq + BLOCK_M - 1) / BLOCK_M, sm_scale * LOG2E, causal_block, 0, 0};
  StoreBf16 epi{static_cast<bf16*>(dk), static_cast<bf16*>(dv), sm_scale, Lk};
  auto kern = causal ? flash_bwd_fused_kernel<true> : flash_bwd_fused_kernel<false>;
  static unsigned smem_raised[2] = {0, 0};
  err = flash::raise_smem_limit(kern, SMEM_BYTES, smem_raised[causal]);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((Lk + BLOCK_N - 1) / BLOCK_N, B * H);
  kern<<<grid, NTHREADS, SMEM_BYTES, static_cast<cudaStream_t>(stream)>>>(maps[0], maps[1], maps[2], maps[3], p, epi);
  return static_cast<int>(cudaGetLastError());
}

// dq (B, H, Lq, 128) bf16 = dq_accum * sm_scale, from the fused kernel's
// dq_accum. Returns the cudaError_t of the launch.
extern "C" int flash_attention_bwd_dq_convert(const void* dq_accum, void* dq, int B, int H, int Lq, int d,
                                              float sm_scale, void* stream) {
  if (d != D || Lq <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const int n_qtiles = (Lq + BLOCK_M - 1) / BLOCK_M;
  const long long n = (long long)B * H * n_qtiles * (BLOCK_M * D / 4);
  flash_bwd_dq_convert_kernel<<<(unsigned)((n + 255) / 256), 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(dq_accum), static_cast<bf16*>(dq), Lq, n_qtiles, n, sm_scale);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* flash_attention_bwd_sm90_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
