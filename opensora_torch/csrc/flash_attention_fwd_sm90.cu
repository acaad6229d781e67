// Flash-attention forward at head dim 128 for Hopper (sm_90a): one
// warp-specialised kernel (wgmma + TMA).
//
// Replaces at D = 128 the two Pallas TPU forward kernels of
// opensora_tpu/ops/flash_attention.py and the dispatch between them:
//   - _fwd_kernel           (:179, running-max online softmax, optional
//                            frame-causal ``causal_block`` mask)
//   - _fwd_kernel_anchored  (:247, softmax anchored at the per-(b, h)
//                            Cauchy-Schwarz bound A instead of a running max)
//   - _flash_forward        (:320-422, a lax.cond on max(A) < 40)
// Here every CTA reads its (b, h)'s A from the device tensor that
// ops/flash_attention.py anchor_log2 makes and takes the anchored loop,
// p = exp2(s c - A) with no max and no rescale, when A < 40 (NaN compares
// false and takes the running-max loop): uniform per CTA, no host sync. The
// causal instantiation always runs the running-max loop. D = 512 (the VAE
// mid-block) runs csrc/flash_attention_fwd_d512_sm90.cu.
//
// What it computes, per (b, h): out = softmax(Q K^T * sm_scale) V (bf16) and
// the natural-log LSE per row (fp32), in the exp2 domain with c = sm_scale *
// log2(e), fp32 sums. Keys >= Lk (on the last key tile only) and keys of
// later frames get -inf before the exponent. Rows past Lq and keys past Lk
// are zero-filled by the TMA through 3-D tensor maps (D, L, B*H), so no
// garbage, and never the next head, reaches a product. A row that has seen
// only masked keys keeps m = -1e30, anchors its exponent at 0 (m_safe) and
// divides by 1 (l_safe), as the D = 512 kernel does. P is rounded
// to bf16 before the PV product, as the TPU kernel does; the row sum l adds
// the fp32 p.
//
// Design. One CTA owns 128 query rows of one (b, h) (grid ceil(Lq / 128) x
// B*H) and walks that (b, h)'s keys in tiles of 128. Three warpgroups:
//   - the producer (setmaxnreg down to 24): one thread loads the CTA's Q
//     tile once and keeps K and V tiles in flight by TMA (128-byte swizzle)
//     through a ring of 2 stages, with full (K and V apart) and empty
//     mbarriers;
//   - two consumers (setmaxnreg up to 240), each owning 64 of the 128 rows.
//     Per key tile each runs
//       S = Q_wg K^T    m64n128k16 x 8, both operands K-major from shared memory
//       the softmax     on the accumulator registers (anchored or running max)
//       O += P V        m64n128k16 x 8, P from registers (the S registers
//                       rounded to bf16 in place), V MN-major from the same
//                       swizzled tile
//     O (64 fp32 a thread) and S (64) live in registers: the L x L scores
//     never touch memory.
// The softmax overlaps the other consumer's products by ping-pong: the two
// consumers take turns issuing S = Q K^T (two named barriers), so while one
// runs its exp2 and rescale, the other's wgmma runs on the tensor cores.
// The epilogue rounds O / l to bf16, stages it (swizzled, conflict-free) in
// the consumer's own rows of the Q tile and writes it with 16-byte stores;
// one thread of each quad writes the LSE.
// Shared memory: Q 32 KB, K and V 2 stages x 32 KB each, 7 barriers: 161 KB,
// one CTA per SM.
//
// What bounds it, at the MMDiT shape (B=3, H=24, L=8828, D=128): the two
// products of 2 * B * H * L^2 * D = 1.436 TFLOP each, 2.87 TFLOP, 2.905 ms
// at 989 TFLOP/s, on 0.65 GB of q, k, v, out: ~4400 flops a byte, so
// operations bound it. What the design does about the kernel it replaces
// at D = 128 (the former csrc/flash_attention_fwd.cu: 64 rows a block, 4
// warps, mma.sync m16n8k16 fed by ldmatrix, cp.async and two __syncthreads a
// tile): wgmma is the only path to the
// card's tensor-core rate; a 64-row warpgroup product reads each K and V
// tile from shared memory once instead of once per warp; 128-row CTAs halve
// the K/V traffic from L2; TMA with mbarriers and a producer warpgroup
// replace cp.async and the block-wide barriers; the ping-pong hides the
// softmax.
//
// The main loop (fwd_mainloop, csrc/flash_fwd_sm90.cuh) is a device
// template over the global query and key offsets of the causal mask (the
// positions of local row 0 and key 0), its start state and its epilogue:
// EmptyState and StoreOut here; the ring forward's hop kernel
// (csrc/ring_flash_attention.cu) loads and stores the rank's fp32 (m, l,
// acc) state between hops instead.
//
// Layout: q, k, v, out are (B, H, L, 128) contiguous bf16, 16-byte aligned;
// lse (B, H, Lq) fp32; anchor (B, H) fp32 log2-domain bounds.

#include "flash_fwd_sm90.cuh"

namespace {

using namespace ffwd;

template <bool CAUSAL>
__global__ void __launch_bounds__(NTHREADS, 1)
    flash_fwd_sm90_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                          const __grid_constant__ CUtensorMap tv, const FwdParams p, const StoreOut epilogue) {
  fwd_mainloop<CAUSAL>(&tq, &tk, &tv, p, blockIdx.x * BLOCK_M, blockIdx.y, EmptyState{}, epilogue);
}

}  // namespace

// q, k, v, o: (B, H, L, 128) bf16 contiguous, 16-byte aligned; lse: (B, H,
// Lq) fp32; anchor: (B, H) fp32 log2-domain bound, read only when
// causal_block <= 0. sm_scale_log2 = sm_scale * log2(e); causal_block <= 0
// means bidirectional. Returns the cudaError_t of the launch (0 on success).
extern "C" int flash_attention_fwd_sm90(const void* q, const void* k, const void* v, void* o, void* lse,
                                        const void* anchor, int B, int H, int Lq, int Lk, int d, float sm_scale_log2,
                                        int causal_block, void* stream) {
  if (d != D || Lq <= 0 || Lk <= 0) return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap maps[3];
  cudaError_t err = encode_maps(maps, q, k, v, B * H, Lq, Lk);
  if (err != cudaSuccess) return static_cast<int>(err);
  const bool causal = causal_block > 0;
  FwdParams p{causal ? nullptr : static_cast<const float*>(anchor), Lq, Lk, sm_scale_log2, causal_block, 0, 0};
  StoreOut epi{static_cast<bf16*>(o), static_cast<float*>(lse), Lq};
  auto kern = causal ? flash_fwd_sm90_kernel<true> : flash_fwd_sm90_kernel<false>;
  static unsigned smem_raised[2] = {0, 0};
  err = flash::raise_smem_limit(kern, SMEM_BYTES, smem_raised[causal]);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((Lq + BLOCK_M - 1) / BLOCK_M, B * H);
  kern<<<grid, NTHREADS, SMEM_BYTES, static_cast<cudaStream_t>(stream)>>>(maps[0], maps[1], maps[2], p, epi);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* flash_attention_fwd_sm90_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
