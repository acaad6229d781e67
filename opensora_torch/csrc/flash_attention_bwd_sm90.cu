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
// The main loop (bwd_mainloop) is a device template over the query and key
// offsets of the causal mask (global positions of local row 0) and over
// the dK/dV epilogue: StoreBf16 here; a ring hop would add into its
// travelling fp32 accumulators instead.
//
// Layout: q, k, v, dout, dk, dv are (B, H, L, 128) contiguous bf16; lse
// and delta (B, H, Lq) fp32; dq_accum (B, H, ceil(Lq / 64) * 64, 128)
// fp32, zeroed by the caller; dq (B, H, Lq, 128) bf16.

#include "flash_common.cuh"
#include "hopper_common.cuh"

namespace {

using flash::bf16;
using flash::fast_exp2;
using flash::LOG2E;
using flash::lse_log2_safe;
using flash::pack_bf16;
using namespace hopper;

constexpr int D = 128;
constexpr int BLOCK_N = 128;  // keys per CTA
constexpr int BLOCK_M = 64;   // query rows per tile
constexpr int STAGES = 2;
constexpr int CONSUMERS = 2;  // warpgroups owning 64 keys each
constexpr int NTHREADS = 128 * (CONSUMERS + 1);
constexpr int PRODUCER_REGS = 24;
constexpr int CONSUMER_REGS = 240;

// shared memory, bytes from a 1 KB aligned base
constexpr int ROW = 128;                         // one 64-column bf16 row
constexpr int HALF_K = BLOCK_N * ROW;            // 64 columns of K or V: 16 KB
constexpr int HALF_Q = BLOCK_M * ROW;            // 64 columns of a Q or dO tile: 8 KB
constexpr int DS_BYTES = BLOCK_N * BLOCK_M * 2;  // dS^T, 128 keys x 64 queries
constexpr int DQ_BYTES = BLOCK_M * 64 * 4;       // one consumer's dQ partial
constexpr int OFF_K = 0;
constexpr int OFF_V = OFF_K + 2 * HALF_K;
constexpr int OFF_Q = OFF_V + 2 * HALF_K;
constexpr int OFF_DO = OFF_Q + STAGES * 2 * HALF_Q;
constexpr int OFF_DS = OFF_DO + STAGES * 2 * HALF_Q;
constexpr int OFF_DQ = OFF_DS + 2 * DS_BYTES;
constexpr int OFF_LSE = OFF_DQ + CONSUMERS * DQ_BYTES;
constexpr int OFF_DELTA = OFF_LSE + STAGES * BLOCK_M * 4;
constexpr int OFF_BAR = OFF_DELTA + STAGES * BLOCK_M * 4;
constexpr int N_BARS = 1 + 2 * STAGES;  // kv_full, full[STAGES], empty[STAGES]
constexpr int SMEM_BYTES = OFF_BAR + 8 * N_BARS + 1024;  // + the base's alignment
static_assert(SMEM_BYTES <= 232448, "shared memory");

// named barriers (0 is __syncthreads)
constexpr int BAR_DS = 1;        // both consumers wrote their dS^T rows
constexpr int BAR_DQ_STAGE = 2;  // + consumer: its dQ staging tile

struct BwdParams {
  const float* lse;
  const float* delta;
  float* dq_accum;
  int Lq, Lk, n_qtiles;
  float c;  // sm_scale * log2(e)
  int causal_block;
  int q_off, k_off;  // global positions of local query row 0 and key 0 (causal mask)
};

// The first query tile that sees key block n0: frames before the block's
// first key frame see none of its keys.
template <bool CAUSAL>
__device__ __forceinline__ int first_qtile(const BwdParams& p, int n0) {
  if (!CAUSAL) return 0;
  const int first_row = ((p.k_off + n0) / p.causal_block) * p.causal_block - p.q_off;
  return first_row <= 0 ? 0 : min(first_row / BLOCK_M, p.n_qtiles);
}

// dK, dV of one consumer's 64 keys written as bf16 (dK times sm_scale).
struct StoreBf16 {
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

// One CTA: keys n0 .. n0 + 127 of (b, h) bh against all query tiles that
// see them.
template <bool CAUSAL, class Epilogue>
__device__ __forceinline__ void bwd_mainloop(const CUtensorMap* tq, const CUtensorMap* tk, const CUtensorMap* tv,
                                             const CUtensorMap* tdo, const BwdParams& p, int n0, int bh,
                                             const Epilogue& epilogue) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>((reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  float* lse_s = reinterpret_cast<float*>(smem + OFF_LSE);
  float* delta_s = reinterpret_cast<float*>(smem + OFF_DELTA);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + OFF_BAR);
  uint64_t* kv_full = bars;
  uint64_t* full = bars + 1;
  uint64_t* empty = bars + 1 + STAGES;

  const int q_first = first_qtile<CAUSAL>(p, n0);
  const int n_tiles = p.n_qtiles - q_first;

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1 + 32);               // the TMA thread + the LSE warp
      mbar_init(&empty[s], 128 * CONSUMERS);     // every consumer thread
    }
    mbar_fence_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == CONSUMERS) {
    // ---------------- producer ----------------
    reg_dealloc<PRODUCER_REGS>();
    const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
    if (warp == 0 && lane == 0) {
      mbar_arrive_expect_tx(kv_full, 4 * HALF_K);
      for (int h = 0; h < 2; ++h) {
        tma_load_3d(smem + OFF_K + h * HALF_K, tk, kv_full, 64 * h, n0, bh);
        tma_load_3d(smem + OFF_V + h * HALF_K, tv, kv_full, 64 * h, n0, bh);
      }
      for (int it = 0; it < n_tiles; ++it) {
        const int st = it % STAGES;
        if (it >= STAGES) mbar_wait(&empty[st], ((it / STAGES) - 1) & 1);
        const int q0 = (q_first + it) * BLOCK_M;
        mbar_arrive_expect_tx(&full[st], 4 * HALF_Q);
        for (int h = 0; h < 2; ++h) {
          tma_load_3d(smem + OFF_Q + (st * 2 + h) * HALF_Q, tq, &full[st], 64 * h, q0, bh);
          tma_load_3d(smem + OFF_DO + (st * 2 + h) * HALF_Q, tdo, &full[st], 64 * h, q0, bh);
        }
      }
    } else if (warp == 1) {
      const float* lse = p.lse + (size_t)bh * p.Lq;
      const float* delta = p.delta + (size_t)bh * p.Lq;
      for (int it = 0; it < n_tiles; ++it) {
        const int st = it % STAGES;
        if (it >= STAGES) mbar_wait(&empty[st], ((it / STAGES) - 1) & 1);
        const int q0 = (q_first + it) * BLOCK_M;
#pragma unroll
        for (int r = lane; r < BLOCK_M; r += 32) {
          const bool in = q0 + r < p.Lq;
          lse_s[st * BLOCK_M + r] = in ? lse_log2_safe(lse[q0 + r]) : 0.f;
          delta_s[st * BLOCK_M + r] = in ? delta[q0 + r] : 0.f;
        }
        mbar_arrive(&full[st]);
      }
    }
  } else {
    // ---------------- consumers ----------------
    reg_alloc<CONSUMER_REGS>();
    const int tid = threadIdx.x % 128;
    const int warp = tid / 32, lane = tid % 32, g = lane / 4, q = lane % 4;
    const int key_row = 64 * wg + 16 * warp + g;  // this thread's keys: key_row and key_row + 8 (CTA-local)
    const uint32_t sK = smem_u32(smem + OFF_K), sV = smem_u32(smem + OFF_V);
    const uint32_t sQ = smem_u32(smem + OFF_Q), sDO = smem_u32(smem + OFF_DO);
    const uint32_t sDS = smem_u32(smem + OFF_DS);
    unsigned char* ds_tile = smem + OFF_DS;
    float4* dq_stage = reinterpret_cast<float4*>(smem + OFF_DQ + wg * DQ_BYTES);
    float* dq_accum = p.dq_accum + (size_t)bh * p.n_qtiles * (BLOCK_M * D);
    // Masks: the tail key block and, for causal, blocks whose keys span
    // more than one frame against a tile's first query frame.
    const bool tail_keys = n0 + BLOCK_N > p.Lk;

    float dk_acc[64], dv_acc[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) dk_acc[i] = dv_acc[i] = 0.f;

    mbar_wait(kv_full, 0);
    for (int it = 0; it < n_tiles; ++it) {
      const int st = it % STAGES;
      const int qt = q_first + it;
      const int q0 = qt * BLOCK_M;
      const uint32_t sQt = sQ + st * 2 * HALF_Q, sDOt = sDO + st * 2 * HALF_Q;
      mbar_wait(&full[st], (it / STAGES) & 1);

      // S^T = K_wg Q^T and dP^T = V_wg dO^T: K-major operands, K = D in 8 slices
      float s[32], dp[32];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t off = (kk / 4) * HALF_K + 64 * wg * ROW + (kk % 4) * 32;
        const uint32_t qoff = (kk / 4) * HALF_Q + (kk % 4) * 32;
        wgmma_m64n64k16_ss<0, 0>(s, desc_sw128(sK + off, 16, 1024), desc_sw128(sQt + qoff, 16, 1024), kk > 0);
      }
      wgmma_commit();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t off = (kk / 4) * HALF_K + 64 * wg * ROW + (kk % 4) * 32;
        const uint32_t qoff = (kk / 4) * HALF_Q + (kk % 4) * 32;
        wgmma_m64n64k16_ss<0, 0>(dp, desc_sw128(sV + off, 16, 1024), desc_sw128(sDOt + qoff, 16, 1024), kk > 0);
      }
      wgmma_commit();

      bool need_mask = tail_keys || q0 + BLOCK_M > p.Lq;
      if (CAUSAL)
        need_mask = need_mask || (p.k_off + n0 + BLOCK_N - 1) / p.causal_block > (p.q_off + q0) / p.causal_block;
      const float* lse_t = lse_s + st * BLOCK_M;
      const float* delta_t = delta_s + st * BLOCK_M;

      // P^T = exp2(S^T c - lse): row key_row (+ 8), column (query) 8 j + 2 q + e
      wgmma_wait<1>();
      fence_regs(s);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float2 l = *reinterpret_cast<const float2*>(lse_t + 8 * j + 2 * q);
#pragma unroll
        for (int i = 0; i < 2; ++i) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int idx = 4 * j + 2 * i + e;
            float pv = fast_exp2(s[idx] * p.c - (e ? l.y : l.x));
            if (need_mask) {
              const int qrow = q0 + 8 * j + 2 * q + e;
              const int key = n0 + key_row + 8 * i;
              bool ok = qrow < p.Lq && key < p.Lk;
              if (CAUSAL) ok = ok && (p.k_off + key) / p.causal_block <= (p.q_off + qrow) / p.causal_block;
              pv = ok ? pv : 0.f;
            }
            s[idx] = pv;
          }
        }
      }
      // dV += P^T dO: P^T (bf16) as A fragments, dO MN-major (N = D in two 64-column halves)
      uint32_t pa[16];
#pragma unroll
      for (int r = 0; r < 16; ++r) pa[r] = pack_bf16(s[2 * r], s[2 * r + 1]);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BLOCK_M / 16; ++kk) {
        const uint32_t a[4] = {pa[4 * kk], pa[4 * kk + 1], pa[4 * kk + 2], pa[4 * kk + 3]};
        wgmma_m64n128k16_rs<1>(dv_acc, a, desc_sw128(sDOt + kk * 16 * ROW, HALF_Q, 1024), 1);
      }
      wgmma_commit();

      // dS^T = P^T (dP^T - delta)
      wgmma_wait<1>();
      fence_regs(dp);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float2 dl = *reinterpret_cast<const float2*>(delta_t + 8 * j + 2 * q);
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          dp[4 * j + 2 * i] = s[4 * j + 2 * i] * (dp[4 * j + 2 * i] - dl.x);
          dp[4 * j + 2 * i + 1] = s[4 * j + 2 * i + 1] * (dp[4 * j + 2 * i + 1] - dl.y);
        }
      }
      uint32_t da[16];
#pragma unroll
      for (int r = 0; r < 16; ++r) da[r] = pack_bf16(dp[2 * r], dp[2 * r + 1]);
      // dK += dS^T Q: Q MN-major
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BLOCK_M / 16; ++kk) {
        const uint32_t a[4] = {da[4 * kk], da[4 * kk + 1], da[4 * kk + 2], da[4 * kk + 3]};
        wgmma_m64n128k16_rs<1>(dk_acc, a, desc_sw128(sQt + kk * 16 * ROW, HALF_Q, 1024), 1);
      }
      wgmma_commit();

      // dS^T (bf16) to shared memory: row key_row (+ 8), 128-byte swizzle
      unsigned char* ds_buf = ds_tile + (it & 1) * DS_BYTES;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int i = 0; i < 2; ++i)
          *reinterpret_cast<uint32_t*>(ds_buf + (key_row + 8 * i) * ROW + ((j ^ g) << 4) + 4 * q) = da[2 * j + i];
      fence_proxy_async();
      named_bar_sync(BAR_DS, 128 * CONSUMERS);

      // dQ[:, 64 wg ..] partial = dS K: dS MN-major (rows of dS^T are keys = K),
      // K MN-major (its half wg), K = 128 keys in 8 slices
      float dq[32];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BLOCK_N / 16; ++kk)
        wgmma_m64n64k16_ss<1, 1>(dq, desc_sw128(sDS + (it & 1) * DS_BYTES + kk * 16 * ROW, DS_BYTES, 1024),
                                 desc_sw128(sK + wg * HALF_K + kk * 16 * ROW, HALF_K, 1024), kk > 0);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(dq);
      fence_regs(dk_acc);
      fence_regs(dv_acc);
      mbar_arrive(&empty[st]);  // Q, dO, LSE, delta of this stage are read

      // stage the partial in accumulator order and add it into dq_accum
      if (tid == 0) bulk_wait_read<0>();
      named_bar_sync(BAR_DQ_STAGE + wg, 128);
#pragma unroll
      for (int j = 0; j < 8; ++j)
        dq_stage[j * 128 + tid] = make_float4(dq[4 * j], dq[4 * j + 1], dq[4 * j + 2], dq[4 * j + 3]);
      fence_proxy_async();
      named_bar_sync(BAR_DQ_STAGE + wg, 128);
      if (tid == 0) {
        bulk_reduce_add_f32(dq_accum + ((size_t)qt * 2 + wg) * (DQ_BYTES / 4), dq_stage, DQ_BYTES);
        bulk_commit();
      }
    }
    if (tid == 0) bulk_wait<0>();
    epilogue(dk_acc, dv_acc, bh, n0 + 64 * wg + 16 * warp, g, q);
  }
}

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

cudaError_t encode_maps(CUtensorMap (&maps)[4], const void* q, const void* k, const void* v, const void* dout,
                        int BH, int Lq, int Lk) {
  const void* ptrs[4] = {q, k, v, dout};
  for (int m = 0; m < 4; ++m) {
    const int L = (m == 1 || m == 2) ? Lk : Lq;
    const uint64_t dims[3] = {(uint64_t)D, (uint64_t)L, (uint64_t)BH};
    const uint64_t strides[2] = {(uint64_t)D * 2, (uint64_t)L * D * 2};
    const uint32_t box[3] = {64, (uint32_t)((m == 1 || m == 2) ? BLOCK_N : BLOCK_M), 1};
    cudaError_t err = encode_bf16_sw128(&maps[m], ptrs[m], 3, dims, strides, box);
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
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
