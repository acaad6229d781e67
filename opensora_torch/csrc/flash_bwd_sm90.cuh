// The D = 128 flash-attention backward's main loop for Hopper (sm_90a),
// shared by the dense fused kernel (csrc/flash_attention_bwd_sm90.cu) and
// the ring backward's hop kernel (csrc/ring_flash_attention.cu): the CTA
// layout, shared memory, barriers and parameters, first_qtile, bwd_mainloop
// and the tensor-map encoder. See flash_attention_bwd_sm90.cu for the design.
//
// bwd_mainloop<CAUSAL, Epilogue> runs one CTA: keys n0 .. n0 + 127 of one
// (b, h) against every 64-row query tile that sees them, at the global query
// and key offsets of BwdParams (0 for dense attention; rank * L_q and
// src * L_k for a ring hop), and hands each consumer's dK, dV registers to
// the epilogue. An epilogue has
//   static constexpr bool kSkipEmpty;  // return at once where no query sees the keys
//   void operator()(const float (&dk)[64], const float (&dv)[64], int bh, int key0, int g, int q) const;
// where thread (warp w, g, q) holds keys key0 + g (+ 8) (key0 = n0 + 64 wg +
// 16 w), columns 8 j + 2 q + e in d[4 j + 2 i + e] (i: + 8), dK unscaled.

#pragma once

#include "flash_common.cuh"
#include "hopper_common.cuh"

namespace fbwd {

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

// One CTA: keys n0 .. n0 + 127 of (b, h) bh against all query tiles that
// see them.
template <bool CAUSAL, class Epilogue>
__device__ __forceinline__ void bwd_mainloop(const CUtensorMap* tq, const CUtensorMap* tk, const CUtensorMap* tv,
                                             const CUtensorMap* tdo, const BwdParams& p, int n0, int bh,
                                             const Epilogue& epilogue) {
  extern __shared__ unsigned char bwd_smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>((reinterpret_cast<uintptr_t>(bwd_smem_raw) + 1023) & ~uintptr_t(1023));
  float* lse_s = reinterpret_cast<float*>(smem + OFF_LSE);
  float* delta_s = reinterpret_cast<float*>(smem + OFF_DELTA);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + OFF_BAR);
  uint64_t* kv_full = bars;
  uint64_t* full = bars + 1;
  uint64_t* empty = bars + 1 + STAGES;

  const int q_first = first_qtile<CAUSAL>(p, n0);
  const int n_tiles = p.n_qtiles - q_first;
  if (Epilogue::kSkipEmpty && n_tiles == 0) return;  // no query sees these keys

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

inline cudaError_t encode_maps(CUtensorMap (&maps)[4], const void* q, const void* k, const void* v, const void* dout,
                               int BH, int Lq, int Lk) {
  const void* ptrs[4] = {q, k, v, dout};
  for (int m = 0; m < 4; ++m) {
    const bool keys = m == 1 || m == 2;
    cudaError_t err = encode_heads_bf16_sw128(&maps[m], ptrs[m], D, keys ? Lk : Lq, BH, keys ? BLOCK_N : BLOCK_M);
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

}  // namespace fbwd
