// The D = 128 flash-attention forward's main loop for Hopper (sm_90a),
// shared by the dense kernel (csrc/flash_attention_fwd_sm90.cu) and the
// ring forward's hop kernel (csrc/ring_flash_attention.cu): the CTA layout,
// shared memory, barriers and parameters, kv_tiles, the StoreOut epilogue,
// the EmptyState start and fwd_mainloop. See flash_attention_fwd_sm90.cu
// for the design.
//
// fwd_mainloop<CAUSAL, Start, Epilogue> runs one CTA: query rows m0 .. m0 +
// 127 of one (b, h) against the keys they see, at the global query and key
// offsets of FwdParams (0 for dense attention; rank * L_q and src * L_k for
// a ring hop). Each consumer's running state -- acc (64 fp32 a thread), m
// (log2 domain) and l (this thread's share of the row sum) of its rows i =
// 0, 1 -- comes from the start hook and goes to the epilogue:
//   void Start::operator()(float (&acc)[64], float (&m)[2], float (&l)[2], int bh, int row0, int tid) const;
//   void Epilogue::operator()(const float (&acc)[64], const float (&m)[2], const float (&l)[2], int bh,
//                             int row0, int wg, int tid, unsigned char* stage) const;
// where thread tid (warp w = tid / 32, g = (tid % 32) / 4, q = tid % 4)
// holds rows row0 + 16 w + g + 8 i, columns 8 j + 2 q + e in acc[4 j + 2 i
// + e]. The epilogue gets whole-row sums in l (the quad's shares added), so
// a start that loads a row sum gives it to lane q = 0 and 0 to the other
// three. The running-max loop rescales the started state by exp2(m_old -
// m_safe) on the first tile, as it rescales its own.

#pragma once

#include <math_constants.h>

#include "flash_common.cuh"
#include "hopper_common.cuh"

namespace ffwd {

using flash::bf16;
using flash::fast_exp2;
using flash::LN2;
using flash::NEG_INF;
using flash::pack_bf16;
using namespace hopper;

constexpr int D = 128;
constexpr int BLOCK_M = 128;  // query rows per CTA
constexpr int BLOCK_N = 128;  // keys per tile
constexpr int WG_ROWS = 64;   // query rows per consumer
constexpr int STAGES = 2;
constexpr int CONSUMERS = 2;
constexpr int NTHREADS = 128 * (CONSUMERS + 1);
constexpr int PRODUCER_REGS = 24;
constexpr int CONSUMER_REGS = 240;
constexpr float ANCHOR_MAX_LOG2 = 40.0f;
constexpr bool PINGPONG = true;  // the consumers take turns issuing S = Q K^T

// shared memory, bytes from a 1 KB aligned base
constexpr int ROW = 128;         // one 64-column bf16 row
constexpr int HALF = 128 * ROW;  // 64 columns of a 128-row tile: 16 KB
constexpr int TILE = 2 * HALF;   // a 128 x 128 bf16 tile: 32 KB
constexpr int OFF_Q = 0;
constexpr int OFF_K = OFF_Q + TILE;
constexpr int OFF_V = OFF_K + STAGES * TILE;
constexpr int OFF_BAR = OFF_V + STAGES * TILE;
constexpr int N_BARS = 1 + 3 * STAGES;  // q_full, k_full[STAGES], v_full[STAGES], empty[STAGES]
constexpr int SMEM_BYTES = OFF_BAR + 8 * N_BARS + 1024;  // + the base's alignment
static_assert(SMEM_BYTES <= 232448, "shared memory");

// named barriers (0 is __syncthreads)
constexpr int BAR_TURN = 1;   // + consumer: its turn to issue S = Q K^T
constexpr int BAR_STAGE = 3;  // + consumer: its output tile is staged

struct FwdParams {
  const float* anchor;  // (B * H) log2-domain bounds; nullptr: the running-max loop
  int Lq, Lk;
  float c;  // sm_scale * log2(e)
  int causal_block;
  int q_off, k_off;  // global positions of local query row 0 and key 0 (causal mask)
};

// Key tiles the CTA of rows m0 .. m0 + 127 walks: under the frame-causal
// mask, keys of frames after its last row's are skipped.
template <bool CAUSAL>
__device__ __forceinline__ int kv_tiles(const FwdParams& p, int m0) {
  int kv_end = p.Lk;
  if (CAUSAL) {
    const int last_row = p.q_off + min(m0 + BLOCK_M, p.Lq) - 1;
    kv_end = min(p.Lk, max(0, (last_row / p.causal_block + 1) * p.causal_block - p.k_off));
  }
  return (kv_end + BLOCK_N - 1) / BLOCK_N;
}

// The start of dense attention: acc = 0, m = -1e30, l = 0.
struct EmptyState {
  __device__ __forceinline__ void operator()(float (&acc)[64], float (&m)[2], float (&l)[2], int, int, int) const {
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = 0.f;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      m[i] = NEG_INF;
      l[i] = 0.f;
    }
  }
};

// out = acc / l as bf16 and lse = m ln 2 + ln l for one consumer's 64 rows.
struct StoreOut {
  bf16* o;
  float* lse;
  int Lq;
  // STAGE: this consumer's 64 rows of the Q tile (both 64-column halves
  // HALF apart), free once its last S = Q K^T has completed.
  __device__ __forceinline__ void operator()(const float (&acc)[64], const float (&m)[2], const float (&l)[2], int bh,
                                             int row0, int wg, int tid, unsigned char* stage) const {
    const int warp = tid / 32, g = (tid % 32) / 4, q = tid % 4;
    float inv[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float l_safe = l[i] == 0.f ? 1.f : l[i];
      inv[i] = 1.f / l_safe;
      const int row = row0 + 16 * warp + g + 8 * i;
      if (q == 0 && row < Lq) lse[(size_t)bh * Lq + row] = m[i] * LN2 + logf(l_safe);
    }
    // row r = 16 w + g + 8 i, 16-byte chunk j % 8 of half j / 8, swizzled by r % 8 = g
#pragma unroll
    for (int j = 0; j < 16; ++j)
#pragma unroll
      for (int i = 0; i < 2; ++i)
        *reinterpret_cast<uint32_t*>(stage + (j / 8) * HALF + (16 * warp + g + 8 * i) * ROW + (((j % 8) ^ g) << 4) +
                                     4 * q) = pack_bf16(acc[4 * j + 2 * i] * inv[i], acc[4 * j + 2 * i + 1] * inv[i]);
    named_bar_sync(BAR_STAGE + wg, 128);
    // 64 rows x 16 chunks of 16 bytes: 8 a thread, a row's 256 bytes by 16 neighbours
#pragma unroll
    for (int it = 0; it < 8; ++it) {
      const int idx = it * 128 + tid;
      const int r = idx / 16, h = (idx / 8) % 2, c = idx % 8;
      const int row = row0 + r;
      if (row < Lq)
        *reinterpret_cast<uint4*>(o + ((size_t)bh * Lq + row) * D + 64 * h + 8 * c) =
            *reinterpret_cast<const uint4*>(stage + h * HALF + r * ROW + ((c ^ (r % 8)) << 4));
    }
  }
};

// One CTA: query rows m0 .. m0 + 127 of (b, h) bh against the keys they see.
template <bool CAUSAL, class Start, class Epilogue>
__device__ __forceinline__ void fwd_mainloop(const CUtensorMap* tq, const CUtensorMap* tk, const CUtensorMap* tv,
                                             const FwdParams& p, int m0, int bh, const Start& start,
                                             const Epilogue& epilogue) {
  extern __shared__ unsigned char fwd_smem_raw[];
  unsigned char* smem =
      reinterpret_cast<unsigned char*>((reinterpret_cast<uintptr_t>(fwd_smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + OFF_BAR);
  uint64_t* q_full = bars;
  uint64_t* k_full = bars + 1;
  uint64_t* v_full = bars + 1 + STAGES;
  uint64_t* empty = bars + 1 + 2 * STAGES;

  const int n_tiles = kv_tiles<CAUSAL>(p, m0);

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&k_full[s], 1);
      mbar_init(&v_full[s], 1);
      mbar_init(&empty[s], 128 * CONSUMERS);  // every consumer thread
    }
    mbar_fence_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == CONSUMERS) {
    // ---------------- producer ----------------
    reg_dealloc<PRODUCER_REGS>();
    if (threadIdx.x % 128 == 0 && n_tiles > 0) {
      mbar_arrive_expect_tx(q_full, TILE);
      for (int h = 0; h < 2; ++h) tma_load_3d(smem + OFF_Q + h * HALF, tq, q_full, 64 * h, m0, bh);
      for (int t = 0; t < n_tiles; ++t) {
        const int st = t % STAGES;
        if (t >= STAGES) mbar_wait(&empty[st], ((t / STAGES) - 1) & 1);
        const int n0 = t * BLOCK_N;
        mbar_arrive_expect_tx(&k_full[st], TILE);
        for (int h = 0; h < 2; ++h) tma_load_3d(smem + OFF_K + st * TILE + h * HALF, tk, &k_full[st], 64 * h, n0, bh);
        mbar_arrive_expect_tx(&v_full[st], TILE);
        for (int h = 0; h < 2; ++h) tma_load_3d(smem + OFF_V + st * TILE + h * HALF, tv, &v_full[st], 64 * h, n0, bh);
      }
    }
    return;
  }

  // ---------------- consumers ----------------
  reg_alloc<CONSUMER_REGS>();
  const int tid = threadIdx.x % 128;
  const int warp = tid / 32, g = (tid % 32) / 4, q = tid % 4;
  const int row0 = m0 + WG_ROWS * wg;  // this consumer's first row; the thread's: row0 + 16 warp + g (+ 8)
  const uint32_t sQ = smem_u32(smem + OFF_Q) + WG_ROWS * wg * ROW;
  const uint32_t sK = smem_u32(smem + OFF_K), sV = smem_u32(smem + OFF_V);

  float a2 = 0.f;
  bool anchored = false;
  if (!CAUSAL && p.anchor != nullptr) {
    a2 = p.anchor[bh];
    anchored = a2 < ANCHOR_MAX_LOG2;  // NaN -> the running-max loop
  }
  float o[64];
  float m[2];  // running max (log2 domain) of rows i = 0, 1
  float l[2];  // this thread's share of their sums
  start(o, m, l, bh, row0, tid);

  // Consumer 0 issues first: consumer 1 hands it the first turn.
  if (PINGPONG && wg == 1 && n_tiles > 0) named_bar_arrive(BAR_TURN, 256);
  if (n_tiles > 0) mbar_wait(q_full, 0);
  for (int t = 0; t < n_tiles; ++t) {
    const int st = t % STAGES;
    const uint32_t phase = (t / STAGES) & 1;
    const int n0 = t * BLOCK_N;
    const uint32_t sKt = sK + st * TILE, sVt = sV + st * TILE;

    // S = Q_wg K^T: K-major operands, K = D in 8 slices of 16
    mbar_wait(&k_full[st], phase);
    if (PINGPONG) named_bar_sync(BAR_TURN + wg, 256);
    float s[64];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t off = (kk / 4) * HALF + (kk % 4) * 32;
      wgmma_m64n128k16_ss<0, 0>(s, desc_sw128(sQ + off, 16, 1024), desc_sw128(sKt + off, 16, 1024), kk > 0);
    }
    wgmma_commit();
    // the other consumer's turn (its last turn is never handed back)
    if (PINGPONG && !(wg == 1 && t == n_tiles - 1)) named_bar_arrive(BAR_TURN + 1 - wg, 256);
    wgmma_wait<0>();
    fence_regs(s);

    // s[4 j + 2 i + e]: row 16 warp + g + 8 i, key n0 + 8 j + 2 q + e
    bool need_mask = n0 + BLOCK_N > p.Lk;
    if (CAUSAL)
      need_mask = need_mask || (p.k_off + n0 + BLOCK_N - 1) / p.causal_block > (p.q_off + m0) / p.causal_block;
    if (need_mask) {
#pragma unroll
      for (int j = 0; j < 16; ++j)
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int key = n0 + 8 * j + 2 * q + e;
            bool ok = key < p.Lk;
            if (CAUSAL)
              ok = ok && (p.k_off + key) / p.causal_block <=
                             (p.q_off + row0 + 16 * warp + g + 8 * i) / p.causal_block;
            if (!ok) s[4 * j + 2 * i + e] = -CUDART_INF_F;
          }
    }

    if (anchored) {
      // p = exp2(s c - A): no max, no rescale (A bounds every logit)
#pragma unroll
      for (int idx = 0; idx < 64; ++idx) {
        const float pv = fast_exp2(fmaf(s[idx], p.c, -a2));
        l[(idx >> 1) & 1] += pv;
        s[idx] = pv;
      }
    } else {
      float mx[2] = {-CUDART_INF_F, -CUDART_INF_F};
#pragma unroll
      for (int idx = 0; idx < 64; ++idx) mx[(idx >> 1) & 1] = fmaxf(mx[(idx >> 1) & 1], s[idx]);
      float m_safe[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
        const float m_new = fmaxf(m[i], mx[i] * p.c);
        // a row that has seen only masked keys anchors at 0: exp2(-inf - 0) = 0
        m_safe[i] = m_new <= NEG_INF * 0.5f ? 0.f : m_new;
        const float corr = fast_exp2(m[i] - m_safe[i]);
        m[i] = m_new;
        l[i] *= corr;
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          o[4 * j + 2 * i] *= corr;
          o[4 * j + 2 * i + 1] *= corr;
        }
      }
#pragma unroll
      for (int idx = 0; idx < 64; ++idx) {
        const float pv = fast_exp2(fmaf(s[idx], p.c, -m_safe[(idx >> 1) & 1]));
        l[(idx >> 1) & 1] += pv;
        s[idx] = pv;
      }
    }

    // O += P V: P (bf16) as A fragments, V MN-major (N = D in two 64-column halves)
    uint32_t pa[32];
#pragma unroll
    for (int r = 0; r < 32; ++r) pa[r] = pack_bf16(s[2 * r], s[2 * r + 1]);
    mbar_wait(&v_full[st], phase);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BLOCK_N / 16; ++kk) {
      const uint32_t a[4] = {pa[4 * kk], pa[4 * kk + 1], pa[4 * kk + 2], pa[4 * kk + 3]};
      wgmma_m64n128k16_rs<1>(o, a, desc_sw128(sVt + kk * 16 * ROW, HALF, 1024), 1);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(o);
    mbar_arrive(&empty[st]);  // K and V of this stage are read
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    if (anchored) m[i] = a2;
  }
  epilogue(o, m, l, bh, row0, wg, tid, smem + OFF_Q + WG_ROWS * wg * ROW);
}

// Tensor maps of q (Lq rows a head) and k, v (Lk rows), (B*H, L, 128) bf16.
inline cudaError_t encode_maps(CUtensorMap (&maps)[3], const void* q, const void* k, const void* v, int BH, int Lq,
                               int Lk) {
  const void* ptrs[3] = {q, k, v};
  cudaError_t err = cudaSuccess;
  for (int m = 0; m < 3 && err == cudaSuccess; ++m)
    err = encode_heads_bf16_sw128(&maps[m], ptrs[m], D, m == 0 ? Lq : Lk, BH, m == 0 ? BLOCK_M : BLOCK_N);
  return err;
}

}  // namespace ffwd
