// Flash-attention backward at head dim 512 (the HunyuanVAE mid-block: one
// head, frame-causal, or bidirectional) for Hopper (sm_90a): one
// warp-specialised kernel (wgmma + TMA) in two kinds of CTA, and a dQ
// epilogue kernel. Head dim 128 (the MMDiT) runs
// csrc/flash_attention_bwd_sm90.cu.
//
// Replaces at D = 512 the two Pallas TPU backward kernels of
// opensora_tpu/ops/flash_attention.py:
//   - _dkv_kernel (:425)  dV = sum_q P^T dO,  dK = sm_scale * sum_q dS^T Q
//   - _dq_kernel  (:497)  dQ = sm_scale * sum_k dS K
// with the TPU kernels' rounding points: P recomputed from the forward's
// LSE in the exp2 domain, p = exp2(s * c - lse_safe * log2(e)) with c =
// sm_scale * log2(e) and lse_safe = 0 for fully masked rows (lse <= -5e29);
// P rounded to bf16 before the dV product and dS = P (dP - delta) before the
// dK and dQ products; sm_scale multiplies the fp32 sums once, at the end (dK
// here, dQ in the epilogue kernel). Query rows past Lq, keys past Lk and keys
// of later frames (causal_block) give P = 0 exactly; rows outside the
// tensors are zero-filled by the TMA, so no garbage reaches a product. delta
// = rowsum(dO * O) comes from the caller.
//
// Design. A CTA owns 64 keys x all 512 columns of one (b, h) and walks the
// query tiles that see them (grid ceil(Lk / 64) x B*H x 2). Its dK and dV in
// fp32 would take 256 KB, the whole register file, so the gradients are
// split over two kinds of CTA, the work of two passes over the queries run
// side by side (blockIdx.z):
//   - z = 1, the dV CTA: csrc/flash_d512_sm90.cuh stream_loop with K
//     resident and 64-row tiles of Q and dO in its two slots: per query tile
//     S^T = K Q^T (each consumer the columns of its 32 queries), P^T =
//     exp2(S^T c - lse), dV[:, 256 wg ..] += P^T dO (m64n256k16): 2 products;
//   - z = 0, the dK / dQ CTA: K and V resident, 32-row tiles of Q and dO.
//     Per query tile consumer 0 computes S^T = K Q^T and consumer 1 dP^T = V
//     dO^T (m64n32k16 x 32 each, from shared memory, side by side); consumer
//     1 hands dP^T (fp32, in its fragment order) to consumer 0 through shared
//     memory, which forms dS^T = P^T (dP^T - delta) and writes it (bf16,
//     64-byte swizzle); then each consumer runs dK[:, 256 wg ..] += dS^T Q
//     (m64n256k16) and its four 64-column blocks of dQ^T = K^T dS^T
//     (m64n32k16, K^T and dS^T MN-major from shared memory) and adds them
//     into the fp32 dq_accum with 16-byte atomic adds: 4 products.
// So each (key block, query tile) costs 6 products' work against the 5 of
// the minimal backward (S twice), where the kernels this replaces did 19
// (the former csrc/flash_attention_bwd.cu split D over 4 blocks, each
// recomputing S and dP over all 512 columns). One producer warpgroup (setmaxnreg 24) issues
// every TMA load; the two consumer warpgroups (setmaxnreg 240) hold 64 x 256
// fp32 accumulators (128 registers a thread). Frame-causal calls start at
// the first query tile that sees the block's first key frame; the dK / dQ
// CTAs, which do twice the dV CTAs' work, are launched first.
// Shared memory: dV CTA K 64 KB, Q and dO slots 64 KB each, P^T 2 x 8 KB
// (208 KB); dK / dQ CTA K, V 64 KB each, Q, dO 32 KB each, dP^T 8 KB, dS^T
// 4 KB (204 KB): one CTA per SM.
//
// dq_accum is not row-major: each 32-row query tile of a (b, h) holds 32 x
// 512 floats in the order [consumer w][block mb][j 0..3][thread 0..127][4],
// thread t = 32 warp + 4 g + q holding D column 256 w + 64 mb + 16 warp + g +
// 8 i and query row 8 j + 2 q + e in its float 2 i + e (the m64n32
// accumulator of dQ^T), so every thread adds its fragment with coalesced
// 16-byte atomics; flash_bwd_d512_dq_convert_kernel maps it back, multiplies
// by sm_scale and rounds to bf16. The adds of different key blocks land in
// an order that changes from run to run, so dQ is not bitwise reproducible
// (fp32 ulps before the bf16 rounding).
//
// What bounds it: operations, 5 * 2 * 512 flops a visible (query, key) pair
// for the minimal backward (6 here). At the VAE training mid-block ((1, 1,
// 9216, 512), frames of 1024: 47.2 M pairs) that is 0.242 TFLOP, 0.245 ms at
// 989 TFLOP/s (0.293 for 6 products), against 57 MB of inputs and outputs
// and 19 MB of dq_accum. What the design does about the kernels it replaces
// (flash_bwd_dkv_kernel<512>, flash_bwd_dq_kernel<512>): (1) 6 products
// where they did 19; (2) wgmma from shared memory in place of mma.sync fed
// by ldmatrix; (3) a producer warpgroup keeps the TMA loads in flight in
// place of cp.async from the computing warps; (4) 32- and 64-row query tiles
// in place of 16-row steps.
//
// Layout: q, k, v, dout, dk, dv are (B, H, L, 512) contiguous bf16, 16-byte
// aligned; lse and delta (B, H, Lq) fp32; dq_accum (B, H, ceil(Lq / 32) *
// 32, 512) fp32, zeroed by the caller; dq (B, H, Lq, 512) bf16.

#include "flash_d512_sm90.cuh"

namespace {

using namespace fd512;
using flash::fast_exp2;
using flash::LOG2E;
using flash::lse_log2_safe;

constexpr int QT = 32;          // the dK / dQ CTA's query rows per tile
constexpr int QBOX = QT * ROW;  // 32 rows x 64 columns: 4 KB
constexpr int DQ_TILE = QT * D;  // floats of dq_accum per query tile

// shared memory, bytes from a 1 KB aligned base. The dV CTA:
constexpr int DV_OFF_K = 0;
constexpr int DV_OFF_Q = DV_OFF_K + TILE;  // slot 0
constexpr int DV_OFF_DO = DV_OFF_Q + TILE;  // slot 1
constexpr int DV_OFF_P = DV_OFF_DO + TILE;  // two 64 x 64 bf16 buffers of P^T
constexpr int DV_END = DV_OFF_P + 2 * BOX;
// the dK / dQ CTA:
constexpr int DK_OFF_K = 0;
constexpr int DK_OFF_V = DK_OFF_K + TILE;
constexpr int DK_OFF_Q = DK_OFF_V + TILE;
constexpr int DK_OFF_DO = DK_OFF_Q + QT * D * 2;
constexpr int DK_OFF_DP = DK_OFF_DO + QT * D * 2;  // dP^T, fp32 [4][128 threads][4]
constexpr int DK_OFF_DS = DK_OFF_DP + BLOCK * QT * 4;  // dS^T, 64 keys x 32 queries bf16, 64-byte swizzle
constexpr int DK_END = DK_OFF_DS + BLOCK * QT * 2;
constexpr int OFF_BAR = DV_END > DK_END ? DV_END : DK_END;
constexpr int N_BARS = 5;  // kv_full, full[2], empty[2]
constexpr int SMEM_BYTES = OFF_BAR + 8 * N_BARS + 1024;  // + the base's alignment
static_assert(SMEM_BYTES <= SMEM_LIMIT, "shared memory");

constexpr int BAR_DP = BAR_FREE;      // consumer 1 wrote dP^T
constexpr int BAR_DS = BAR_FREE + 1;  // consumer 0 wrote dS^T

struct Params {
  const float* lse;
  const float* delta;
  bf16* dk;
  bf16* dv;
  float* dq_accum;
  int Lq, Lk;
  float c;  // sm_scale * log2(e)
  float sm_scale;
  int causal_block;
};

// The first query tile of ROWS rows that sees key block n0: frames before
// the block's first key frame see none of its keys.
template <bool CAUSAL, int ROWS>
__device__ __forceinline__ int first_qtile(const Params& p, int n0) {
  const int n_qtiles = (p.Lq + ROWS - 1) / ROWS;
  if (!CAUSAL) return 0;
  return min((n0 / p.causal_block) * p.causal_block / ROWS, n_qtiles);
}

// P^T = exp2(S^T c - lse) of 64 keys (rows 16 warp + g + 8 i from n0) x
// the queries q0 + 8 j + 2 q + e in s[4 j + 2 i + e]; 0 where masked.
template <bool CAUSAL>
__device__ __forceinline__ void probabilities(const Params& p, const float* lse, float (&s)[16], int n0, int q0,
                                              int rows, int tid) {
  const int warp = tid / 32, g = (tid % 32) / 4, q = tid % 4;
  float l2[8];
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int query = q0 + 8 * j + 2 * q + e;
      l2[2 * j + e] = query < p.Lq ? lse_log2_safe(lse[query]) : 0.f;
    }
  bool need_mask = q0 + rows > p.Lq || n0 + BLOCK > p.Lk;
  if (CAUSAL) need_mask = need_mask || (n0 + BLOCK - 1) / p.causal_block > q0 / p.causal_block;
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float pv = fast_exp2(s[4 * j + 2 * i + e] * p.c - l2[2 * j + e]);
        if (need_mask) {
          const int query = q0 + 8 * j + 2 * q + e, key = n0 + 16 * warp + g + 8 * i;
          bool ok = query < p.Lq && key < p.Lk;
          if (CAUSAL) ok = ok && key / p.causal_block <= query / p.causal_block;
          pv = ok ? pv : 0.f;
        }
        s[4 * j + 2 * i + e] = pv;
      }
}

// The dV CTA's S^T -> P^T (stream_loop's policy).
template <bool CAUSAL>
struct DvPolicy {
  const Params& p;
  const float* lse;  // this (b, h)'s
  int n0, q_first, wg, tid;
  __device__ __forceinline__ void operator()(int t, float (&s)[16], float (&)[128]) const {
    probabilities<CAUSAL>(p, lse, s, n0, (q_first + t) * BLOCK + 32 * wg, BLOCK - 32 * wg, tid);
  }
};

template <bool CAUSAL>
__device__ __forceinline__ void dv_cta(const CUtensorMap* tq, const CUtensorMap* tk, const CUtensorMap* tdo,
                                       const Params& p, unsigned char* smem, uint64_t* kv_full, uint64_t* full,
                                       uint64_t* empty, int n0, int bh) {
  const int q_first = first_qtile<CAUSAL, BLOCK>(p, n0);
  const int n_tiles = (p.Lq + BLOCK - 1) / BLOCK - q_first;
  const int wg = threadIdx.x / 128;
  if (wg == CONSUMERS) {
    reg_dealloc<PRODUCER_REGS>();
    if (threadIdx.x % 128 == 0 && n_tiles > 0) {
      load_rows<BLOCK, BLOCK>(smem + DV_OFF_K, tk, kv_full, n0, bh);
      stream_producer<QT>(smem + DV_OFF_Q, smem + DV_OFF_DO, tq, tdo, full, empty, n_tiles, q_first * BLOCK, bh);
    }
    return;
  }
  reg_alloc<CONSUMER_REGS>();
  const int tid = threadIdx.x % 128;
  float dv[128];
#pragma unroll
  for (int i = 0; i < 128; ++i) dv[i] = 0.f;
  if (n_tiles > 0) mbar_wait(kv_full, 0);
  const DvPolicy<CAUSAL> policy{p, p.lse + (size_t)bh * p.Lq, n0, q_first, wg, tid};
  stream_loop(smem + DV_OFF_K, smem + DV_OFF_Q, smem + DV_OFF_DO, smem + DV_OFF_P, full, empty, n_tiles, wg, tid, dv,
              policy);
  const float one[2] = {1.f, 1.f};
  // this consumer's own boxes of the dO slot: only its own P^T dO read them
  store_rows(dv, one, smem + DV_OFF_DO + 4 * wg * BOX, p.dv + (size_t)bh * p.Lk * D, n0, p.Lk, wg, tid);
}

template <bool CAUSAL>
__device__ __forceinline__ void dkdq_cta(const CUtensorMap* tq, const CUtensorMap* tk, const CUtensorMap* tv,
                                         const CUtensorMap* tdo, const Params& p, unsigned char* smem,
                                         uint64_t* kv_full, uint64_t* full, uint64_t* empty, int n0, int bh) {
  // full[0] / empty[0]: the Q tile (freed by both consumers after dK);
  // full[1] / empty[1]: the dO tile (freed by consumer 1 after dP^T)
  const int q_first = first_qtile<CAUSAL, QT>(p, n0);
  const int n_tiles = (p.Lq + QT - 1) / QT - q_first;
  const int wg = threadIdx.x / 128;
  if (wg == CONSUMERS) {
    reg_dealloc<PRODUCER_REGS>();
    if (threadIdx.x % 128 == 0 && n_tiles > 0) {
      mbar_arrive_expect_tx(kv_full, 2 * TILE);
#pragma unroll
      for (int b = 0; b < D / 64; ++b) {
        tma_load_3d(smem + DK_OFF_K + b * BOX, tk, kv_full, 64 * b, n0, bh);
        tma_load_3d(smem + DK_OFF_V + b * BOX, tv, kv_full, 64 * b, n0, bh);
      }
      for (int t = 0; t < n_tiles; ++t) {
        const int q0 = (q_first + t) * QT;
        if (t > 0) mbar_wait(&empty[1], (t - 1) & 1);
        load_rows<QT, QT>(smem + DK_OFF_DO, tdo, &full[1], q0, bh);
        if (t > 0) mbar_wait(&empty[0], (t - 1) & 1);
        load_rows<QT, QT>(smem + DK_OFF_Q, tq, &full[0], q0, bh);
      }
    }
    return;
  }
  reg_alloc<CONSUMER_REGS>();
  const int tid = threadIdx.x % 128;
  const int warp = tid / 32, g = (tid % 32) / 4, q = tid % 4;
  const uint32_t sK = smem_u32(smem + DK_OFF_K), sV = smem_u32(smem + DK_OFF_V);
  const uint32_t sQ = smem_u32(smem + DK_OFF_Q), sDO = smem_u32(smem + DK_OFF_DO);
  const uint32_t sDS = smem_u32(smem + DK_OFF_DS);
  float4* dp_x = reinterpret_cast<float4*>(smem + DK_OFF_DP);
  unsigned char* ds_tile = smem + DK_OFF_DS;
  const float* lse = p.lse + (size_t)bh * p.Lq;
  const float* delta = p.delta + (size_t)bh * p.Lq;
  float* dq_accum = p.dq_accum + (size_t)bh * ((p.Lq + QT - 1) / QT) * DQ_TILE;

  float dk[128];
#pragma unroll
  for (int i = 0; i < 128; ++i) dk[i] = 0.f;
  if (n_tiles > 0) mbar_wait(kv_full, 0);
  for (int t = 0; t < n_tiles; ++t) {
    const uint32_t phase = t & 1;
    const int q0 = (q_first + t) * QT;
    // consumer 0: S^T = K Q^T; consumer 1: dP^T = V dO^T (64 x 32, K = D)
    mbar_wait(&full[wg == 0 ? 0 : 1], phase);
    const uint32_t sA = wg == 0 ? sK : sV, sB = wg == 0 ? sQ : sDO;
    float s[16];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_m64n32k16_ss<0, 0>(s, desc_sw128(sA + (kk / 4) * BOX + (kk % 4) * 32, 16, 1024),
                               desc_sw128(sB + (kk / 4) * QBOX + (kk % 4) * 32, 16, 1024), kk > 0);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);
    if (wg == 1) {
      mbar_arrive(&empty[1]);  // dO is read
#pragma unroll
      for (int j = 0; j < 4; ++j) dp_x[j * 128 + tid] = make_float4(s[4 * j], s[4 * j + 1], s[4 * j + 2], s[4 * j + 3]);
      named_bar_sync(BAR_DP, 128 * CONSUMERS);
      named_bar_sync(BAR_DS, 128 * CONSUMERS);
      mbar_wait(&full[0], phase);  // Q, for dK
    } else {
      probabilities<CAUSAL>(p, lse, s, n0, q0, QT, tid);
      float dl[8];
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int query = q0 + 8 * j + 2 * q + e;
          dl[2 * j + e] = query < p.Lq ? delta[query] : 0.f;
        }
      named_bar_sync(BAR_DP, 128 * CONSUMERS);
      // dS^T = P^T (dP^T - delta), bf16: row (key) r = 16 warp + g + 8 i, column
      // (query) 8 j + 2 q + e, 64-byte rows, chunk j at j ^ ((r / 2) % 4)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float4 dp = dp_x[j * 128 + tid];
        const float d0 = s[4 * j] * (dp.x - dl[2 * j]), d1 = s[4 * j + 1] * (dp.y - dl[2 * j + 1]);
        const float d2 = s[4 * j + 2] * (dp.z - dl[2 * j]), d3 = s[4 * j + 3] * (dp.w - dl[2 * j + 1]);
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int r = 16 * warp + g + 8 * i;
          *reinterpret_cast<uint32_t*>(ds_tile + r * 64 + ((j ^ ((r >> 1) & 3)) << 4) + 4 * q) =
              i == 0 ? pack_bf16(d0, d1) : pack_bf16(d2, d3);
        }
      }
      fence_proxy_async();
      named_bar_sync(BAR_DS, 128 * CONSUMERS);
    }

    // dK[:, 256 wg ..] += dS^T Q: dS^T K-major (K = 32 queries), Q MN-major
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < QT / 16; ++kk)
      wgmma_m64n256k16_ss<0, 1>(dk, desc_sw64(sDS + kk * 32), desc_sw128(sQ + 4 * wg * QBOX + kk * 16 * ROW, QBOX, 1024),
                                1);
    wgmma_commit();
    // dQ^T[256 wg + 64 mb ..] = K^T dS^T: both MN-major, K = the block's 64 keys
    float dq[4][16];
#pragma unroll
    for (int mb = 0; mb < 4; ++mb)
#pragma unroll
      for (int kk = 0; kk < BLOCK / 16; ++kk)
        wgmma_m64n32k16_ss<1, 1>(dq[mb], desc_sw128(sK + (4 * wg + mb) * BOX + kk * 16 * ROW, BOX, 1024),
                                 desc_sw64(sDS + kk * 16 * 64), kk > 0);
    wgmma_commit();
    wgmma_wait<1>();  // dK's products are done: Q is read, and its next tile loads while dQ^T's run
    fence_regs(dk);
    mbar_arrive(&empty[0]);
    wgmma_wait<0>();
#pragma unroll
    for (int mb = 0; mb < 4; ++mb) fence_regs(dq[mb]);

    float* acc = dq_accum + (size_t)(q_first + t) * DQ_TILE + ((wg * 4) * 4 * 128 + tid) * 4;
#pragma unroll
    for (int mb = 0; mb < 4; ++mb)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        atomicAdd(reinterpret_cast<float4*>(acc + ((mb * 4 + j) * 128) * 4),
                  make_float4(dq[mb][4 * j], dq[mb][4 * j + 1], dq[mb][4 * j + 2], dq[mb][4 * j + 3]));
  }
  const float scale[2] = {p.sm_scale, p.sm_scale};
  // this consumer's own boxes of V: consumer 1's last dP^T precedes the last BAR_DS
  store_rows(dk, scale, smem + DK_OFF_V + 4 * wg * BOX, p.dk + (size_t)bh * p.Lk * D, n0, p.Lk, wg, tid);
}

template <bool CAUSAL>
__global__ void __launch_bounds__(NTHREADS, 1)
    flash_bwd_d512_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                          const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap tdo,
                          const Params p) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align_1k(smem_raw);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + OFF_BAR);
  uint64_t* kv_full = bars;
  uint64_t* full = bars + 1;
  uint64_t* empty = bars + 3;
  const bool dv = blockIdx.z == 1;
  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int s = 0; s < 2; ++s) {
      mbar_init(&full[s], 1);
      // every consumer thread, but the dK / dQ CTA's dO only by consumer 1
      mbar_init(&empty[s], dv || s == 0 ? 128 * CONSUMERS : 128);
    }
    mbar_fence_init();
  }
  __syncthreads();
  const int n0 = blockIdx.x * BLOCK, bh = blockIdx.y;
  if (dv)
    dv_cta<CAUSAL>(&tq, &tk, &tdo, p, smem, kv_full, full, empty, n0, bh);
  else
    dkdq_cta<CAUSAL>(&tq, &tk, &tv, &tdo, p, smem, kv_full, full, empty, n0, bh);
}

// dq = bf16(dq_accum * sm_scale): one thread per float4 of dq_accum (see
// the layout at the top of this file).
__global__ void __launch_bounds__(256)
    flash_bwd_d512_dq_convert_kernel(const float4* __restrict__ dq_accum, bf16* __restrict__ dq, int Lq,
                                     int n_qtiles, long long n, float sm_scale) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int t = i % 128, j = (i / 128) % 4, mb = (i / 512) % 4, w = (i / 2048) % 2;
  const long long tile = i / 4096;  // (b, h) * n_qtiles + query tile
  const int qt = tile % n_qtiles;
  const long long bh = tile / n_qtiles;
  const int col = COLS * w + 64 * mb + 16 * (t / 32) + (t % 32) / 4;
  const int row = qt * QT + 8 * j + 2 * (t % 4);
  const float4 a = dq_accum[i];
  bf16* out = dq + (bh * Lq + row) * D + col;
  if (row < Lq) {
    out[0] = __float2bfloat16_rn(a.x * sm_scale);
    out[8] = __float2bfloat16_rn(a.z * sm_scale);
  }
  if (row + 1 < Lq) {
    out[D] = __float2bfloat16_rn(a.y * sm_scale);
    out[D + 8] = __float2bfloat16_rn(a.w * sm_scale);
  }
}

}  // namespace

// q, k, v, dout: (B, H, L, 512) bf16 contiguous, 16-byte aligned; lse
// (natural log, from the forward) and delta = rowsum(dout * out): (B, H, Lq)
// fp32; dq_accum: (B, H, ceil(Lq / 32) * 32, 512) fp32, zeroed; dk, dv: (B,
// H, Lk, 512) bf16. causal_block <= 0 means bidirectional. Returns the
// cudaError_t of the launch (0 on success).
extern "C" int flash_attention_bwd_d512(const void* q, const void* k, const void* v, const void* dout,
                                        const void* lse, const void* delta, void* dk, void* dv, void* dq_accum,
                                        int B, int H, int Lq, int Lk, int d, float sm_scale, int causal_block,
                                        void* stream) {
  if (d != D || Lq <= 0 || Lk <= 0) return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap maps[4];
  const void* ptrs[4] = {q, k, v, dout};
  for (int m = 0; m < 4; ++m) {
    const bool keys = m == 1 || m == 2;
    cudaError_t err = encode_map(&maps[m], ptrs[m], keys ? Lk : Lq, B * H, keys ? BLOCK : QT);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const bool causal = causal_block > 0;
  Params p{static_cast<const float*>(lse), static_cast<const float*>(delta), static_cast<bf16*>(dk),
           static_cast<bf16*>(dv), static_cast<float*>(dq_accum), Lq, Lk, sm_scale * LOG2E, sm_scale, causal_block};
  auto kern = causal ? flash_bwd_d512_kernel<true> : flash_bwd_d512_kernel<false>;
  static unsigned smem_raised[2] = {0, 0};
  cudaError_t err = flash::raise_smem_limit(kern, SMEM_BYTES, smem_raised[causal]);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((Lk + BLOCK - 1) / BLOCK, B * H, 2);
  kern<<<grid, NTHREADS, SMEM_BYTES, static_cast<cudaStream_t>(stream)>>>(maps[0], maps[1], maps[2], maps[3], p);
  return static_cast<int>(cudaGetLastError());
}

// dq (B, H, Lq, 512) bf16 = dq_accum * sm_scale, from the kernel's
// dq_accum. Returns the cudaError_t of the launch.
extern "C" int flash_attention_bwd_d512_dq_convert(const void* dq_accum, void* dq, int B, int H, int Lq, int d,
                                                   float sm_scale, void* stream) {
  if (d != D || Lq <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const int n_qtiles = (Lq + QT - 1) / QT;
  const long long n = (long long)B * H * n_qtiles * (DQ_TILE / 4);
  flash_bwd_d512_dq_convert_kernel<<<(unsigned)((n + 255) / 256), 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(dq_accum), static_cast<bf16*>(dq), Lq, n_qtiles, n, sm_scale);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* flash_attention_bwd_d512_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
