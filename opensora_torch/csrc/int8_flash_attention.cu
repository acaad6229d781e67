// Int8 flash-attention forward for Hopper (sm_90a), SageAttention-style,
// bidirectional, head dim 128: one warp-specialised kernel (TMA + int8 and
// bf16 wgmma) in two modes, qk8 and pv_int8.
//
// Replaces the two Pallas TPU kernels of opensora_tpu/ops/int8_flash.py:
//   - _int8_fwd_kernel           (:62, running-max online softmax)
//   - _int8_fwd_kernel_anchored  (:144, softmax anchored at the per-(b, h)
//                                 bound a2 = sm_scale*log2(e)*max|q|*max|k - mean k|)
// and their dispatch (int8_flash_attention :230, a lax.cond on max(a2) < 40
// for the whole call). Here every CTA reads its (b, h) a2 from a device
// tensor and takes the anchored loop when a2 < 40 (NaN compares false and
// runs the running-max loop), so no call syncs with the host. That changes
// only rounding: the two loops compute the same function, and in both the
// quantized P of the pv_int8 mode is round(p * 127 / p_scale) with p_scale =
// max(row max of p over the quantization tile, 1e-8), i.e. 127 *
// exp2(s - row max of the tile).
//
// Inputs come from the quantize preamble (ops/int8_flash.py, plain torch):
//   q8 (B, H, Lq, 128) int8, per-token scales sq (B, H, Lq) fp32 that already
//      carry sm_scale * log2(e);
//   k8 (B, H, Lk, 128) int8 of the mean-centred K, one scale per block_k
//      tile: sk (B, H, nk) fp32, nk = ceil(Lk / block_k). block_k is part of
//      the function (the JAX package's pick_blocks rule); the kernel's
//      compute tile is BN = 128 keys where block_k is a multiple of 128 or
//      covers Lk (nk = 1), else 64 (block_k a multiple of 64), so a compute
//      tile never straddles two quantization tiles and tile t uses sk[t /
//      (block_k / BN)];
//   qk8 mode: v (B, H, Lk, 128) bf16, and P.V in bf16 with P rounded to bf16
//      from the fp32 probabilities, as the TPU's p.astype(bf16);
//   pv_int8 mode: the mean-centred V as int8 with per-channel scales sv
//      (B, H, 128), stored transposed and key-permuted as v8t (B, H, 128, Lv),
//      Lv a multiple of 64 (see below), and P.V in int8. P's scale is the
//      row max over the whole quantization tile, so each quantization tile
//      is swept twice: a row-max pass (Q K^T and an integer max, no exp2,
//      no P.V), then the main pass, whose compute tiles add their P8 V8 into
//      one s32 accumulator (at most block_k * 127^2 < 2^31), dequantized
//      once by p_scale / 127, as the TPU dequantizes its block_k tile's
//      product; sv is applied per channel at the end. The running max
//      advances once per quantization tile, as on the TPU.
//   a2 (B, H) fp32.
// The softmax runs in the exp2 domain with an exact fp32 denominator (the
// sum of the unquantized p). out (B, H, Lq, 128) bf16 is acc / l (times sv
// in pv_int8 mode); the wrapper adds V's mean back in pv_int8 mode.
//
// Design: the D = 128 forward's shape (csrc/flash_fwd_sm90.cuh). One CTA
// owns 128 query rows of one (b, h) (grid ceil(Lq / 128) x B*H) and walks
// that (b, h)'s jobs: the compute tiles in order (qk8), or per quantization
// tile its compute tiles twice, a row-max pass then the main pass
// (pv_int8). Three warpgroups:
//   - the producer (setmaxnreg down to 40): one thread loads the CTA's Q8
//     tile once and keeps K8 and V tiles in flight by TMA through a ring of
//     3 stages, full (K and V apart) and empty mbarriers; a row-max job
//     loads K8 only and arrives on the stage's V barrier without bytes, so
//     every job moves every barrier's phase once;
//   - two consumers (setmaxnreg up to 232), each owning 64 rows:
//       S = Q8 K8^T  wgmma.m64n{BN}k32.s32.s8.s8 x 4, both operands K-major
//                    from shared memory (SS; one 128-byte swizzled row a
//                    token), the s32 scores in registers
//       softmax      on the score registers: s = float(s32) * sq * sk in the
//                    log2 domain, anchored at a2 or at the running max
//       qk8:     O += P V   wgmma.m64n128k16 bf16, P from registers (the
//                    probabilities rounded to bf16 in place), V MN-major
//                    (keys x 128, the transpose bit) from shared memory
//       pv_int8: PV += P8 V8   wgmma.m64n128k32.s32.s8.s8, P8 from
//                    registers, v8t K-major (128 channels x keys); O +=
//                    float(PV) * p_scale / 127 after a quantization tile
// The consumers take turns issuing S (ping-pong on named barriers 1-2), so
// one's softmax runs beside the other's products.
// The int8 P fragments need no shuffle: the s32 accumulator of wgmma
// m64nN holds, per 8-column group, keys 2q, 2q + 1 in a thread (the
// mma.sync layout), while the s8 register A of m64nNk32 wants keys 4q ..
// 4q + 3 and 16 + 4q .. 16 + 4q + 3 of a 32-key slice (the m16n8k32 one).
// The preamble permutes the keys of every 16-key group of v8t so that
// physical position 4q + j holds logical key 8 (j / 2) + 2q + j % 2 --
// exactly what the thread holds -- and the sum over keys is unchanged
// (tests/test_torch_int8_flash_schedule.py emulates the mapping).
// Conversions in the loop stay off the 16-a-clock conversion unit: a score
// s32 -> fp32 by the magic number (the int's bits added to those of 1.5 *
// 2^23, then 1.5 * 2^23 subtracted: exact for |x| < 2^22; a score is at
// most 128 * 127^2), P8 by the FP32 rounding of the W8A8 GEMM (+ 1.5 *
// 2^23, the low byte, half to even as __float2int_rn), and the row maxima
// as integer maxima of the s32 scores (their scale is positive, so the
// float maximum is the scaled integer one).
//
// Tails: Q/K rows past L and bf16 V rows past Lk are zero-filled by the TMA
// (3-D tensor maps over (row bytes, L, B*H), so a tile never reads the next
// head; bf16 garbage could be NaN, and 0 * NaN = NaN); key columns past Lk
// get p = 0 and no part in a row maximum. v8t is zero-padded by the
// preamble up to Lv and by the TMA past it.
//
// What bounds it: at the MMDiT call (B=3, H=24, L=8828, D=128) each product
// is 1.436e12 ops: Q K^T on int8 at 1979 TOP/s (twice in pv_int8 mode), P.V
// on bf16 at 989 TFLOP/s (qk8) or int8 -- 2.178 and 1.452 ms, on 0.33 GB of
// inputs and outputs -- and the exp2 of every logit on the special-function
// units (16 a clock per SM, 1.342 ms). Scores and accumulators stay in
// registers. What the design does about the kernel it replaces (64-row
// blocks of 4 warps, mma.sync m16n8k32 / m16n8k16 from ldmatrix, each warp
// reading K/V from shared memory on its own, cp.async double buffering with
// two __syncthreads a tile, conversions on the conversion unit): wgmma is
// the path to the card's int8 rate, a 64-row warpgroup product reads each
// K/V tile from shared memory once, 128-row CTAs halve the K/V traffic from
// L2, TMA and mbarriers replace cp.async and the block barriers, and the
// ping-pong hides the softmax.
//
// Layout: q8, k8 (B, H, L, 128) int8; v (B, H, Lk, 128) bf16 or v8t (B, H,
// 128, Lv) int8; all contiguous and 16-byte aligned (TMA); sq (B, H, Lq),
// sk (B, H, nk), sv (B, H, 128), anchor (B, H) fp32; o (B, H, Lq, 128) bf16.

#include <limits.h>

#include "flash_common.cuh"
#include "hopper_common.cuh"

namespace {

using flash::bf16;
using flash::fast_exp2;
using flash::NEG_INF;
using flash::pack_bf16;
using namespace hopper;

constexpr int D = 128;
constexpr int BLOCK_M = 128;  // query rows per CTA
constexpr int WG_ROWS = 64;   // query rows per consumer
constexpr int STAGES = 3;
constexpr int CONSUMERS = 2;
constexpr int NTHREADS = 128 * (CONSUMERS + 1);
constexpr int PRODUCER_REGS = 40;
constexpr int CONSUMER_REGS = 232;
constexpr float ANCHOR_MAX_LOG2 = 40.0f;
constexpr float P_SCALE_MIN = 1e-8f;
constexpr bool PINGPONG = true;  // the consumers take turns issuing S = Q K^T
constexpr float MAGIC = 12582912.f;  // 1.5 * 2^23
constexpr int MAGIC_BITS = 0x4B400000;

constexpr int BAR_TURN = 1;  // + consumer: its turn to issue S

// shared memory, bytes from a 1 KB aligned base
template <bool PV_INT8, int BN>
struct Smem {
  static constexpr int ROW = 128;                                   // a Q8/K8 row; a 64-column bf16 row
  static constexpr int Q_TILE = BLOCK_M * ROW;                      // 16 KB
  static constexpr int K_STAGE = BN * ROW;                          // 16 or 8 KB
  static constexpr int V_HALF = BN * ROW;                           // bf16: 64 columns of a BN-row tile
  static constexpr int V_STAGE = PV_INT8 ? D * BN : 2 * V_HALF;     // v8t: 128 channels x BN keys
  static constexpr int OFF_Q = 0;
  static constexpr int OFF_K = OFF_Q + Q_TILE;
  static constexpr int OFF_V = OFF_K + STAGES * K_STAGE;
  static constexpr int OFF_BAR = OFF_V + STAGES * V_STAGE;
  static constexpr int N_BARS = 1 + 3 * STAGES;  // q_full, k_full[STAGES], v_full[STAGES], empty[STAGES]
  static constexpr int BYTES = OFF_BAR + 8 * N_BARS + 1024;  // + the base's alignment
  static_assert(BYTES <= 232448, "shared memory");
};

// exact for |x| < 2^22
__device__ __forceinline__ float i2f(int x) { return __int_as_float(x + MAGIC_BITS) - MAGIC; }

// round(y) for y in [0, 127], half to even, in the low byte
__device__ __forceinline__ uint32_t p8_bits(float y) { return __float_as_uint(__fadd_rn(fminf(y, 127.f), MAGIC)); }

__device__ __forceinline__ int quad_max(int x) {
  x = max(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return max(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

template <int BN>
__device__ __forceinline__ void qk_product(int (&s)[BN / 2], uint32_t sQ, uint32_t sK) {
#pragma unroll
  for (int kk = 0; kk < D / 32; ++kk) {
    const uint64_t da = desc_sw128(sQ + 32 * kk, 16, 1024), db = desc_sw128(sK + 32 * kk, 16, 1024);
    if constexpr (BN == 128)
      wgmma_m64n128k32_s8_ss(s, da, db, kk > 0);
    else
      wgmma_m64n64k32_s8_ss(s, da, db, kk > 0);
  }
}

// Job i of a CTA: its compute tile and whether it is a row-max pass. qk8:
// tile i. pv_int8: quantization tile qt's TPQ compute tiles (fewer in the
// last) twice, the row-max pass first.
template <bool PV_INT8>
__device__ __forceinline__ void job(int i, int n_tiles, int tpq, int& tile, bool& max_pass) {
  if (!PV_INT8) {
    tile = i;
    max_pass = false;
    return;
  }
  const int qt = i / (2 * tpq);
  const int r = i - qt * 2 * tpq;
  const int cnt = min(tpq, n_tiles - qt * tpq);
  max_pass = r < cnt;
  tile = qt * tpq + (max_pass ? r : r - cnt);
}

struct Params {
  const float* sq;      // (B*H, Lq)
  const float* sk;      // (B*H, nk)
  const float* sv;      // (B*H, 128), pv_int8
  const float* anchor;  // (B*H)
  bf16* o;
  int Lq, Lk, nk, tpq;  // tpq: compute tiles per quantization tile
};

template <bool PV_INT8, int BN>
__global__ void __launch_bounds__(NTHREADS, 1)
    int8_flash_fwd_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                          const __grid_constant__ CUtensorMap tv, const Params p) {
  using L = Smem<PV_INT8, BN>;
  constexpr int NS = BN / 2;  // score registers a thread
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem =
      reinterpret_cast<unsigned char*>((reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + L::OFF_BAR);
  uint64_t* q_full = bars;
  uint64_t* k_full = bars + 1;
  uint64_t* v_full = bars + 1 + STAGES;
  uint64_t* empty = bars + 1 + 2 * STAGES;

  const int m0 = blockIdx.x * BLOCK_M, bh = blockIdx.y;
  const int n_tiles = (p.Lk + BN - 1) / BN;
  const int n_jobs = PV_INT8 ? 2 * n_tiles : n_tiles;

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
    if (threadIdx.x % 128 == 0) {
      mbar_arrive_expect_tx(q_full, L::Q_TILE);
      tma_load_3d(smem + L::OFF_Q, &tq, q_full, 0, m0, bh);
      for (int i = 0; i < n_jobs; ++i) {
        const int st = i % STAGES;
        if (i >= STAGES) mbar_wait(&empty[st], ((i / STAGES) - 1) & 1);
        int tile;
        bool max_pass;
        job<PV_INT8>(i, n_tiles, p.tpq, tile, max_pass);
        mbar_arrive_expect_tx(&k_full[st], L::K_STAGE);
        tma_load_3d(smem + L::OFF_K + st * L::K_STAGE, &tk, &k_full[st], 0, tile * BN, bh);
        unsigned char* sv = smem + L::OFF_V + st * L::V_STAGE;
        if (max_pass) {
          mbar_arrive(&v_full[st]);  // no V: the phase moves without bytes
        } else if (PV_INT8) {
          mbar_arrive_expect_tx(&v_full[st], L::V_STAGE);
          tma_load_3d(sv, &tv, &v_full[st], tile * BN, 0, bh);
        } else {
          mbar_arrive_expect_tx(&v_full[st], L::V_STAGE);
          for (int h = 0; h < 2; ++h) tma_load_3d(sv + h * L::V_HALF, &tv, &v_full[st], 64 * h, tile * BN, bh);
        }
      }
    }
    return;
  }

  // ---------------- consumers ----------------
  reg_alloc<CONSUMER_REGS>();
  const int tid = threadIdx.x % 128;
  const int warp = tid / 32, g = (tid % 32) / 4, q = tid % 4;
  const int row0 = m0 + WG_ROWS * wg;  // this consumer's first row; the thread's: row0 + 16 warp + g (+ 8)
  const uint32_t sQ = smem_u32(smem + L::OFF_Q) + WG_ROWS * wg * L::ROW;
  const uint32_t sK = smem_u32(smem + L::OFF_K), sV = smem_u32(smem + L::OFF_V);
  const float* skg = p.sk + (size_t)bh * p.nk;

  const float a2 = p.anchor[bh];
  const bool anchored = a2 < ANCHOR_MAX_LOG2;  // NaN -> the running-max loop
  float sq_r[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row0 + 16 * warp + g + 8 * i;
    sq_r[i] = row < p.Lq ? p.sq[(size_t)bh * p.Lq + row] : 0.f;
  }

  float o[64];
#pragma unroll
  for (int idx = 0; idx < 64; ++idx) o[idx] = 0.f;
  float m[2] = {NEG_INF, NEG_INF};  // running max (log2 domain)
  float l[2] = {0.f, 0.f};          // this thread's share of the row sums
  float anc[2] = {a2, a2};          // the exponent's anchor
  int mq[2] = {INT_MIN, INT_MIN};   // pv_int8: the quantization tile's integer row max so far
  float pmul[2] = {0.f, 0.f}, pdeq[2] = {0.f, 0.f};  // pv_int8: 127 / p_scale, p_scale / 127
  int pv[PV_INT8 ? 64 : 1];         // pv_int8: the quantization tile's P8 V8 (s32 accumulator)
#pragma unroll
  for (int idx = 0; idx < (PV_INT8 ? 64 : 1); ++idx) pv[idx] = 0;

  // Consumer 0 issues first: consumer 1 hands it the first turn.
  if (PINGPONG && wg == 1) named_bar_arrive(BAR_TURN, 256);
  mbar_wait(q_full, 0);
  for (int i = 0; i < n_jobs; ++i) {
    const int st = i % STAGES;
    const uint32_t phase = (i / STAGES) & 1;
    int tile;
    bool max_pass;
    job<PV_INT8>(i, n_tiles, p.tpq, tile, max_pass);
    const int qt = tile / p.tpq;
    const int n0 = tile * BN;

    // S = Q8 K8^T on this consumer's 64 rows x BN keys
    mbar_wait(&k_full[st], phase);
    if (PINGPONG) named_bar_sync(BAR_TURN + wg, 256);
    int s[NS];
    wgmma_fence();
    qk_product<BN>(s, sQ, sK + st * L::K_STAGE);
    wgmma_commit();
    // the other consumer's turn (its last turn is never handed back)
    if (PINGPONG && !(wg == 1 && i == n_jobs - 1)) named_bar_arrive(BAR_TURN + 1 - wg, 256);
    wgmma_wait<0>();
    fence_regs(s);

    // s[4 j + 2 i + e]: row 16 warp + g + 8 i, key n0 + 8 j + 2 q + e
    const bool need_mask = n0 + BN > p.Lk;
    int mx[2] = {INT_MIN, INT_MIN};  // the integer row max, where a pass needs it
    if (PV_INT8 ? max_pass : !anchored) {
#pragma unroll
      for (int idx = 0; idx < NS; ++idx)
        if (!need_mask || n0 + 8 * (idx / 4) + 2 * q + (idx & 1) < p.Lk)
          mx[(idx >> 1) & 1] = max(mx[(idx >> 1) & 1], s[idx]);
    }
    const float sk_t = skg[qt];
    const float scale[2] = {__fmul_rn(sq_r[0], sk_t), __fmul_rn(sq_r[1], sk_t)};

    if (PV_INT8 && max_pass) {
      mbar_arrive(&empty[st]);  // K read; no V in this stage
      if (tile == qt * p.tpq) mq[0] = mq[1] = INT_MIN;  // a new quantization tile
      mq[0] = max(mq[0], mx[0]);
      mq[1] = max(mq[1], mx[1]);
      continue;
    }

    if (PV_INT8) {
      if (tile == qt * p.tpq) {
        // first main-pass tile of a quantization tile: its anchor and P's scale
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const float tmax = __fmul_rn(__int2float_rn(quad_max(mq[r])), scale[r]);
          if (!anchored) {
            const float m_new = fmaxf(m[r], tmax);
            const float m_safe = m_new <= NEG_INF * 0.5f ? 0.f : m_new;
            const float corr = fast_exp2(m[r] - m_safe);
            m[r] = m_new;
            l[r] *= corr;
#pragma unroll
            for (int j = 0; j < 16; ++j) {
              o[4 * j + 2 * r] *= corr;
              o[4 * j + 2 * r + 1] *= corr;
            }
            anc[r] = m_safe;
          }
          const float p_scale = fmaxf(fast_exp2(tmax - anc[r]), P_SCALE_MIN);
          pmul[r] = __fdiv_rn(127.f, p_scale);
          pdeq[r] = __fmul_rn(p_scale, 1.f / 127.f);
        }
      }
    } else if (!anchored) {
      // running max over this compute tile (qk8)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float tmax = __fmul_rn(__int2float_rn(quad_max(mx[r])), scale[r]);
        const float m_new = fmaxf(m[r], tmax);
        const float m_safe = m_new <= NEG_INF * 0.5f ? 0.f : m_new;
        const float corr = fast_exp2(m[r] - m_safe);
        m[r] = m_new;
        l[r] *= corr;
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          o[4 * j + 2 * r] *= corr;
          o[4 * j + 2 * r + 1] *= corr;
        }
        anc[r] = m_safe;
      }
    }

    // p = exp2(s - anchor); the denominator sums the unquantized p
    float pr[NS];
#pragma unroll
    for (int idx = 0; idx < NS; ++idx) {
      const int r = (idx >> 1) & 1;
      const bool ok = !need_mask || n0 + 8 * (idx / 4) + 2 * q + (idx & 1) < p.Lk;
      const float pe = ok ? fast_exp2(fmaf(i2f(s[idx]), scale[r], -anc[r])) : 0.f;
      l[r] += pe;
      pr[idx] = pe;
    }

    if constexpr (PV_INT8) {
      // P8 = round(p * 127 / p_scale) as the s8 A fragments of each 32-key
      // slice: register r of slice kc holds row g + 8 (r % 2), physical keys
      // 16 (2 kc + r / 2) + 4 q + b = logical 16 (2 kc + r / 2) + 8 (b / 2) +
      // 2 q + b % 2, i.e. score register 4 (2 (2 kc + r / 2) + b / 2) + 2 (r % 2) + b % 2
      uint32_t pa[BN / 32][4];
#pragma unroll
      for (int kc = 0; kc < BN / 32; ++kc)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int j0 = 2 * (2 * kc + r / 2), i = r % 2;
          const uint32_t t0 = p8_bits(__fmul_rn(pr[4 * j0 + 2 * i], pmul[i]));
          const uint32_t t1 = p8_bits(__fmul_rn(pr[4 * j0 + 2 * i + 1], pmul[i]));
          const uint32_t t2 = p8_bits(__fmul_rn(pr[4 * (j0 + 1) + 2 * i], pmul[i]));
          const uint32_t t3 = p8_bits(__fmul_rn(pr[4 * (j0 + 1) + 2 * i + 1], pmul[i]));
          pa[kc][r] = __byte_perm(__byte_perm(t0, t1, 0x0040), __byte_perm(t2, t3, 0x0040), 0x5410);
        }
      // the quantization tile's P8 V8 sums in pv over its compute tiles
      const bool qt_first = tile == qt * p.tpq, qt_last = tile == min((qt + 1) * p.tpq, n_tiles) - 1;
      mbar_wait(&v_full[st], phase);
      wgmma_fence();
#pragma unroll
      for (int kc = 0; kc < BN / 32; ++kc) {
        const uint32_t vt = sV + st * L::V_STAGE + 32 * kc;
        wgmma_m64n128k32_s8_rs(pv, pa[kc], BN == 128 ? desc_sw128(vt, 16, 1024) : desc_sw64(vt),
                               !qt_first || kc > 0);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(pv);
      mbar_arrive(&empty[st]);  // K and V of this stage are read
      if (qt_last) {
#pragma unroll
        for (int idx = 0; idx < 64; ++idx)
          o[idx] = fmaf(__int2float_rn(pv[idx]), pdeq[(idx >> 1) & 1], o[idx]);
      }
    } else {
      // O += P V: P (bf16) as A fragments, V MN-major (N = D in two 64-column halves)
      uint32_t pa[NS / 2];
#pragma unroll
      for (int r = 0; r < NS / 2; ++r) pa[r] = pack_bf16(pr[2 * r], pr[2 * r + 1]);
      mbar_wait(&v_full[st], phase);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk) {
        const uint32_t a[4] = {pa[4 * kk], pa[4 * kk + 1], pa[4 * kk + 2], pa[4 * kk + 3]};
        wgmma_m64n128k16_rs<1>(o, a, desc_sw128(sV + st * L::V_STAGE + kk * 16 * L::ROW, L::V_HALF, 1024), 1);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(o);
      mbar_arrive(&empty[st]);  // K and V of this stage are read
    }
  }

  // out = o (x sv) / l, bf16; a quad writes 16 contiguous bytes of a row
  float l_safe[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float x = l[r];
    x += __shfl_xor_sync(0xffffffffu, x, 1);
    x += __shfl_xor_sync(0xffffffffu, x, 2);
    l_safe[r] = x <= 0.f ? 1.f : x;
  }
  const float* svg = p.sv + (size_t)bh * D;
  bf16* og = p.o + (size_t)bh * p.Lq * D;
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const int col = 8 * j + 2 * q;
    const float2 svc = PV_INT8 ? *reinterpret_cast<const float2*>(svg + col) : make_float2(1.f, 1.f);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + 16 * warp + g + 8 * r;
      if (row < p.Lq)
        *reinterpret_cast<__nv_bfloat162*>(og + (size_t)row * D + col) =
            __floats2bfloat162_rn(__fdiv_rn(__fmul_rn(o[4 * j + 2 * r], svc.x), l_safe[r]),
                                  __fdiv_rn(__fmul_rn(o[4 * j + 2 * r + 1], svc.y), l_safe[r]));
    }
  }
}

template <bool PV_INT8, int BN>
cudaError_t launch(const void* q8, const void* k8, const void* v, const Params& p, int BH, int Lv,
                   cudaStream_t stream) {
  using L = Smem<PV_INT8, BN>;
  CUtensorMap tq, tk, tv;
  cudaError_t err = encode_3d(&tq, CU_TENSOR_MAP_DATA_TYPE_UINT8, q8, D, p.Lq, BH, D, BLOCK_M,
                              CU_TENSOR_MAP_SWIZZLE_128B);
  if (err == cudaSuccess)
    err = encode_3d(&tk, CU_TENSOR_MAP_DATA_TYPE_UINT8, k8, D, p.Lk, BH, D, BN, CU_TENSOR_MAP_SWIZZLE_128B);
  if (err == cudaSuccess)
    err = PV_INT8 ? encode_3d(&tv, CU_TENSOR_MAP_DATA_TYPE_UINT8, v, Lv, D, BH, BN, D,
                              BN == 128 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B)
                  : encode_3d(&tv, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, v, D, p.Lk, BH, 64, BN,
                              CU_TENSOR_MAP_SWIZZLE_128B);
  if (err != cudaSuccess) return err;
  auto kern = int8_flash_fwd_kernel<PV_INT8, BN>;
  static unsigned smem_raised = 0;
  err = flash::raise_smem_limit(kern, L::BYTES, smem_raised);
  if (err != cudaSuccess) return err;
  dim3 grid((p.Lq + BLOCK_M - 1) / BLOCK_M, BH);
  kern<<<grid, NTHREADS, L::BYTES, stream>>>(tq, tk, tv, p);
  return cudaGetLastError();
}

}  // namespace

// q8, k8: (B, H, L, 128) int8; sq (B, H, Lq), sk (B, H, nk), anchor (B, H)
// fp32; o (B, H, Lq, 128) bf16. pv_int8 = 0: v (B, H, Lk, 128) bf16, sv
// unused. pv_int8 = 1: v = v8t (B, H, 128, Lv) int8 (keys permuted in every
// 16-key group, zero past Lk, Lv % 64 == 0), sv (B, H, 128) fp32. block_k:
// the quantization tile, a multiple of 64 unless it covers Lk (nk = 1). All
// tensors contiguous, the int8 and bf16 ones 16-byte aligned. Returns the
// cudaError_t of the launch (0 on success).
extern "C" int int8_flash_attention_fwd(const void* q8, const void* k8, const void* v, const void* sq,
                                        const void* sk, const void* sv, const void* anchor, void* o, int B,
                                        int H, int Lq, int Lk, int Lv, int nk, int block_k, int pv_int8,
                                        void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (Lq <= 0 || Lk <= 0 || nk <= 0 || block_k <= 0 || (long long)nk * block_k < Lk ||
      (nk > 1 && block_k % 64 != 0))
    return static_cast<int>(cudaErrorInvalidValue);
  // pv_int8 sums a quantization tile's P8 V8 in int32: at most its keys * 127^2
  if (pv_int8 && (Lv % 64 != 0 || Lv < Lk || (long long)(nk == 1 ? Lk : block_k) * 127 * 127 > INT_MAX))
    return static_cast<int>(cudaErrorInvalidValue);
  // BN = 128 unless a 128-key compute tile would straddle two quantization tiles
  const int bn = nk == 1 || block_k % 128 == 0 ? 128 : 64;
  const int tpq = nk == 1 ? (Lk + bn - 1) / bn : block_k / bn;
  const Params p{static_cast<const float*>(sq), static_cast<const float*>(sk), static_cast<const float*>(sv),
                 static_cast<const float*>(anchor), static_cast<bf16*>(o), Lq, Lk, nk, tpq};
  cudaError_t err;
  if (pv_int8)
    err = bn == 128 ? launch<true, 128>(q8, k8, v, p, B * H, Lv, s) : launch<true, 64>(q8, k8, v, p, B * H, Lv, s);
  else
    err = bn == 128 ? launch<false, 128>(q8, k8, v, p, B * H, Lv, s) : launch<false, 64>(q8, k8, v, p, B * H, Lv, s);
  return static_cast<int>(err);
}

extern "C" const char* int8_flash_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
