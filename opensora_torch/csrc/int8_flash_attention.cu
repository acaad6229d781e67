// Int8 flash-attention forward for Hopper (sm_90a), SageAttention-style,
// bidirectional, head dim 128.
//
// Replaces the two Pallas TPU kernels of opensora_tpu/ops/int8_flash.py:
//   - _int8_fwd_kernel           (:62, running-max online softmax)
//   - _int8_fwd_kernel_anchored  (:144, softmax anchored at the per-(b, h)
//                                 bound a2 = sm_scale*log2(e)*max|q|*max|k - mean k|)
// and their dispatch (:344-357). On the TPU one lax.cond on max(a2) < 40
// picks a kernel for the whole call; here every block reads its (b, h) a2
// from a device tensor and takes the anchored loop when a2 < 40 (NaN
// compares false and runs the running-max loop), so no call syncs with the
// host. That changes only rounding: the two loops compute the same function,
// and in both the quantized P of the pv_int8 mode is
// round(p * 127 / p_scale) with p_scale = max(row max of p over the
// quantization tile, 1e-8), i.e. 127 * exp2(s - row max of the tile).
//
// Inputs come from the quantize preamble (ops/int8_flash.py, plain torch):
//   q8 (B, H, Lq, 128) int8, per-token scales sq (B, H, Lq) fp32 that already
//      carry sm_scale * log2(e);
//   k8 (B, H, Lk, 128) int8 of the mean-centred K, one scale per block_k
//      tile: sk (B, H, nk) fp32, nk = ceil(Lk / block_k). block_k is part of
//      the function (the JAX package's pick_blocks rule); this kernel's own
//      compute tile is BN = 64 keys, and tile j of the scores uses
//      sk[(64 j) / block_k] (block_k is a multiple of 64, or covers Lk);
//   qk8 mode: v (B, H, Lk, 128) bf16 and P.V in bf16 (m16n8k16), P rounded
//      to bf16 from the fp32 probabilities, as the TPU's p.astype(bf16);
//   pv_int8 mode: the mean-centred V as int8 with per-channel scales sv
//      (B, H, 128), stored transposed and key-permuted as v8t (B, H, 128,
//      Lv) with Lv a multiple of 64 (see below), and P.V in int8
//      (m16n8k32) dequantized by p_scale / 127 * sv. P's scale is the row max
//      over the whole quantization tile, so each tile is swept twice: a first
//      int8 QK^T pass for its row max, then the pass that uses it. The
//      running max also advances once per quantization tile, as on the TPU.
//   a2 (B, H) fp32.
// The softmax runs in the exp2 domain with an exact fp32 denominator (the
// sum of the unquantized p). out (B, H, Lq, 128) bf16 is acc / l; the
// wrapper adds V's mean back in pv_int8 mode.
//
// Layout work: the int8 MMA wants both operands K-major. Q K^T is that as
// stored. For P.V the contraction runs over keys, so V must be key-major per
// channel: the preamble writes V8 transposed. The int32 score fragment of
// one m16n8k32 is not the A fragment of the next: a thread holds keys
// 2t, 2t+1 of each 8-key n-tile, while the A fragment wants keys 4t..4t+3
// of a 16-key group. Rather than shuffle P between lanes, the keys of every
// 16-key group are permuted in v8t so that logical key 4t + j is physical
// key 8 (j / 2) + 2t + j % 2 -- exactly what the thread holds -- and the
// sum over keys is unchanged.
//
// Tails: Q/K rows past L, and bf16 V rows, are zero-filled on load (bf16
// garbage could be NaN, and 0 * NaN = NaN); key columns past Lk score -1e30
// (p = 0). v8t is zero-padded to Lv by the preamble.
//
// What bounds it: at the MMDiT call (B=3, H=24, L=8828, D=128) the two
// products are 2.87e12 ops on 0.33 GB of int8/bf16 inputs and outputs: bound
// by tensor-core operations (int8 Q K^T at 1979 TOP/s; bf16 P.V at 989
// TFLOP/s in qk8 mode) and by the exp2 of every logit (16 a clock per SM on
// the MUFU unit). Scores and accumulators stay in registers, K/V tiles are
// double-buffered with cp.async, Q's fragments are loaded once per block.

#include "flash_common.cuh"

namespace {

using namespace flash;

constexpr int D = 128;
constexpr int BM = 64;  // query rows per block (16 per warp)
constexpr int BN = 64;  // keys per compute tile
constexpr int NWARPS = 4;
constexpr int NTHREADS = NWARPS * 32;
constexpr int QKS = D + 16;    // int8 Q/K smem row stride (bytes)
constexpr int VTS = BN + 16;   // int8 V^T smem row stride (bytes)
constexpr int VS = D + PAD;    // bf16 V smem row stride (elements)
constexpr float ANCHOR_MAX_LOG2 = 40.0f;
constexpr float P_SCALE_MIN = 1e-8f;

__device__ __forceinline__ uint32_t pack_s8(int a, int b, int c, int d) {
  return (a & 0xff) | (b & 0xff) << 8 | (c & 0xff) << 16 | (uint32_t)(d & 0xff) << 24;
}

__device__ __forceinline__ float row_max4(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

template <bool PV_INT8>
__global__ void __launch_bounds__(NTHREADS)
    int8_flash_fwd_kernel(const int8_t* __restrict__ q8, const int8_t* __restrict__ k8,
                          const void* __restrict__ v, const float* __restrict__ sq,
                          const float* __restrict__ sk, const float* __restrict__ sv,
                          const float* __restrict__ anchor, bf16* __restrict__ o, int Lq, int Lk, int Lv,
                          int nk, int tiles_per_qt) {
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* Qs = smem;                 // BM x QKS
  unsigned char* Ks = Qs + BM * QKS;        // 2 x BN x QKS
  unsigned char* Vs = Ks + 2 * BN * QKS;    // 2 x (BN x VS bf16 | D x VTS int8)
  constexpr int V_STAGE = PV_INT8 ? D * VTS : BN * VS * 2;
  float* svs = reinterpret_cast<float*>(Vs + 2 * V_STAGE);  // D channel scales (pv_int8)

  const int q0 = blockIdx.x * BM;
  const int bh = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3, mat = lane >> 3;
  const int row_a = q0 + warp * 16 + g, row_b = row_a + 8;

  const unsigned char* qg = reinterpret_cast<const unsigned char*>(q8) + (size_t)bh * Lq * D;
  const unsigned char* kg = reinterpret_cast<const unsigned char*>(k8) + (size_t)bh * Lk * D;
  const unsigned char* vg = PV_INT8 ? static_cast<const unsigned char*>(v) + (size_t)bh * D * Lv
                                    : static_cast<const unsigned char*>(v) + (size_t)bh * Lk * D * 2;
  const float* skg = sk + (size_t)bh * nk;

  const float a2 = anchor[bh];
  const bool anchored = a2 < ANCHOR_MAX_LOG2;  // NaN -> running-max loop
  const float sq_r[2] = {row_a < Lq ? sq[(size_t)bh * Lq + row_a] : 0.f,
                         row_b < Lq ? sq[(size_t)bh * Lq + row_b] : 0.f};

  // The jobs: compute tiles in order (qk8); in pv_int8 mode each
  // quantization tile's compute tiles twice, a row-max pass then the main one.
  const int n_tiles = (Lk + BN - 1) / BN;
  const int n_jobs = PV_INT8 ? 2 * n_tiles : n_tiles;
  auto job = [&](int i, int& tile, bool& max_pass) {
    if (!PV_INT8) {
      tile = i;
      max_pass = false;
      return;
    }
    const int qt = i / (2 * tiles_per_qt);
    const int r = i - qt * 2 * tiles_per_qt;
    const int cnt = min(tiles_per_qt, n_tiles - qt * tiles_per_qt);
    max_pass = r < cnt;
    tile = qt * tiles_per_qt + (max_pass ? r : r - cnt);
  };
  auto load_kv = [&](int i, int stage) {
    int tile;
    bool max_pass;
    job(i, tile, max_pass);
    load_rows<BN, D, QKS, NTHREADS>(Ks + stage * BN * QKS, kg, tile * BN, Lk, D);
    if (max_pass) return;
    if (PV_INT8)
      load_rows<D, BN, VTS, NTHREADS>(Vs + stage * V_STAGE, vg + tile * BN, 0, D, Lv);
    else
      load_rows<BN, 2 * D, 2 * VS, NTHREADS>(Vs + stage * V_STAGE, vg, tile * BN, Lk, 2 * D);
  };

  load_rows<BM, D, QKS, NTHREADS>(Qs, qg, q0, Lq, D);
  load_kv(0, 0);
  cp_async_commit();
  if (PV_INT8) {
    for (int i = threadIdx.x; i < D; i += NTHREADS) svs[i] = sv[(size_t)bh * D + i];
  }

  float acc[D / 8][4];
#pragma unroll
  for (int i = 0; i < D / 8; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
  float m_r[2] = {NEG_INF, NEG_INF};  // running max (log2 domain)
  float l_r[2] = {0.f, 0.f};          // this thread's share of the row sums
  float mt[2] = {NEG_INF, NEG_INF};   // pv_int8: row max of the current quantization tile
  float anc[2] = {a2, a2};            // the exponent's anchor for the current tile
  float pmul[2] = {0.f, 0.f}, pdeq[2] = {0.f, 0.f};  // pv_int8: 127 / p_scale, p_scale / 127
  uint32_t qa[D / 32][4];             // this warp's Q fragments, loaded once

  for (int i = 0; i < n_jobs; ++i) {
    const int st = i & 1;
    if (i + 1 < n_jobs) load_kv(i + 1, st ^ 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    if (i == 0) {
#pragma unroll
      for (int kk = 0; kk < D / 32; ++kk)
        ldmatrix_x4(qa[kk], smem_u32(Qs + (warp * 16 + (lane & 15)) * QKS + kk * 32 + (lane >> 4) * 16));
    }
    int tile;
    bool max_pass;
    job(i, tile, max_pass);
    const int qt = tile / tiles_per_qt;
    const unsigned char* Kt = Ks + st * BN * QKS;

    // S = Q K^T on int8 for this warp's 16 rows x BN keys
    float s[BN / 8][4];
    {
      int s32[BN / 8][4];
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) s32[j][0] = s32[j][1] = s32[j][2] = s32[j][3] = 0;
#pragma unroll
      for (int kk = 0; kk < D / 32; ++kk) {
#pragma unroll
        for (int nn = 0; nn < BN / 16; ++nn) {
          uint32_t b[4];
          ldmatrix_x4(b, smem_u32(Kt + (nn * 16 + (lane & 7) + (mat >> 1) * 8) * QKS + kk * 32 + (mat & 1) * 16));
          mma_s8(s32[2 * nn], qa[kk], b[0], b[1]);
          mma_s8(s32[2 * nn + 1], qa[kk], b[2], b[3]);
        }
      }
      // dequantize: one per-row scale sq * sk_tile (as on the TPU), log2 domain
      const float sk_t = skg[qt];
      const float scale[2] = {__fmul_rn(sq_r[0], sk_t), __fmul_rn(sq_r[1], sk_t)};
      const int n0 = tile * BN;
      const bool need_mask = n0 + BN > Lk;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = __fmul_rn(__int2float_rn(s32[j][e]), scale[e >> 1]);
          if (need_mask && n0 + j * 8 + 2 * t + (e & 1) >= Lk) x = NEG_INF;
          s[j][e] = x;
        }
    }

    if (PV_INT8 && max_pass) {
      if (tile == qt * tiles_per_qt) mt[0] = mt[1] = NEG_INF;  // a new quantization tile
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        mt[0] = fmaxf(mt[0], fmaxf(s[j][0], s[j][1]));
        mt[1] = fmaxf(mt[1], fmaxf(s[j][2], s[j][3]));
      }
      __syncthreads();  // the next job's prefetch overwrites this stage
      continue;
    }

    if (PV_INT8) {
      if (tile == qt * tiles_per_qt) {
        // first main-pass tile of a quantization tile: fix its anchor and P's scale
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const float tmax = row_max4(mt[r]);
          if (!anchored) {
            const float m_new = fmaxf(m_r[r], tmax);
            const float m_safe = m_new <= NEG_INF * 0.5f ? 0.f : m_new;
            const float corr = fast_exp2(m_r[r] - m_safe);
            m_r[r] = m_new;
            l_r[r] *= corr;
#pragma unroll
            for (int d = 0; d < D / 8; ++d) {
              acc[d][2 * r] *= corr;
              acc[d][2 * r + 1] *= corr;
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
        float mx = NEG_INF;
#pragma unroll
        for (int j = 0; j < BN / 8; ++j) mx = fmaxf(mx, fmaxf(s[j][2 * r], s[j][2 * r + 1]));
        const float m_new = fmaxf(m_r[r], row_max4(mx));
        const float m_safe = m_new <= NEG_INF * 0.5f ? 0.f : m_new;
        const float corr = fast_exp2(m_r[r] - m_safe);
        m_r[r] = m_new;
        l_r[r] *= corr;
#pragma unroll
        for (int d = 0; d < D / 8; ++d) {
          acc[d][2 * r] *= corr;
          acc[d][2 * r + 1] *= corr;
        }
        anc[r] = m_safe;
      }
    }

    // p = exp2(s - anchor); the denominator sums the unquantized p
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = fast_exp2(s[j][e] - anc[e >> 1]);
        l_r[e >> 1] += p;
        s[j][e] = p;
      }

    if (PV_INT8) {
      // P8 = round(p * 127 / p_scale) as A fragments over permuted keys
      uint32_t pa[BN / 32][4];
#pragma unroll
      for (int kc = 0; kc < BN / 32; ++kc) {
        int p8[4][4];
#pragma unroll
        for (int jj = 0; jj < 4; ++jj)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            p8[jj][e] = min(__float2int_rn(__fmul_rn(s[4 * kc + jj][e], pmul[e >> 1])), 127);
        pa[kc][0] = pack_s8(p8[0][0], p8[0][1], p8[1][0], p8[1][1]);
        pa[kc][1] = pack_s8(p8[0][2], p8[0][3], p8[1][2], p8[1][3]);
        pa[kc][2] = pack_s8(p8[2][0], p8[2][1], p8[3][0], p8[3][1]);
        pa[kc][3] = pack_s8(p8[2][2], p8[2][3], p8[3][2], p8[3][3]);
      }
      const unsigned char* Vt = Vs + st * V_STAGE;
#pragma unroll
      for (int dd = 0; dd < D / 16; ++dd) {
        int c0[4] = {0, 0, 0, 0}, c1[4] = {0, 0, 0, 0};
#pragma unroll
        for (int kc = 0; kc < BN / 32; ++kc) {
          uint32_t b[4];
          ldmatrix_x4(b, smem_u32(Vt + (dd * 16 + (lane & 7) + (mat >> 1) * 8) * VTS + kc * 32 + (mat & 1) * 16));
          mma_s8(c0, pa[kc], b[0], b[1]);
          mma_s8(c1, pa[kc], b[2], b[3]);
        }
        // acc += float(pv32) * (p_scale / 127) * sv
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col0 = dd * 16 + 2 * t + (e & 1);
          acc[2 * dd][e] += __fmul_rn(__fmul_rn(__int2float_rn(c0[e]), pdeq[e >> 1]), svs[col0]);
          acc[2 * dd + 1][e] += __fmul_rn(__fmul_rn(__int2float_rn(c1[e]), pdeq[e >> 1]), svs[col0 + 8]);
        }
      }
    } else {
      // acc += P V in bf16: the score registers are the A fragments
      const bf16* Vt = reinterpret_cast<const bf16*>(Vs + st * V_STAGE);
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk) {
        const uint32_t p0 = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
        const uint32_t p1 = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
        const uint32_t p2 = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
        const uint32_t p3 = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
        for (int dd = 0; dd < D / 16; ++dd) {
          uint32_t b0, b1, b2, b3;
          ldmatrix_x4_trans(b0, b1, b2, b3,
                            smem_u32(Vt + (kk * 16 + (lane & 7) + (mat & 1) * 8) * VS + dd * 16 + (mat >> 1) * 8));
          mma_bf16(acc[2 * dd], p0, p1, p2, p3, b0, b1);
          mma_bf16(acc[2 * dd + 1], p0, p1, p2, p3, b2, b3);
        }
      }
    }
    __syncthreads();  // the next job's prefetch overwrites this stage
  }
  cp_async_wait<0>();

  float l[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float x = l_r[r];
    x += __shfl_xor_sync(0xffffffffu, x, 1);
    x += __shfl_xor_sync(0xffffffffu, x, 2);
    l[r] = x <= 0.f ? 1.f : x;
  }
  bf16* og = o + (size_t)bh * Lq * D;
#pragma unroll
  for (int d = 0; d < D / 8; ++d) {
    const int col = d * 8 + 2 * t;
    if (row_a < Lq)
      *reinterpret_cast<__nv_bfloat162*>(og + (size_t)row_a * D + col) =
          __floats2bfloat162_rn(__fdiv_rn(acc[d][0], l[0]), __fdiv_rn(acc[d][1], l[0]));
    if (row_b < Lq)
      *reinterpret_cast<__nv_bfloat162*>(og + (size_t)row_b * D + col) =
          __floats2bfloat162_rn(__fdiv_rn(acc[d][2], l[1]), __fdiv_rn(acc[d][3], l[1]));
  }
}

template <bool PV_INT8>
cudaError_t launch(const void* q8, const void* k8, const void* v, const void* sq, const void* sk,
                   const void* sv, const void* anchor, void* o, int BH, int Lq, int Lk, int Lv, int nk,
                   int tiles_per_qt, cudaStream_t stream) {
  constexpr int v_stage = PV_INT8 ? D * VTS : BN * VS * 2;
  constexpr int smem = BM * QKS + 2 * BN * QKS + 2 * v_stage + (PV_INT8 ? D * 4 : 0);
  auto kern = int8_flash_fwd_kernel<PV_INT8>;
  static unsigned smem_raised = 0;
  cudaError_t err = raise_smem_limit(kern, smem, smem_raised);
  if (err != cudaSuccess) return err;
  dim3 grid((Lq + BM - 1) / BM, BH);
  kern<<<grid, NTHREADS, smem, stream>>>(
      static_cast<const int8_t*>(q8), static_cast<const int8_t*>(k8), v, static_cast<const float*>(sq),
      static_cast<const float*>(sk), static_cast<const float*>(sv), static_cast<const float*>(anchor),
      static_cast<bf16*>(o), Lq, Lk, Lv, nk, tiles_per_qt);
  return cudaGetLastError();
}

}  // namespace

// q8, k8: (B, H, L, 128) int8; sq (B, H, Lq), sk (B, H, nk), anchor (B, H)
// fp32; o (B, H, Lq, 128) bf16. pv_int8 = 0: v (B, H, Lk, 128) bf16, sv
// unused. pv_int8 = 1: v = v8t (B, H, 128, Lv) int8 (keys permuted in every
// 16-key group, zero past Lk, Lv % 64 == 0), sv (B, H, 128) fp32. Compute
// tile t of 64 keys uses sk[t / tiles_per_qt]. Returns the cudaError_t of
// the launch (0 on success).
extern "C" int int8_flash_attention_fwd(const void* q8, const void* k8, const void* v, const void* sq,
                                        const void* sk, const void* sv, const void* anchor, void* o, int B,
                                        int H, int Lq, int Lk, int Lv, int nk, int tiles_per_qt, int pv_int8,
                                        void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (Lq <= 0 || Lk <= 0 || tiles_per_qt <= 0 || (long long)(Lk + BN - 1) / BN > (long long)nk * tiles_per_qt)
    return static_cast<int>(cudaErrorInvalidValue);
  if (pv_int8) {
    if (Lv % BN != 0 || Lv < Lk) return static_cast<int>(cudaErrorInvalidValue);
    return launch<true>(q8, k8, v, sq, sk, sv, anchor, o, B * H, Lq, Lk, Lv, nk, tiles_per_qt, s);
  }
  return launch<false>(q8, k8, v, sq, sk, sv, anchor, o, B * H, Lq, Lk, Lv, nk, tiles_per_qt, s);
}

extern "C" const char* int8_flash_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
