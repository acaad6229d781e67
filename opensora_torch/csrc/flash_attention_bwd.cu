// Flash-attention backward for Hopper (sm_90a): two kernels, bf16 in/out,
// fp32 accumulation.
//
// Replaces the two Pallas TPU backward kernels of
// opensora_tpu/ops/flash_attention.py:
//   - _dkv_kernel (:425)  dV = sum_q P^T dO,  dK = sm_scale * sum_q dS^T Q
//   - _dq_kernel  (:497)  dQ = sm_scale * sum_k dS K
// with P recomputed from the forward's LSE and dS = P * (dP - delta),
// dP = dO V^T, delta = rowsum(dO * O) (computed by the caller, as XLA does
// beside the TPU kernels). The rounding sits where the TPU kernels put it:
// p = exp2(s * c - lse_safe * log2(e)) with c = sm_scale * log2(e) and
// lse_safe = 0 for fully masked rows (lse <= -5e29); masked logits give
// p = 0 exactly (the TPU kernels mask to -1e30 / c before the scale, and
// exp2 of -1e30 is 0); P is rounded to bf16 before the dV product and dS
// before the dK and dQ products; sm_scale multiplies the fp32 sums once,
// at the end. Rows and columns past the sequence are zero-filled on load
// and lse / delta read as 0 there, so no garbage reaches a product
// (0 * NaN = NaN, opensora_tpu/ops/flash_attention.py:446-452), and query
// rows past Lq are masked out of P.
//
// On the TPU the grid runs in order and each kernel carries its sums in
// VMEM scratch across the last grid axis. Here that axis is a loop inside
// the block:
//   dkv: one block of 4 warps owns 64 key rows (16 per warp) of one (b, h)
//        and walks the query rows in steps of 32. Each warp works on the
//        transposed scores S^T = K Q^T (16 keys x 32 queries), so the dK and
//        dV sums of its 16 key rows stay in its registers. Those two fp32
//        accumulators take 2 x 64 = 128 registers a thread at D = 128; the
//        query step is 32 (not 64) so the score and dP tiles take 16
//        registers each and nothing spills.
//   dq:  one block of 4 warps owns 64 query rows (16 per warp) and walks
//        the keys in steps of 64, as the forward does.
// Q / dO (dkv) and K / V (dq) tiles are double-buffered with cp.async.
// Frame-causal calls (causal_block) skip the query steps (dkv) and key
// tiles (dq) that the mask hides wholly.
//
// What bounds it: at the MMDiT shape (B=3, H=24, L=8828, D=128) the two
// kernels do 7 products of 2*B*H*L^2*D = 1.44 TFLOP each (dkv: S, dV, dP,
// dK; dq: S, dP, dQ), 10.1 TFLOP, on 0.98 GB of q/k/v/dO/dq/dk/dv: ~10^4
// flops per byte, far above the H100's ~295, so tensor-core operations
// bound it (10.2 ms at 989 TFLOP/s; the minimal backward, 5 products, is
// 7.3 ms). mma.sync from shared memory; wgmma/TMA are for a later change.
//
// D = 512 (the VAE mid-block) would need 512-column dK/dV accumulators per
// warp; it is not instantiated and the wrapper raises before a launch.
//
// Layout: q, k, v, dout, dq, dk, dv are (B, H, L, D) contiguous bf16; lse
// and delta are (B, H, Lq) fp32.

#include "flash_common.cuh"

namespace {

using namespace flash;

constexpr int NWARPS = 4;
constexpr int NTHREADS = NWARPS * 32;
constexpr int D = 128;
constexpr int RS = D + PAD;  // smem row stride of every tile

constexpr int KV_ROWS = 64;  // dkv: key rows per block
constexpr int Q_STEP = 32;   // dkv: query rows per step
constexpr int Q_ROWS = 64;   // dq: query rows per block
constexpr int KV_STEP = 64;  // dq: keys per step

__device__ __forceinline__ float lse_log2_safe(float l) {
  return l <= NEG_INF * 0.5f ? 0.f : l * LOG2E;
}

template <bool CAUSAL>
__global__ void __launch_bounds__(NTHREADS)
    flash_bwd_dkv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                         const bf16* __restrict__ v, const bf16* __restrict__ dout,
                         const float* __restrict__ lse, const float* __restrict__ delta,
                         bf16* __restrict__ dk, bf16* __restrict__ dv, int Lq, int Lk,
                         float sm_scale, float c, int causal_block) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Ks = reinterpret_cast<bf16*>(smem_raw);  // KV_ROWS x RS
  bf16* Vs = Ks + KV_ROWS * RS;                  // KV_ROWS x RS
  bf16* Qs = Vs + KV_ROWS * RS;                  // 2 stages x Q_STEP x RS
  bf16* dOs = Qs + 2 * Q_STEP * RS;              // 2 stages x Q_STEP x RS
  float* Ls = reinterpret_cast<float*>(dOs + 2 * Q_STEP * RS);  // 2 x Q_STEP: lse_safe*log2e
  float* Ds = Ls + 2 * Q_STEP;                                  // 2 x Q_STEP: delta

  const int k0 = blockIdx.x * KV_ROWS;
  const int bh = blockIdx.y;
  const bf16* qg = q + (size_t)bh * Lq * D;
  const bf16* dog = dout + (size_t)bh * Lq * D;
  const float* lg = lse + (size_t)bh * Lq;
  const float* dg = delta + (size_t)bh * Lq;

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int mat = lane >> 3;
  const int key_a = k0 + warp * 16 + g;  // accumulator rows g and g + 8
  const int key_b = key_a + 8;

  // Query rows of frames before this block's first key frame see none of
  // its keys.
  int q_begin = 0;
  if (CAUSAL) q_begin = (k0 / causal_block) * causal_block / Q_STEP * Q_STEP;
  const int n_steps = q_begin < Lq ? (Lq - q_begin + Q_STEP - 1) / Q_STEP : 0;

  auto load_step = [&](int j, int st) {
    const int q0 = q_begin + j * Q_STEP;
    load_tile<Q_STEP, D, NTHREADS>(Qs + st * Q_STEP * RS, qg, q0, Lq, D);
    load_tile<Q_STEP, D, NTHREADS>(dOs + st * Q_STEP * RS, dog, q0, Lq, D);
    if (threadIdx.x < Q_STEP) {
      const int r = q0 + threadIdx.x;
      Ls[st * Q_STEP + threadIdx.x] = r < Lq ? lse_log2_safe(lg[r]) : 0.f;
      Ds[st * Q_STEP + threadIdx.x] = r < Lq ? dg[r] : 0.f;
    }
  };

  load_tile<KV_ROWS, D, NTHREADS>(Ks, k + (size_t)bh * Lk * D, k0, Lk, D);
  load_tile<KV_ROWS, D, NTHREADS>(Vs, v + (size_t)bh * Lk * D, k0, Lk, D);
  if (n_steps > 0) load_step(0, 0);
  cp_async_commit();

  float dk_acc[D / 8][4], dv_acc[D / 8][4];
#pragma unroll
  for (int i = 0; i < D / 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[i][e] = dv_acc[i][e] = 0.f;

  for (int j = 0; j < n_steps; ++j) {
    const int st = j & 1;
    if (j + 1 < n_steps) load_step(j + 1, st ^ 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();

    const int q0 = q_begin + j * Q_STEP;
    const bf16* Qt = Qs + st * Q_STEP * RS;
    const bf16* dOt = dOs + st * Q_STEP * RS;
    const float* Lt = Ls + st * Q_STEP;
    const float* Dt = Ds + st * Q_STEP;

    // S^T = K Q^T: this warp's 16 keys x Q_STEP queries.
    float s[Q_STEP / 8][4];
#pragma unroll
    for (int i = 0; i < Q_STEP / 8; ++i) s[i][0] = s[i][1] = s[i][2] = s[i][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t a0, a1, a2, a3;
      ldmatrix_x4(a0, a1, a2, a3,
                  smem_u32(Ks + (warp * 16 + (lane & 15)) * RS + kk * 16 + (lane >> 4) * 8));
#pragma unroll
      for (int nn = 0; nn < Q_STEP / 16; ++nn) {
        uint32_t b0, b1, b2, b3;
        ldmatrix_x4(b0, b1, b2, b3,
                    smem_u32(Qt + (nn * 16 + (lane & 7) + (mat >> 1) * 8) * RS + kk * 16 +
                             (mat & 1) * 8));
        mma_bf16(s[2 * nn], a0, a1, a2, a3, b0, b1);
        mma_bf16(s[2 * nn + 1], a0, a1, a2, a3, b2, b3);
      }
    }

    // P^T from the LSE; masked entries (query rows past Lq, later-frame
    // keys) are exactly 0.
    bool need_mask = q0 + Q_STEP > Lq;
    if (CAUSAL) need_mask = need_mask || (k0 + KV_ROWS - 1) / causal_block > q0 / causal_block;
#pragma unroll
    for (int nt = 0; nt < Q_STEP / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = nt * 8 + 2 * t + (e & 1);
        float p = fast_exp2(s[nt][e] * c - Lt[col]);
        if (need_mask) {
          const int qrow = q0 + col;
          bool ok = qrow < Lq;
          if (CAUSAL) ok = ok && (e < 2 ? key_a : key_b) / causal_block <= qrow / causal_block;
          p = ok ? p : 0.f;
        }
        s[nt][e] = p;
      }
    }

    // dV += P^T dO, P^T rounded to bf16 as A fragments.
#pragma unroll
    for (int kk = 0; kk < Q_STEP / 16; ++kk) {
      const uint32_t p0 = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      const uint32_t p1 = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
      const uint32_t p2 = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      const uint32_t p3 = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
      for (int dd = 0; dd < D / 16; ++dd) {
        uint32_t b0, b1, b2, b3;
        ldmatrix_x4_trans(b0, b1, b2, b3,
                          smem_u32(dOt + (kk * 16 + (lane & 7) + (mat & 1) * 8) * RS + dd * 16 +
                                   (mat >> 1) * 8));
        mma_bf16(dv_acc[2 * dd], p0, p1, p2, p3, b0, b1);
        mma_bf16(dv_acc[2 * dd + 1], p0, p1, p2, p3, b2, b3);
      }
    }

    // dP^T = V dO^T.
    float dp[Q_STEP / 8][4];
#pragma unroll
    for (int i = 0; i < Q_STEP / 8; ++i) dp[i][0] = dp[i][1] = dp[i][2] = dp[i][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t a0, a1, a2, a3;
      ldmatrix_x4(a0, a1, a2, a3,
                  smem_u32(Vs + (warp * 16 + (lane & 15)) * RS + kk * 16 + (lane >> 4) * 8));
#pragma unroll
      for (int nn = 0; nn < Q_STEP / 16; ++nn) {
        uint32_t b0, b1, b2, b3;
        ldmatrix_x4(b0, b1, b2, b3,
                    smem_u32(dOt + (nn * 16 + (lane & 7) + (mat >> 1) * 8) * RS + kk * 16 +
                             (mat & 1) * 8));
        mma_bf16(dp[2 * nn], a0, a1, a2, a3, b0, b1);
        mma_bf16(dp[2 * nn + 1], a0, a1, a2, a3, b2, b3);
      }
    }

    // dS^T = P^T (dP^T - delta), then dK += dS^T Q with dS^T rounded to bf16.
#pragma unroll
    for (int nt = 0; nt < Q_STEP / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] *= dp[nt][e] - Dt[nt * 8 + 2 * t + (e & 1)];
#pragma unroll
    for (int kk = 0; kk < Q_STEP / 16; ++kk) {
      const uint32_t p0 = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      const uint32_t p1 = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
      const uint32_t p2 = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      const uint32_t p3 = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
      for (int dd = 0; dd < D / 16; ++dd) {
        uint32_t b0, b1, b2, b3;
        ldmatrix_x4_trans(b0, b1, b2, b3,
                          smem_u32(Qt + (kk * 16 + (lane & 7) + (mat & 1) * 8) * RS + dd * 16 +
                                   (mat >> 1) * 8));
        mma_bf16(dk_acc[2 * dd], p0, p1, p2, p3, b0, b1);
        mma_bf16(dk_acc[2 * dd + 1], p0, p1, p2, p3, b2, b3);
      }
    }
    __syncthreads();  // the next iteration's prefetch overwrites this stage
  }
  cp_async_wait<0>();

  bf16* dkg = dk + (size_t)bh * Lk * D;
  bf16* dvg = dv + (size_t)bh * Lk * D;
#pragma unroll
  for (int i = 0; i < D / 8; ++i) {
    const int col = i * 8 + 2 * t;
    if (key_a < Lk) {
      *reinterpret_cast<__nv_bfloat162*>(dkg + (size_t)key_a * D + col) =
          __floats2bfloat162_rn(dk_acc[i][0] * sm_scale, dk_acc[i][1] * sm_scale);
      *reinterpret_cast<__nv_bfloat162*>(dvg + (size_t)key_a * D + col) =
          __floats2bfloat162_rn(dv_acc[i][0], dv_acc[i][1]);
    }
    if (key_b < Lk) {
      *reinterpret_cast<__nv_bfloat162*>(dkg + (size_t)key_b * D + col) =
          __floats2bfloat162_rn(dk_acc[i][2] * sm_scale, dk_acc[i][3] * sm_scale);
      *reinterpret_cast<__nv_bfloat162*>(dvg + (size_t)key_b * D + col) =
          __floats2bfloat162_rn(dv_acc[i][2], dv_acc[i][3]);
    }
  }
}

template <bool CAUSAL>
__global__ void __launch_bounds__(NTHREADS)
    flash_bwd_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                        const bf16* __restrict__ v, const bf16* __restrict__ dout,
                        const float* __restrict__ lse, const float* __restrict__ delta,
                        bf16* __restrict__ dq, int Lq, int Lk, float sm_scale, float c,
                        int causal_block) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);  // Q_ROWS x RS
  bf16* dOs = Qs + Q_ROWS * RS;                  // Q_ROWS x RS
  bf16* Ks = dOs + Q_ROWS * RS;                  // 2 stages x KV_STEP x RS
  bf16* Vs = Ks + 2 * KV_STEP * RS;              // 2 stages x KV_STEP x RS

  const int q0 = blockIdx.x * Q_ROWS;
  const int bh = blockIdx.y;
  const bf16* kg = k + (size_t)bh * Lk * D;
  const bf16* vg = v + (size_t)bh * Lk * D;

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int mat = lane >> 3;
  const int row_a = q0 + warp * 16 + g;
  const int row_b = row_a + 8;
  const float l_a = row_a < Lq ? lse_log2_safe(lse[(size_t)bh * Lq + row_a]) : 0.f;
  const float l_b = row_b < Lq ? lse_log2_safe(lse[(size_t)bh * Lq + row_b]) : 0.f;
  const float d_a = row_a < Lq ? delta[(size_t)bh * Lq + row_a] : 0.f;
  const float d_b = row_b < Lq ? delta[(size_t)bh * Lq + row_b] : 0.f;

  // Key tiles wholly past the causal frontier of this block are skipped.
  int kv_end = Lk;
  if (CAUSAL) {
    const int last_row = min(q0 + Q_ROWS, Lq) - 1;
    kv_end = min(Lk, (last_row / causal_block + 1) * causal_block);
  }
  const int n_tiles = (kv_end + KV_STEP - 1) / KV_STEP;

  load_tile<Q_ROWS, D, NTHREADS>(Qs, q + (size_t)bh * Lq * D, q0, Lq, D);
  load_tile<Q_ROWS, D, NTHREADS>(dOs, dout + (size_t)bh * Lq * D, q0, Lq, D);
  load_tile<KV_STEP, D, NTHREADS>(Ks, kg, 0, Lk, D);
  load_tile<KV_STEP, D, NTHREADS>(Vs, vg, 0, Lk, D);
  cp_async_commit();

  float acc[D / 8][4];
#pragma unroll
  for (int i = 0; i < D / 8; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;

  for (int j = 0; j < n_tiles; ++j) {
    const int st = j & 1;
    if (j + 1 < n_tiles) {
      load_tile<KV_STEP, D, NTHREADS>(Ks + (st ^ 1) * KV_STEP * RS, kg, (j + 1) * KV_STEP, Lk, D);
      load_tile<KV_STEP, D, NTHREADS>(Vs + (st ^ 1) * KV_STEP * RS, vg, (j + 1) * KV_STEP, Lk, D);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();

    const bf16* Kt = Ks + st * KV_STEP * RS;
    const bf16* Vt = Vs + st * KV_STEP * RS;

    // S = Q K^T and dP = dO V^T: this warp's 16 rows x KV_STEP keys.
    float s[KV_STEP / 8][4], dp[KV_STEP / 8][4];
#pragma unroll
    for (int i = 0; i < KV_STEP / 8; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[i][e] = dp[i][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t a0, a1, a2, a3, o0, o1, o2, o3;
      ldmatrix_x4(a0, a1, a2, a3,
                  smem_u32(Qs + (warp * 16 + (lane & 15)) * RS + kk * 16 + (lane >> 4) * 8));
      ldmatrix_x4(o0, o1, o2, o3,
                  smem_u32(dOs + (warp * 16 + (lane & 15)) * RS + kk * 16 + (lane >> 4) * 8));
#pragma unroll
      for (int nn = 0; nn < KV_STEP / 16; ++nn) {
        const int off = (nn * 16 + (lane & 7) + (mat >> 1) * 8) * RS + kk * 16 + (mat & 1) * 8;
        uint32_t b0, b1, b2, b3;
        ldmatrix_x4(b0, b1, b2, b3, smem_u32(Kt + off));
        mma_bf16(s[2 * nn], a0, a1, a2, a3, b0, b1);
        mma_bf16(s[2 * nn + 1], a0, a1, a2, a3, b2, b3);
        ldmatrix_x4(b0, b1, b2, b3, smem_u32(Vt + off));
        mma_bf16(dp[2 * nn], o0, o1, o2, o3, b0, b1);
        mma_bf16(dp[2 * nn + 1], o0, o1, o2, o3, b2, b3);
      }
    }

    // dS = P (dP - delta), P from the LSE; masked keys (tail, later frames)
    // give P = 0 exactly.
    const int n0 = j * KV_STEP;
    bool need_mask = n0 + KV_STEP > Lk;
    if (CAUSAL) need_mask = need_mask || (n0 + KV_STEP - 1) / causal_block > q0 / causal_block;
#pragma unroll
    for (int nt = 0; nt < KV_STEP / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool lo = e < 2;
        float p = fast_exp2(s[nt][e] * c - (lo ? l_a : l_b));
        if (need_mask) {
          const int col = n0 + nt * 8 + 2 * t + (e & 1);
          bool ok = col < Lk;
          if (CAUSAL) ok = ok && col / causal_block <= (lo ? row_a : row_b) / causal_block;
          p = ok ? p : 0.f;
        }
        s[nt][e] = p * (dp[nt][e] - (lo ? d_a : d_b));
      }
    }

    // dQ += dS K, dS rounded to bf16 as A fragments.
#pragma unroll
    for (int kk = 0; kk < KV_STEP / 16; ++kk) {
      const uint32_t p0 = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      const uint32_t p1 = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
      const uint32_t p2 = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      const uint32_t p3 = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
      for (int dd = 0; dd < D / 16; ++dd) {
        uint32_t b0, b1, b2, b3;
        ldmatrix_x4_trans(b0, b1, b2, b3,
                          smem_u32(Kt + (kk * 16 + (lane & 7) + (mat & 1) * 8) * RS + dd * 16 +
                                   (mat >> 1) * 8));
        mma_bf16(acc[2 * dd], p0, p1, p2, p3, b0, b1);
        mma_bf16(acc[2 * dd + 1], p0, p1, p2, p3, b2, b3);
      }
    }
    __syncthreads();  // the next iteration's prefetch overwrites this stage
  }
  cp_async_wait<0>();

  bf16* dqg = dq + (size_t)bh * Lq * D;
#pragma unroll
  for (int i = 0; i < D / 8; ++i) {
    const int col = i * 8 + 2 * t;
    if (row_a < Lq)
      *reinterpret_cast<__nv_bfloat162*>(dqg + (size_t)row_a * D + col) =
          __floats2bfloat162_rn(acc[i][0] * sm_scale, acc[i][1] * sm_scale);
    if (row_b < Lq)
      *reinterpret_cast<__nv_bfloat162*>(dqg + (size_t)row_b * D + col) =
          __floats2bfloat162_rn(acc[i][2] * sm_scale, acc[i][3] * sm_scale);
  }
}

constexpr int DKV_SMEM = (2 * KV_ROWS * RS + 4 * Q_STEP * RS) * 2 + 4 * Q_STEP * 4;
constexpr int DQ_SMEM = (2 * Q_ROWS * RS + 4 * KV_STEP * RS) * 2;

template <bool CAUSAL>
cudaError_t launch_dkv(const void* q, const void* k, const void* v, const void* dout,
                       const void* lse, const void* delta, void* dk, void* dv, int BH, int Lq,
                       int Lk, float sm_scale, int causal_block, cudaStream_t stream) {
  auto kern = flash_bwd_dkv_kernel<CAUSAL>;
  static unsigned smem_raised = 0;
  cudaError_t err = raise_smem_limit(kern, DKV_SMEM, smem_raised);
  if (err != cudaSuccess) return err;
  dim3 grid((Lk + KV_ROWS - 1) / KV_ROWS, BH);
  kern<<<grid, NTHREADS, DKV_SMEM, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const bf16*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<bf16*>(dk), static_cast<bf16*>(dv), Lq, Lk,
      sm_scale, sm_scale * LOG2E, causal_block);
  return cudaGetLastError();
}

template <bool CAUSAL>
cudaError_t launch_dq(const void* q, const void* k, const void* v, const void* dout,
                      const void* lse, const void* delta, void* dq, int BH, int Lq, int Lk,
                      float sm_scale, int causal_block, cudaStream_t stream) {
  auto kern = flash_bwd_dq_kernel<CAUSAL>;
  static unsigned smem_raised = 0;
  cudaError_t err = raise_smem_limit(kern, DQ_SMEM, smem_raised);
  if (err != cudaSuccess) return err;
  dim3 grid((Lq + Q_ROWS - 1) / Q_ROWS, BH);
  kern<<<grid, NTHREADS, DQ_SMEM, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const bf16*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<bf16*>(dq), Lq, Lk, sm_scale,
      sm_scale * LOG2E, causal_block);
  return cudaGetLastError();
}

}  // namespace

// q, k, v, dout: (B, H, L, D) bf16 contiguous; lse (natural log, from the
// forward) and delta = rowsum(dout * out): (B, H, Lq) fp32. dk, dv (dkv) and
// dq (dq) are written in the same layout as k, v and q. causal_block <= 0
// means bidirectional. Only D = 128 is instantiated. Each returns the
// cudaError_t of its launch (0 on success).
extern "C" int flash_attention_bwd_dkv(const void* q, const void* k, const void* v,
                                       const void* dout, const void* lse, const void* delta,
                                       void* dk, void* dv, int B, int H, int Lq, int Lk, int d,
                                       float sm_scale, int causal_block, void* stream) {
  if (d != D) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return causal_block > 0 ? launch_dkv<true>(q, k, v, dout, lse, delta, dk, dv, B * H, Lq, Lk,
                                             sm_scale, causal_block, s)
                          : launch_dkv<false>(q, k, v, dout, lse, delta, dk, dv, B * H, Lq, Lk,
                                              sm_scale, causal_block, s);
}

extern "C" int flash_attention_bwd_dq(const void* q, const void* k, const void* v,
                                      const void* dout, const void* lse, const void* delta,
                                      void* dq, int B, int H, int Lq, int Lk, int d,
                                      float sm_scale, int causal_block, void* stream) {
  if (d != D) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return causal_block > 0 ? launch_dq<true>(q, k, v, dout, lse, delta, dq, B * H, Lq, Lk,
                                            sm_scale, causal_block, s)
                          : launch_dq<false>(q, k, v, dout, lse, delta, dq, B * H, Lq, Lk,
                                             sm_scale, causal_block, s);
}

extern "C" const char* flash_attention_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
