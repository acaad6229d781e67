// Flash-attention backward at head dim 512 (the HunyuanVAE mid-block: one
// head, frame-causal) for Hopper (sm_90a): two kernels, bf16 in/out, fp32
// accumulation. Head dim 128 (the MMDiT) runs the fused wgmma/TMA kernel
// of csrc/flash_attention_bwd_sm90.cu instead.
//
// Replaces the two Pallas TPU backward kernels of
// opensora_tpu/ops/flash_attention.py at D = 512:
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
//        and walks the query rows in steps of 16. Each warp works on the
//        transposed scores S^T = K Q^T, so the dK and dV sums of its 16 key
//        rows stay in its registers.
//   dq:  one block of 4 warps owns 64 query rows (16 per warp) and walks
//        the keys in steps of 16, as the forward does.
// 512-column fp32 accumulators per warp would take 4x the registers a
// thread has. As in the D = 512 forward, the gradient's D is split over
// D / 128 = 4 blocks (grid z): each block recomputes S^T (dkv) or S (dq)
// and dP over the full D from shared memory and keeps one 128-column slice
// of dK / dV (dkv) or dQ (dq) in registers. Keeping the accumulators in
// shared memory instead would take 64 x 512 x 4 B x 2 = 256 KB for dkv,
// above the 227 KB a block may have. The resident 64-row tiles take 133 KB,
// so the streamed tiles are 16 rows (query steps in dkv, key steps in dq),
// double-buffered with cp.async: 195 KB of shared memory, one block per SM.
// Frame-causal calls (causal_block) skip the query steps (dkv) and key
// tiles (dq) that the mask hides wholly.
//
// What bounds it: at the VAE mid-block's shape (1, 1, 9216, 512),
// causal_block 1024, the mask leaves 47.2 M (query, key) pairs: dkv's 4
// products take 0.20 ms and dq's 3 take 0.15 ms at 989 TFLOP/s, on 57 MB of
// inputs and outputs (17 us at 3.35 TB/s), so operations bound it. The D
// split recomputes S and dP in each of the 4 blocks: 10 products' work
// where 4 are needed in dkv, 9 where 3 are needed in dq. mma.sync from
// shared memory.
//
// Layout: q, k, v, dout, dq, dk, dv are (B, H, L, D) contiguous bf16; lse
// and delta are (B, H, Lq) fp32.

#include "flash_common.cuh"

namespace {

using namespace flash;

constexpr int NWARPS = 4;
constexpr int NTHREADS = NWARPS * 32;
constexpr int DV = 128;      // gradient columns per block (grid z splits D)

constexpr int KV_ROWS = 64;   // dkv: key rows per block
constexpr int Q_ROWS = 64;    // dq: query rows per block
constexpr int STEP_ROWS = 16; // the streamed step: dkv's query rows and dq's keys

template <int D, int Q_STEP, bool CAUSAL>
__global__ void __launch_bounds__(NTHREADS)
    flash_bwd_dkv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                         const bf16* __restrict__ v, const bf16* __restrict__ dout,
                         const float* __restrict__ lse, const float* __restrict__ delta,
                         bf16* __restrict__ dk, bf16* __restrict__ dv, int Lq, int Lk,
                         float sm_scale, float c, int causal_block) {
  static_assert(D % DV == 0 && Q_STEP % 16 == 0, "tile shape");
  constexpr int RS = D + PAD;  // smem row stride of every tile
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Ks = reinterpret_cast<bf16*>(smem_raw);  // KV_ROWS x RS
  bf16* Vs = Ks + KV_ROWS * RS;                  // KV_ROWS x RS
  bf16* Qs = Vs + KV_ROWS * RS;                  // 2 stages x Q_STEP x RS
  bf16* dOs = Qs + 2 * Q_STEP * RS;              // 2 stages x Q_STEP x RS
  float* Ls = reinterpret_cast<float*>(dOs + 2 * Q_STEP * RS);  // 2 x Q_STEP: lse_safe*log2e
  float* Ds = Ls + 2 * Q_STEP;                                  // 2 x Q_STEP: delta

  const int k0 = blockIdx.x * KV_ROWS;
  const int bh = blockIdx.y;
  const int c0 = blockIdx.z * DV;  // this block's columns of dK and dV
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

  float dk_acc[DV / 8][4], dv_acc[DV / 8][4];
#pragma unroll
  for (int i = 0; i < DV / 8; ++i)
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

    // dV += P^T dO[:, c0:c0+DV], P^T rounded to bf16 as A fragments.
#pragma unroll
    for (int kk = 0; kk < Q_STEP / 16; ++kk) {
      const uint32_t p0 = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      const uint32_t p1 = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
      const uint32_t p2 = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      const uint32_t p3 = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
      for (int dd = 0; dd < DV / 16; ++dd) {
        uint32_t b0, b1, b2, b3;
        ldmatrix_x4_trans(b0, b1, b2, b3,
                          smem_u32(dOt + (kk * 16 + (lane & 7) + (mat & 1) * 8) * RS + c0 + dd * 16 +
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

    // dS^T = P^T (dP^T - delta), then dK += dS^T Q[:, c0:c0+DV] with dS^T
    // rounded to bf16.
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
      for (int dd = 0; dd < DV / 16; ++dd) {
        uint32_t b0, b1, b2, b3;
        ldmatrix_x4_trans(b0, b1, b2, b3,
                          smem_u32(Qt + (kk * 16 + (lane & 7) + (mat & 1) * 8) * RS + c0 + dd * 16 +
                                   (mat >> 1) * 8));
        mma_bf16(dk_acc[2 * dd], p0, p1, p2, p3, b0, b1);
        mma_bf16(dk_acc[2 * dd + 1], p0, p1, p2, p3, b2, b3);
      }
    }
    __syncthreads();  // the next iteration's prefetch overwrites this stage
  }
  cp_async_wait<0>();

  bf16* dkg = dk + (size_t)bh * Lk * D + c0;
  bf16* dvg = dv + (size_t)bh * Lk * D + c0;
#pragma unroll
  for (int i = 0; i < DV / 8; ++i) {
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

template <int D, int KV_STEP, bool CAUSAL>
__global__ void __launch_bounds__(NTHREADS)
    flash_bwd_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                        const bf16* __restrict__ v, const bf16* __restrict__ dout,
                        const float* __restrict__ lse, const float* __restrict__ delta,
                        bf16* __restrict__ dq, int Lq, int Lk, float sm_scale, float c,
                        int causal_block) {
  static_assert(D % DV == 0 && KV_STEP % 16 == 0, "tile shape");
  constexpr int RS = D + PAD;  // smem row stride of every tile
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);  // Q_ROWS x RS
  bf16* dOs = Qs + Q_ROWS * RS;                  // Q_ROWS x RS
  bf16* Ks = dOs + Q_ROWS * RS;                  // 2 stages x KV_STEP x RS
  bf16* Vs = Ks + 2 * KV_STEP * RS;              // 2 stages x KV_STEP x RS

  const int q0 = blockIdx.x * Q_ROWS;
  const int bh = blockIdx.y;
  const int c0 = blockIdx.z * DV;  // this block's columns of dQ
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

  float acc[DV / 8][4];
#pragma unroll
  for (int i = 0; i < DV / 8; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;

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

    // dQ += dS K[:, c0:c0+DV], dS rounded to bf16 as A fragments.
#pragma unroll
    for (int kk = 0; kk < KV_STEP / 16; ++kk) {
      const uint32_t p0 = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      const uint32_t p1 = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
      const uint32_t p2 = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      const uint32_t p3 = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
      for (int dd = 0; dd < DV / 16; ++dd) {
        uint32_t b0, b1, b2, b3;
        ldmatrix_x4_trans(b0, b1, b2, b3,
                          smem_u32(Kt + (kk * 16 + (lane & 7) + (mat & 1) * 8) * RS + c0 + dd * 16 +
                                   (mat >> 1) * 8));
        mma_bf16(acc[2 * dd], p0, p1, p2, p3, b0, b1);
        mma_bf16(acc[2 * dd + 1], p0, p1, p2, p3, b2, b3);
      }
    }
    __syncthreads();  // the next iteration's prefetch overwrites this stage
  }
  cp_async_wait<0>();

  bf16* dqg = dq + (size_t)bh * Lq * D + c0;
#pragma unroll
  for (int i = 0; i < DV / 8; ++i) {
    const int col = i * 8 + 2 * t;
    if (row_a < Lq)
      *reinterpret_cast<__nv_bfloat162*>(dqg + (size_t)row_a * D + col) =
          __floats2bfloat162_rn(acc[i][0] * sm_scale, acc[i][1] * sm_scale);
    if (row_b < Lq)
      *reinterpret_cast<__nv_bfloat162*>(dqg + (size_t)row_b * D + col) =
          __floats2bfloat162_rn(acc[i][2] * sm_scale, acc[i][3] * sm_scale);
  }
}

// causal_block <= 0 picks the bidirectional instantiation
template <int D>
cudaError_t launch_dkv(const void* q, const void* k, const void* v, const void* dout,
                       const void* lse, const void* delta, void* dk, void* dv, int BH, int Lq,
                       int Lk, float sm_scale, int causal_block, cudaStream_t stream) {
  constexpr int Q_STEP = STEP_ROWS;
  constexpr int RS = D + PAD;
  constexpr int smem = (2 * KV_ROWS * RS + 4 * Q_STEP * RS) * 2 + 4 * Q_STEP * 4;
  const bool causal = causal_block > 0;
  auto kern = causal ? flash_bwd_dkv_kernel<D, Q_STEP, true> : flash_bwd_dkv_kernel<D, Q_STEP, false>;
  static unsigned smem_raised[2] = {0, 0};
  cudaError_t err = raise_smem_limit(kern, smem, smem_raised[causal]);
  if (err != cudaSuccess) return err;
  dim3 grid((Lk + KV_ROWS - 1) / KV_ROWS, BH, D / DV);
  kern<<<grid, NTHREADS, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const bf16*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<bf16*>(dk), static_cast<bf16*>(dv), Lq, Lk,
      sm_scale, sm_scale * LOG2E, causal_block);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dq(const void* q, const void* k, const void* v, const void* dout,
                      const void* lse, const void* delta, void* dq, int BH, int Lq, int Lk,
                      float sm_scale, int causal_block, cudaStream_t stream) {
  constexpr int KV_STEP = STEP_ROWS;
  constexpr int RS = D + PAD;
  constexpr int smem = (2 * Q_ROWS * RS + 4 * KV_STEP * RS) * 2;
  const bool causal = causal_block > 0;
  auto kern = causal ? flash_bwd_dq_kernel<D, KV_STEP, true> : flash_bwd_dq_kernel<D, KV_STEP, false>;
  static unsigned smem_raised[2] = {0, 0};
  cudaError_t err = raise_smem_limit(kern, smem, smem_raised[causal]);
  if (err != cudaSuccess) return err;
  dim3 grid((Lq + Q_ROWS - 1) / Q_ROWS, BH, D / DV);
  kern<<<grid, NTHREADS, smem, stream>>>(
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
// means bidirectional. Only D = 512 is instantiated. Each returns the
// cudaError_t of its launch (0 on success).
extern "C" int flash_attention_bwd_dkv(const void* q, const void* k, const void* v,
                                       const void* dout, const void* lse, const void* delta,
                                       void* dk, void* dv, int B, int H, int Lq, int Lk, int d,
                                       float sm_scale, int causal_block, void* stream) {
  auto launch = d == 512 ? launch_dkv<512> : nullptr;
  if (launch == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return launch(q, k, v, dout, lse, delta, dk, dv, B * H, Lq, Lk, sm_scale, causal_block,
                static_cast<cudaStream_t>(stream));
}

extern "C" int flash_attention_bwd_dq(const void* q, const void* k, const void* v,
                                      const void* dout, const void* lse, const void* delta,
                                      void* dq, int B, int H, int Lq, int Lk, int d,
                                      float sm_scale, int causal_block, void* stream) {
  auto launch = d == 512 ? launch_dq<512> : nullptr;
  if (launch == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return launch(q, k, v, dout, lse, delta, dq, B * H, Lq, Lk, sm_scale, causal_block,
                static_cast<cudaStream_t>(stream));
}

extern "C" const char* flash_attention_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
