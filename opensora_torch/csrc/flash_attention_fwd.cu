// Flash-attention forward at head dim 512 (the VAE mid-block) for Hopper
// (sm_90a), bf16 in/out, fp32 accumulation. Head dim 128 (the MMDiT) runs
// on the warp-specialised wgmma/TMA kernel of flash_attention_fwd_sm90.cu.
//
// Replaces the two Pallas TPU forward kernels of
// opensora_tpu/ops/flash_attention.py at D = 512:
//   - _fwd_kernel           (:179, running-max online softmax, optional
//                            frame-causal ``causal_block`` mask)
//   - _fwd_kernel_anchored  (:247, softmax anchored at the per-(b, h)
//                            Cauchy-Schwarz bound A instead of a running max)
// and the host-side choice between them in _flash_forward (:320-422). On the
// TPU that choice is a ``lax.cond`` on max(A) < 40; here every block reads
// its own (b, h) anchor from a device tensor and takes the anchored loop when
// A < 40 (NaN compares false and falls to the running-max loop), so a call
// never syncs the host. The causal instantiation always runs the running-max
// loop, as on the TPU.
//
// What it computes, per (b, h): out = softmax(Q K^T * sm_scale) V and the
// natural-log LSE per row, in the exp2 domain with c = sm_scale * log2(e).
// Tail columns (>= Lk) and columns of later frames (frame-causal mask) get
// -1e30 before the exponent; fully masked rows are guarded (m_safe, l_safe).
// Rows and columns past the sequence are zero-filled on load, so no garbage
// ever reaches a product (0 * NaN = NaN).
//
// What bounds it: the VAE training mid-block (B=1, H=1, L=9216, D=512,
// frames of 1024) does 4*B*H*D times the visible (query, key) pairs, 0.097
// TFLOP, on 38 MB of q/k/v/o: ~2500 flops per byte, above the H100's ~295
// bf16 flops per byte, so it is bound by tensor-core operations.
// The design keeps both products on the tensor cores (mma.sync m16n8k16 bf16
// -> fp32), keeps the score tile and the output accumulator in registers and
// never writes the L x L scores to memory, and double-buffers the K/V tiles
// with cp.async so loads overlap the math.
//
// Layout: q, k, v, o are (B, H, L, D) contiguous; lse is (B, H, Lq) fp32;
// anchor is (B, H) fp32 log2-domain bounds (bidirectional only).
// One block of 4 warps owns 64 query rows (16 per warp) and DV = 128 output
// columns; it loops over KV tiles of BN keys. D = 512 needs a 64 x 512 fp32
// accumulator that does not fit in registers, so the output's D is split
// across D / 128 blocks (grid z); each recomputes Q K^T over the full D and
// keeps only its 128-column slice of P V.

#include "flash_common.cuh"

namespace {

using namespace flash;

constexpr int BM = 64;         // query rows per block
constexpr int NWARPS = 4;      // 16 rows per warp
constexpr int NTHREADS = NWARPS * 32;
constexpr int DV = 128;        // output columns per block
constexpr float ANCHOR_MAX_LOG2 = 40.0f;

template <int D, int BN, bool CAUSAL>
__global__ void __launch_bounds__(NTHREADS)
    flash_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, bf16* __restrict__ o, float* __restrict__ lse,
                     const float* __restrict__ anchor, int Lq, int Lk, float c, int causal_block) {
  static_assert(D % DV == 0 && BN % 16 == 0, "tile shape");
  constexpr int QS = D + PAD;   // Q/K smem row stride
  constexpr int VS = DV + PAD;  // V smem row stride
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);  // BM x QS
  bf16* Ks = Qs + BM * QS;                       // 2 stages x BN x QS
  bf16* Vs = Ks + 2 * BN * QS;                   // 2 stages x BN x VS

  const int q0 = blockIdx.x * BM;
  const int bh = blockIdx.y;
  const int dchunk = blockIdx.z;
  const bf16* qg = q + (size_t)bh * Lq * D;
  const bf16* kg = k + (size_t)bh * Lk * D;
  const bf16* vg = v + (size_t)bh * Lk * D + dchunk * DV;

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;  // accumulator row within the 8-row half
  const int t = lane & 3;   // accumulator column pair
  const int row_a = q0 + warp * 16 + g;
  const int row_b = row_a + 8;

  // KV tiles wholly above the causal frontier of this block are skipped.
  int kv_end = Lk;
  if (CAUSAL) {
    const int last_row = min(q0 + BM, Lq) - 1;
    kv_end = min(Lk, (last_row / causal_block + 1) * causal_block);
  }
  const int n_tiles = (kv_end + BN - 1) / BN;

  float a2 = 0.f;
  bool anchored = false;
  if (!CAUSAL) {
    a2 = anchor[bh];
    anchored = a2 < ANCHOR_MAX_LOG2;  // NaN -> running-max loop
  }

  load_tile<BM, D, NTHREADS>(Qs, qg, q0, Lq, D);
  load_tile<BN, D, NTHREADS>(Ks, kg, 0, Lk, D);
  load_tile<BN, DV, NTHREADS>(Vs, vg, 0, Lk, D);
  cp_async_commit();

  float acc[DV / 8][4];
#pragma unroll
  for (int i = 0; i < DV / 8; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
  float m_r[2] = {NEG_INF, NEG_INF};  // running max (log2 domain), rows g and g + 8
  float l_r[2] = {0.f, 0.f};          // this thread's share of the row sums

  const int mat = lane >> 3;  // which 8x8 matrix this lane addresses in ldmatrix.x4

  for (int j = 0; j < n_tiles; ++j) {
    const int st = j & 1;
    if (j + 1 < n_tiles) {
      load_tile<BN, D, NTHREADS>(Ks + (st ^ 1) * BN * QS, kg, (j + 1) * BN, Lk, D);
      load_tile<BN, DV, NTHREADS>(Vs + (st ^ 1) * BN * VS, vg, (j + 1) * BN, Lk, D);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();

    const bf16* Kt = Ks + st * BN * QS;
    const bf16* Vt = Vs + st * BN * VS;

    // S = Q K^T for this warp's 16 rows x BN keys.
    float s[BN / 8][4];
#pragma unroll
    for (int i = 0; i < BN / 8; ++i) s[i][0] = s[i][1] = s[i][2] = s[i][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t a0, a1, a2r, a3;
      ldmatrix_x4(a0, a1, a2r, a3,
                  smem_u32(Qs + (warp * 16 + (lane & 15)) * QS + kk * 16 + (lane >> 4) * 8));
#pragma unroll
      for (int nn = 0; nn < BN / 16; ++nn) {
        uint32_t b0, b1, b2, b3;
        ldmatrix_x4(b0, b1, b2, b3,
                    smem_u32(Kt + (nn * 16 + (lane & 7) + (mat >> 1) * 8) * QS + kk * 16 +
                             (mat & 1) * 8));
        mma_bf16(s[2 * nn], a0, a1, a2r, a3, b0, b1);
        mma_bf16(s[2 * nn + 1], a0, a1, a2r, a3, b2, b3);
      }
    }

    // Scale into the log2 domain; mask tail and later-frame columns.
    const int n0 = j * BN;
    bool need_mask = n0 + BN > Lk;
    if (CAUSAL) need_mask = need_mask || (n0 + BN - 1) / causal_block > q0 / causal_block;
#pragma unroll
    for (int nt = 0; nt < BN / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[nt][e] * c;
        if (need_mask) {
          const int col = n0 + nt * 8 + 2 * t + (e & 1);
          const int row = e < 2 ? row_a : row_b;
          bool ok = col < Lk;
          if (CAUSAL) ok = ok && col / causal_block <= row / causal_block;
          x = ok ? x : NEG_INF;
        }
        s[nt][e] = x;
      }
    }

    if (anchored) {
      // p = exp2(s*c - A): no max, no rescaling (A bounds every logit).
#pragma unroll
      for (int nt = 0; nt < BN / 8; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p = fast_exp2(s[nt][e] - a2);
          l_r[e >> 1] += p;
          s[nt][e] = p;
        }
      }
    } else {
      float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
      for (int nt = 0; nt < BN / 8; ++nt) {
        mx[0] = fmaxf(mx[0], fmaxf(s[nt][0], s[nt][1]));
        mx[1] = fmaxf(mx[1], fmaxf(s[nt][2], s[nt][3]));
      }
      float m_safe[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        const float m_new = fmaxf(m_r[r], mx[r]);
        // a row still fully masked anchors at 0 so exp2(-1e30 - 0) = 0
        m_safe[r] = m_new <= NEG_INF * 0.5f ? 0.f : m_new;
        const float corr = fast_exp2(m_r[r] - m_safe[r]);
        m_r[r] = m_new;
        l_r[r] *= corr;
#pragma unroll
        for (int i = 0; i < DV / 8; ++i) {
          acc[i][2 * r] *= corr;
          acc[i][2 * r + 1] *= corr;
        }
      }
#pragma unroll
      for (int nt = 0; nt < BN / 8; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p = fast_exp2(s[nt][e] - m_safe[e >> 1]);
          l_r[e >> 1] += p;
          s[nt][e] = p;
        }
      }
    }

    // acc += P V: P comes straight from the score registers as A fragments.
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) {
      const uint32_t p0 = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      const uint32_t p1 = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
      const uint32_t p2 = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      const uint32_t p3 = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
      for (int dd = 0; dd < DV / 16; ++dd) {
        uint32_t b0, b1, b2, b3;
        ldmatrix_x4_trans(b0, b1, b2, b3,
                          smem_u32(Vt + (kk * 16 + (lane & 7) + (mat & 1) * 8) * VS + dd * 16 +
                                   (mat >> 1) * 8));
        mma_bf16(acc[2 * dd], p0, p1, p2, p3, b0, b1);
        mma_bf16(acc[2 * dd + 1], p0, p1, p2, p3, b2, b3);
      }
    }
    __syncthreads();  // the next iteration's prefetch overwrites this stage
  }
  cp_async_wait<0>();

  float inv[2], row_lse[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float l = l_r[r];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    float l_safe;
    if (anchored) {
      l_safe = l <= 0.f ? 1.f : l;
      row_lse[r] = a2 * LN2 + logf(l_safe);
    } else {
      l_safe = l == 0.f ? 1.f : l;
      row_lse[r] = m_r[r] * LN2 + logf(l_safe);
    }
    inv[r] = 1.f / l_safe;
  }

  bf16* og = o + (size_t)bh * Lq * D + dchunk * DV;
#pragma unroll
  for (int i = 0; i < DV / 8; ++i) {
    const int col = i * 8 + 2 * t;
    if (row_a < Lq)
      *reinterpret_cast<__nv_bfloat162*>(og + (size_t)row_a * D + col) =
          __floats2bfloat162_rn(acc[i][0] * inv[0], acc[i][1] * inv[0]);
    if (row_b < Lq)
      *reinterpret_cast<__nv_bfloat162*>(og + (size_t)row_b * D + col) =
          __floats2bfloat162_rn(acc[i][2] * inv[1], acc[i][3] * inv[1]);
  }
  if (dchunk == 0 && t == 0) {
    if (row_a < Lq) lse[(size_t)bh * Lq + row_a] = row_lse[0];
    if (row_b < Lq) lse[(size_t)bh * Lq + row_b] = row_lse[1];
  }
}

template <int D, int BN, bool CAUSAL>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, void* lse,
                   const void* anchor, int B, int H, int Lq, int Lk, float c, int causal_block,
                   cudaStream_t stream) {
  constexpr int smem = (BM * (D + PAD) + 2 * BN * (D + PAD) + 2 * BN * (DV + PAD)) * 2;
  auto kern = flash_fwd_kernel<D, BN, CAUSAL>;
  static unsigned smem_raised = 0;
  cudaError_t err = raise_smem_limit(kern, smem, smem_raised);
  if (err != cudaSuccess) return err;
  dim3 grid((Lq + BM - 1) / BM, B * H, D / DV);
  kern<<<grid, NTHREADS, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(o), static_cast<float*>(lse), static_cast<const float*>(anchor), Lq, Lk,
      c, causal_block);
  return cudaGetLastError();
}

}  // namespace

// q, k, v, o: (B, H, L, D) bf16 contiguous, D = 512; lse: (B, H, Lq) fp32;
// anchor: (B, H) fp32 log2-domain bound, read only when causal_block <= 0.
// sm_scale_log2 = sm_scale * log2(e). causal_block <= 0 means bidirectional.
// Returns the cudaError_t of the launch (0 on success).
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v, void* o, void* lse,
                                   const void* anchor, int B, int H, int Lq, int Lk, int D,
                                   float sm_scale_log2, int causal_block, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool causal = causal_block > 0;
  if (D == 512) {
    return causal ? launch<512, 32, true>(q, k, v, o, lse, anchor, B, H, Lq, Lk, sm_scale_log2,
                                          causal_block, s)
                  : launch<512, 32, false>(q, k, v, o, lse, anchor, B, H, Lq, Lk, sm_scale_log2,
                                           causal_block, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* flash_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
