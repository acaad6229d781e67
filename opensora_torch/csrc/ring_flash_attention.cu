// Ring flash attention for Hopper (sm_90a): the per-hop kernels of
// sequence-parallel attention whose KV shards rotate around a ring of ranks.
// bf16 in, fp32 state and accumulators.
//
// Replaces the two Pallas TPU kernels of opensora_tpu/ops/ring_flash.py:
//   - _ring_fwd_kernel (:70)  ->  ring_flash_fwd
//   - _ring_bwd_kernel (:185) ->  ring_flash_bwd_fused
// On the TPU one (b, h) grid cell runs all sp hops and moves the KV shard to
// the right neighbour by remote DMA while it computes. Here the rotation is
// the host's (opensora_torch/parallel/comm.py: two slots per rank, a copy
// stream, "received" and "ack" events) and one launch runs ONE hop of ONE
// rank over every (b, h, tile) block, reading the KV shard in the rank's
// current slot. What a TPU cell keeps in VMEM across hops lives in device
// memory between launches:
//   forward:  the running max m (log2 domain), the row sum l and the fp32
//             output accumulator acc of the rank's queries;
//   backward: the fp32 dK/dV accumulators that travel WITH the KV shard
//             (the slot's grad buffer, added into and then sent on) and
//             the rank's fp32 dq_accum, which stays home.
// Each hop masks at GLOBAL offsets: the rank's rows start at q_off = rank *
// L_q and the shard it holds at hop h came from src = (rank - h) mod sp, so
// its columns start at k_off = src * L_k (ring_flash.py:133-134,147-153).
// Tiles the frame-causal mask hides wholly are skipped and leave the state as
// it was (the m_safe rule, :155-160); a hop that is masked entirely launches
// blocks that return at once and costs no products. The ragged last tile of
// L_q or L_k is zero-filled on load and masked, so no garbage reaches a
// product (0 * NaN = NaN); the JAX kernel instead asserts that each local
// length tiles evenly (:328).
//
// The backward hop is the dense D = 128 backward's fused kernel
// (flash_bwd_sm90.cuh's bwd_mainloop: a TMA producer warpgroup, two wgmma
// consumers of 64 keys each, the minimal backward's 5 products) at the hop's
// global offsets, with an epilogue that adds sm_scale * dK and dV into the
// slot's travelling fp32 accumulators. dQ's partials go, as in the dense
// kernel, by bulk reduce-adds into the rank's fp32 dq_accum, which the dense
// backward's epilogue kernel (flash_attention_bwd_dq_convert) scales and
// rounds once after the last hop. P is recomputed from the global LSE
// (natural log, from the forward), delta = rowsum(dO * O) is computed
// outside (ring_flash.py:373-376), and P and dS are rounded to bf16 before
// their products, as in the dense kernels.
//
// What bounds it: at the slice's shape (global B=3, H=24, L=8828, D=128,
// sp=4: L_q = L_k = 2207 a rank) one forward hop does 4*B*H*L_q*L_k*D =
// 0.18 TFLOP on q, k, v (7 MB each) plus the fp32 state (m, l, acc: 82 MB
// read and written): ~1000 flops per byte, above the H100's ~295, so the
// tensor cores bound it (0.18 ms at 989 TFLOP/s; the 16 (rank, hop)
// launches of a call 2.9 ms). The state traffic costs ~0.05 ms a hop at
// 3.35 TB/s and is the price of running a hop per launch; a kernel that
// walks all hops with the state in registers would need the shards of all
// ranks at once, which is what the ring avoids. The forward keeps both
// products on the tensor cores (mma.sync m16n8k16 from shared memory, as
// csrc/flash_attention_fwd.cu), the scores in registers, and K/V tiles
// double-buffered with cp.async; its wgmma/TMA redesign is later work. A
// backward hop does the dense backward's 5 products over L_q x L_k (7.26 ms
// for the 16 hops at 989 TFLOP/s) plus the travelling fp32 dK and dV, 81 MB
// each, read and written (~0.1 ms a hop at 3.35 TB/s).
//
// Layout: q, k, v, dout: (B, H, L, D) bf16 contiguous with D = 128; m, l,
// lse, delta: (B, H, L_q) fp32; acc: (B, H, L_q, D) fp32; dq_accum: (B, H,
// ceil(L_q / 64) * 64, D) fp32 (flash_bwd_sm90.cuh's layout); dk_acc,
// dv_acc: (B, H, L_k, D) fp32.

#include "flash_bwd_sm90.cuh"
#include "flash_common.cuh"

namespace {

using namespace flash;

constexpr int D = 128;
constexpr int RS = D + PAD;  // smem row stride of every tile
constexpr int NWARPS = 4;
constexpr int NTHREADS = NWARPS * 32;
constexpr int BM = 64;  // forward: query rows per block
constexpr int BN = 64;  // forward: keys per streamed tile

__device__ __forceinline__ int frame_end(int row, int causal_block) {
  return (row / causal_block + 1) * causal_block;
}

// One hop of the forward: fold the keys of the current slot into the
// rank's (m, l, acc); the first hop starts from (-inf, 0, 0), the last
// writes out = acc / l and lse = m ln 2 + ln l instead of the state.
template <bool CAUSAL>
__global__ void __launch_bounds__(NTHREADS)
    ring_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, float* __restrict__ m_state,
                    float* __restrict__ l_state, float* __restrict__ acc_state,
                    bf16* __restrict__ o, float* __restrict__ lse, int Lq, int Lk, float c,
                    int causal_block, int q_off, int k_off, int first, int last) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);  // BM x RS
  bf16* Ks = Qs + BM * RS;                       // 2 stages x BN x RS
  bf16* Vs = Ks + 2 * BN * RS;                   // 2 stages x BN x RS

  const int q0 = blockIdx.x * BM;
  const int bh = blockIdx.y;
  const bf16* qg = q + (size_t)bh * Lq * D;
  const bf16* kg = k + (size_t)bh * Lk * D;
  const bf16* vg = v + (size_t)bh * Lk * D;

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int mat = lane >> 3;
  const int row_a = q0 + warp * 16 + g;
  const int row_b = row_a + 8;

  // Keys of frames after this block's last (global) row are hidden.
  int kv_end = Lk;
  if (CAUSAL) {
    const int last_row = q_off + min(q0 + BM, Lq) - 1;
    kv_end = min(Lk, max(0, frame_end(last_row, causal_block) - k_off));
  }
  const int n_tiles = (kv_end + BN - 1) / BN;
  if (n_tiles == 0 && !first && !last) return;  // the state stays as it is

  if (n_tiles > 0) {
    load_tile<BM, D, NTHREADS>(Qs, qg, q0, Lq, D);
    load_tile<BN, D, NTHREADS>(Ks, kg, 0, Lk, D);
    load_tile<BN, D, NTHREADS>(Vs, vg, 0, Lk, D);
  }
  cp_async_commit();

  float acc[D / 8][4];
  float m_r[2], l_r[2];  // l_r: this thread's share of the row sums
  const int rows[2] = {row_a, row_b};
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const bool in = !first && rows[r] < Lq;
    const size_t sr = (size_t)bh * Lq + rows[r];
    m_r[r] = in ? m_state[sr] : NEG_INF;
    l_r[r] = in && t == 0 ? l_state[sr] : 0.f;
#pragma unroll
    for (int i = 0; i < D / 8; ++i) {
      float2 a = make_float2(0.f, 0.f);
      if (in) a = *reinterpret_cast<const float2*>(acc_state + sr * D + i * 8 + 2 * t);
      acc[i][2 * r] = a.x;
      acc[i][2 * r + 1] = a.y;
    }
  }

  for (int j = 0; j < n_tiles; ++j) {
    const int st = j & 1;
    if (j + 1 < n_tiles) {
      load_tile<BN, D, NTHREADS>(Ks + (st ^ 1) * BN * RS, kg, (j + 1) * BN, Lk, D);
      load_tile<BN, D, NTHREADS>(Vs + (st ^ 1) * BN * RS, vg, (j + 1) * BN, Lk, D);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();

    const bf16* Kt = Ks + st * BN * RS;
    const bf16* Vt = Vs + st * BN * RS;

    // S = Q K^T for this warp's 16 rows x BN keys.
    float s[BN / 8][4];
#pragma unroll
    for (int i = 0; i < BN / 8; ++i) s[i][0] = s[i][1] = s[i][2] = s[i][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t a0, a1, a2, a3;
      ldmatrix_x4(a0, a1, a2, a3,
                  smem_u32(Qs + (warp * 16 + (lane & 15)) * RS + kk * 16 + (lane >> 4) * 8));
#pragma unroll
      for (int nn = 0; nn < BN / 16; ++nn) {
        uint32_t b0, b1, b2, b3;
        ldmatrix_x4(b0, b1, b2, b3,
                    smem_u32(Kt + (nn * 16 + (lane & 7) + (mat >> 1) * 8) * RS + kk * 16 +
                             (mat & 1) * 8));
        mma_bf16(s[2 * nn], a0, a1, a2, a3, b0, b1);
        mma_bf16(s[2 * nn + 1], a0, a1, a2, a3, b2, b3);
      }
    }

    // Scale into the log2 domain; mask tail columns and, at global
    // offsets, columns of later frames.
    const int n0 = j * BN;
    bool need_mask = n0 + BN > Lk;
    if (CAUSAL)
      need_mask = need_mask || (k_off + n0 + BN - 1) / causal_block > (q_off + q0) / causal_block;
#pragma unroll
    for (int nt = 0; nt < BN / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[nt][e] * c;
        if (need_mask) {
          const int col = n0 + nt * 8 + 2 * t + (e & 1);
          bool ok = col < Lk;
          if (CAUSAL) ok = ok && (k_off + col) / causal_block <= (q_off + rows[e >> 1]) / causal_block;
          x = ok ? x : NEG_INF;
        }
        s[nt][e] = x;
      }
    }

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
      for (int i = 0; i < D / 8; ++i) {
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

    // acc += P V: P comes straight from the score registers as A fragments.
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
                          smem_u32(Vt + (kk * 16 + (lane & 7) + (mat & 1) * 8) * RS + dd * 16 +
                                   (mat >> 1) * 8));
        mma_bf16(acc[2 * dd], p0, p1, p2, p3, b0, b1);
        mma_bf16(acc[2 * dd + 1], p0, p1, p2, p3, b2, b3);
      }
    }
    __syncthreads();  // the next iteration's prefetch overwrites this stage
  }
  cp_async_wait<0>();

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float l = l_r[r];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    if (rows[r] >= Lq) continue;
    const size_t sr = (size_t)bh * Lq + rows[r];
    if (last) {
      const float l_safe = l == 0.f ? 1.f : l;
      const float inv = 1.f / l_safe;
      bf16* og = o + sr * D;
#pragma unroll
      for (int i = 0; i < D / 8; ++i)
        *reinterpret_cast<__nv_bfloat162*>(og + i * 8 + 2 * t) =
            __floats2bfloat162_rn(acc[i][2 * r] * inv, acc[i][2 * r + 1] * inv);
      if (t == 0) lse[sr] = m_r[r] * LN2 + logf(l_safe);
    } else {
#pragma unroll
      for (int i = 0; i < D / 8; ++i)
        *reinterpret_cast<float2*>(acc_state + sr * D + i * 8 + 2 * t) =
            make_float2(acc[i][2 * r], acc[i][2 * r + 1]);
      if (t == 0) {
        m_state[sr] = m_r[r];
        l_state[sr] = l;
      }
    }
  }
}

// One hop of the backward: bwd_mainloop (flash_bwd_sm90.cuh) on the rank's
// Q, dO, LSE and delta against the K, V of the slot it holds, at the global
// offsets of the hop. dQ's partials are reduce-added into the rank's fp32
// dq_accum (the fused kernel's layout, converted once after the last hop);
// dK and dV are added, by this epilogue, into the fp32 accumulators that
// travel with the slot. One CTA owns its 128 keys in a hop and the
// transport orders the hops of a slot, so a plain read-add-write suffices.
struct AddF32 {
  static constexpr bool kSkipEmpty = true;  // keys no query of the rank sees: nothing to add
  float* dk;
  float* dv;
  float sm_scale;
  int Lk;
  __device__ __forceinline__ void operator()(const float (&dk_acc)[64], const float (&dv_acc)[64], int bh, int key0,
                                             int g, int q) const {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int key = key0 + g + 8 * i;
      if (key >= Lk) continue;
      const size_t base = ((size_t)bh * Lk + key) * D + 2 * q;
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        float2* a = reinterpret_cast<float2*>(dk + base + 8 * j);
        float2* b = reinterpret_cast<float2*>(dv + base + 8 * j);
        float2 x = *a, y = *b;
        x.x += dk_acc[4 * j + 2 * i] * sm_scale;
        x.y += dk_acc[4 * j + 2 * i + 1] * sm_scale;
        y.x += dv_acc[4 * j + 2 * i];
        y.y += dv_acc[4 * j + 2 * i + 1];
        *a = x;
        *b = y;
      }
    }
  }
};

template <bool CAUSAL>
__global__ void __launch_bounds__(fbwd::NTHREADS, 1)
    ring_bwd_fused_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                          const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap tdo,
                          const fbwd::BwdParams p, const AddF32 epilogue) {
  fbwd::bwd_mainloop<CAUSAL>(&tq, &tk, &tv, &tdo, p, blockIdx.x * fbwd::BLOCK_N, blockIdx.y, epilogue);
}

constexpr int FWD_SMEM = (BM + 4 * BN) * RS * 2;

// Launch ``kern`` (the causal or the bidirectional instantiation) over grid
// (tiles, B * H) after raising its shared-memory limit; an empty grid
// launches nothing.
template <typename Kernel, typename... Args>
cudaError_t launch(Kernel kern, unsigned& smem_raised, int smem, int tiles, int BH,
                   cudaStream_t stream, Args... args) {
  if (tiles == 0 || BH == 0) return cudaSuccess;
  cudaError_t err = raise_smem_limit(kern, smem, smem_raised);
  if (err != cudaSuccess) return err;
  kern<<<dim3(tiles, BH), NTHREADS, smem, stream>>>(args...);
  return cudaGetLastError();
}

}  // namespace

// q, k, v: (B, H, L, D) bf16 contiguous, D = 128; m, l: (B, H, Lq) fp32 and
// acc: (B, H, Lq, D) fp32, the rank's state (read unless first, written
// unless last); out (bf16, q's layout) and lse ((B, H, Lq) fp32, natural
// log) are written on the last hop. c = sm_scale * log2(e); causal_block <=
// 0 means bidirectional; q_off / k_off are the global indices of the first
// query row and key. Each entry point returns the cudaError_t of its launch
// (0 on success).
extern "C" int ring_flash_fwd(const void* q, const void* k, const void* v, void* m, void* l,
                              void* acc, void* out, void* lse, int B, int H, int Lq, int Lk,
                              int d, float c, int causal_block, int q_off, int k_off, int first,
                              int last, void* stream) {
  if (d != D) return static_cast<int>(cudaErrorInvalidValue);
  static unsigned raised[2] = {0, 0};
  const bool causal = causal_block > 0;
  auto kern = causal ? ring_fwd_kernel<true> : ring_fwd_kernel<false>;
  return launch(kern, raised[causal], FWD_SMEM, (Lq + BM - 1) / BM, B * H,
                static_cast<cudaStream_t>(stream), static_cast<const bf16*>(q),
                static_cast<const bf16*>(k), static_cast<const bf16*>(v), static_cast<float*>(m),
                static_cast<float*>(l), static_cast<float*>(acc), static_cast<bf16*>(out),
                static_cast<float*>(lse), Lq, Lk, c, causal_block, q_off, k_off, first, last);
}

// dout: (B, H, Lq, D) bf16; lse (natural log, global) and delta =
// rowsum(dout * out): (B, H, Lq) fp32; q, k, v, dout 16-byte aligned (their
// TMA tensor maps). dk_acc, dv_acc: (B, H, Lk, D) fp32, added into (dK times
// sm_scale); dq_accum: (B, H, ceil(Lq / 64) * 64, D) fp32 in the fused
// kernel's layout, reduce-added into (unscaled).
extern "C" int ring_flash_bwd_fused(const void* q, const void* k, const void* v, const void* dout,
                                    const void* lse, const void* delta, void* dk_acc, void* dv_acc, void* dq_accum,
                                    int B, int H, int Lq, int Lk, int d, float sm_scale, int causal_block, int q_off,
                                    int k_off, void* stream) {
  if (d != D) return static_cast<int>(cudaErrorInvalidValue);
  if (Lq == 0 || Lk == 0 || B * H == 0) return static_cast<int>(cudaSuccess);
  CUtensorMap maps[4];
  cudaError_t err = fbwd::encode_maps(maps, q, k, v, dout, B * H, Lq, Lk);
  if (err != cudaSuccess) return static_cast<int>(err);
  const bool causal = causal_block > 0;
  fbwd::BwdParams p{static_cast<const float*>(lse), static_cast<const float*>(delta), static_cast<float*>(dq_accum),
                    Lq, Lk, (Lq + fbwd::BLOCK_M - 1) / fbwd::BLOCK_M, sm_scale * LOG2E, causal_block, q_off, k_off};
  AddF32 epi{static_cast<float*>(dk_acc), static_cast<float*>(dv_acc), sm_scale, Lk};
  auto kern = causal ? ring_bwd_fused_kernel<true> : ring_bwd_fused_kernel<false>;
  static unsigned raised[2] = {0, 0};
  err = raise_smem_limit(kern, fbwd::SMEM_BYTES, raised[causal]);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((Lk + fbwd::BLOCK_N - 1) / fbwd::BLOCK_N, B * H);
  kern<<<grid, fbwd::NTHREADS, fbwd::SMEM_BYTES, static_cast<cudaStream_t>(stream)>>>(maps[0], maps[1], maps[2],
                                                                                      maps[3], p, epi);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* ring_flash_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
