// Flash-attention forward at head dim 128 for Hopper (sm_90a): one
// warp-specialised kernel (wgmma + TMA).
//
// Replaces at D = 128 the two Pallas TPU forward kernels of
// opensora_tpu/ops/flash_attention.py and the dispatch between them:
//   - _fwd_kernel           (:179, running-max online softmax, optional
//                            frame-causal ``causal_block`` mask)
//   - _fwd_kernel_anchored  (:247, softmax anchored at the per-(b, h)
//                            Cauchy-Schwarz bound A instead of a running max)
//   - _flash_forward        (:320-422, a lax.cond on max(A) < 40)
// Here every CTA reads its (b, h)'s A from the device tensor that
// ops/flash_attention.py anchor_log2 makes and takes the anchored loop,
// p = exp2(s c - A) with no max and no rescale, when A < 40 (NaN compares
// false and takes the running-max loop): uniform per CTA, no host sync. The
// causal instantiation always runs the running-max loop. D = 512 (the VAE
// mid-block) stays on csrc/flash_attention_fwd.cu.
//
// What it computes, per (b, h): out = softmax(Q K^T * sm_scale) V (bf16) and
// the natural-log LSE per row (fp32), in the exp2 domain with c = sm_scale *
// log2(e), fp32 sums. Keys >= Lk (on the last key tile only) and keys of
// later frames get -inf before the exponent. Rows past Lq and keys past Lk
// are zero-filled by the TMA through 3-D tensor maps (D, L, B*H), so no
// garbage, and never the next head, reaches a product. A row that has seen
// only masked keys keeps m = -1e30, anchors its exponent at 0 (m_safe) and
// divides by 1 (l_safe), as csrc/flash_attention_fwd.cu does. P is rounded
// to bf16 before the PV product, as the TPU kernel does; the row sum l adds
// the fp32 p.
//
// Design. One CTA owns 128 query rows of one (b, h) (grid ceil(Lq / 128) x
// B*H) and walks that (b, h)'s keys in tiles of 128. Three warpgroups:
//   - the producer (setmaxnreg down to 24): one thread loads the CTA's Q
//     tile once and keeps K and V tiles in flight by TMA (128-byte swizzle)
//     through a ring of 2 stages, with full (K and V apart) and empty
//     mbarriers;
//   - two consumers (setmaxnreg up to 240), each owning 64 of the 128 rows.
//     Per key tile each runs
//       S = Q_wg K^T    m64n128k16 x 8, both operands K-major from shared memory
//       the softmax     on the accumulator registers (anchored or running max)
//       O += P V        m64n128k16 x 8, P from registers (the S registers
//                       rounded to bf16 in place), V MN-major from the same
//                       swizzled tile
//     O (64 fp32 a thread) and S (64) live in registers: the L x L scores
//     never touch memory.
// The softmax overlaps the other consumer's products by ping-pong: the two
// consumers take turns issuing S = Q K^T (two named barriers), so while one
// runs its exp2 and rescale, the other's wgmma runs on the tensor cores.
// The epilogue rounds O / l to bf16, stages it (swizzled, conflict-free) in
// the consumer's own rows of the Q tile and writes it with 16-byte stores;
// one thread of each quad writes the LSE.
// Shared memory: Q 32 KB, K and V 2 stages x 32 KB each, 7 barriers: 161 KB,
// one CTA per SM.
//
// What bounds it, at the MMDiT shape (B=3, H=24, L=8828, D=128): the two
// products of 2 * B * H * L^2 * D = 1.436 TFLOP each, 2.87 TFLOP, 2.905 ms
// at 989 TFLOP/s, on 0.65 GB of q, k, v, out: ~4400 flops a byte, so
// operations bound it. What the design does about the kernel it replaces
// at D = 128 (csrc/flash_attention_fwd.cu: 64 rows a block, 4 warps,
// mma.sync m16n8k16 fed by ldmatrix, cp.async and two __syncthreads a
// tile): wgmma is the only path to the
// card's tensor-core rate; a 64-row warpgroup product reads each K and V
// tile from shared memory once instead of once per warp; 128-row CTAs halve
// the K/V traffic from L2; TMA with mbarriers and a producer warpgroup
// replace cp.async and the block-wide barriers; the ping-pong hides the
// softmax.
//
// The main loop (fwd_mainloop) is a device template over the global query
// and key offsets of the causal mask (the positions of local row 0 and key
// 0) and over the epilogue: StoreOut here; a ring hop would load and store
// its fp32 (m, l, acc) state instead.
//
// Layout: q, k, v, out are (B, H, L, 128) contiguous bf16, 16-byte aligned;
// lse (B, H, Lq) fp32; anchor (B, H) fp32 log2-domain bounds.

#include <math_constants.h>

#include "flash_common.cuh"
#include "hopper_common.cuh"

namespace {

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

// out = acc / l as bf16 and lse = m ln 2 + ln l for one consumer's 64 rows.
struct StoreOut {
  bf16* o;
  float* lse;
  int Lq;
  // acc[4 j + 2 i + e] is row row0 + 16 w + g + 8 i (w = tid / 32), column
  // 8 j + 2 q + e; m (log2 domain) and l (whole-row sums) of rows i = 0, 1.
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
template <bool CAUSAL, class Epilogue>
__device__ __forceinline__ void fwd_mainloop(const CUtensorMap* tq, const CUtensorMap* tk, const CUtensorMap* tv,
                                             const FwdParams& p, int m0, int bh, const Epilogue& epilogue) {
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
#pragma unroll
  for (int i = 0; i < 64; ++i) o[i] = 0.f;
  float m[2] = {NEG_INF, NEG_INF};  // running max (log2 domain) of rows i = 0, 1
  float l[2] = {0.f, 0.f};          // this thread's share of their sums

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

template <bool CAUSAL>
__global__ void __launch_bounds__(NTHREADS, 1)
    flash_fwd_sm90_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                          const __grid_constant__ CUtensorMap tv, const FwdParams p, const StoreOut epilogue) {
  fwd_mainloop<CAUSAL>(&tq, &tk, &tv, p, blockIdx.x * BLOCK_M, blockIdx.y, epilogue);
}

}  // namespace

// q, k, v, o: (B, H, L, 128) bf16 contiguous, 16-byte aligned; lse: (B, H,
// Lq) fp32; anchor: (B, H) fp32 log2-domain bound, read only when
// causal_block <= 0. sm_scale_log2 = sm_scale * log2(e); causal_block <= 0
// means bidirectional. Returns the cudaError_t of the launch (0 on success).
extern "C" int flash_attention_fwd_sm90(const void* q, const void* k, const void* v, void* o, void* lse,
                                        const void* anchor, int B, int H, int Lq, int Lk, int d, float sm_scale_log2,
                                        int causal_block, void* stream) {
  if (d != D || Lq <= 0 || Lk <= 0) return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap maps[3];
  const void* ptrs[3] = {q, k, v};
  cudaError_t err = cudaSuccess;
  for (int m = 0; m < 3 && err == cudaSuccess; ++m)
    err = encode_heads_bf16_sw128(&maps[m], ptrs[m], D, m == 0 ? Lq : Lk, B * H, m == 0 ? BLOCK_M : BLOCK_N);
  if (err != cudaSuccess) return static_cast<int>(err);
  const bool causal = causal_block > 0;
  FwdParams p{causal ? nullptr : static_cast<const float*>(anchor), Lq, Lk, sm_scale_log2, causal_block, 0, 0};
  StoreOut epi{static_cast<bf16*>(o), static_cast<float*>(lse), Lq};
  auto kern = causal ? flash_fwd_sm90_kernel<true> : flash_fwd_sm90_kernel<false>;
  static unsigned smem_raised[2] = {0, 0};
  err = flash::raise_smem_limit(kern, SMEM_BYTES, smem_raised[causal]);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((Lq + BLOCK_M - 1) / BLOCK_M, B * H);
  kern<<<grid, NTHREADS, SMEM_BYTES, static_cast<cudaStream_t>(stream)>>>(maps[0], maps[1], maps[2], p, epi);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* flash_attention_fwd_sm90_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
