// Flash-attention forward at head dim 512 (the HunyuanVAE mid-block: one
// head, frame-causal with causal_block = H * W, or bidirectional) for Hopper
// (sm_90a): one warp-specialised kernel (wgmma + TMA). Head dim 128 (the
// MMDiT) runs csrc/flash_attention_fwd_sm90.cu.
//
// Replaces at D = 512 the two Pallas TPU forward kernels of
// opensora_tpu/ops/flash_attention.py and the choice between them:
//   - _fwd_kernel           (:179, running-max online softmax, optional
//                            frame-causal ``causal_block`` mask)
//   - _fwd_kernel_anchored  (:247, softmax anchored at the per-(b, h)
//                            Cauchy-Schwarz bound A instead of a running max)
//   - _flash_forward        (:320-422, a lax.cond on max(A) < 40)
// Each CTA reads its (b, h)'s A from the device tensor that
// ops/flash_attention.py anchor_log2 makes and takes the anchored loop, p =
// exp2(s c - A) with no max and no rescale, when A < 40 (NaN compares false
// and takes the running-max loop); the causal instantiation always runs the
// running-max loop.
//
// What it computes, per (b, h): out = softmax(Q K^T * sm_scale) V (bf16) and
// the natural-log LSE per row (fp32), in the exp2 domain with c = sm_scale *
// log2(e), fp32 sums. Keys >= Lk and keys of later frames get -inf before
// the exponent (on the tiles that hold any). Rows past Lq and keys past Lk
// are zero-filled by the TMA through 3-D tensor maps (D, L, B*H), so no
// garbage, and never the next head, reaches a product. A row that has seen
// only masked keys keeps m = -1e30, anchors its exponent at 0 (m_safe) and
// divides by 1 (l_safe). P is rounded to bf16 before the P V product, as the
// TPU kernel does; the row sum adds the fp32 p.
//
// Design. One CTA owns 64 query rows x all 512 output columns of one (b,
// h) (grid ceil(Lq / 64) x B*H; under the causal mask the CTAs of the last
// rows, which walk the most keys, start first) and walks the keys in tiles
// of 64. Three warpgroups:
//   - the producer (setmaxnreg down to 24): one thread loads Q (64 KB) once
//     and K_j, V_j by TMA into a two-slot ring, K_j in slot 0 and V_j in
//     slot 1: K_{j+1} loads while the consumers run P_j V_j, V_{j+1} while
//     they run S_{j+1} (csrc/flash_d512_sm90.cuh, stream_loop);
//   - two consumers (setmaxnreg up to 240). Consumer wg holds O[:, 256 wg
//     .. 256 wg + 255] (64 x 256 fp32, 128 registers a thread) and computes
//     S for keys 32 wg .. 32 wg + 31 of each tile, so each S = Q K^T of a
//     (query tile, key tile) is computed once, on wgmma (m64n32k16, Q and K
//     from shared memory). In the running-max loop each consumer writes its
//     rows' maxima over its 32 keys to shared memory; after a named barrier
//     both take the same row max (fmaxf of the two) and rescale their own O
//     and row-sum share by it. Each writes its half of P (bf16) to shared
//     memory; after a second named barrier both run O += P V[:, their 256
//     columns] (m64n256k16, P and V from shared memory). The row sums (each
//     consumer's share over its keys) are added across the two consumers
//     once, at the end; the anchored loop needs no other exchange.
// The epilogue stages each consumer's O / l (bf16) in its own 4 boxes of
// the V slot and writes it with 16-byte stores; consumer 0 writes the LSE.
// Shared memory: Q 64 KB, K and V slots 64 KB each, P 2 x 8 KB, the row
// statistics 1 KB: 209 KB, one CTA per SM. The ring has two slots because
// two slots of 64-key K and V tiles (128 KB each) beside Q would need 320 KB.
//
// What bounds it: operations, 4 * 512 flops a visible (query, key) pair.
// At the 256px decode tile 24 x 32 ((1, 1, 25344, 512), frames of 768) that
// is 0.678 TFLOP, 0.685 ms at 989 TFLOP/s, against 52 MB of q, k, v, out
// (16 us at 3.35 TB/s). What the design does about the kernel it replaces
// (the former csrc/flash_attention_fwd.cu, mma.sync): (1) the output's D
// is no longer split over 4 blocks that each recomputed S over all 512 columns (2.5x the
// function's work): one CTA holds all 512 columns over two warpgroups and S
// is computed once; (2) wgmma from shared memory in place of mma.sync fed by
// ldmatrix; (3) a producer warpgroup keeps the TMA loads in flight while the
// consumers compute, in place of cp.async issued by the same warps; (4) 64-key
// tiles in place of 32. Each CTA reads K and V once per 64 query rows, 64
// flops a byte of K and V: the L2-to-SM traffic, not the tensor cores, may
// bound it.
//
// Layout: q, k, v, out are (B, H, L, 512) contiguous bf16, 16-byte aligned;
// lse (B, H, Lq) fp32; anchor (B, H) fp32 log2-domain bounds.

#include <math_constants.h>

#include "flash_d512_sm90.cuh"

namespace {

using namespace fd512;
using flash::fast_exp2;
using flash::LN2;
using flash::NEG_INF;

constexpr float ANCHOR_MAX_LOG2 = 40.0f;

// shared memory, bytes from a 1 KB aligned base
constexpr int OFF_Q = 0;
constexpr int OFF_K = OFF_Q + TILE;  // slot 0
constexpr int OFF_V = OFF_K + TILE;  // slot 1
constexpr int OFF_P = OFF_V + TILE;  // two 64 x 64 bf16 buffers
constexpr int OFF_RED = OFF_P + 2 * BOX;  // row statistics: [2 buffers][CONSUMERS][64] fp32
constexpr int OFF_BAR = OFF_RED + 2 * CONSUMERS * BLOCK * 4;
constexpr int N_BARS = 5;  // q_full, full[2], empty[2]
constexpr int SMEM_BYTES = OFF_BAR + 8 * N_BARS + 1024;  // + the base's alignment
static_assert(SMEM_BYTES <= SMEM_LIMIT, "shared memory");

constexpr int BAR_MAX = BAR_FREE;  // both consumers wrote their row maxima
constexpr int BAR_SUM = BAR_FREE + 1;  // both consumers wrote their row sums

struct Params {
  bf16* o;
  float* lse;
  const float* anchor;  // (B * H) log2-domain bounds; nullptr: causal
  int Lq, Lk;
  float c;  // sm_scale * log2(e)
  int causal_block;
};

// S -> P of one consumer: the mask, then the anchored or the running-max
// softmax (the latter exchanging row maxima with the other consumer).
template <bool CAUSAL>
struct Softmax {
  int Lk, causal_block;
  float c;
  float* red;  // OFF_RED
  int m0, wg, tid;
  bool anchored;
  float a2;
  float m[2];  // running max (log2 domain) of rows 16 warp + g + 8 i
  float l[2];  // this thread's share of their sums

  __device__ __forceinline__ void operator()(int t, float (&s)[16], float (&acc)[128]) {
    const int warp = tid / 32, g = (tid % 32) / 4, q = tid % 4;
    const int r_lo = 16 * warp + g;
    const int n0 = t * BLOCK;
    // s[4 j + 2 i + e]: row m0 + r_lo + 8 i, key n0 + 32 wg + 8 j + 2 q + e
    bool need_mask = n0 + BLOCK > Lk;
    if (CAUSAL) need_mask = need_mask || (n0 + BLOCK - 1) / causal_block > m0 / causal_block;
    if (need_mask) {
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int key = n0 + 32 * wg + 8 * j + 2 * q + e;
            bool ok = key < Lk;
            if (CAUSAL) ok = ok && key / causal_block <= (m0 + r_lo + 8 * i) / causal_block;
            if (!ok) s[4 * j + 2 * i + e] = -CUDART_INF_F;
          }
    }
    if (anchored) {
#pragma unroll
      for (int idx = 0; idx < 16; ++idx) {
        const float pv = fast_exp2(fmaf(s[idx], c, -a2));
        l[(idx >> 1) & 1] += pv;
        s[idx] = pv;
      }
      return;
    }
    float mx[2] = {-CUDART_INF_F, -CUDART_INF_F};
#pragma unroll
    for (int idx = 0; idx < 16; ++idx) mx[(idx >> 1) & 1] = fmaxf(mx[(idx >> 1) & 1], s[idx]);
    float* red_t = red + (t & 1) * CONSUMERS * BLOCK;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      if (q == 0) red_t[wg * BLOCK + r_lo + 8 * i] = mx[i];
    }
    named_bar_sync(BAR_MAX, 128 * CONSUMERS);
    float m_safe[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      // fmaxf is exact and symmetric: both consumers take the same row max
      const float row_max = fmaxf(mx[i], red_t[(1 - wg) * BLOCK + r_lo + 8 * i]);
      const float m_new = fmaxf(m[i], row_max * c);
      // a row that has seen only masked keys anchors at 0: exp2(-inf - 0) = 0
      m_safe[i] = m_new <= NEG_INF * 0.5f ? 0.f : m_new;
      const float corr = fast_exp2(m[i] - m_safe[i]);
      m[i] = m_new;
      l[i] *= corr;
#pragma unroll
      for (int j = 0; j < 32; ++j) {
        acc[4 * j + 2 * i] *= corr;
        acc[4 * j + 2 * i + 1] *= corr;
      }
    }
#pragma unroll
    for (int idx = 0; idx < 16; ++idx) {
      const float pv = fast_exp2(fmaf(s[idx], c, -m_safe[(idx >> 1) & 1]));
      l[(idx >> 1) & 1] += pv;
      s[idx] = pv;
    }
  }
};

template <bool CAUSAL>
__global__ void __launch_bounds__(NTHREADS, 1)
    flash_fwd_d512_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                          const __grid_constant__ CUtensorMap tv, const Params p) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align_1k(smem_raw);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + OFF_BAR);
  uint64_t* q_full = bars;
  uint64_t* full = bars + 1;
  uint64_t* empty = bars + 3;

  // under the causal mask the last query rows walk the most keys: they start first
  const int m0 = (CAUSAL ? gridDim.x - 1 - blockIdx.x : blockIdx.x) * BLOCK;
  const int bh = blockIdx.y;
  int kv_end = p.Lk;
  if (CAUSAL) {
    const int last_row = min(m0 + BLOCK, p.Lq) - 1;
    kv_end = min(p.Lk, (last_row / p.causal_block + 1) * p.causal_block);
  }
  const int n_tiles = (kv_end + BLOCK - 1) / BLOCK;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < 2; ++s) {
      mbar_init(&full[s], 1);
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
      load_rows<BLOCK, BLOCK>(smem + OFF_Q, &tq, q_full, m0, bh);
      stream_producer<BLOCK>(smem + OFF_K, smem + OFF_V, &tk, &tv, full, empty, n_tiles, 0, bh);
    }
    return;
  }

  // ---------------- consumers ----------------
  reg_alloc<CONSUMER_REGS>();
  const int tid = threadIdx.x % 128;
  const int warp = tid / 32, g = (tid % 32) / 4, q = tid % 4;
  float* red = reinterpret_cast<float*>(smem + OFF_RED);
  Softmax<CAUSAL> sm{p.Lk, p.causal_block, p.c, red, m0, wg, tid, false, 0.f, {NEG_INF, NEG_INF}, {0.f, 0.f}};
  if (!CAUSAL) {
    sm.a2 = p.anchor[bh];
    sm.anchored = sm.a2 < ANCHOR_MAX_LOG2;  // NaN -> the running-max loop
  }
  float o[128];
#pragma unroll
  for (int i = 0; i < 128; ++i) o[i] = 0.f;

  if (n_tiles > 0) mbar_wait(q_full, 0);
  stream_loop(smem + OFF_Q, smem + OFF_K, smem + OFF_V, smem + OFF_P, full, empty, n_tiles, wg, tid, o, sm);

  // the row sums: the quad's shares, then the two consumers' (the buffers
  // of the row maxima are free: every read of them precedes the last BAR_P)
  float inv[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    sm.l[i] += __shfl_xor_sync(0xffffffffu, sm.l[i], 1);
    sm.l[i] += __shfl_xor_sync(0xffffffffu, sm.l[i], 2);
    if (q == 0) red[wg * BLOCK + 16 * warp + g + 8 * i] = sm.l[i];
  }
  named_bar_sync(BAR_SUM, 128 * CONSUMERS);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = 16 * warp + g + 8 * i;
    const float l = sm.l[i] + red[(1 - wg) * BLOCK + r];
    const float l_safe = l == 0.f ? 1.f : l;
    inv[i] = 1.f / l_safe;
    if (wg == 0 && q == 0 && m0 + r < p.Lq)
      p.lse[(size_t)bh * p.Lq + m0 + r] = (sm.anchored ? sm.a2 : sm.m[i]) * LN2 + logf(l_safe);
  }
  // this consumer's own boxes of the V slot: only its own P V read them
  store_rows(o, inv, smem + OFF_V + 4 * wg * BOX, p.o + (size_t)bh * p.Lq * D, m0, p.Lq, wg, tid);
}

}  // namespace

// q, k, v, o: (B, H, L, 512) bf16 contiguous, 16-byte aligned; lse: (B, H,
// Lq) fp32; anchor: (B, H) fp32 log2-domain bound, read only when
// causal_block <= 0. sm_scale_log2 = sm_scale * log2(e); causal_block <= 0
// means bidirectional. Returns the cudaError_t of the launch (0 on success).
extern "C" int flash_attention_fwd_d512(const void* q, const void* k, const void* v, void* o, void* lse,
                                        const void* anchor, int B, int H, int Lq, int Lk, int d, float sm_scale_log2,
                                        int causal_block, void* stream) {
  if (d != D || Lq <= 0 || Lk <= 0) return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap maps[3];
  const void* ptrs[3] = {q, k, v};
  for (int m = 0; m < 3; ++m) {
    cudaError_t err = encode_map(&maps[m], ptrs[m], m == 0 ? Lq : Lk, B * H, BLOCK);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const bool causal = causal_block > 0;
  Params p{static_cast<bf16*>(o), static_cast<float*>(lse), causal ? nullptr : static_cast<const float*>(anchor),
           Lq, Lk, sm_scale_log2, causal_block};
  auto kern = causal ? flash_fwd_d512_kernel<true> : flash_fwd_d512_kernel<false>;
  static unsigned smem_raised[2] = {0, 0};
  cudaError_t err = flash::raise_smem_limit(kern, SMEM_BYTES, smem_raised[causal]);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((Lq + BLOCK - 1) / BLOCK, B * H);
  kern<<<grid, NTHREADS, SMEM_BYTES, static_cast<cudaStream_t>(stream)>>>(maps[0], maps[1], maps[2], p);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* flash_attention_fwd_d512_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
