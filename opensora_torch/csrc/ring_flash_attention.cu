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
// The forward hop is the dense D = 128 forward's main loop
// (flash_fwd_sm90.cuh's fwd_mainloop: a TMA producer warpgroup, two wgmma
// consumers of 64 query rows each, 128-key tiles through 2 stages, the
// consumers' ping-pong) at the hop's global offsets, always in the
// running-max loop (the TPU's ring kernel has no anchored form), with a
// start hook that loads the rank's state (LoadState) and an epilogue that
// stores it (StoreState) or, on the last hop, writes out and the LSE (the
// dense kernel's StoreOut). A CTA that the frame-causal mask leaves no key
// tile returns at once on a middle hop; on the first hop it still writes
// the empty state, on the last out and LSE from the loaded one. It replaces
// an mma.sync hop (64-row blocks of 4 warps, each warp reading K and V from
// shared memory on its own, cp.async and two __syncthreads a tile), the
// design the dense forward left for this main loop.
//
// What bounds it: at the slice's shape (global B=3, H=24, L=8828, D=128,
// sp=4: L_q = L_k = 2207 a rank) one forward hop does 4*B*H*L_q*L_k*D =
// 0.18 TFLOP on q, k, v (7 MB each) plus the fp32 state (m, l, acc: 82 MB
// read and written): ~1000 flops per byte, above the H100's ~295, so the
// tensor cores bound it (0.18 ms at 989 TFLOP/s; the 16 (rank, hop)
// launches of a call 2.9 ms). The state traffic costs ~0.05 ms a hop at
// 3.35 TB/s and is the price of running a hop per launch; a kernel that
// walks all hops with the state in registers would need the shards of all
// ranks at once, which is what the ring avoids. The state is kept row-major
// (acc (B, H, L_q, D)): each quad of threads loads and stores 32
// contiguous bytes of a row, whole sectors. A backward hop does the dense
// backward's 5 products over L_q x L_k (7.26 ms for the 16 hops at 989
// TFLOP/s) plus the travelling fp32 dK and dV, 81 MB each, read and
// written (~0.1 ms a hop at 3.35 TB/s).
//
// Layout: q, k, v, dout: (B, H, L, D) bf16 contiguous with D = 128, 16-byte
// aligned (their TMA tensor maps); m, l, lse, delta: (B, H, L_q) fp32; acc:
// (B, H, L_q, D) fp32; dq_accum: (B, H, ceil(L_q / 64) * 64, D) fp32
// (flash_bwd_sm90.cuh's layout); dk_acc, dv_acc: (B, H, L_k, D) fp32.

#include "flash_bwd_sm90.cuh"
#include "flash_common.cuh"
#include "flash_fwd_sm90.cuh"

namespace {

using namespace flash;

constexpr int D = 128;

// The start of a forward hop: the rank's state (m, l, acc) as the previous
// hop stored it, or (-1e30, 0, 0) on the first hop and for rows past Lq.
// The whole-row sum l goes to lane q = 0 of the quad, 0 to the other three,
// as the main loop keeps its per-thread shares.
struct LoadState {
  const float* m;
  const float* l;
  const float* acc;
  int Lq, first;
  __device__ __forceinline__ void operator()(float (&o)[64], float (&mr)[2], float (&lr)[2], int bh, int row0,
                                             int tid) const {
    if (first) return ffwd::EmptyState{}(o, mr, lr, bh, row0, tid);
    const int warp = tid / 32, g = (tid % 32) / 4, q = tid % 4;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = row0 + 16 * warp + g + 8 * i;
      const bool in = row < Lq;
      const size_t sr = (size_t)bh * Lq + row;
      mr[i] = in ? m[sr] : NEG_INF;
      lr[i] = in && q == 0 ? l[sr] : 0.f;
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        float2 a = make_float2(0.f, 0.f);
        if (in) a = *reinterpret_cast<const float2*>(acc + sr * D + 8 * j + 2 * q);
        o[4 * j + 2 * i] = a.x;
        o[4 * j + 2 * i + 1] = a.y;
      }
    }
  }
};

// The epilogue of a forward hop: the state (m, l as whole-row sums, acc)
// for the next hop, or on the last hop out = acc / l and the LSE.
struct StoreState {
  float* m;
  float* l;
  float* acc;
  ffwd::StoreOut out;
  int last;
  __device__ __forceinline__ void operator()(const float (&o)[64], const float (&mr)[2], const float (&lr)[2], int bh,
                                             int row0, int wg, int tid, unsigned char* stage) const {
    if (last) return out(o, mr, lr, bh, row0, wg, tid, stage);
    const int warp = tid / 32, g = (tid % 32) / 4, q = tid % 4;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = row0 + 16 * warp + g + 8 * i;
      if (row >= out.Lq) continue;
      const size_t sr = (size_t)bh * out.Lq + row;
#pragma unroll
      for (int j = 0; j < 16; ++j)
        *reinterpret_cast<float2*>(acc + sr * D + 8 * j + 2 * q) = make_float2(o[4 * j + 2 * i], o[4 * j + 2 * i + 1]);
      if (q == 0) {
        m[sr] = mr[i];
        l[sr] = lr[i];
      }
    }
  }
};

// One hop of the forward: fwd_mainloop (flash_fwd_sm90.cuh) on the rank's
// queries against the keys of the slot it holds, at the hop's global
// offsets, from the stored state. A CTA whose causal frontier leaves it no
// key tile on a middle hop returns at once: its state stays as it is.
template <bool CAUSAL>
__global__ void __launch_bounds__(ffwd::NTHREADS, 1)
    ring_fwd_sm90_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                         const __grid_constant__ CUtensorMap tv, const ffwd::FwdParams p, const LoadState start,
                         const StoreState epilogue) {
  const int m0 = blockIdx.x * ffwd::BLOCK_M;
  if (!start.first && !epilogue.last && ffwd::kv_tiles<CAUSAL>(p, m0) == 0) return;
  ffwd::fwd_mainloop<CAUSAL>(&tq, &tk, &tv, p, m0, blockIdx.y, start, epilogue);
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

}  // namespace

// q, k, v: (B, H, L, D) bf16 contiguous, D = 128, 16-byte aligned (their
// TMA tensor maps); m, l: (B, H, Lq) fp32 and
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
  if (d != D || Lk < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (Lq == 0 || B * H == 0) return static_cast<int>(cudaSuccess);
  // With no keys (Lk = 0) no CTA has a key tile and K, V are never read:
  // q's map stands in for theirs, which cannot span 0 rows.
  CUtensorMap maps[3];
  cudaError_t err = Lk > 0 ? ffwd::encode_maps(maps, q, k, v, B * H, Lq, Lk)
                           : ffwd::encode_maps(maps, q, q, q, B * H, Lq, Lq);
  if (err != cudaSuccess) return static_cast<int>(err);
  const bool causal = causal_block > 0;
  const ffwd::FwdParams p{nullptr, Lq, Lk, c, causal_block, q_off, k_off};  // the running-max loop only
  float* mf = static_cast<float*>(m);
  float* lf = static_cast<float*>(l);
  float* af = static_cast<float*>(acc);
  const LoadState start{mf, lf, af, Lq, first};
  const StoreState epi{mf, lf, af, {static_cast<bf16*>(out), static_cast<float*>(lse), Lq}, last};
  auto kern = causal ? ring_fwd_sm90_kernel<true> : ring_fwd_sm90_kernel<false>;
  static unsigned raised[2] = {0, 0};
  err = raise_smem_limit(kern, ffwd::SMEM_BYTES, raised[causal]);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((Lq + ffwd::BLOCK_M - 1) / ffwd::BLOCK_M, B * H);
  kern<<<grid, ffwd::NTHREADS, ffwd::SMEM_BYTES, static_cast<cudaStream_t>(stream)>>>(maps[0], maps[1], maps[2], p,
                                                                                      start, epi);
  return static_cast<int>(cudaGetLastError());
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
