// Pieces shared by the D = 512 flash-attention forward
// (csrc/flash_attention_fwd_d512_sm90.cu) and backward
// (csrc/flash_attention_bwd_d512_sm90.cu) for Hopper (sm_90a): the CTA
// shape, the shared-memory tile layout, the TMA tile load, the streamed
// product loop both kernels run, and the staged store of a consumer's 64 x
// 256 block.
//
// A CTA has one producer warpgroup and two consumer warpgroups; consumer wg
// owns columns 256 wg .. 256 wg + 255 of the 64 x 512 fp32 accumulator (128
// registers a thread), so no product is split over blocks. Every tile of 64
// rows x 512 columns lies in shared memory as 8 boxes of 64 columns (one
// 128-byte swizzled row each, the layout a TMA load with
// CU_TENSOR_MAP_SWIZZLE_128B writes), box b holding columns 64 b .. 64 b +
// 63 of all 64 rows (8 KB); a 32-row tile likewise, with 4 KB boxes.
//
// stream_loop: one consumer's walk over n tiles of 64 rows of X (slot 0)
// and Y (slot 1), against a resident 64 x 512 tile A. Per tile t:
//   S = A X_t[32 wg .. 32 wg + 31]^T   m64n32k16 x 32, both K-major from smem:
//                                      each consumer computes the S columns
//                                      of its 32 rows of X, so S is computed once
//   policy(t, s, acc)                  S (fp32 registers) -> P, in place
//   P (bf16) to shared memory          the consumer's 32 columns of the 64 x 64 P
//   both consumers' P written          named barrier BAR_P
//   acc += P Y_t[:, 256 wg ..]         m64n256k16 x 4, P K-major, Y MN-major
// The forward runs it with A = Q, X = K, Y = V (acc = O); the backward's
// dV pass with A = K, X = Q, Y = dO (acc = dV, S^T and P^T in place of S and
// P). P has two buffers: a consumer writes P of tile t + 1 only after both
// passed BAR_P of tile t, which each reaches after its own P V of tile t - 1.
// The producer reloads slot 0 (X_{t+1}) once both consumers' S of tile t has
// completed and slot 1 (Y_{t+1}) once their P Y_t has: X_{t+1} arrives while
// P Y_t runs, Y_{t+1} while S_{t+1} does.

#pragma once

#include "flash_common.cuh"
#include "hopper_common.cuh"

namespace fd512 {

using flash::bf16;
using flash::pack_bf16;
using namespace hopper;

constexpr int D = 512;
constexpr int BLOCK = 64;     // rows of a CTA's resident tile and of a streamed tile
constexpr int CONSUMERS = 2;  // warpgroups, 256 accumulator columns each
constexpr int COLS = D / CONSUMERS;
constexpr int NTHREADS = 128 * (CONSUMERS + 1);
constexpr int PRODUCER_REGS = 24;
constexpr int CONSUMER_REGS = 240;

constexpr int ROW = 128;                   // one 64-column bf16 row
constexpr int BOX = BLOCK * ROW;           // 64 rows x 64 columns: 8 KB
constexpr int TILE = (D / 64) * BOX;       // 64 rows x 512 columns: 64 KB
constexpr int SMEM_LIMIT = 232448;

// named barriers (0 is __syncthreads)
constexpr int BAR_P = 1;      // both consumers wrote their half of P
constexpr int BAR_STAGE = 2;  // + consumer: its output block is staged
constexpr int BAR_FREE = 4;   // first free id

__device__ __forceinline__ unsigned char* align_1k(unsigned char* p) {
  return reinterpret_cast<unsigned char*>((reinterpret_cast<uintptr_t>(p) + 1023) & ~uintptr_t(1023));
}

// ROWS rows (from row0) x 512 columns of (b, h) bh by TMA into DST, in boxes
// of BOX_ROWS rows (the tensor map's) x 64 columns; completion on BAR.
template <int ROWS, int BOX_ROWS>
__device__ __forceinline__ void load_rows(unsigned char* dst, const CUtensorMap* map, uint64_t* bar, int row0,
                                          int bh) {
  mbar_arrive_expect_tx(bar, ROWS * D * 2);
#pragma unroll
  for (int b = 0; b < D / 64; ++b)
#pragma unroll
    for (int h = 0; h < ROWS / BOX_ROWS; ++h)
      tma_load_3d(dst + b * ROWS * ROW + h * BOX_ROWS * ROW, map, bar, 64 * b, row0 + h * BOX_ROWS, bh);
}

// Consumer wg's half of P (s[4 j + 2 i + e]: row 16 warp + g + 8 i, column
// 32 wg + 8 j + 2 q + e) as bf16 into the 64 x 64 tile at P_TILE.
__device__ __forceinline__ void store_p(unsigned char* p_tile, const float (&s)[16], int wg, int tid) {
  const int warp = tid / 32, g = (tid % 32) / 4, q = tid % 4;
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int i = 0; i < 2; ++i)
      *reinterpret_cast<uint32_t*>(p_tile + (16 * warp + g + 8 * i) * ROW + (((4 * wg + j) ^ g) << 4) + 4 * q) =
          pack_bf16(s[4 * j + 2 * i], s[4 * j + 2 * i + 1]);
}

// The streamed product loop (see the top of this file). SA, SX, SY, SP:
// the resident tile, the two slots and the two P buffers; FULL / EMPTY:
// the slots' barriers. Policy: void operator()(int t, float (&s)[16],
// float (&acc)[128]) turns S into P in place (fp32) and may rescale acc.
template <class Policy>
__device__ __forceinline__ void stream_loop(unsigned char* sA, unsigned char* sX, unsigned char* sY,
                                            unsigned char* sP, uint64_t* full, uint64_t* empty, int n_tiles, int wg,
                                            int tid, float (&acc)[128], Policy& policy) {
  const uint32_t a = smem_u32(sA), x = smem_u32(sX) + 32 * wg * ROW, y = smem_u32(sY) + 4 * wg * BOX;
  for (int t = 0; t < n_tiles; ++t) {
    const uint32_t phase = t & 1;
    mbar_wait(&full[0], phase);
    float s[16];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t off = (kk / 4) * BOX + (kk % 4) * 32;
      wgmma_m64n32k16_ss<0, 0>(s, desc_sw128(a + off, 16, 1024), desc_sw128(x + off, 16, 1024), kk > 0);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);
    mbar_arrive(&empty[0]);  // X_t is read

    policy(t, s, acc);
    unsigned char* p_tile = sP + (t & 1) * BOX;
    store_p(p_tile, s, wg, tid);
    fence_proxy_async();
    named_bar_sync(BAR_P, 128 * CONSUMERS);

    mbar_wait(&full[1], phase);
    const uint32_t p = smem_u32(p_tile);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BLOCK / 16; ++kk)
      wgmma_m64n256k16_ss<0, 1>(acc, desc_sw128(p + kk * 32, 16, 1024), desc_sw128(y + kk * 16 * ROW, BOX, 1024), 1);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);
    mbar_arrive(&empty[1]);  // Y_t is read
  }
}

// The producer of stream_loop: X_t and Y_t (64-row tiles from row
// row_first + 64 t, boxes of BOX_ROWS rows) into the two slots.
template <int BOX_ROWS>
__device__ __forceinline__ void stream_producer(unsigned char* sX, unsigned char* sY, const CUtensorMap* tx,
                                                const CUtensorMap* ty, uint64_t* full, uint64_t* empty, int n_tiles,
                                                int row_first, int bh) {
  for (int it = 0; it < 2 * n_tiles; ++it) {
    const int slot = it & 1, t = it >> 1;
    if (t > 0) mbar_wait(&empty[slot], (t - 1) & 1);
    load_rows<BLOCK, BOX_ROWS>(slot ? sY : sX, slot ? ty : tx, &full[slot], row_first + BLOCK * t, bh);
  }
}

// Consumer wg's 64 x 256 block of acc (row 16 warp + g + 8 i, column 8 j + 2
// q + e in acc[4 j + 2 i + e]) times scale[i], rounded to bf16, into rows
// row0 .. row0 + 63 (those below L) and columns 256 wg .. of the (L, 512)
// matrix G: staged in the 4 boxes at STAGE (32 KB the consumer alone uses,
// 128-byte swizzle, conflict-free), then written 16 bytes a thread, a
// row's 512 bytes by 32 neighbours.
__device__ __forceinline__ void store_rows(const float (&acc)[128], const float (&scale)[2], unsigned char* stage,
                                           bf16* G, int row0, int L, int wg, int tid) {
  const int warp = tid / 32, g = (tid % 32) / 4, q = tid % 4;
#pragma unroll
  for (int j = 0; j < 32; ++j)
#pragma unroll
    for (int i = 0; i < 2; ++i)
      *reinterpret_cast<uint32_t*>(stage + (j / 8) * BOX + (16 * warp + g + 8 * i) * ROW + (((j % 8) ^ g) << 4) +
                                   4 * q) = pack_bf16(acc[4 * j + 2 * i] * scale[i], acc[4 * j + 2 * i + 1] * scale[i]);
  named_bar_sync(BAR_STAGE + wg, 128);
#pragma unroll 4
  for (int it = 0; it < 16; ++it) {
    const int idx = it * 128 + tid;
    const int r = idx / 32, c = idx % 32;
    if (row0 + r < L)
      *reinterpret_cast<uint4*>(G + (size_t)(row0 + r) * D + COLS * wg + 8 * c) =
          *reinterpret_cast<const uint4*>(stage + (c / 8) * BOX + r * ROW + (((c % 8) ^ (r % 8)) << 4));
  }
}

// A tensor map over a contiguous (B*H, L, 512) bf16 tensor: boxes of 64
// columns x ROWS rows of one head (rows past L read as zero).
inline cudaError_t encode_map(CUtensorMap* map, const void* ptr, int L, int BH, int rows) {
  return encode_heads_bf16_sw128(map, ptr, D, L, BH, rows);
}

}  // namespace fd512
