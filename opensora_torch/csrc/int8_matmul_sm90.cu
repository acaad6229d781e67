// The W8A8 GEMMs for Hopper (sm_90a): int8 x int8 -> int32 on wgmma ->
// rescaled bf16 (or fp32). One warp-specialised, persistent kernel (TMA +
// int8 wgmma) with two instantiations of its A operand:
//
//   int8 A (A_INT8):         out[m, n] = (sum_k x8[m, k] * w[n, k]) * s_a[m] * s_w[n]
//   bf16 A, quantized here:  x8[m, k]  = clip(round_half_even(x[m, k] * inv[m]), -127, 127)
//
// Replaces the Pallas TPU kernels of opensora_tpu/ops/int8_matmul.py:
// _w8a8_kernel (:31, called by w8a8_matmul :136; x arrives int8 with
// per-row scales s_a) and _w8a8_fq_kernel (:51, called by
// w8a8_fusedquant_matmul :83). In the fused-quant instantiation x * inv is
// rounded on its own (__fmul_rn, never fused into the next step), as the TPU
// kernel multiplies by the precomputed reciprocal. The epilogue is
// float(acc) * s_a[m] * s_w[n] in fp32, in that order, each step rounded to
// nearest, so the result equals the plain versions' (w8a8_matmul_ref,
// w8a8_fusedquant_matmul_ref: the integer sum exact in float64, the same
// fp32 epilogue) in every element: every partial sum is an integer below
// 2^31 (K * 127^2). The int32 sum never reaches device memory.
//
// Design. grid = min(SM count, output tiles) CTAs; each walks the 128 x 256
// output tiles t = blockIdx.x, + gridDim.x, ... in the grouped order of
// GROUP_M block rows (CTAs running together share A rows and weight columns
// in L2), and each tile's K in steps of 64. Three warpgroups:
//   - the producer (setmaxnreg down to 40): one thread keeps a ring of
//     STAGES stages in flight by TMA, full and empty mbarriers, across tile
//     boundaries: while the consumers scale and store one tile, the next
//     tile's first stages load. A stage holds the A tile (2-D tensor map over
//     (K, M)) and the int8 weight tile (256 x 64, a 2-D map over (K, N),
//     64-byte swizzle);
//   - two consumers (setmaxnreg up to 232), each owning 64 rows x 256
//     columns, the int32 accumulator in registers (128 a thread), issuing
//     two wgmma.m64n256k32.s32.s8.s8 a stage. Integer wgmma takes K-major
//     operands only, which is how x8 (M, K) and a torch linear weight (N, K)
//     are held.
// The A operand:
//   - int8 (w8a8_matmul): the producer loads the int8 A tile (128 x 64 B)
//     K-major in the 64-byte swizzle, the layout of the weight tile, and the
//     products read both operands through shared-memory descriptors (SS,
//     desc_sw64, the k32 slice 32 bytes into the row). The K step stays 64
//     bytes: a 128-byte step (128-byte swizzle, four products a stage) would
//     halve the barrier round trips but double a stage (48 KB), leaving 3
//     stages beside the epilogue's staging; 6 stages of 64 keep 384 K-bytes
//     in flight either way. Nothing of A passes through registers, so a
//     consumer keeps one product group in flight (wait depth 1): it commits
//     a stage's products, waits for the previous stage's, and frees that
//     stage.
//   - bf16 (w8a8_fq_matmul): the A tile is bf16 (128 x 64 x 2 B, 128-byte
//     swizzle); each consumer reads its 64 x 64 slice from shared memory,
//     quantizes it straight into the s8 A fragments of the products (A from
//     registers) and issues them, then waits for them (wait depth 0) and
//     frees the stage: ptxas serializes a wgmma whose register A is written
//     while earlier products are in flight (C7513). The rounding runs at the
//     FP32 rate, not through the conversion unit (16 a clock per SM on
//     compute capability 9.0, 128 for FP32 adds): y = __fmul_rn(x, inv),
//     clamped to +-127 in float, t = __fadd_rn(y, 1.5 * 2^23) lands on the
//     integer grid (ulp 1 in [2^23, 2^24)) rounded half to even, and the low
//     byte of t's bits is the two's-complement int8; four pack with
//     __byte_perm. That equals the clamped __float2int_rn for every finite x.
//     The shared-memory reads of the A slice are conflict-free: in one
//     8-byte load, lanes with odd g read the other K slice than lanes with
//     even g, so a half-warp touches 8 distinct 16-byte chunks; a select
//     puts the quantized words back in fragment order. Each A element is
//     quantized once per tile (84 times at linear1's N = 21504).
// The epilogue: each consumer waits for its last products, frees the last
// stage, scales its accumulators, float(acc) * s_a * s_w, stages its 64 rows
// in its own 32 KB buffer apart from the stages (512-byte rows: all 256
// columns of bf16, or 128 of fp32 in each of two passes; 16-byte chunks
// XOR-swizzled by row, conflict-free both ways) and writes them with
// 16-byte stores, masking the M and N tails (the loads are zero-filled by
// the TMA). K must be a multiple of 64; M and N any size. Shared memory:
// int8 A 6 stages x (8 + 16) KB, bf16 A 5 x (16 + 16) KB; staging 64 KB;
// barriers: 208 KB and 225 KB, one CTA per SM.
//
// What bounds it: at linear1 (M, K, N) = (26484, 3072, 21504), 2MNK = 3.50
// Tops, 1.768 ms at 1979 Tops/s, on 0.08 GB of int8 x (0.16 GB bf16) + 0.07
// GB of weight + 1.14 GB of bf16 out (0.39 ms at 3.35 TB/s): operations
// bound it. The fused-quant instantiation adds ~84 x M x K = 6.8e9
// quantized elements of ~6 instructions on the CUDA cores (~1.4 ms at the
// card's FP32 issue rate), which its products do not overlap (see
// PERF.md).
// What the design does about the kernels it replaces (w8a8_matmul:
// mma.sync m16n8k32 from ldmatrix, a 4-stage cp.async ring, 128 x 128 tiles,
// __syncthreads every K step; w8a8_fq_matmul: a one-tile-a-CTA form of
// this kernel): int8 wgmma is the path to the card's int8 rate; TMA and
// mbarriers replace cp.async and the block barriers; the SS products free
// the int8 instantiation's wait depth; persistence and the separate staging
// buffer overlap a tile's epilogue with the next tile's loads.
//
// Layout: x8 (M, K) int8 or x (M, K) bf16, and w (N, K) int8, row-major,
// 16-byte aligned; inv, s_a (M,), s_w (N,) fp32; out (M, N) row-major bf16
// or fp32.

#include "flash_common.cuh"
#include "hopper_common.cuh"

namespace {

using flash::bf16;
using namespace hopper;

constexpr int BM = 128, BN = 256, BK = 64;  // output tile; K step
constexpr int WG_ROWS = 64;                 // rows per consumer
constexpr int CONSUMERS = 2;
constexpr int NTHREADS = 128 * (CONSUMERS + 1);
constexpr int PRODUCER_REGS = 40;
constexpr int CONSUMER_REGS = 232;
constexpr int GROUP_M = 8;  // block rows walked together (L2 reuse)

// shared memory, bytes from a 1 KB aligned base
template <bool A_INT8>
struct Smem {
  static constexpr int STAGES = A_INT8 ? 6 : 5;
  static constexpr int A_ROW = A_INT8 ? BK : 2 * BK;  // 64 B (int8) or 128 B (bf16) a row of A
  static constexpr int A_STAGE = BM * A_ROW;          // 8 or 16 KB
  static constexpr int B_STAGE = BN * BK;             // 16 KB (64-byte rows)
  static constexpr int OUT_ROW = 512;                 // one staged row: 256 bf16 or 128 fp32
  static constexpr int OFF_A = 0;
  static constexpr int OFF_B = OFF_A + STAGES * A_STAGE;
  static constexpr int OFF_OUT = OFF_B + STAGES * B_STAGE;
  static constexpr int OFF_BAR = OFF_OUT + CONSUMERS * WG_ROWS * OUT_ROW;
  static constexpr int N_BARS = 2 * STAGES;  // full[STAGES], empty[STAGES]
  static constexpr int BYTES = OFF_BAR + 8 * N_BARS + 1024;  // + the base's alignment
  static_assert(BYTES <= 232448, "shared memory");
};

constexpr int BAR_STAGE = 1;  // + consumer: named barrier over its staging buffer

constexpr float ROUND_MAGIC = 12582912.f;  // 1.5 * 2^23

// (m0, n0) of output tile T: GROUP_M block rows share each weight tile.
__device__ __forceinline__ void tile_origin(int t, int grid_m, int grid_n, int& m0, int& n0) {
  const int in_group = GROUP_M * grid_n;
  const int first_m = (t / in_group) * GROUP_M;
  const int group_rows = min(grid_m - first_m, GROUP_M);
  m0 = (first_m + (t % in_group) % group_rows) * BM;
  n0 = ((t % in_group) / group_rows) * BN;
}

// Four bf16 (the 8 bytes V, lowest K first) times inv, rounded half to even
// and clamped to +-127, as four int8 in one word (the lowest K in the
// lowest byte).
__device__ __forceinline__ uint32_t quant4(uint2 v, float inv) {
  const float x[4] = {__uint_as_float(v.x << 16), __uint_as_float(v.x & 0xffff0000u), __uint_as_float(v.y << 16),
                      __uint_as_float(v.y & 0xffff0000u)};
  uint32_t t[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float y = fminf(fmaxf(__fmul_rn(x[j], inv), -127.f), 127.f);
    t[j] = __float_as_uint(__fadd_rn(y, ROUND_MAGIC));  // low byte: round_half_even(y) as int8
  }
  return __byte_perm(__byte_perm(t[0], t[1], 0x0040), __byte_perm(t[2], t[3], 0x0040), 0x5410);
}

// The s8 A fragments of both 32-wide K slices of one bf16 stage: a[4 kk + r]
// is register r of slice kk (row g + 8 (r % 2) of the warp's 16, K columns
// 32 kk + 16 (r / 2) + 4 q .. + 3). SA: this consumer's 64 rows of the
// stage's A tile (128-byte rows, 16-byte chunk c of row r at c ^ (r % 8)).
// Load (s, h, i) of a lane reads slice kk = s ^ (g % 2), so each 8-byte
// load of a half-warp covers 8 distinct chunks: no bank conflict.
__device__ __forceinline__ void a_frags(uint32_t (&a)[8], const unsigned char* sA, int warp, int g, int q,
                                        const float (&inv)[2]) {
  constexpr int A_ROW = Smem<false>::A_ROW;
  const int odd = g & 1;
  uint32_t w[2][4];  // [s][2 h + i]
#pragma unroll
  for (int s = 0; s < 2; ++s)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int kk = s ^ odd;
        const int r = 16 * warp + g + 8 * i;
        const int chunk = 4 * kk + 2 * h + (q >> 1);
        const uint2 v = *reinterpret_cast<const uint2*>(sA + r * A_ROW + ((chunk ^ g) << 4) + 8 * (q & 1));
        w[s][2 * h + i] = quant4(v, inv[i]);
      }
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    a[r] = odd ? w[1][r] : w[0][r];
    a[4 + r] = odd ? w[0][r] : w[1][r];
  }
}

// One tile's K loop of the int8 instantiation: both operands through
// descriptors, one product group in flight. IT: the ring position of the
// tile's first stage. SA: this consumer's 64 rows of stage 0's A tile.
__device__ __forceinline__ void k_loop_int8(int it, int n_k, int (&acc)[128], uint64_t* full, uint64_t* empty,
                                            uint32_t sA, uint32_t sB) {
  using L = Smem<true>;
  for (int kt = 0; kt < n_k; ++kt) {
    const int i = it + kt, st = i % L::STAGES;
    mbar_wait(&full[st], (i / L::STAGES) & 1);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 32; ++kk)
      wgmma_m64n256k32_s8_ss(acc, desc_sw64(sA + st * L::A_STAGE + 32 * kk),
                             desc_sw64(sB + st * L::B_STAGE + 32 * kk), kt > 0 || kk > 0);
    wgmma_commit();
    wgmma_wait<1>();  // the previous stage's products are done: free it
    if (kt > 0) mbar_arrive(&empty[(i - 1) % L::STAGES]);
  }
  wgmma_wait<0>();
  fence_regs(acc);
  mbar_arrive(&empty[(it + n_k - 1) % L::STAGES]);
}

// One tile's K loop of the fused-quant instantiation: per stage, quantize
// the A slice into the A fragments, issue the two products, wait for them
// and free the stage.
__device__ __forceinline__ void k_loop_fq(int it, int n_k, int (&acc)[128], uint64_t* full, uint64_t* empty,
                                          const unsigned char* sA, uint32_t sB, int warp, int g, int q,
                                          const float (&inv)[2]) {
  using L = Smem<false>;
  for (int kt = 0; kt < n_k; ++kt) {
    const int i = it + kt, st = i % L::STAGES;
    mbar_wait(&full[st], (i / L::STAGES) & 1);
    uint32_t a[8];
    a_frags(a, sA + st * L::A_STAGE, warp, g, q, inv);
    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 32; ++kk) {
      const uint32_t frag[4] = {a[4 * kk], a[4 * kk + 1], a[4 * kk + 2], a[4 * kk + 3]};
      wgmma_m64n256k32_s8_rs(acc, frag, desc_sw64(sB + st * L::B_STAGE + 32 * kk), kt > 0 || kk > 0);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);
    mbar_arrive(&empty[st]);
  }
}

// One consumer's epilogue: float(acc) * s_a * s_w, staged at STAGE (64 rows
// of OUT_ROW bytes, 16-byte chunk c of row r at c ^ (KEY * (r % 8))), then
// written with 16-byte stores (element-wise where rows do not start
// 16-byte aligned), the M and N tails masked.
template <bool OUT_F32>
__device__ __forceinline__ void epilogue(const int (&acc)[128], unsigned char* stage, const float* __restrict__ sa,
                                         const float* __restrict__ sw, void* __restrict__ out, int row0, int n0,
                                         int M, int N, int wg, int tid) {
  constexpr int ELEM = OUT_F32 ? 4 : 2;
  constexpr int PASSES = ELEM / 2;           // fp32: two 128-column halves, one after the other
  constexpr int PASS_J = BN / 8 / PASSES;    // 8-column groups a pass
  constexpr int ROW_BYTES = BN / PASSES * ELEM;
  static_assert(ROW_BYTES == Smem<true>::OUT_ROW, "one staged row");
  constexpr int KEY = ELEM / 2;
  constexpr int CHUNKS = ROW_BYTES / 16, PER_CHUNK = 16 / ELEM;
  const int warp = tid / 32, g = (tid % 32) / 4, q = tid % 4;
  float sa_r[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row0 + 16 * warp + g + 8 * i;
    sa_r[i] = row < M ? sa[row] : 0.f;
  }
  const bool vec = N % PER_CHUNK == 0;  // rows start 16-byte aligned
#pragma unroll
  for (int pass = 0; pass < PASSES; ++pass) {
    named_bar_sync(BAR_STAGE + wg, 128);  // the buffer's previous reads are done
#pragma unroll
    for (int jj = 0; jj < PASS_J; ++jj) {
      const int j = pass * PASS_J + jj;
      const int col = n0 + 8 * j + 2 * q;
      const float sw0 = col < N ? sw[col] : 0.f, sw1 = col + 1 < N ? sw[col + 1] : 0.f;
      const int byte = (8 * jj + 2 * q) * ELEM;  // of the staged row
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int r = 16 * warp + g + 8 * i;
        const float v0 = __fmul_rn(__fmul_rn(__int2float_rn(acc[4 * j + 2 * i]), sa_r[i]), sw0);
        const float v1 = __fmul_rn(__fmul_rn(__int2float_rn(acc[4 * j + 2 * i + 1]), sa_r[i]), sw1);
        unsigned char* dst = stage + r * ROW_BYTES + ((((byte >> 4) ^ (KEY * g))) << 4) + (byte & 15);
        if constexpr (OUT_F32)
          *reinterpret_cast<float2*>(dst) = make_float2(v0, v1);
        else
          *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(v0, v1);
      }
    }
    named_bar_sync(BAR_STAGE + wg, 128);
    // 64 rows x CHUNKS 16-byte chunks; a warp writes 512 contiguous bytes of a row
#pragma unroll 4
    for (int idx = tid; idx < WG_ROWS * CHUNKS; idx += 128) {
      const int r = idx / CHUNKS, c = idx % CHUNKS;
      const int row = row0 + r, col = n0 + pass * (BN / PASSES) + c * PER_CHUNK;
      if (row >= M || col >= N) continue;
      const unsigned char* src = stage + r * ROW_BYTES + ((c ^ (KEY * (r % 8))) << 4);
      unsigned char* dst = static_cast<unsigned char*>(out) + ((size_t)row * N + col) * ELEM;
      if (vec) {
        *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
      } else {  // the elements inside the matrix, byte by byte
        for (int b = 0; b < ELEM * min(PER_CHUNK, N - col); ++b) dst[b] = src[b];
      }
    }
  }
}

template <bool A_INT8, bool OUT_F32>
__global__ void __launch_bounds__(NTHREADS, 1)
    w8a8_sm90_kernel(const __grid_constant__ CUtensorMap ta, const __grid_constant__ CUtensorMap tb,
                     const float* __restrict__ inv, const float* __restrict__ sa, const float* __restrict__ sw,
                     void* __restrict__ out, int M, int N, int K) {
  using L = Smem<A_INT8>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem =
      reinterpret_cast<unsigned char*>((reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::OFF_BAR);
  uint64_t* empty = full + L::STAGES;

  const int grid_m = (M + BM - 1) / BM, grid_n = (N + BN - 1) / BN;
  const int n_tiles = grid_m * grid_n;
  const int n_k = K / BK;

  if (threadIdx.x == 0) {
    for (int s = 0; s < L::STAGES; ++s) {
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
    if (threadIdx.x % 128 == 0) {
      int it = 0;  // ring position, continued across tiles
      for (int t = blockIdx.x; t < n_tiles; t += gridDim.x) {
        int m0, n0;
        tile_origin(t, grid_m, grid_n, m0, n0);
        for (int kt = 0; kt < n_k; ++kt, ++it) {
          const int st = it % L::STAGES;
          if (it >= L::STAGES) mbar_wait(&empty[st], ((it / L::STAGES) - 1) & 1);
          mbar_arrive_expect_tx(&full[st], L::A_STAGE + L::B_STAGE);
          tma_load_2d(smem + L::OFF_A + st * L::A_STAGE, &ta, &full[st], kt * BK, m0);
          tma_load_2d(smem + L::OFF_B + st * L::B_STAGE, &tb, &full[st], kt * BK, n0);
        }
      }
    }
    return;
  }

  // ---------------- consumers ----------------
  reg_alloc<CONSUMER_REGS>();
  const int tid = threadIdx.x % 128;
  const int warp = tid / 32, g = (tid % 32) / 4, q = tid % 4;
  const uint32_t sB = smem_u32(smem + L::OFF_B);
  unsigned char* stage = smem + L::OFF_OUT + wg * WG_ROWS * L::OUT_ROW;

  int acc[128];
#pragma unroll
  for (int i = 0; i < 128; ++i) acc[i] = 0;
  int it = 0;
  for (int t = blockIdx.x; t < n_tiles; t += gridDim.x, it += n_k) {
    int m0, n0;
    tile_origin(t, grid_m, grid_n, m0, n0);
    const int row0 = m0 + WG_ROWS * wg;  // this consumer's first row; the thread's: row0 + 16 warp + g (+ 8)
    if constexpr (A_INT8) {
      k_loop_int8(it, n_k, acc, full, empty, smem_u32(smem + L::OFF_A) + WG_ROWS * wg * L::A_ROW, sB);
    } else {
      float inv_r[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int row = row0 + 16 * warp + g + 8 * i;
        inv_r[i] = row < M ? inv[row] : 0.f;
      }
      k_loop_fq(it, n_k, acc, full, empty, smem + L::OFF_A + WG_ROWS * wg * L::A_ROW, sB, warp, g, q, inv_r);
    }
    epilogue<OUT_F32>(acc, stage, sa, sw, out, row0, n0, M, N, wg, tid);
  }
}

template <bool A_INT8, bool OUT_F32>
cudaError_t launch(const void* x, const void* w, const void* inv, const void* sa, const void* sw, void* out, int M,
                   int N, int K, cudaStream_t stream) {
  using L = Smem<A_INT8>;
  if (M <= 0 || N <= 0 || K <= 0 || K % BK != 0) return cudaErrorInvalidValue;
  const long long tiles = (long long)((M + BM - 1) / BM) * ((N + BN - 1) / BN);
  if (tiles > 0x7fffffffLL) return cudaErrorInvalidValue;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  CUtensorMap ta, tb;
  err = A_INT8 ? encode_2d(&ta, CU_TENSOR_MAP_DATA_TYPE_UINT8, x, K, M, BK, BM, CU_TENSOR_MAP_SWIZZLE_64B)
               : encode_2d(&ta, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, x, K, M, BK, BM, CU_TENSOR_MAP_SWIZZLE_128B);
  if (err == cudaSuccess)
    err = encode_2d(&tb, CU_TENSOR_MAP_DATA_TYPE_UINT8, w, K, N, BK, BN, CU_TENSOR_MAP_SWIZZLE_64B);
  if (err != cudaSuccess) return err;
  auto kern = w8a8_sm90_kernel<A_INT8, OUT_F32>;
  static unsigned smem_raised = 0;
  err = flash::raise_smem_limit(kern, L::BYTES, smem_raised);
  if (err != cudaSuccess) return err;
  const unsigned grid = (unsigned)(tiles < sms ? tiles : sms);
  kern<<<grid, NTHREADS, L::BYTES, stream>>>(ta, tb, static_cast<const float*>(inv), static_cast<const float*>(sa),
                                             static_cast<const float*>(sw), out, M, N, K);
  return cudaGetLastError();
}

}  // namespace

// x8 (M, K) int8, w (N, K) int8, s_a (M,) fp32, s_w (N,) fp32 -> out (M, N),
// bf16 (out_f32 = 0) or fp32. x8, w contiguous and 16-byte aligned (their
// TMA tensor maps); K % 64 == 0. Returns the cudaError_t of the launch (0
// on success).
extern "C" int w8a8_matmul(const void* x8, const void* w, const void* sa, const void* sw, void* out, int M, int N,
                           int K, int out_f32, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(out_f32 ? launch<true, true>(x8, w, nullptr, sa, sw, out, M, N, K, s)
                                  : launch<true, false>(x8, w, nullptr, sa, sw, out, M, N, K, s));
}

// x (M, K) bf16, w (N, K) int8, inv = 1 / s_a and s_a (M,) fp32, s_w (N,)
// fp32 -> out (M, N), bf16 (out_f32 = 0) or fp32. x, w contiguous and
// 16-byte aligned (their TMA tensor maps); K % 64 == 0. Returns the
// cudaError_t of the launch (0 on success).
extern "C" int w8a8_fq_matmul(const void* x, const void* w, const void* inv, const void* sa, const void* sw,
                              void* out, int M, int N, int K, int out_f32, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(out_f32 ? launch<false, true>(x, w, inv, sa, sw, out, M, N, K, s)
                                  : launch<false, false>(x, w, inv, sa, sw, out, M, N, K, s));
}

extern "C" const char* int8_matmul_sm90_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
