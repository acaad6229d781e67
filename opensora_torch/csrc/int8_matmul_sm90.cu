// Fused-quant W8A8 GEMM for Hopper (sm_90a): bf16 activations quantized
// inside the kernel, int8 x int8 -> int32 on wgmma -> rescaled bf16 (or
// fp32). One warp-specialised kernel (TMA + int8 wgmma).
//
//   x8[m, k]  = clip(round_half_even(x[m, k] * inv[m]), -127, 127)
//   out[m, n] = (sum_k x8[m, k] * w[n, k]) * s_a[m] * s_w[n]
//
// Replaces the Pallas TPU kernel _w8a8_fq_kernel of
// opensora_tpu/ops/int8_matmul.py (:51, called by w8a8_fusedquant_matmul
// :83). x * inv is rounded on its own (__fmul_rn, never fused into the next
// step), as the TPU kernel multiplies by the precomputed reciprocal. The
// epilogue is float(acc) * s_a[m] * s_w[n] in fp32, in that order, each
// step rounded to nearest, so the result equals the plain version's
// (w8a8_fusedquant_matmul_ref: the integer sum exact in float64, the same
// fp32 epilogue) in every element: every partial sum is an integer below
// 2^31 (K * 127^2). The int32 sum never reaches device memory.
//
// Design. One CTA owns a 128 x 256 output tile (grid: the tiles in groups of
// GROUP_M block rows, so CTAs running together share A rows and weight
// columns in L2) and walks K in steps of 64. Three warpgroups:
//   - the producer (setmaxnreg down to 24): one thread keeps a ring of
//     STAGES stages in flight by TMA, full and empty mbarriers; a stage holds
//     the bf16 A tile (128 x 64 through a 2-D tensor map over (K, M),
//     128-byte swizzle) and the int8 weight tile (256 x 64, a 2-D map over
//     (K, N), 64-byte swizzle);
//   - two consumers (setmaxnreg up to 240), each owning 64 rows x 256
//     columns, the int32 accumulator in registers (128 a thread). Per stage
//     each reads its 64 x 64 bf16 slice from shared memory, quantizes it
//     straight into the s8 A fragments of two
//     wgmma.m64n256k32.s32.s8.s8 (A from registers, the weight K-major
//     from shared memory: integer wgmma takes K-major operands only, which
//     is how torch holds a linear weight, (N, K)) and issues them, then
//     waits for them (wgmma_wait<0>) and frees the stage.
// Each A element is quantized once per CTA (the 256-wide tile halves the
// re-quantizations of a 128-wide one: 84 per element at linear1's N =
// 21504). The rounding runs at the FP32 rate, not through the conversion
// unit (16 a clock per SM on compute capability 9.0, 128 for FP32 adds):
// y = __fmul_rn(x, inv), clamped to +-127 in float, t = __fadd_rn(y, 1.5 *
// 2^23) lands on the integer grid (ulp 1 in [2^23, 2^24)) rounded half to
// even, and the low byte of t's bits is the two's-complement int8; four
// pack with __byte_perm. That equals the clamped __float2int_rn for every
// finite x. The shared-memory reads of the A slice are conflict-free: in
// one 8-byte load, lanes with odd g read the other K slice than lanes with
// even g, so a half-warp touches 8 distinct 16-byte chunks; a select puts
// the quantized words back in fragment order.
// The epilogue: both consumers meet at a named barrier (the stages are then
// free), each scales its accumulators, float(acc) * s_a * s_w (s_w staged
// in shared memory), stages its 64 x 256 tile in the freed stage buffers
// (16-byte chunks XOR-swizzled by row, conflict-free both ways) and writes
// it with 16-byte stores, masking the M and N tails (the loads are
// zero-filled by the TMA). K must be a multiple of 64; M and N any size.
// Shared memory: 5 stages x (16 KB A + 16 KB weight), s_w 1 KB, barriers:
// 162 KB, one CTA per SM.
//
// What bounds it: at linear1 (M, K, N) = (26484, 3072, 21504), 2MNK = 3.50
// Tops, 1.768 ms at 1979 Tops/s, on 0.16 GB of bf16 x + 0.07 GB of weight +
// 1.14 GB of bf16 out (0.41 ms at 3.35 TB/s): operations bound it. The
// quantize is 84 x M x K = 6.8e9 elements of ~6 instructions on the CUDA
// cores, ~1.4 ms at the card's FP32 issue rate. Overlapping it with the
// consumer's own products would take A fragments written while earlier
// products are in flight; ptxas serializes such wgmmas (C7513). Measured
// on an H100 (700 W) by opensora_torch/tools/gemm_fq_ab.py at linear1, in
// turns: this form 4.49-4.50 ms, the pipelined one (wait depth 1, two
// register sets) 4.63-4.67; without the quantize (wrong values, the same
// loads and products) 3.59, without the A reads too 3.50: the quantize
// costs ~0.9 ms, the product stream the rest (see PERF.md).
// What the design does about the kernel it replaces (mma.sync m16n8k32 from
// ldmatrix, the whole A tile quantized into a separate int8 shared tile
// between two __syncthreads per K step with __float2int_rn, 128-wide
// tiles): int8 wgmma is the path to the card's int8 rate; quantizing
// straight into the A fragments drops the int8 shared tile and both block
// barriers; the FP32 rounding and the 256-wide tile cut the conversion cost
// by 8x and 2x.
//
// The main loop takes its A fragments from a_frags (bf16 in shared memory,
// quantized); the W8A8 GEMM of int8 activations (csrc/int8_matmul.cu,
// w8a8_matmul) can become a second instantiation that reads an int8 A tile
// through a K-major descriptor instead.
//
// Layout: x (M, K) bf16 and w (N, K) int8 row-major, 16-byte aligned; inv,
// s_a (M,), s_w (N,) fp32; out (M, N) row-major bf16 or fp32.

#include "flash_common.cuh"
#include "hopper_common.cuh"

namespace {

using flash::bf16;
using namespace hopper;

constexpr int BM = 128, BN = 256, BK = 64;  // output tile; K step
constexpr int WG_ROWS = 64;                 // rows per consumer
constexpr int STAGES = 5;
constexpr int CONSUMERS = 2;
constexpr int NTHREADS = 128 * (CONSUMERS + 1);
constexpr int PRODUCER_REGS = 24;
constexpr int CONSUMER_REGS = 240;
constexpr int GROUP_M = 8;  // block rows walked together (L2 reuse)

// shared memory, bytes from a 1 KB aligned base
constexpr int A_ROW = 2 * BK;            // 128 B: one bf16 row of a stage
constexpr int A_STAGE = BM * A_ROW;      // 16 KB
constexpr int B_STAGE = BN * BK;         // 16 KB (64-byte rows)
constexpr int OFF_A = 0;
constexpr int OFF_B = OFF_A + STAGES * A_STAGE;
constexpr int OFF_SW = OFF_B + STAGES * B_STAGE;
constexpr int OFF_BAR = OFF_SW + BN * 4;
constexpr int N_BARS = 2 * STAGES;  // full[STAGES], empty[STAGES]
constexpr int SMEM_BYTES = OFF_BAR + 8 * N_BARS + 1024;  // + the base's alignment
static_assert(SMEM_BYTES <= 232448, "shared memory");
static_assert(CONSUMERS * WG_ROWS * BN * 4 <= OFF_SW, "the output staging fits in the stage buffers");

constexpr int BAR_EPI = 1;  // named barrier: both consumers' last products are done

constexpr float ROUND_MAGIC = 12582912.f;  // 1.5 * 2^23

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

// The s8 A fragments of both 32-wide K slices of one stage: a[4 kk + r] is
// register r of slice kk (row g + 8 (r % 2) of the warp's 16, K columns
// 32 kk + 16 (r / 2) + 4 q .. + 3). SA: this consumer's 64 rows of the
// stage's A tile (128-byte rows, 16-byte chunk c of row r at c ^ (r % 8)).
// Load (s, h, i) of a lane reads slice kk = s ^ (g % 2), so each 8-byte
// load of a half-warp covers 8 distinct chunks: no bank conflict.
__device__ __forceinline__ void a_frags(uint32_t (&a)[8], const unsigned char* sA, int warp, int g, int q,
                                        const float (&inv)[2]) {
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

// One K step of a consumer: quantize stage kt's A into the A fragments,
// issue its two k32 products, wait for them and free the stage.
__device__ __forceinline__ void k_step(int kt, int (&acc)[128], uint64_t* full, uint64_t* empty,
                                       const unsigned char* sA, uint32_t sB, int warp, int g, int q,
                                       const float (&inv)[2]) {
  const int st = kt % STAGES;
  mbar_wait(&full[st], (kt / STAGES) & 1);
  uint32_t a[8];
  a_frags(a, sA + st * A_STAGE, warp, g, q, inv);
  fence_regs(acc);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 2; ++kk) {
    const uint32_t frag[4] = {a[4 * kk], a[4 * kk + 1], a[4 * kk + 2], a[4 * kk + 3]};
    wgmma_m64n256k32_s8_rs(acc, frag, desc_sw64(sB + st * B_STAGE + 32 * kk), 1);
  }
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(acc);
  mbar_arrive(&empty[st]);
}

template <bool OUT_F32>
__global__ void __launch_bounds__(NTHREADS, 1)
    w8a8_fq_sm90_kernel(const __grid_constant__ CUtensorMap ta, const __grid_constant__ CUtensorMap tb,
                        const float* __restrict__ inv, const float* __restrict__ sa, const float* __restrict__ sw,
                        void* __restrict__ out, int M, int N, int K) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem =
      reinterpret_cast<unsigned char*>((reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + OFF_BAR);
  uint64_t* empty = full + STAGES;
  float* sw_s = reinterpret_cast<float*>(smem + OFF_SW);

  // grouped tile order: GROUP_M block rows share each weight tile in L2
  const int pid = blockIdx.x;
  const int grid_m = (M + BM - 1) / BM, grid_n = (N + BN - 1) / BN;
  const int in_group = GROUP_M * grid_n;
  const int first_m = (pid / in_group) * GROUP_M;
  const int group_rows = min(grid_m - first_m, GROUP_M);
  const int m0 = (first_m + (pid % in_group) % group_rows) * BM;
  const int n0 = ((pid % in_group) / group_rows) * BN;
  const int n_k = K / BK;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
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
      for (int kt = 0; kt < n_k; ++kt) {
        const int st = kt % STAGES;
        if (kt >= STAGES) mbar_wait(&empty[st], ((kt / STAGES) - 1) & 1);
        mbar_arrive_expect_tx(&full[st], A_STAGE + B_STAGE);
        tma_load_2d(smem + OFF_A + st * A_STAGE, &ta, &full[st], kt * BK, m0);
        tma_load_2d(smem + OFF_B + st * B_STAGE, &tb, &full[st], kt * BK, n0);
      }
    }
    return;
  }

  // ---------------- consumers ----------------
  reg_alloc<CONSUMER_REGS>();
  const int tid = threadIdx.x % 128;
  const int warp = tid / 32, g = (tid % 32) / 4, q = tid % 4;
  const int row0 = m0 + WG_ROWS * wg;  // this consumer's first row; the thread's: row0 + 16 warp + g (+ 8)
  {
    const int col = n0 + threadIdx.x;  // 256 consumer threads, one column each
    sw_s[threadIdx.x] = col < N ? sw[col] : 0.f;
  }
  float inv_r[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row0 + 16 * warp + g + 8 * i;
    inv_r[i] = row < M ? inv[row] : 0.f;
  }
  const unsigned char* sA = smem + OFF_A + WG_ROWS * wg * A_ROW;
  const uint32_t sB = smem_u32(smem + OFF_B);

  int acc[128];
#pragma unroll
  for (int i = 0; i < 128; ++i) acc[i] = 0;
  for (int kt = 0; kt < n_k; ++kt) k_step(kt, acc, full, empty, sA, sB, warp, g, q, inv_r);

  // ---------------- epilogue ----------------
  named_bar_sync(BAR_EPI, 128 * CONSUMERS);  // every product is done: the stages are free; s_w is staged
  constexpr int ELEM = OUT_F32 ? 4 : 2;
  constexpr int ROW_BYTES = BN * ELEM;
  constexpr int KEY = ELEM / 2;  // chunk c of row r is staged at c ^ (KEY * (r % 8))
  unsigned char* stage = smem + wg * WG_ROWS * ROW_BYTES;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = 16 * warp + g + 8 * i;
    const int row = row0 + r;
    const float sa_r = row < M ? sa[row] : 0.f;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const float2 swc = *reinterpret_cast<const float2*>(sw_s + 8 * j + 2 * q);
      const float v0 = __fmul_rn(__fmul_rn(__int2float_rn(acc[4 * j + 2 * i]), sa_r), swc.x);
      const float v1 = __fmul_rn(__fmul_rn(__int2float_rn(acc[4 * j + 2 * i + 1]), sa_r), swc.y);
      const int byte = (8 * j + 2 * q) * ELEM;  // of the row
      const int chunk = (byte >> 4) ^ (KEY * g);
      unsigned char* dst = stage + r * ROW_BYTES + (chunk << 4) + (byte & 15);
      if constexpr (OUT_F32)
        *reinterpret_cast<float2*>(dst) = make_float2(v0, v1);
      else
        *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(v0, v1);
    }
  }
  named_bar_sync(BAR_EPI + 1 + wg, 128);
  // 64 rows x CHUNKS 16-byte chunks; a warp writes 512 contiguous bytes of a row
  constexpr int CHUNKS = ROW_BYTES / 16, PER_CHUNK = 16 / ELEM;
  const bool vec = N % PER_CHUNK == 0;  // rows start 16-byte aligned
#pragma unroll 4
  for (int idx = tid; idx < WG_ROWS * CHUNKS; idx += 128) {
    const int r = idx / CHUNKS, c = idx % CHUNKS;
    const int row = row0 + r, col = n0 + c * PER_CHUNK;
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

template <bool OUT_F32>
cudaError_t launch(const void* x, const void* w, const void* inv, const void* sa, const void* sw, void* out, int M,
                   int N, int K, cudaStream_t stream) {
  if (M <= 0 || N <= 0 || K <= 0 || K % BK != 0) return cudaErrorInvalidValue;
  const long long blocks = (long long)((M + BM - 1) / BM) * ((N + BN - 1) / BN);
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  CUtensorMap ta, tb;
  cudaError_t err = encode_2d(&ta, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, x, K, M, BK, BM, CU_TENSOR_MAP_SWIZZLE_128B);
  if (err == cudaSuccess)
    err = encode_2d(&tb, CU_TENSOR_MAP_DATA_TYPE_UINT8, w, K, N, BK, BN, CU_TENSOR_MAP_SWIZZLE_64B);
  if (err != cudaSuccess) return err;
  auto kern = w8a8_fq_sm90_kernel<OUT_F32>;
  static unsigned smem_raised = 0;
  err = flash::raise_smem_limit(kern, SMEM_BYTES, smem_raised);
  if (err != cudaSuccess) return err;
  kern<<<(unsigned)blocks, NTHREADS, SMEM_BYTES, stream>>>(ta, tb, static_cast<const float*>(inv),
                                                           static_cast<const float*>(sa),
                                                           static_cast<const float*>(sw), out, M, N, K);
  return cudaGetLastError();
}

}  // namespace

// x (M, K) bf16, w (N, K) int8, inv = 1 / s_a and s_a (M,) fp32, s_w (N,)
// fp32 -> out (M, N), bf16 (out_f32 = 0) or fp32. x, w contiguous and
// 16-byte aligned (their TMA tensor maps); K % 64 == 0. Returns the
// cudaError_t of the launch (0 on success).
extern "C" int w8a8_fq_matmul(const void* x, const void* w, const void* inv, const void* sa, const void* sw,
                              void* out, int M, int N, int K, int out_f32, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(out_f32 ? launch<true>(x, w, inv, sa, sw, out, M, N, K, s)
                                  : launch<false>(x, w, inv, sa, sw, out, M, N, K, s));
}

extern "C" const char* int8_matmul_sm90_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
