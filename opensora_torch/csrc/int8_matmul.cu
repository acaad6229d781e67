// W8A8 GEMM for Hopper (sm_90a): int8 x int8 -> int32 in registers -> rescaled bf16 (or fp32).
//
//   out[m, n] = (sum_k x8[m, k] * w8[n, k]) * s_a[m] * s_w[n]
//
// Replaces the Pallas TPU kernel _w8a8_kernel of
// opensora_tpu/ops/int8_matmul.py (:31, called by w8a8_matmul :136): x
// arrives int8 with per-row scales s_a. The fused-quant kernel
// (_w8a8_fq_kernel, :51) is csrc/int8_matmul_sm90.cu. One templated kernel,
// instantiated for a bf16 or fp32 output. The epilogue is float(acc) *
// s_a[m] * s_w[n] in fp32, in that order, with round-to-nearest conversions, so the result is exactly the plain
// version's (w8a8_matmul_ref: the integer sum exact in float64, the same fp32
// epilogue): every partial sum is an integer below 2^31 (K * 127^2 <= 2.5e8).
//
// Layout: x (M, K) and the weight (N, K) are both K-contiguous, which is what
// mma.sync.m16n8k32.row.col.s32.s8.s8.s32 takes for its A and B operands, so
// the weight stays as torch holds it (nn.Linear's (out, in)). s_a (M,),
// s_w (N,) fp32; out (M, N) row-major.
//
// What bounds it: at the MMDiT's shapes (M = 24948..26484 tokens, K and N
// 3072..21504) a GEMM does 2*M*N*K ops on (M + N)*K + 2*M*N bytes, ~1000 ops
// per byte, far above the H100's ~590 int8 ops per byte: tensor-core bound.
// The design keeps the int32 accumulator in registers (the point of the TPU
// kernel: it never reaches device memory), feeds mma.sync from a 4-stage
// cp.async ring of 128 x 64-byte tiles, and walks the output tiles in groups of
// 8 block rows so that concurrently running blocks share A rows and weight
// columns in L2. wgmma/TMA, which reach Hopper's full int8 rate, are later work
// (the fused-quant kernel's main loop with an int8 A tile).
//
// Tiles: a block of 8 warps owns a 128 x 128 output tile (2 x 4 warps of
// 64 x 32); the K loop steps 64 bytes. M and N tails are zero-filled on load
// and masked on store; K must be a multiple of 64 (the wrapper checks).

#include "flash_common.cuh"

namespace {

using namespace flash;

constexpr int BM = 128, BN = 128, BK = 64;  // output tile; K step in int8 elements
constexpr int WARPS_M = 2, WARPS_N = 4;
constexpr int NTHREADS = WARPS_M * WARPS_N * 32;
constexpr int WM = BM / WARPS_M;  // 64 rows per warp
constexpr int WN = BN / WARPS_N;  // 32 columns per warp
constexpr int MT = WM / 16;       // m16 tiles per warp
constexpr int NT = WN / 8;        // n8 tiles per warp
constexpr int SROW = BK + 16;     // int8 smem row stride (bytes): ldmatrix rows conflict-free
constexpr int GROUP_M = 8;        // block rows walked together (L2 reuse)
constexpr int S = 4;              // stages
constexpr int A_STAGE = BM * SROW;  // bytes of one A stage
constexpr int SMEM_BYTES = S * (BM * SROW + BN * SROW);

template <bool OUT_F32>
__global__ void __launch_bounds__(NTHREADS)
    w8a8_gemm_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w, const float* __restrict__ sa,
                     const float* __restrict__ sw, void* __restrict__ out, int M, int N, int K) {
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* As = smem;                    // S stages of A
  unsigned char* Bs = smem + S * A_STAGE;      // S stages of W

  // grouped tile order: GROUP_M block rows share each weight tile in L2
  const int pid = blockIdx.x;
  const int grid_m = (M + BM - 1) / BM, grid_n = (N + BN - 1) / BN;
  const int in_group = GROUP_M * grid_n;
  const int first_m = (pid / in_group) * GROUP_M;
  const int group_rows = min(grid_m - first_m, GROUP_M);
  const int m0 = (first_m + (pid % in_group) % group_rows) * BM;
  const int n0 = ((pid % in_group) / group_rows) * BN;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm = warp / WARPS_N, wn = warp % WARPS_N;
  const int g = lane >> 2, t = lane & 3, mat = lane >> 3;
  const int n_k = K / BK;

  auto load_stage = [&](int kt) {
    const int st = kt % S;
    load_rows<BM, BK, SROW, NTHREADS>(As + st * A_STAGE, x + kt * BK, m0, M, K);
    load_rows<BN, BK, SROW, NTHREADS>(Bs + st * BN * SROW, w + kt * BK, n0, N, K);
  };

  int acc[MT][NT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j) acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0;

#pragma unroll
  for (int s = 0; s < S - 1; ++s) {
    if (s < n_k) load_stage(s);
    cp_async_commit();
  }

  for (int kt = 0; kt < n_k; ++kt) {
    cp_async_wait<S - 2>();
    __syncthreads();  // tile kt has landed; every warp is done with tile kt - 1
    const unsigned char* At = As + (kt % S) * A_STAGE;
    if (kt + S - 1 < n_k) load_stage(kt + S - 1);  // into the stage tile kt - 1 used
    cp_async_commit();

    const unsigned char* Bt = Bs + (kt % S) * BN * SROW;
#pragma unroll
    for (int kk = 0; kk < BK / 32; ++kk) {
      uint32_t a[MT][4];
#pragma unroll
      for (int i = 0; i < MT; ++i)
        ldmatrix_x4(a[i], smem_u32(At + (wm * WM + i * 16 + (lane & 15)) * SROW + kk * 32 +
                                   (lane >> 4) * 16));
#pragma unroll
      for (int jp = 0; jp < NT / 2; ++jp) {
        uint32_t b[4];
        ldmatrix_x4(b, smem_u32(Bt + (wn * WN + jp * 16 + (lane & 7) + (mat >> 1) * 8) * SROW +
                                kk * 32 + (mat & 1) * 16));
#pragma unroll
        for (int i = 0; i < MT; ++i) {
          mma_s8(acc[i][2 * jp], a[i], b[0], b[1]);
          mma_s8(acc[i][2 * jp + 1], a[i], b[2], b[3]);
        }
      }
    }
  }
  cp_async_wait<0>();

  // epilogue: float(acc) * s_a[m] * s_w[n], fp32, in that order
  float sw_c[NT][2];
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int col = n0 + wn * WN + j * 8 + 2 * t + e;
      sw_c[j][e] = col < N ? sw[col] : 0.f;
    }
#pragma unroll
  for (int i = 0; i < MT; ++i) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = m0 + wm * WM + i * 16 + g + 8 * h;
      if (row >= M) continue;
      const float sa_r = sa[row];
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const int col = n0 + wn * WN + j * 8 + 2 * t;
        const float v0 = __fmul_rn(__fmul_rn(__int2float_rn(acc[i][j][2 * h]), sa_r), sw_c[j][0]);
        const float v1 = __fmul_rn(__fmul_rn(__int2float_rn(acc[i][j][2 * h + 1]), sa_r), sw_c[j][1]);
        const size_t off = (size_t)row * N + col;
        if constexpr (OUT_F32) {
          float* o = static_cast<float*>(out);
          if (col + 1 < N && !(N & 1)) {
            *reinterpret_cast<float2*>(o + off) = make_float2(v0, v1);
          } else {
            if (col < N) o[off] = v0;
            if (col + 1 < N) o[off + 1] = v1;
          }
        } else {
          bf16* o = static_cast<bf16*>(out);
          if (col + 1 < N && !(N & 1)) {
            *reinterpret_cast<__nv_bfloat162*>(o + off) = __floats2bfloat162_rn(v0, v1);
          } else {
            if (col < N) o[off] = __float2bfloat16_rn(v0);
            if (col + 1 < N) o[off + 1] = __float2bfloat16_rn(v1);
          }
        }
      }
    }
  }
}

template <bool OUT_F32>
cudaError_t launch(const void* x, const void* w, const void* sa, const void* sw, void* out, int M, int N, int K,
                   cudaStream_t stream) {
  if (M <= 0 || N <= 0 || K <= 0 || K % BK != 0) return cudaErrorInvalidValue;
  auto kern = w8a8_gemm_kernel<OUT_F32>;
  static unsigned smem_raised = 0;
  cudaError_t err = raise_smem_limit(kern, SMEM_BYTES, smem_raised);
  if (err != cudaSuccess) return err;
  const long long blocks = (long long)((M + BM - 1) / BM) * ((N + BN - 1) / BN);
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  kern<<<(unsigned)blocks, NTHREADS, SMEM_BYTES, stream>>>(
      static_cast<const int8_t*>(x), static_cast<const int8_t*>(w), static_cast<const float*>(sa),
      static_cast<const float*>(sw), out, M, N, K);
  return cudaGetLastError();
}

}  // namespace

// x8 (M, K) int8, w (N, K) int8, s_a (M,) fp32, s_w (N,) fp32 -> out (M, N),
// bf16 (out_f32 = 0) or fp32. All contiguous, 16-byte aligned; K % 64 == 0.
// Returns the cudaError_t of the launch (0 on success).
extern "C" int w8a8_matmul(const void* x8, const void* w, const void* sa, const void* sw, void* out, int M,
                           int N, int K, int out_f32, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return out_f32 ? launch<true>(x8, w, sa, sw, out, M, N, K, s) : launch<false>(x8, w, sa, sw, out, M, N, K, s);
}

extern "C" const char* int8_matmul_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
