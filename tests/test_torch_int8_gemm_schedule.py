"""The fused-quant W8A8 GEMM's order of work
(``opensora_torch/csrc/int8_matmul_sm90.cu``), emulated in numpy on the
CPU and held against the port's plain version
(``w8a8_fusedquant_matmul_ref``) and the JAX package's Pallas kernel
(``w8a8_fusedquant_matmul``, interpret mode) on the same numpy inputs.

The emulation follows the kernel at the level of its addresses and
registers: CTAs of 128 x 256 outputs in the grouped tile order; K in
stages of 64 with the bf16 A tile laid out as the TMA's 128-byte swizzle
writes it and the weight tile zero-filled past N; two consumers of 64 rows
whose threads read their A slice at the kernel's addresses (lanes with odd
g on the other 32-wide K slice), quantize four bf16 at a time by the
float32 magic-number rounding (x * inv, clamp to +-127, + 1.5 * 2^23, the
low byte), pack them with the kernel's __byte_perm selectors and select
them into fragment order; the int8 A matrix of each k32 product is read
back from those registers through the mma.m16n8k32 fragment layout
(register r: row g + 8 (r % 2), K 16 (r / 2) + 4 q + byte); int32 sums;
the epilogue float(acc) * s_a * s_w in float32, staged at the kernel's
XOR-swizzled shared-memory addresses and written back with its 16-byte
(or element-wise) stores and tail masks.

Tolerance: none. The kernel's integer sums are exact and its epilogue
rounds where the plain version rounds, so the emulated output equals the
plain version's in every element, at fp32 and at bf16 output. Against
JAX: equal in every element too; JAX's jitted ``xf_max / 127.0`` is a
product with the reciprocal of 127, one ulp off the port's quotient for
some abs-max values (tests/test_torch_quant.py), so each row's abs-max is
chosen where the two agree. The rounding itself is held exhaustively: over
every finite bf16 value and a few reciprocals, the magic-number rounding
equals clip(round_half_even(x * inv), -127, 127).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opensora_tpu.ops.int8_matmul import w8a8_fusedquant_matmul as j_fq_matmul
from opensora_torch.ops import int8_matmul as tgemm

BM, BN, BK, WG_ROWS, GROUP_M = 128, 256, 64, 64, 8  # the kernel's tile, K step, consumer rows, tile groups
A_ROW = 2 * BK  # bytes of a bf16 row of an A stage
MAGIC = np.float32(12582912.0)  # 1.5 * 2^23


def quant_magic(x: np.ndarray, inv) -> np.ndarray:
    """The kernel's rounding in float32: the int8 values as int8 (a product
    that overflows to +-inf clamps to +-127)."""
    with np.errstate(over="ignore"):
        y = x.astype(np.float32) * np.float32(inv)
    y = np.minimum(np.maximum(y, np.float32(-127)), np.float32(127))
    t = (y + MAGIC).astype(np.float32)
    return (t.view(np.uint32) & 0xFF).astype(np.uint8).view(np.int8)


def byte_perm(x: np.ndarray, y: np.ndarray, s: int) -> np.ndarray:
    """CUDA's __byte_perm on uint32 arrays."""
    src = np.stack([(x >> (8 * b)) & 0xFF for b in range(4)] + [(y >> (8 * b)) & 0xFF for b in range(4)])
    out = np.zeros_like(x)
    for n in range(4):
        out |= src[(s >> (4 * n)) & 0x7] << (8 * n)
    return out


def quant4(v: np.ndarray, inv: np.ndarray) -> np.ndarray:
    """The kernel's quant4 on (threads, 4) uint16 bf16 bit patterns (lowest K
    first): one packed uint32 a thread."""
    x = (v.astype(np.uint32) << 16).view(np.float32)
    t = [quant_magic(x[:, j], inv).view(np.uint8).astype(np.uint32) for j in range(4)]  # the low bytes
    return byte_perm(byte_perm(t[0], t[1], 0x0040), byte_perm(t[2], t[3], 0x0040), 0x5410)


def tile_order(M: int, N: int):
    """(m0, n0) of each CTA in launch order: GROUP_M block rows share each
    weight tile."""
    grid_m, grid_n = -(-M // BM), -(-N // BN)
    in_group = GROUP_M * grid_n
    for pid in range(grid_m * grid_n):
        first_m = (pid // in_group) * GROUP_M
        group_rows = min(grid_m - first_m, GROUP_M)
        yield (first_m + (pid % in_group) % group_rows) * BM, ((pid % in_group) // group_rows) * BN


THREADS = np.arange(128)
WARP, G, Q = THREADS // 32, (THREADS % 32) // 4, THREADS % 4


def a_stage_smem(x_bits: np.ndarray, m0: int, k0: int) -> np.ndarray:
    """The bf16 A tile of rows m0.., K k0..k0+63 as the TMA writes it: 128
    rows of 128 bytes, 16-byte chunk c of row r at c ^ (r % 8); rows past M
    zero."""
    tile = np.zeros((BM, BK), np.uint16)
    rows = x_bits[m0:m0 + BM, k0:k0 + BK]
    tile[:rows.shape[0]] = rows
    logical = tile.view(np.uint8).reshape(BM, 8, 16)
    smem = np.zeros((BM, 8, 16), np.uint8)
    for r in range(BM):
        smem[r, np.arange(8) ^ (r % 8)] = logical[r]
    return smem.reshape(-1)


def a_frag_addresses(s: int, h: int, i: int) -> np.ndarray:
    """Byte offset, in the consumer's 64 rows of a stage, of each thread's
    8-byte load (s, h, i) (a_frags)."""
    odd = G & 1
    kk = s ^ odd
    r = 16 * WARP + G + 8 * i
    chunk = 4 * kk + 2 * h + (Q >> 1)
    return r * A_ROW + ((chunk ^ G) << 4) + 8 * (Q & 1)


def a_frags(smem: np.ndarray, wg: int, inv_rows: np.ndarray) -> np.ndarray:
    """(128 threads, 8) uint32: a[4 kk + r] as the kernel builds it."""
    base = WG_ROWS * wg * A_ROW
    odd = (G & 1).astype(bool)
    w = np.zeros((2, 4, 128), np.uint32)
    for s in range(2):
        for h in range(2):
            for i in range(2):
                addr = base + a_frag_addresses(s, h, i)
                v = np.stack([smem[addr + b] for b in range(8)], 1).copy().view(np.uint16)  # (128, 4)
                w[s, 2 * h + i] = quant4(v, inv_rows[16 * WARP + G + 8 * i])
    a = np.zeros((128, 8), np.uint32)
    for r in range(4):
        a[:, r] = np.where(odd, w[1, r], w[0, r])
        a[:, 4 + r] = np.where(odd, w[0, r], w[1, r])
    return a


def a_matrix(a: np.ndarray) -> np.ndarray:
    """The consumer's 64 x 64 int8 A of a stage, read from the registers
    through the fragment layout of wgmma m64nNk32 (s8): every element once."""
    out = np.zeros((WG_ROWS, BK), np.int64)
    seen = np.zeros((WG_ROWS, BK), np.int64)
    for kk in range(2):
        for r in range(4):
            word = a[:, 4 * kk + r]
            for b in range(4):
                row = 16 * WARP + G + 8 * (r % 2)
                col = 32 * kk + 16 * (r // 2) + 4 * Q + b
                out[row, col] = ((word >> (8 * b)) & 0xFF).astype(np.uint8).view(np.int8)
                seen[row, col] += 1
    assert (seen == 1).all()
    return out


def stage_and_store(v: np.ndarray, out: np.ndarray, row0: int, n0: int, out_f32: bool) -> None:
    """The epilogue of one consumer: V (64, 256) float32 staged at the
    kernel's swizzled addresses, then read back in 16-byte chunks and
    stored with the M and N tails masked."""
    M, N = out.shape
    elem = 4 if out_f32 else 2
    row_bytes, key = BN * elem, elem // 2
    vals = v if out_f32 else torch.from_numpy(v).to(torch.bfloat16).view(torch.int16).numpy()
    stage = np.zeros(WG_ROWS * row_bytes, np.uint8)
    written = np.zeros(WG_ROWS * row_bytes, np.int64)
    for i in range(2):
        r = 16 * WARP + G + 8 * i
        for j in range(BN // 8):  # the accumulator's d[4 j + 2 i + e]: column 8 j + 2 q + e
            byte = (8 * j + 2 * Q) * elem
            addr = r * row_bytes + (((byte >> 4) ^ (key * G)) << 4) + (byte & 15)
            pair = np.stack([vals[r, 8 * j + 2 * Q], vals[r, 8 * j + 2 * Q + 1]], 1).copy().view(np.uint8)
            for b in range(2 * elem):
                stage[addr + b] = pair[:, b]
                written[addr + b] += 1
    assert (written == 1).all()
    chunks, per_chunk = row_bytes // 16, 16 // elem
    flat = out.view(np.uint8).reshape(-1)
    for idx in range(WG_ROWS * chunks):
        r, c = divmod(idx, chunks)
        row, col = row0 + r, n0 + c * per_chunk
        if row >= M or col >= N:
            continue
        src = stage[r * row_bytes + ((c ^ (key * (r % 8))) << 4):][:16]
        n_el = per_chunk if N % per_chunk == 0 else min(per_chunk, N - col)  # the 16-byte store, or elements
        dst = (row * N + col) * elem
        flat[dst:dst + n_el * elem] = src[:n_el * elem]


def gemm_schedule(x_bits, w, inv, s_a, s_w, out_f32):
    """The kernel's output (M, N): float32, or bf16 as int16 bits."""
    M, K = x_bits.shape
    N = w.shape[0]
    out = np.zeros((M, N), np.float32 if out_f32 else np.int16)
    tiles = list(tile_order(M, N))
    assert sorted(tiles) == sorted({(m0, n0) for m0 in range(0, M, BM) for n0 in range(0, N, BN)})
    inv_p = np.zeros(-(-M // BM) * BM, np.float32)
    inv_p[:M] = inv
    sa_p = np.zeros_like(inv_p)
    sa_p[:M] = s_a
    for m0, n0 in tiles:
        wt = np.zeros((BN, K), np.int64)
        wt[:min(BN, N - n0)] = w[n0:n0 + BN]
        sw = np.zeros(BN, np.float32)
        sw[:min(BN, N - n0)] = s_w[n0:n0 + BN]
        acc = [np.zeros((WG_ROWS, BN), np.int64) for _ in range(2)]
        for k0 in range(0, K, BK):
            smem = a_stage_smem(x_bits, m0, k0)
            for wg in range(2):
                rows = slice(m0 + WG_ROWS * wg, m0 + WG_ROWS * (wg + 1))
                a8 = a_matrix(a_frags(smem, wg, inv_p[rows]))
                acc[wg] += a8 @ wt[:, k0:k0 + BK].T
        for wg in range(2):
            assert np.abs(acc[wg]).max() < 2 ** 31
            row0 = m0 + WG_ROWS * wg
            v = acc[wg].astype(np.float32) * sa_p[row0:row0 + WG_ROWS, None]
            v = (v * sw[None, :]).astype(np.float32)
            stage_and_store(v, out, row0, n0, out_f32)
    return out


def _agreeing_absmax(rng, n, lo=1.5, hi=3.0):
    """n bf16 values in [lo, hi] whose abs-max scale max / 127 equals the
    product with the reciprocal of 127 in float32."""
    bits = np.arange(0, 1 << 15, dtype=np.uint32)
    vals = (bits << 16).view(np.float32)
    vals = vals[(vals >= lo) & (vals <= hi)]
    ok = vals / np.float32(127.0) == vals * (np.float32(1.0) / np.float32(127.0))
    return rng.choice(vals[ok], n)


def _inputs(M, K, N, seed, ties_rows=0):
    """bf16 x (M, K) (float32 values), int8 w (N, K), s_w (N,). Each row's
    abs-max is set to a value where the two s_a computations agree; the
    first ``ties_rows`` rows have abs-max 127 (s_a = inv = 1) and hold
    half-integers, so x * inv falls on ties."""
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((M, K)) * 0.3).astype(np.float32)
    cols = rng.integers(0, K, M)
    x[np.arange(M), cols] = _agreeing_absmax(rng, M) * rng.choice([-1.0, 1.0], M)
    if ties_rows:
        x[:ties_rows] = (rng.integers(-127, 127, (ties_rows, K)) + 0.5).astype(np.float32)
        x[:ties_rows, 0] = 127.0
    x = torch.from_numpy(x).to(torch.bfloat16).float().numpy()
    w = rng.integers(-127, 128, (N, K)).astype(np.int8)
    sw = (rng.random(N) * 0.01 + 1e-3).astype(np.float32)
    return x, w, sw


# (M, K, N): an M tail in the second block row and an N tail whose width is
# no multiple of 8 (bf16 output stored element-wise); M = 3 (the
# modulation's rows) with N = 200 (a multiple of 8: 16-byte stores of a
# partial tile); one K step (an odd count: the first register set only)
# with ties at abs-max 127
CASES = [
    ((200, 128, 300), 0),
    ((3, 192, 200), 0),
    ((130, 64, 264), 8),
]


@pytest.mark.parametrize("out_f32", [True, False], ids=["fp32_out", "bf16_out"])
@pytest.mark.parametrize("shape,ties", CASES)
def test_gemm_schedule_equals_plain_and_jax(shape, ties, out_f32):
    M, K, N = shape
    x, w, sw = _inputs(M, K, N, seed=M + K + N, ties_rows=ties)
    tx = torch.from_numpy(x).to(torch.bfloat16)
    s_a, inv = tgemm.fq_inputs(tx)
    if ties:
        assert (s_a[:ties] == 1).all() and (inv[:ties] == 1).all()
    x_bits = tx.view(torch.int16).numpy().view(np.uint16)
    got = gemm_schedule(x_bits, w.astype(np.int64), inv.numpy().reshape(-1), s_a.numpy().reshape(-1), sw, out_f32)
    dtype = torch.float32 if out_f32 else torch.bfloat16
    ref = tgemm.w8a8_fusedquant_matmul_ref(tx, torch.from_numpy(w), torch.from_numpy(sw), dtype)
    ref_np = ref.numpy() if out_f32 else ref.view(torch.int16).numpy()
    np.testing.assert_array_equal(got, ref_np)
    if out_f32:
        j_out = np.asarray(j_fq_matmul(jnp.asarray(x, jnp.bfloat16), jnp.asarray(w.T.copy()), jnp.asarray(sw),
                                       out_dtype=jnp.float32, interpret=True))
        np.testing.assert_array_equal(got, j_out)


@pytest.mark.parametrize("inv", [1.0, 1.0 / 127.0, 127.0 / 3.0, 0.7329, 45.123, 1e8])
def test_magic_rounding_equals_clamped_round_half_even_on_every_bf16(inv):
    bits = np.arange(1 << 16, dtype=np.uint32)
    x = (bits << 16).view(np.float32)
    x = x[np.isfinite(x)]
    got = quant_magic(x, inv)
    with np.errstate(over="ignore"):
        y = x * np.float32(inv)
    want = np.clip(np.rint(y), -127, 127).astype(np.int8)
    np.testing.assert_array_equal(got, want)
    if inv == 1.0:  # bf16 holds every half-integer up to 127.5: ties, rounded to even
        assert (np.abs(y - np.trunc(y)) == 0.5).sum() >= 2 * 127
    ref = torch.clamp(torch.round(torch.from_numpy(x) * np.float32(inv)), -127, 127).to(torch.int8).numpy()
    np.testing.assert_array_equal(got, ref)


def test_a_loads_and_output_staging_are_conflict_free():
    """The claims of the kernel's comment: each 8-byte A load of a half-warp
    touches 32 distinct banks (16 lanes x 2), the output staging writes and
    the 16-byte read-backs are conflict-free per access phase."""

    def banks(addr, nbytes):
        return np.stack([((addr + 4 * b) // 4) % 32 for b in range(nbytes // 4)], 1).reshape(-1)

    for s in range(2):
        for h in range(2):
            for i in range(2):
                addr = a_frag_addresses(s, h, i)
                for half in range(2):
                    lanes = slice(16 * half, 16 * half + 16)
                    assert len(set(banks(addr[lanes], 8))) == 32, (s, h, i, half)
    for elem in (4, 2):
        row_bytes, key = BN * elem, elem // 2
        for i in range(2):
            r = 16 * WARP[:32] + G[:32] + 8 * i
            for j in range(BN // 8):
                byte = (8 * j + 2 * Q[:32]) * elem
                addr = r * row_bytes + (((byte >> 4) ^ (key * G[:32])) << 4) + (byte & 15)
                if elem == 4:  # 8-byte stores: per half-warp
                    for half in range(2):
                        assert len(set(banks(addr[16 * half:16 * half + 16], 8))) == 32
                else:
                    assert len(set(banks(addr, 4))) == 32
        chunks = row_bytes // 16
        for idx0 in range(0, WG_ROWS * chunks, 32):
            idx = idx0 + np.arange(32)
            r, c = idx // chunks, idx % chunks
            addr = r * row_bytes + ((c ^ (key * (r % 8))) << 4)
            for quarter in range(4):  # 16-byte loads: per quarter-warp
                assert len(set(banks(addr[8 * quarter:8 * quarter + 8], 16))) == 32
