"""The W8A8 GEMM's order of work (``opensora_torch/csrc/int8_matmul_sm90.cu``),
both instantiations, emulated in numpy on the CPU and held against the
port's plain versions (``w8a8_matmul_ref``, ``w8a8_fusedquant_matmul_ref``)
and the JAX package's Pallas kernels (``w8a8_matmul``,
``w8a8_fusedquant_matmul``, interpret mode) on the same numpy inputs.

The emulation follows the kernel at the level of its addresses and
registers: persistent CTAs (grid = min(SM count, tiles)) walking 128 x 256
output tiles in the grouped order; a ring of stages in K steps of 64 that
continues across a CTA's tiles, filled by the producer as far ahead as its
empty barriers let it, each stage checked to hold the position its reader
waits for. The int8 instantiation: the int8 A tile laid out as the TMA's
64-byte swizzle writes it (16-byte chunk c of row r at c ^ ((r / 2) % 4)),
and both operands of each k32 product read back through their
shared-memory descriptors (desc_sw64: 512-byte 8-row atoms, the slice 32
bytes into the row, the swizzle applied to the address bits), the products
completing one stage late (wait depth 1: a stage is read when its products
complete and freed only then). The fused-quant instantiation: the bf16 A
tile as the 128-byte swizzle writes it; two consumers of 64 rows whose
threads read their A slice at the kernel's addresses (lanes with odd g on
the other 32-wide K slice), quantize four bf16 at a time by the float32
magic-number rounding (x * inv, clamp to +-127, + 1.5 * 2^23, the low
byte), pack them with the kernel's __byte_perm selectors and select them
into fragment order; the int8 A matrix of each k32 product read back from
those registers through the mma.m16n8k32 fragment layout (register r: row
g + 8 (r % 2), K 16 (r / 2) + 4 q + byte); wait depth 0. int32 sums; the
epilogue float(acc) * s_a * s_w in float32, staged at the kernel's
XOR-swizzled addresses in each consumer's own buffer of 512-byte rows (bf16:
all 256 columns; fp32: two passes of 128) and written back with its
16-byte (or element-wise) stores and tail masks.

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
from opensora_tpu.ops.int8_matmul import w8a8_matmul as j_matmul
from opensora_torch.ops import int8_matmul as tgemm

BM, BN, BK, WG_ROWS, GROUP_M = 128, 256, 64, 64, 8  # the kernel's tile, K step, consumer rows, tile groups
STAGES = {True: 6, False: 5}  # by A_INT8
OUT_ROW = 512  # bytes of a staged output row
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


def tile_origin(t: int, M: int, N: int):
    """(m0, n0) of output tile t: GROUP_M block rows share each weight tile."""
    grid_m, grid_n = -(-M // BM), -(-N // BN)
    in_group = GROUP_M * grid_n
    first_m = (t // in_group) * GROUP_M
    group_rows = min(grid_m - first_m, GROUP_M)
    return (first_m + (t % in_group) % group_rows) * BM, ((t % in_group) // group_rows) * BN


def cta_tiles(M: int, N: int, sms: int):
    """Each CTA's tiles, in its order: t = blockIdx.x, + gridDim.x, ..."""
    n_tiles = -(-M // BM) * -(-N // BN)
    grid = min(n_tiles, sms)
    return [[tile_origin(t, M, N) for t in range(b, n_tiles, grid)] for b in range(grid)]


THREADS = np.arange(128)
WARP, G, Q = THREADS // 32, (THREADS % 32) // 4, THREADS % 4


def swizzle128(tile: np.ndarray) -> np.ndarray:
    """A tile of 128-byte rows as the TMA's 128-byte swizzle writes it:
    16-byte chunk c of row r at c ^ (r % 8)."""
    logical = tile.reshape(tile.shape[0], 8, 16)
    smem = np.zeros_like(logical)
    for r in range(tile.shape[0]):
        smem[r, np.arange(8) ^ (r % 8)] = logical[r]
    return smem.reshape(-1)


def swizzle64(tile: np.ndarray) -> np.ndarray:
    """A tile of 64-byte rows as the TMA's 64-byte swizzle writes it: 16-byte
    chunk c of row r at c ^ ((r / 2) % 4)."""
    logical = tile.reshape(tile.shape[0], 4, 16)
    smem = np.zeros_like(logical)
    for r in range(tile.shape[0]):
        smem[r, np.arange(4) ^ ((r // 2) % 4)] = logical[r]
    return smem.reshape(-1)


def load_tile(src: np.ndarray, r0: int, rows: int, k0: int, width: int) -> np.ndarray:
    """Rows r0.., columns k0..k0+width of SRC as a TMA box: zero past the rows."""
    tile = np.zeros((rows, width), src.dtype)
    part = src[r0:r0 + rows, k0:k0 + width]
    tile[:part.shape[0]] = part
    return tile


def desc_sw64_read(smem: np.ndarray, start: int, rows: int) -> np.ndarray:
    """The (rows, 32) int8 K-major operand a wgmma reads through
    desc_sw64(START): row r, byte k at start + 512 (r / 8) + 64 (r % 8) + k,
    with the 64-byte swizzle on the address bits (bits 4-5 ^= bits 7-8)."""
    r = np.arange(rows)[:, None]
    k = np.arange(32)[None, :]
    logical = start + 512 * (r // 8) + 64 * (r % 8) + k
    physical = logical ^ (((logical >> 7) & 3) << 4)
    return smem[physical].view(np.int8).astype(np.int64)


def a_frag_addresses(s: int, h: int, i: int) -> np.ndarray:
    """Byte offset, in the consumer's 64 rows of a bf16 stage, of each
    thread's 8-byte load (s, h, i) (a_frags)."""
    odd = G & 1
    kk = s ^ odd
    r = 16 * WARP + G + 8 * i
    chunk = 4 * kk + 2 * h + (Q >> 1)
    return r * 2 * BK + ((chunk ^ G) << 4) + 8 * (Q & 1)


def a_frags(smem: np.ndarray, wg: int, inv_rows: np.ndarray) -> np.ndarray:
    """(128 threads, 8) uint32: a[4 kk + r] as the kernel builds it."""
    base = WG_ROWS * wg * 2 * BK
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


def staged_address(i: int, j: int, out_f32: bool) -> np.ndarray:
    """Byte offset, in a consumer's staging buffer, of each thread's store of
    accumulator pair d[4 j + 2 i], d[4 j + 2 i + 1] (column 8 j + 2 q of the
    tile; row 16 w + g + 8 i); fp32 stages columns 128 p.. in pass p."""
    elem = 4 if out_f32 else 2
    jj = j % (BN // 8 // (elem // 2))
    byte = (8 * jj + 2 * Q) * elem
    return (16 * WARP + G + 8 * i) * OUT_ROW + (((byte >> 4) ^ ((elem // 2) * G)) << 4) + (byte & 15)


def epilogue(acc: np.ndarray, out: np.ndarray, s_a, s_w, row0: int, n0: int, out_f32: bool) -> None:
    """One consumer: float(acc) * s_a * s_w (float32), staged pass by pass at
    the kernel's addresses, then read back in 16-byte chunks and stored
    with the M and N tails masked."""
    M, N = out.shape
    elem = 4 if out_f32 else 2
    passes = elem // 2
    sa = np.array([s_a[r] if r < M else 0 for r in range(row0, row0 + WG_ROWS)], np.float32)
    sw = np.array([s_w[c] if c < N else 0 for c in range(n0, n0 + BN)], np.float32)
    v = (acc.astype(np.float32) * sa[:, None]).astype(np.float32)
    v = (v * sw[None, :]).astype(np.float32)
    vals = v if out_f32 else torch.from_numpy(v).to(torch.bfloat16).view(torch.int16).numpy()
    chunks, per_chunk = OUT_ROW // 16, 16 // elem
    flat = out.view(np.uint8).reshape(-1)
    for p in range(passes):
        stage = np.zeros(WG_ROWS * OUT_ROW, np.uint8)
        written = np.zeros(WG_ROWS * OUT_ROW, np.int64)
        for j in range(p * BN // 8 // passes, (p + 1) * BN // 8 // passes):
            for i in range(2):
                addr = staged_address(i, j, out_f32)
                r = 16 * WARP + G + 8 * i
                pair = np.stack([vals[r, 8 * j + 2 * Q], vals[r, 8 * j + 2 * Q + 1]], 1).copy().view(np.uint8)
                for b in range(2 * elem):
                    stage[addr + b] = pair[:, b]
                    written[addr + b] += 1
        assert (written == 1).all()
        for idx in range(WG_ROWS * chunks):
            r, c = divmod(idx, chunks)
            row, col = row0 + r, n0 + p * BN // passes + c * per_chunk
            if row >= M or col >= N:
                continue
            src = stage[r * OUT_ROW + ((c ^ ((elem // 2) * (r % 8))) << 4):][:16]
            n_el = per_chunk if N % per_chunk == 0 else min(per_chunk, N - col)  # the 16-byte store, or elements
            dst = (row * N + col) * elem
            flat[dst:dst + n_el * elem] = src[:n_el * elem]


class Ring:
    """The stages, their full and empty barriers (phases completed), and the
    producer, which fills position it into stage it % S once the stage's
    previous position has been freed by both consumers."""

    def __init__(self, a_int8: bool, loads):
        self.s = STAGES[a_int8]
        self.a_int8, self.loads, self.it = a_int8, loads, 0
        self.slots = [None] * self.s
        self.full = [0] * self.s
        self.empty = [0] * self.s

    def produce(self):
        while self.it < len(self.loads):
            st = self.it % self.s
            if self.it >= self.s and self.empty[st] < self.it // self.s:  # mbar_wait(empty, (it / S - 1) & 1)
                return
            a_tile, b_tile = self.loads[self.it]()
            self.slots[st] = (self.it, a_tile, b_tile)
            self.full[st] += 1
            self.it += 1

    def wait_full(self, i):
        """The consumer's wait at position i: the stage holds position i."""
        self.produce()
        st = i % self.s
        assert self.full[st] == i // self.s + 1 and self.slots[st][0] == i
        return st

    def read(self, i):
        st = i % self.s
        assert self.slots[st][0] == i, "a stage was overwritten before its products completed"
        return self.slots[st][1:]

    def free(self, i):
        self.empty[i % self.s] += 1  # both consumers' arrivals
        self.produce()


def gemm_schedule(a_int8, x, w, inv, s_a, s_w, out_f32, sms):
    """The kernel's output (M, N): float32, or bf16 as int16 bits. X: int8
    values (int8 instantiation) or bf16 bit patterns (uint16)."""
    M, K = x.shape
    N = w.shape[0]
    out = np.zeros((M, N), np.float32 if out_f32 else np.int16)
    ctas = cta_tiles(M, N, sms)
    assert sorted(t for c in ctas for t in c) == sorted(
        (m0, n0) for m0 in range(0, M, BM) for n0 in range(0, N, BN))
    inv_p = np.zeros(-(-M // BM) * BM + BM, np.float32)
    inv_p[:M] = inv
    w8 = w.astype(np.int8).view(np.uint8)
    x_bytes = x.astype(np.int8).view(np.uint8) if a_int8 else x.view(np.uint8).reshape(M, 2 * K)
    for tiles in ctas:
        def load(m0, n0, k0):
            a_tile = load_tile(x_bytes, m0, BM, k0 * (1 if a_int8 else 2), BK * (1 if a_int8 else 2))
            b_tile = load_tile(w8, n0, BN, k0, BK)
            return (swizzle64(a_tile) if a_int8 else swizzle128(a_tile)), swizzle64(b_tile)

        ring = Ring(a_int8, [lambda m0=m0, n0=n0, k0=k0: load(m0, n0, k0)
                             for m0, n0 in tiles for k0 in range(0, K, BK)])
        it = 0
        for m0, n0 in tiles:
            acc = [np.zeros((WG_ROWS, BN), np.int64) for _ in range(2)]
            pending = []  # positions whose products are in flight

            def complete(i):
                a_smem, b_smem = ring.read(i)
                for wg in range(2):
                    for kk in range(BK // 32):
                        b = desc_sw64_read(b_smem, 32 * kk, BN)
                        if a_int8:
                            a = desc_sw64_read(a_smem, WG_ROWS * wg * BK + 32 * kk, WG_ROWS)
                        else:
                            rows = slice(m0 + WG_ROWS * wg, m0 + WG_ROWS * (wg + 1))
                            a = a_matrix(a_frags(a_smem, wg, inv_p[rows]))[:, 32 * kk:32 * kk + 32]
                        acc[wg] += a @ b.T

            n_k = K // BK
            for kt in range(n_k):
                i = it + kt
                ring.wait_full(i)
                pending.append(i)
                if a_int8:  # commit, wait<1>: the previous group completes, its stage is freed
                    while len(pending) > 1:
                        done = pending.pop(0)
                        complete(done)
                        ring.free(done)
                else:  # wait<0>, free this stage
                    complete(pending.pop())
                    ring.free(i)
            for done in pending:  # wait<0>, free the last stage
                complete(done)
                ring.free(done)
            it += n_k
            for wg in range(2):
                assert np.abs(acc[wg]).max() < 2 ** 31
                epilogue(acc[wg], out, s_a, s_w, m0 + WG_ROWS * wg, n0, out_f32)
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
# partial tile); one K step with ties at abs-max 127
CASES = [
    ((200, 128, 300), 0),
    ((3, 192, 200), 0),
    ((130, 64, 264), 8),
]


@pytest.mark.parametrize("out_f32", [True, False], ids=["fp32_out", "bf16_out"])
@pytest.mark.parametrize("shape,ties", CASES)
def test_gemm_schedule_equals_plain_and_jax(shape, ties, out_f32):
    """The fused-quant instantiation, one tile a CTA where the card has SMs
    enough, and with two CTAs walking the tiles (sms=2)."""
    M, K, N = shape
    x, w, sw = _inputs(M, K, N, seed=M + K + N, ties_rows=ties)
    tx = torch.from_numpy(x).to(torch.bfloat16)
    s_a, inv = tgemm.fq_inputs(tx)
    if ties:
        assert (s_a[:ties] == 1).all() and (inv[:ties] == 1).all()
    x_bits = tx.view(torch.int16).numpy().view(np.uint16)
    dtype = torch.float32 if out_f32 else torch.bfloat16
    ref = tgemm.w8a8_fusedquant_matmul_ref(tx, torch.from_numpy(w), torch.from_numpy(sw), dtype)
    ref_np = ref.numpy() if out_f32 else ref.view(torch.int16).numpy()
    for sms in (132, 2):
        got = gemm_schedule(False, x_bits, w, inv.numpy().reshape(-1), s_a.numpy().reshape(-1), sw, out_f32, sms)
        np.testing.assert_array_equal(got, ref_np)
    if out_f32:
        j_out = np.asarray(j_fq_matmul(jnp.asarray(x, jnp.bfloat16), jnp.asarray(w.T.copy()), jnp.asarray(sw),
                                       out_dtype=jnp.float32, interpret=True))
        np.testing.assert_array_equal(got, j_out)


# (M, K, N, SMs): the path's tails at small K -- M = 3 (the modulation), an
# M and N tail (m_and_n_tails' N = 200), an N no multiple of 8 -- and, with
# fewer CTAs than tiles, CTAs walking several tiles whose K loops run the
# ring through many wraps (7 and 3 positions a tile against 6 stages)
INT8_CASES = [
    (3, 128, 200, 132),
    (200, 448, 300, 2),
    (300, 192, 520, 3),
]


@pytest.mark.parametrize("out_f32", [True, False], ids=["fp32_out", "bf16_out"])
@pytest.mark.parametrize("m,k,n,sms", INT8_CASES)
def test_int8_gemm_schedule_equals_plain_and_jax(m, k, n, sms, out_f32):
    """The int8 instantiation (w8a8_matmul): equal in every element to the
    plain version and to JAX's _w8a8_kernel."""
    rng = np.random.default_rng(m + k + n)
    x8 = rng.integers(-127, 128, (m, k)).astype(np.int8)
    w = rng.integers(-127, 128, (n, k)).astype(np.int8)
    sa = (rng.random((m, 1)) * 0.01 + 1e-3).astype(np.float32)
    sw = (rng.random(n) * 0.01 + 1e-3).astype(np.float32)
    got = gemm_schedule(True, x8, w, None, sa.reshape(-1), sw, out_f32, sms)
    dtype = torch.float32 if out_f32 else torch.bfloat16
    ref = tgemm.w8a8_matmul_ref(*(torch.from_numpy(a) for a in (x8, w, sa, sw)), dtype)
    np.testing.assert_array_equal(got, ref.numpy() if out_f32 else ref.view(torch.int16).numpy())
    j_out = jnp.asarray(j_matmul(jnp.asarray(x8), jnp.asarray(w.T.copy()), jnp.asarray(sa), jnp.asarray(sw),
                                 out_dtype=jnp.float32 if out_f32 else jnp.bfloat16, interpret=True))
    j_np = np.asarray(j_out) if out_f32 else np.asarray(j_out.view(jnp.int16))
    np.testing.assert_array_equal(got, j_np)


def test_swizzled_int8_a_tile_is_read_back_unchanged_and_an_unswizzled_read_is_not():
    """The 64-byte swizzle the TMA writes and the descriptor reads agree: each
    k32 slice of every consumer's rows comes back as loaded. Read as if the
    tile were unswizzled, it does not (the known-wrong output that
    chip_smoke.py holds the kernel against)."""
    rng = np.random.default_rng(0)
    tile = rng.integers(-127, 128, (BM, BK)).astype(np.int8)
    smem = swizzle64(tile.view(np.uint8))
    for wg in range(2):
        for kk in range(2):
            got = desc_sw64_read(smem, WG_ROWS * wg * BK + 32 * kk, WG_ROWS)
            np.testing.assert_array_equal(got, tile[WG_ROWS * wg:WG_ROWS * (wg + 1), 32 * kk:32 * kk + 32])
    r = np.arange(WG_ROWS)[:, None]
    flat = smem[(64 * r + np.arange(32)[None, :])].view(np.int8)
    assert (flat != tile[:WG_ROWS, :32]).mean() > 0.5


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
    for out_f32 in (True, False):
        elem = 4 if out_f32 else 2
        for i in range(2):
            for j in range(BN // 8):
                addr = staged_address(i, j, out_f32)[:32]
                if elem == 4:  # 8-byte stores: per half-warp
                    for half in range(2):
                        assert len(set(banks(addr[16 * half:16 * half + 16], 8))) == 32
                else:
                    assert len(set(banks(addr, 4))) == 32
        chunks = OUT_ROW // 16
        for idx0 in range(0, WG_ROWS * chunks, 32):
            idx = idx0 + np.arange(32)
            r, c = idx // chunks, idx % chunks
            addr = r * OUT_ROW + ((c ^ ((elem // 2) * (r % 8))) << 4)
            for quarter in range(4):  # 16-byte loads: per quarter-warp
                assert len(set(banks(addr[8 * quarter:8 * quarter + 8], 16))) == 32
