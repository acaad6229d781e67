"""The int8 attention kernel's order of work
(``opensora_torch/csrc/int8_flash_attention.cu``), emulated in numpy on the
CPU on the port's own quantize preamble (``kernel_inputs``) and held
against the port's plain version (``int8_flash_attention_ref``) and the JAX
package's Pallas kernels (``int8_flash_attention``, interpret mode, the
same ``block_k``).

The emulation follows the kernel: CTAs of 128 query rows, two consumers of
64; the compute tile BN = 128 keys unless block_k is no multiple of 128
(then 64), so compute tiles lie inside quantization tiles; the job list --
the compute tiles in order (qk8), or per quantization tile its compute
tiles twice, a row-max pass then the main pass (pv_int8); the s32 scores of
Q8 K8^T on the tile (Q and K rows past L zero, as the TMA fills them), keys
past Lk left out of the integer row max and given p = 0; s = float(s32) *
(sq * sk) in the log2 domain, the exponent fused with the anchor; the
anchor per (b, h) from a2 (a2 < 40) or the running max, advanced per
compute tile (qk8) or once per quantization tile (pv_int8), with the
rescale of o and l; qk8: P rounded to bf16 times the bf16 V tile (rows
past Lk zero); pv_int8: P8 = round(min(p * 127 / p_scale, 127)) packed
into the registers of the s8 A fragments from the thread's s32 score
registers (register r of k32 slice kc from score registers
4 (2 (2 kc + r / 2) + b / 2) + 2 (r % 2) + b % 2), read back through the
m16n8k32 A layout (row g + 8 (r % 2), physical key 16 (r / 2) + 4 q + b)
and multiplied with the key-permuted v8t tile of those physical positions;
the s32 products of a quantization tile's compute tiles summed and
dequantized once by p_scale / 127, sv applied once at the end, out = o (x
sv) / l, the bf16 output rounding, V's mean added back.

Tolerances. The emulation's fp32 output (before the output's bf16
rounding) against the port's plain version: the plain version's own
tolerance against JAX, tests/test_torch_int8_flash.py's FLIP (3e-3 of
max|ref| in any row) and FLIP_L2 (1e-3 relative L2): both quantize the same
inputs the same way; the kernel's schedule adds fp32 rounding in another
order, the anchors of its loops, and in qk8 mode P rounded to bf16 where
the fp32 inputs here leave the plain P unrounded (measured: at most 1.4e-3
in a row in qk8 mode, 3.4e-4 in int8 mode). Against JAX: FLIP_L2, and in a
row 2 * FLIP, for the plain version itself sits up to 4.6e-3 from JAX in
two rows of one case here (L = 1000, block_k 512, int8, running max: one
P8 = round(p * 127 / p_scale) a rounding boundary apart, the
discontinuity tests/test_torch_int8_flash.py describes), and the schedule
adds its FLIP to that. The emulated bf16 output against the plain
version: chip_smoke.py's INT8_ATTN_RTOL, 8e-3 of max|ref| (the bf16
rounding of the output adds up to 2^-9 of |out|; measured at most 3.6e-3).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opensora_tpu.ops.int8_flash import int8_flash_attention as jint8
from opensora_torch.ops import int8_flash as tint8

BLOCK_M, WG_ROWS, D = 128, 64, 128
FLIP, FLIP_L2 = 3e-3, 1e-3
INT8_ATTN_RTOL = 8e-3
MAGIC = np.float32(12582912.0)

THREADS = np.arange(128)
WARP, G, Q = THREADS // 32, (THREADS % 32) // 4, THREADS % 4


def compute_tile(nk: int, block_k: int) -> int:
    return 128 if nk == 1 or block_k % 128 == 0 else 64


def jobs(n_tiles: int, tpq: int, pv_int8: bool):
    """(tile, max_pass) of each job, as the kernel's job()."""
    out = []
    for i in range(2 * n_tiles if pv_int8 else n_tiles):
        if not pv_int8:
            out.append((i, False))
            continue
        qt, r = divmod(i, 2 * tpq)
        cnt = min(tpq, n_tiles - qt * tpq)
        out.append((qt * tpq + (r if r < cnt else r - cnt), r < cnt))
    return out


def f32(x):
    return np.asarray(x, np.float32)


def p8_fragments(p8: np.ndarray, bn: int) -> np.ndarray:
    """The consumer's (64, bn) P8 as the kernel packs it: (128 threads, bn /
    32, 4) uint32, from the s32 score registers s[4 j + 2 i + e] (row
    16 w + g + 8 i, key 8 j + 2 q + e)."""
    regs = np.zeros((128, bn // 2), np.int64)
    for idx in range(bn // 2):
        j, i, e = idx // 4, (idx >> 1) & 1, idx & 1
        regs[:, idx] = p8[16 * WARP + G + 8 * i, 8 * j + 2 * Q + e]
    pa = np.zeros((128, bn // 32, 4), np.uint32)
    for kc in range(bn // 32):
        for r in range(4):
            j0, i = 2 * (2 * kc + r // 2), r % 2
            for b in range(4):
                byte = regs[:, 4 * (j0 + b // 2) + 2 * i + b % 2].astype(np.uint32) & 0xFF
                pa[:, kc, r] |= byte << (8 * b)
    return pa


def a_matrix_s8(pa: np.ndarray, bn: int) -> np.ndarray:
    """(64, bn) int8 A of the P.V products over physical key positions, read
    from the registers through the s8 A layout of wgmma m64nNk32: register r
    of slice kc holds row 16 w + g + 8 (r % 2), keys 32 kc + 16 (r / 2) +
    4 q + b. Every element once."""
    out = np.zeros((WG_ROWS, bn), np.int64)
    seen = np.zeros((WG_ROWS, bn), np.int64)
    for kc in range(bn // 32):
        for r in range(4):
            for b in range(4):
                row = 16 * WARP + G + 8 * (r % 2)
                col = 32 * kc + 16 * (r // 2) + 4 * Q + b
                out[row, col] = ((pa[:, kc, r] >> (8 * b)) & 0xFF).astype(np.uint8).view(np.int8)
                seen[row, col] += 1
    assert (seen == 1).all()
    return out


def consumer(pre, pv_int8, bh, row0, lq, lk, bn, tpq):
    """One consumer's 64 rows of one (b, h): (o (x sv) / l) in fp32."""
    b, h = bh
    nk = pre["nk"]
    q8 = pre["q8"][b, h].numpy().astype(np.int64)
    k8 = pre["k8"][b, h].numpy().astype(np.int64)
    sk = pre["sk"][b, h, :, 0].numpy()
    a2 = np.float32(pre["a2"][b, h].item())
    anchored = a2 < 40.0
    rows = np.arange(row0, row0 + WG_ROWS)
    valid_rows = rows < lq
    qt_rows = np.zeros((WG_ROWS, D), np.int64)
    qt_rows[valid_rows] = q8[rows[valid_rows]]
    sq = np.where(valid_rows, pre["sq"][b, h, :, 0].numpy()[np.minimum(rows, lq - 1)], 0).astype(np.float32)
    if pv_int8:
        v8t = pre["vin"][b, h].numpy().astype(np.int64)  # (128, Lv), keys permuted
        lv = v8t.shape[1]
    else:
        v = pre["vin"][b, h].float().numpy()  # V as the preamble hands it (bf16 on the card)
    n_tiles = -(-lk // bn)
    o = np.zeros((WG_ROWS, D), np.float32)
    m = np.full(WG_ROWS, -1e30, np.float32)
    l = np.zeros(WG_ROWS, np.float32)
    anc = np.full(WG_ROWS, a2, np.float32)
    mq = np.zeros(WG_ROWS, np.int64)
    pmul = pdeq = None
    for tile, max_pass in jobs(n_tiles, tpq, pv_int8):
        qt = tile // tpq
        assert qt < nk and (nk == 1 or (tile * bn) // pre["block_k"] == ((tile + 1) * bn - 1) // pre["block_k"])
        n0 = tile * bn
        kt = np.zeros((bn, D), np.int64)  # K rows past Lk: zero (TMA)
        kt[:max(0, min(bn, lk - n0))] = k8[n0:n0 + bn]
        s32 = qt_rows @ kt.T
        assert np.abs(s32).max() < 2 ** 22  # the magic-number conversion's range
        keys_ok = (n0 + np.arange(bn)) < lk
        scale = f32(sq * np.float32(sk[qt]))
        imax = np.where(keys_ok[None, :], s32, np.iinfo(np.int64).min).max(axis=1)
        if pv_int8 and max_pass:
            mq = imax if tile == qt * tpq else np.maximum(mq, imax)
            continue
        if pv_int8:
            if tile == qt * tpq:
                tmax = f32(mq.astype(np.float32) * scale)
                if not anchored:
                    m_new = np.maximum(m, tmax)
                    m_safe = np.where(m_new <= -5e29, 0, m_new).astype(np.float32)
                    corr = np.exp2(f32(m - m_safe))
                    m, l, o, anc = m_new, f32(l * corr), f32(o * corr[:, None]), m_safe
                p_scale = np.maximum(np.exp2(f32(tmax - anc)), np.float32(1e-8)).astype(np.float32)
                pmul = f32(np.float32(127) / p_scale)
                pdeq = f32(p_scale * np.float32(1 / 127))
        elif not anchored:
            tmax = f32(imax.astype(np.float32) * scale)
            m_new = np.maximum(m, tmax)
            m_safe = np.where(m_new <= -5e29, 0, m_new).astype(np.float32)
            corr = np.exp2(f32(m - m_safe))
            m, l, o, anc = m_new, f32(l * corr), f32(o * corr[:, None]), m_safe
        x = f32(s32.astype(np.float64) * scale[:, None].astype(np.float64) - anc[:, None])  # one fma
        p = np.where(keys_ok[None, :], np.exp2(x), 0).astype(np.float32)
        l = f32(l + p.sum(axis=1, dtype=np.float32))
        if pv_int8:
            y = np.minimum(f32(p * pmul[:, None]), np.float32(127))
            p8 = ((f32(y + MAGIC).view(np.uint32) & 0xFF).astype(np.uint8)).astype(np.int64)
            assert np.array_equal(p8, np.rint(y).astype(np.int64))
            a = a_matrix_s8(p8_fragments(p8, bn), bn)
            vt = np.zeros((D, bn), np.int64)
            vt[:, :max(0, min(bn, lv - n0))] = v8t[:, n0:n0 + bn]
            pv32 = a @ vt.T if tile == qt * tpq else pv32 + a @ vt.T  # the quantization tile's sum
            assert np.abs(pv32).max() < 2 ** 31
            if tile == min((qt + 1) * tpq, n_tiles) - 1:  # its last compute tile: dequantize once
                o = f32(o + f32(pv32.astype(np.float32) * pdeq[:, None]))
        else:
            vt = np.zeros((bn, D), np.float32)  # V rows past Lk: zero (TMA)
            vt[:max(0, min(bn, lk - n0))] = v[n0:n0 + bn]
            pb = torch.from_numpy(p).to(torch.bfloat16).float().numpy()
            o = f32(o + pb @ vt)
    l_safe = np.where(l <= 0, 1, l).astype(np.float32)
    if pv_int8:
        o = f32(o * pre["sv"][b, h, 0].numpy()[None, :])
    return f32(o / l_safe[:, None])


def int8_attention_schedule(q, k, v, block_k, pv_int8):
    """(fp32 output before its bf16 rounding, the output as the wrapper
    returns it from the kernel's bf16): (B, H, Lq, D) each, V's mean added."""
    b, h, lq, _ = q.shape
    lk = k.shape[2]
    block_k = min(block_k, lk)
    pre = tint8.kernel_inputs(q, k, v, D ** -0.5, block_k, pv_int8)
    bn = compute_tile(pre["nk"], block_k)
    tpq = -(-lk // bn) if pre["nk"] == 1 else block_k // bn
    out = np.zeros((b, h, lq, D), np.float32)
    for bi in range(b):
        for hi in range(h):
            for m0 in range(0, lq, BLOCK_M):
                for wg in range(2):
                    row0 = m0 + WG_ROWS * wg
                    if row0 >= lq:
                        continue
                    rows = consumer(pre, pv_int8, (bi, hi), row0, lq, lk, bn, tpq)
                    out[bi, hi, row0:row0 + WG_ROWS] = rows[:lq - row0]
    rounded = torch.from_numpy(out).to(torch.bfloat16).float().numpy()
    if pv_int8:
        mean = pre["v_mean"].numpy()
        return out + mean, f32(rounded + mean)
    return out, rounded


def _qkv(shape, seed, scale):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal(shape).astype(np.float32) for _ in range(3))
    v += 0.5  # a common mode, which the int8 mode's smoothing takes out and adds back
    return q * scale, k * scale, v


def _rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / (np.linalg.norm(b) + 1e-12)


# (B, H, L): L = 200 fills one 128-key compute tile and part of another; L =
# 1000 no whole 128-key tile at its end. block_k 64 runs 64-key compute
# tiles, 128 and 512 128-key ones (512 covers L = 200: one quantization
# tile). Scale 1: the anchored loop; 4: the running max (a2 >= 40).
SHAPES = [(1, 2, 200), (1, 1, 1000)]


@pytest.mark.parametrize("scale", [1.0, 4.0], ids=["anchored", "running_max"])
@pytest.mark.parametrize("pv_int8", [False, True], ids=["qk8", "int8"])
@pytest.mark.parametrize("block_k", [64, 128, 512])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"L{s[2]}")
def test_int8_attention_schedule_matches_plain_and_jax(shape, block_k, pv_int8, scale):
    b, h, length = shape
    q, k, v = _qkv((b, h, length, D), seed=length + block_k, scale=scale)
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    a2 = tint8.quantize_inputs(tq, tk, tv, D ** -0.5, min(block_k, length), pv_int8)["a2"]
    assert bool((a2 < 40).all()) == (scale == 1.0)
    got, got_bf16 = int8_attention_schedule(tq, tk, tv, block_k, pv_int8)
    ref = tint8.int8_flash_attention_ref(tq, tk, tv, block_k=block_k, pv_int8=pv_int8).numpy()
    jref = np.asarray(jint8(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), block_q=128, block_k=block_k,
                            pv_int8=pv_int8, interpret=True))
    for want, row_tol in ((ref, FLIP), (jref, 2 * FLIP)):
        rows = np.abs(got - want).max(axis=-1) / np.abs(want).max()
        assert rows.max() <= row_tol and _rel_l2(got, want) <= FLIP_L2, (rows.max(), _rel_l2(got, want))
    assert np.abs(got_bf16 - ref).max() <= INT8_ATTN_RTOL * np.abs(ref).max()


def test_p8_fragments_need_the_v8t_permutation():
    """The s32 -> s8 register mapping reads physical key 4 q + b of each
    16-key group from the score register of logical key PERM_16[4 q + b]:
    P8 over physical positions is P8 over logical keys permuted by PERM_16,
    so a product with v8t as the preamble writes it (permuted) is P8 V8,
    and with V8 transposed but unpermuted it is not (the known-wrong output
    chip_smoke.py holds the kernel against)."""
    rng = np.random.default_rng(0)
    bn = 128
    p8 = rng.integers(0, 128, (WG_ROWS, bn))
    a = a_matrix_s8(p8_fragments(p8, bn), bn)
    perm = np.concatenate([16 * grp + np.array(tint8.PERM_16) for grp in range(bn // 16)])
    np.testing.assert_array_equal(a, p8[:, perm])
    v8 = torch.from_numpy(rng.integers(-127, 128, (1, 1, bn, D)).astype(np.int8))
    v8t = tint8._v8_transposed(v8)[0, 0].numpy().astype(np.int64)
    want = p8 @ v8[0, 0].numpy().astype(np.int64)
    np.testing.assert_array_equal(a @ v8t.T, want)
    unpermuted = v8[0, 0].numpy().astype(np.int64).T
    assert (a @ unpermuted.T != want).mean() > 0.9


def test_compute_tiles_lie_inside_quantization_tiles():
    """For every block_k the wrapper takes (a multiple of 64, or covering
    L), the kernel's compute tile divides it, and the job list visits each
    compute tile once per pass, the row-max pass of a quantization tile
    before its main pass."""
    for lk in (200, 1000, 8828):
        for block_k in (64, 128, 192, 512, 1536, 1664, lk):
            if block_k > lk:
                continue
            nk = -(-lk // block_k)
            bn = compute_tile(nk, block_k)
            n_tiles = -(-lk // bn)
            tpq = n_tiles if nk == 1 else block_k // bn
            assert nk == 1 or block_k % bn == 0
            js = jobs(n_tiles, tpq, True)
            assert sorted(t for t, mp in js if mp) == sorted(t for t, mp in js if not mp) == list(range(n_tiles))
            for qt in range(nk):
                own = [i for i, (t, _) in enumerate(js) if t // tpq == qt]
                passes = [js[i][1] for i in own]
                assert own == list(range(own[0], own[0] + len(own)))
                assert passes == sorted(passes, reverse=True)  # every row-max job first
            assert [t for t, _ in jobs(n_tiles, tpq, False)] == list(range(n_tiles))
