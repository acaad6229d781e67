"""The D = 128 flash-attention forward's order of work
(``opensora_torch/csrc/flash_attention_fwd_sm90.cu``), emulated in plain
PyTorch on the CPU and held against the JAX package's Pallas forward
(``flash_attention_with_lse`` -> ``_flash_forward``, interpret mode) and
the port's plain forward on the same numpy inputs.

The emulation follows the kernel: a CTA owns 128 query rows of one (b, h),
split into two consumers of 64 rows; each consumer walks the keys in tiles
of 128 up to the causal frontier of the CTA's last row; rows and keys
outside the tensors are zero (the TMA's fill); the mask is applied only on
the tiles the kernel masks (the tail tile, and under the frame-causal mask
the tiles that reach past the CTA's first frame), and the emulation checks
that every other tile needs none and that the tiles it skips hold no key a
row of the CTA sees; each (b, h) takes the anchored loop when its bound A
is below 40, else the running-max loop (the JAX kernel decides once for
all heads: the same function either way); P is rounded to bf16 before the
PV product, the row sum adds the fp32 p; rows that see no key keep m =
-1e30, anchor at 0 and divide by 1.

Tolerances, of max|ref| for the output and absolute for the LSE: in fp32
(no rounding inside), 1e-5 against both (the same sums in another order;
the LSE 1e-5). With bf16 inputs and the kernel's rounding points: 8e-3
against JAX (both round P and the output to bf16; a sum taken in another
order may round an element the other way: two bf16 ulps) and against the
fp32 plain forward (OUT_RTOL, as on the card), the LSE 1e-3 (fp32 on both
sides, as on the card).
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opensora_tpu.ops import flash_attention as jfa
from opensora_torch.ops import flash_attention as tfa
from opensora_torch.ops import ring_flash as tring

BLOCK_M, BLOCK_N, WG_ROWS = 128, 128, 64  # the kernel's CTA rows, key tile, consumer rows
ANCHOR_MAX_LOG2 = 40.0
LOG2E, LN2 = 1.4426950408889634, math.log(2.0)
NEG_INF = -1e30


def _pad_rows(x, n):
    return torch.nn.functional.pad(x, (0, 0, 0, n - x.shape[-2]))


def fwd_schedule(q, k, v, sm_scale, causal_block, anchor, round_bf16, q_off=0, k_off=0):
    """(out, lse) in the kernel's order of work; bf16 roundings where the
    kernel rounds when ``round_bf16``. ``anchor``: the (B, H) bounds of
    ``anchor_log2`` (read only when bidirectional); q_off, k_off: the
    global positions of local row 0 and key 0 under the causal mask."""
    rnd = (lambda x: x.to(torch.bfloat16).float()) if round_bf16 else (lambda x: x)
    b, h, lq, d = q.shape
    lk = k.shape[2]
    c = sm_scale * LOG2E
    n_m, n_kb = -(-lq // BLOCK_M), -(-lk // BLOCK_N)
    qp = _pad_rows(q.float(), n_m * BLOCK_M)
    kp, vp = (_pad_rows(x.float(), n_kb * BLOCK_N) for x in (k, v))
    out = torch.zeros(b, h, n_m * BLOCK_M, d)
    lse = torch.zeros(b, h, n_m * BLOCK_M)
    for bi in range(b):
        for hi in range(h):
            a2 = float(anchor[bi, hi]) if causal_block is None else math.nan
            anchored = a2 < ANCHOR_MAX_LOG2  # NaN -> the running-max loop
            for m0 in range(0, lq, BLOCK_M):
                kv_end = lk
                if causal_block is not None:
                    last_row = q_off + min(m0 + BLOCK_M, lq) - 1
                    kv_end = min(lk, max(0, (last_row // causal_block + 1) * causal_block - k_off))
                    cta_rows = torch.arange(q_off + m0, q_off + min(m0 + BLOCK_M, lq))
                    skipped = torch.arange(k_off + kv_end, k_off + lk)
                    assert not (skipped[None, :] // causal_block <= cta_rows[:, None] // causal_block).any()
                n_tiles = -(-kv_end // BLOCK_N)
                for wg in range(2):
                    r0 = m0 + WG_ROWS * wg
                    rows = torch.arange(r0, r0 + WG_ROWS)
                    o = torch.zeros(WG_ROWS, d)
                    m = torch.full((WG_ROWS,), NEG_INF)
                    l = torch.zeros(WG_ROWS)
                    for t in range(n_tiles):
                        n0 = t * BLOCK_N
                        keys = torch.arange(n0, n0 + BLOCK_N)
                        s = qp[bi, hi, r0:r0 + WG_ROWS] @ kp[bi, hi, n0:n0 + BLOCK_N].T
                        ok = (keys < lk)[None, :].expand(WG_ROWS, -1)
                        need_mask = n0 + BLOCK_N > lk
                        if causal_block is not None:
                            key_frame = (k_off + keys)[None, :] // causal_block
                            ok = ok & (key_frame <= (q_off + rows)[:, None] // causal_block)
                            need_mask = need_mask or (
                                (k_off + n0 + BLOCK_N - 1) // causal_block > (q_off + m0) // causal_block)
                        if need_mask:
                            s = torch.where(ok, s, torch.full_like(s, -math.inf))
                        else:
                            assert ok.all(), (m0, wg, n0)  # an unmasked tile needs no mask
                        if anchored:
                            p = torch.exp2(s * c - a2)
                        else:
                            m_new = torch.maximum(m, s.amax(-1) * c)
                            m_safe = torch.where(m_new <= NEG_INF * 0.5, torch.zeros_like(m_new), m_new)
                            corr = torch.exp2(m - m_safe)
                            m, l, o = m_new, l * corr, o * corr[:, None]
                            p = torch.exp2(s * c - m_safe[:, None])
                        l = l + p.sum(-1)
                        o = o + rnd(p) @ vp[bi, hi, n0:n0 + BLOCK_N]
                    if anchored:
                        m = torch.full_like(m, a2)
                    l_safe = torch.where(l == 0, torch.ones_like(l), l)
                    out[bi, hi, r0:r0 + WG_ROWS] = o / l_safe[:, None]
                    lse[bi, hi, r0:r0 + WG_ROWS] = m * LN2 + torch.log(l_safe)
    return rnd(out[:, :, :lq]), lse[:, :, :lq]


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / np.abs(b).max())


def _inputs(b, h, lq, lk, bf16, qscale=(1.0,), seed=0):
    """q, k, v as numpy; head hi of q scaled by qscale[hi % len(qscale)] (a
    scale of 4 puts that head's bound A above 40: the running-max loop)."""
    rng = np.random.default_rng(seed)
    d = 128
    q, k, v = (rng.standard_normal((b, h, n, d)).astype(np.float32) for n in (lq, lk, lk))
    q = q * np.asarray([qscale[i % len(qscale)] for i in range(h)], np.float32)[None, :, None, None]
    arrs = [q, k, v]
    if bf16:  # bf16-representable values, so both sides start from the same inputs
        arrs = [torch.from_numpy(a).to(torch.bfloat16).float().numpy() for a in arrs]
    return arrs


# (B, H, Lq, Lk), causal_block, per-head q scales: ragged lengths (tails of
# 128-row CTAs, of 64-row consumers and of 128-key tiles), L below one
# consumer, Lq != Lk both ways, frames that straddle tiles and CTAs, one
# (b, h) anchored beside one above A = 40, all heads running-max
CASES = [
    ((2, 2, 200, 200), None, (1.0, 4.0)),
    ((1, 2, 333, 333), None, (1.0, 4.0)),
    ((2, 1, 50, 50), None, (4.0,)),
    ((1, 2, 200, 333), None, (1.0,)),
    ((1, 2, 333, 200), None, (4.0, 1.0)),
    ((1, 2, 333, 333), 48, (1.0,)),
    ((2, 1, 200, 200), 96, (1.0,)),
    ((1, 1, 333, 200), 48, (1.0,)),
]


@pytest.mark.parametrize("bf16", [False, True], ids=["fp32", "bf16"])
@pytest.mark.parametrize("shape,causal_block,qscale", CASES)
def test_fwd_schedule_matches_jax_and_plain_forward(shape, causal_block, qscale, bf16):
    b, h, lq, lk = shape
    q, k, v = _inputs(b, h, lq, lk, bf16, qscale)
    sm_scale = 1.0 / math.sqrt(q.shape[-1])
    dtype = torch.bfloat16 if bf16 else torch.float32
    tq, tk, tv = (torch.from_numpy(x).to(dtype) for x in (q, k, v))
    anchor = tfa.anchor_log2(tq, tk, sm_scale)
    if causal_block is None:  # the case exercises the loops it names: q scale 1 anchored, 4 running max
        assert [bool(a < ANCHOR_MAX_LOG2) for a in anchor[0]] == [qscale[i % len(qscale)] == 1.0 for i in range(h)]
    out, lse = fwd_schedule(tq, tk, tv, sm_scale, causal_block, anchor, round_bf16=bf16)

    jdtype = jnp.bfloat16 if bf16 else jnp.float32
    j_out, j_lse = jfa.flash_attention_with_lse(*(jnp.asarray(x, jdtype) for x in (q, k, v)), sm_scale=sm_scale,
                                                block_q=128, block_k=128, causal_block=causal_block, interpret=True)
    ref_out, ref_lse = tfa.flash_attention_ref(*(torch.from_numpy(x) for x in (q, k, v)), sm_scale, causal_block)
    tol_out, tol_lse = (8e-3, 1e-3) if bf16 else (1e-5, 1e-5)
    got = out.float().numpy()
    assert _rel(got, np.asarray(j_out, np.float32)) <= tol_out, _rel(got, np.asarray(j_out, np.float32))
    assert _rel(got, ref_out.numpy()) <= tol_out, _rel(got, ref_out.numpy())
    assert np.abs(lse.numpy() - np.asarray(j_lse, np.float32)).max() <= tol_lse
    assert np.abs(lse.numpy() - ref_lse.numpy()).max() <= tol_lse


@pytest.mark.parametrize("q_off,k_off", [(0, 200), (100, 160), (300, 0)])
def test_fwd_schedule_guards_rows_that_see_no_key(q_off, k_off):
    """At the global offsets of a ring hop (the main loop's q_off, k_off)
    rows of frames before the shard's first key see no key: the kernel's
    guard gives them out = 0 and lse = -1e30 ln 2, finite, as the plain
    ring hop does (a one-hop ring: first and last); the other rows equal it
    to 1e-5."""
    q, k, v = (torch.from_numpy(x) for x in _inputs(1, 2, 200, 150, False, seed=3))
    sm_scale, cb = 128 ** -0.5, 48
    out, lse = fwd_schedule(q, k, v, sm_scale, cb, None, round_bf16=False, q_off=q_off, k_off=k_off)
    state = (torch.empty(1, 2, 200), torch.empty(1, 2, 200), torch.empty(1, 2, 200, 128))
    ref_out, ref_lse = torch.empty(1, 2, 200, 128), torch.empty(1, 2, 200)
    tring.ring_fwd_hop_ref(q, k, v, state, ref_out, ref_lse, sm_scale=sm_scale, causal_block=cb, q_off=q_off,
                           k_off=k_off, first=True, last=True)
    blind = (q_off + torch.arange(200)) // cb < k_off // cb
    assert torch.isfinite(out).all() and torch.isfinite(lse).all()
    assert bool((out[:, :, blind] == 0).all()) and bool((lse[:, :, blind] == NEG_INF * LN2).all())
    assert bool(blind.any()) == (q_off // cb < k_off // cb)
    assert _rel(out.numpy(), ref_out.numpy()) <= 1e-5
    assert np.abs(lse[:, :, ~blind].numpy() - ref_lse[:, :, ~blind].numpy()).max() <= 1e-5
