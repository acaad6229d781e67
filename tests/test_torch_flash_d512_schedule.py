"""The D = 512 flash-attention kernels' order of work
(``opensora_torch/csrc/flash_attention_fwd_d512_sm90.cu`` and
``flash_attention_bwd_d512_sm90.cu``, the HunyuanVAE mid-block), emulated in
plain PyTorch on the CPU and held against the JAX package's Pallas forward
and backward (interpret mode) and the port's plain versions on the same
numpy inputs.

The forward's emulation follows the kernel: a CTA owns 64 query rows x all
512 columns of one (b, h) and walks the keys in tiles of 64 up to the
causal frontier of its last row (the emulation checks that the keys it
skips are seen by no row of the CTA); consumer w computes S for keys 32 w
.. 32 w + 31 of each tile and holds O[:, 256 w ..]; rows and keys outside
the tensors are zero (the TMA's fill) and the mask is applied only on the
tiles the kernel masks (the emulation checks that every other tile needs
none); in the running-max loop each consumer takes its rows' maxima over
its own keys and the row max is the larger of the two consumers' (the
exchange), both rescale their own O and row-sum share by it; P of the
whole tile (both halves) is rounded to bf16 for P V; the row sums of the
two consumers are added once at the end.

The backward's emulation follows its two kinds of CTA, one per 64-key
block: the dV CTA walks 64-row query tiles from the causal first tile,
consumer w computing S^T for queries 32 w .. 32 w + 31, P^T rounded to
bf16, dV[:, 256 w ..] += P^T dO; the dK / dQ CTA walks 32-row query tiles,
S^T (consumer 0) and dP^T (consumer 1) over all 512 columns, dS^T = P^T
(dP^T - delta) rounded to bf16, dK[:, 256 w ..] += dS^T Q and the four
64-column blocks of dQ^T = K^T dS^T added into the fp32 dq_accum in the
kernel's layout (``dq_rows_to_accum``), read back by the epilogue's
map; sm_scale multiplies dK and dQ at the end.

Tolerances, of max|ref| for outputs and gradients and absolute for the
LSE: in fp32 (no rounding inside), 1e-5 against both (the same sums in
another order), the LSE 1e-5 of max(1, |lse|) (its logits are fp32 sums
over 512 columns: at |lse| ~ 15 a sum in another order moves it by ten
fp32 ulps, 1e-5 absolute). With bf16 inputs and the kernels' rounding points: the
output 8e-3 and the LSE 1e-3, against JAX and the fp32 plain forward
(OUT_RTOL and LSE_TOL, as on the card); the gradients 8e-3 against JAX (two
bf16 ulps: both sides round P, dS and the outputs, and a sum taken in
another order may round an element the other way) and 1e-2 against the
fp32 plain backward (BWD_RTOL, as on the card). The emulation with one of
the kernel's design faults (the row maxima or row sums not exchanged, P of
the previous key tile, one consumer's columns from the other's, dV from the
previous query tile's P, one key block's dQ adds dropped) exceeds those
limits.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opensora_tpu.ops import flash_attention as jfa
from opensora_torch.ops import flash_attention as tfa

D = 512
BLOCK = 64  # query rows of a forward CTA, keys of a tile and of a backward CTA, query rows of a dV tile
QT = 32  # query rows of a dK / dQ tile
HALF = 32  # the keys (forward) or queries (dV CTA) of a tile each consumer computes S for
COLS = 256  # the accumulator columns a consumer holds
ANCHOR_MAX_LOG2 = 40.0
LOG2E, LN2 = 1.4426950408889634, math.log(2.0)
NEG_INF = -1e30


def _pad_rows(x, n):
    return torch.nn.functional.pad(x, (0, 0) * (x.dim() == 2) + (0, n - x.shape[0]))


def _frontier(lk, last_row, causal_block):
    """The key bound of a CTA whose last row is ``last_row``."""
    return lk if causal_block is None else min(lk, (last_row // causal_block + 1) * causal_block)


def fwd_schedule(q, k, v, sm_scale, causal_block, anchor, round_bf16, fault=None):
    """(out, lse) in the forward kernel's order of work, bf16 roundings
    where it rounds when ``round_bf16``; ``fault`` one of FWD_FAULTS."""
    rnd = (lambda x: x.to(torch.bfloat16).float()) if round_bf16 else (lambda x: x)
    b, h, lq, d = q.shape
    lk = k.shape[2]
    c = sm_scale * LOG2E
    n_m, n_kb = -(-lq // BLOCK), -(-lk // BLOCK)
    out = torch.zeros(b, h, n_m * BLOCK, d)
    lse = torch.zeros(b, h, n_m * BLOCK)
    for bi in range(b):
        for hi in range(h):
            qp = _pad_rows(q[bi, hi].float(), n_m * BLOCK)
            kp, vp = (_pad_rows(x[bi, hi].float(), n_kb * BLOCK) for x in (k, v))
            a2 = float(anchor[bi, hi]) if causal_block is None else math.nan
            anchored = a2 < ANCHOR_MAX_LOG2  # NaN -> the running-max loop
            for m0 in range(0, lq, BLOCK):
                rows = torch.arange(m0, m0 + BLOCK)
                kv_end = _frontier(lk, min(m0 + BLOCK, lq) - 1, causal_block)
                if causal_block is not None:  # the skipped keys are seen by no row of the CTA
                    skipped = torch.arange(kv_end, lk)
                    assert not (skipped[None, :] // causal_block <= rows[:lq - m0, None] // causal_block).any()
                m = [torch.full((BLOCK,), NEG_INF) for _ in range(2)]  # each consumer's copy
                l = [torch.zeros(BLOCK) for _ in range(2)]
                o = [torch.zeros(BLOCK, COLS) for _ in range(2)]
                p_prev = torch.zeros(BLOCK, BLOCK)
                for n0 in range(0, kv_end, BLOCK):
                    need_mask = n0 + BLOCK > lk
                    if causal_block is not None:
                        need_mask = need_mask or (n0 + BLOCK - 1) // causal_block > m0 // causal_block
                    s = []
                    for w in range(2):  # consumer w: keys n0 + 32 w ..
                        keys = torch.arange(n0 + HALF * w, n0 + HALF * (w + 1))
                        sw = qp[m0:m0 + BLOCK] @ kp[keys].T
                        ok = (keys < lk)[None, :].expand(BLOCK, -1)
                        if causal_block is not None:
                            ok = ok & (keys[None, :] // causal_block <= rows[:, None] // causal_block)
                        if need_mask:
                            sw = torch.where(ok, sw, torch.full_like(sw, -math.inf))
                        else:
                            assert ok.all(), (m0, n0, w)  # an unmasked tile needs no mask
                        s.append(sw)
                    if anchored:
                        ps = [torch.exp2(sw * c - a2) for sw in s]
                    else:
                        mx = [sw.amax(-1) for sw in s]  # each consumer's maxima over its own keys
                        if fault != "row_max_not_exchanged":
                            mx = [torch.maximum(mx[0], mx[1])] * 2  # the exchange: both take the larger
                        m_new = [torch.maximum(m[w], mx[w] * c) for w in range(2)]
                        m_safe = [torch.where(x <= NEG_INF * 0.5, torch.zeros_like(x), x) for x in m_new]
                        for w in range(2):
                            corr = torch.exp2(m[w] - m_safe[w])
                            l[w], o[w] = l[w] * corr, o[w] * corr[:, None]
                        ps = [torch.exp2(s[w] * c - m_safe[w][:, None]) for w in range(2)]
                        m = m_new
                    for w in range(2):
                        l[w] = l[w] + ps[w].sum(-1)
                    p = torch.cat(ps, -1)  # P of the whole tile, both consumers' halves
                    p_used = p_prev if fault == "p_of_previous_key_tile" else p
                    for w in range(2):
                        o[w] = o[w] + rnd(p_used) @ vp[n0:n0 + BLOCK, COLS * w:COLS * (w + 1)]
                    p_prev = p
                total = l[0] + l[1]  # the row sums added across the consumers, once
                for w in range(2):
                    lw = l[w] if fault == "row_sum_not_exchanged" else total
                    src = 0 if fault == "consumer_columns_from_other" else w
                    out[bi, hi, m0:m0 + BLOCK, COLS * w:COLS * (w + 1)] = o[src] / torch.where(
                        lw == 0, torch.ones_like(lw), lw)[:, None]
                l0 = l[0] if fault == "row_sum_not_exchanged" else total
                m_lse = torch.full_like(m[0], a2) if anchored else m[0]  # consumer 0 writes the LSE
                lse[bi, hi, m0:m0 + BLOCK] = m_lse * LN2 + torch.log(torch.where(l0 == 0, torch.ones_like(l0), l0))
    return rnd(out[:, :, :lq]), lse[:, :, :lq]


FWD_FAULTS = ("row_max_not_exchanged", "row_sum_not_exchanged", "p_of_previous_key_tile",
              "consumer_columns_from_other")


def bwd_schedule(q, k, v, do, lse, delta, sm_scale, causal_block, round_bf16, fault=None):
    """(dq, dk, dv) in the backward kernel's order of work (its dV CTAs and
    its dK / dQ CTAs), bf16 roundings where it rounds when ``round_bf16``;
    ``fault`` one of BWD_FAULTS."""
    rnd = (lambda x: x.to(torch.bfloat16).float()) if round_bf16 else (lambda x: x)
    b, h, lq, d = q.shape
    lk = k.shape[2]
    c = sm_scale * LOG2E
    n_kb, n_q64, n_q32 = -(-lk // BLOCK), -(-lq // BLOCK), -(-lq // QT)
    lse = lse.float()
    lse2 = torch.where(lse <= NEG_INF * 0.5, torch.zeros_like(lse), lse) * LOG2E
    dk = torch.zeros(b, h, n_kb * BLOCK, d)
    dv = torch.zeros_like(dk)
    dq_accum = torch.zeros(b, h, n_q32 * QT, d)  # the kernel's layout
    for bi in range(b):
        for hi in range(h):
            qp, dop = (_pad_rows(x[bi, hi].float(), n_q64 * BLOCK) for x in (q, do))
            kp, vp = (_pad_rows(x[bi, hi].float(), n_kb * BLOCK) for x in (k, v))
            l2 = _pad_rows(lse2[bi, hi][:, None], n_q64 * BLOCK)[:, 0]  # 0 past Lq
            dl = _pad_rows(delta[bi, hi].float()[:, None], n_q64 * BLOCK)[:, 0]
            for n0 in range(0, lk, BLOCK):
                keys = torch.arange(n0, n0 + BLOCK)

                def probs(q0, n):  # P^T of the block's keys x queries q0 .. q0 + n - 1
                    queries = torch.arange(q0, q0 + n)
                    pt = torch.exp2((kp[n0:n0 + BLOCK] @ qp[q0:q0 + n].T) * c - l2[q0:q0 + n][None, :])
                    ok = (keys[:, None] < lk) & (queries[None, :] < lq)
                    need_mask = n0 + BLOCK > lk or q0 + n > lq
                    if causal_block is not None:
                        ok &= keys[:, None] // causal_block <= queries[None, :] // causal_block
                        need_mask = need_mask or (n0 + BLOCK - 1) // causal_block > q0 // causal_block
                    if need_mask:
                        return torch.where(ok, pt, torch.zeros_like(pt))
                    assert ok.all(), (n0, q0)  # an unmasked tile needs no mask
                    return pt

                def first_tile(rows):  # frames before the block's first key frame see none of its keys
                    if causal_block is None:
                        return 0
                    first = min((n0 // causal_block) * causal_block // rows, -(-lq // rows))
                    seen = torch.arange(first * rows)[None, :] // causal_block >= keys[:, None] // causal_block
                    assert not (seen & (keys[:, None] < lk)).any(), (n0, rows)
                    return first

                # the dV CTA: 64-row query tiles, consumer w the S^T of queries 32 w ..
                dv_w = [torch.zeros(BLOCK, COLS) for _ in range(2)]
                pt_prev = torch.zeros(BLOCK, BLOCK)
                for t in range(first_tile(BLOCK), n_q64):
                    q0 = BLOCK * t
                    pt = torch.cat([probs(q0 + HALF * w, HALF) for w in range(2)], -1)
                    p_used = pt_prev if fault == "dv_from_previous_query_tile_p" else pt
                    for w in range(2):
                        dv_w[w] += rnd(p_used) @ dop[q0:q0 + BLOCK, COLS * w:COLS * (w + 1)]
                    pt_prev = pt
                dv[bi, hi, n0:n0 + BLOCK] = torch.cat(dv_w, -1)

                # the dK / dQ CTA: 32-row query tiles; S^T by consumer 0, dP^T by consumer 1
                dk_w = [torch.zeros(BLOCK, COLS) for _ in range(2)]
                for t in range(first_tile(QT), n_q32):
                    q0 = QT * t
                    pt = probs(q0, QT)
                    dpt = vp[n0:n0 + BLOCK] @ dop[q0:q0 + QT].T  # handed to consumer 0 in fp32
                    dst = rnd(pt * (dpt - dl[q0:q0 + QT][None, :]))
                    for w in range(2):
                        dk_w[w] += dst @ qp[q0:q0 + QT, COLS * w:COLS * (w + 1)]
                        for mb in range(4):  # dQ^T[256 w + 64 mb ..] = K^T dS^T, added into dq_accum
                            cols = slice(COLS * w + 64 * mb, COLS * w + 64 * (mb + 1))
                            if fault == "dq_key_block_dropped" and n0 == BLOCK:
                                continue
                            part = torch.zeros(1, 1, QT, d)
                            part[0, 0, :, cols] = (kp[n0:n0 + BLOCK, cols].T @ dst).T
                            dq_accum[bi, hi, q0:q0 + QT] += tfa.dq_rows_to_accum(part)[0, 0]
                dk[bi, hi, n0:n0 + BLOCK] = torch.cat(dk_w, -1) * sm_scale
    dq = tfa.dq_accum_to_rows(dq_accum, lq) * sm_scale  # the epilogue's map
    return tuple(rnd(x) for x in (dq, dk[:, :, :lk], dv[:, :, :lk]))


BWD_FAULTS = ("dv_from_previous_query_tile_p", "dq_key_block_dropped")


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / np.abs(b).max())


def _inputs(b, h, lq, lk, bf16, qscale=(1.0,), seed=0):
    """q, k, v, dO as numpy; head hi of q scaled by qscale[hi % len(qscale)]
    (0.5 puts a (b, h)'s bound A near 20, the anchored loop; 4 near 160, the
    running-max loop)."""
    rng = np.random.default_rng(seed)
    q, k, v, do = (rng.standard_normal((b, h, n, D)).astype(np.float32) for n in (lq, lk, lk, lq))
    q = q * np.asarray([qscale[i % len(qscale)] for i in range(h)], np.float32)[None, :, None, None]
    arrs = [q, k, v, do]
    if bf16:  # bf16-representable values, so both sides start from the same inputs
        arrs = [torch.from_numpy(a).to(torch.bfloat16).float().numpy() for a in arrs]
    return arrs


# (B, H, Lq, Lk), causal_block, per-head q scales: frame-causal with frames
# that straddle tiles, both loops of the bidirectional call side by side,
# Lq != Lk both ways, and L below one 32-row tile (it fills no tile)
CASES = [
    ((1, 1, 600, 600), 96, (1.0,)),
    ((1, 2, 300, 300), None, (0.5, 4.0)),
    ((1, 2, 200, 333), None, (0.5,)),
    ((1, 1, 333, 200), 48, (1.0,)),
    ((1, 1, 20, 20), None, (4.0,)),
]


def _torch(arrs, dtype):
    return [torch.from_numpy(x).to(dtype) for x in arrs]


@pytest.mark.parametrize("bf16", [False, True], ids=["fp32", "bf16"])
@pytest.mark.parametrize("shape,causal_block,qscale", CASES)
def test_fwd_schedule_matches_jax_and_plain_forward(shape, causal_block, qscale, bf16):
    b, h, lq, lk = shape
    q, k, v, _ = _inputs(b, h, lq, lk, bf16, qscale)
    sm_scale = D ** -0.5
    tq, tk, tv = _torch((q, k, v), torch.bfloat16 if bf16 else torch.float32)
    anchor = tfa.anchor_log2(tq, tk, sm_scale)
    if causal_block is None:  # the case runs the loops it names: q scale <= 1 anchored, 4 running max
        assert [bool(a < ANCHOR_MAX_LOG2) for a in anchor[0]] == [qscale[i % len(qscale)] <= 1.0 for i in range(h)]
    out, lse = fwd_schedule(tq, tk, tv, sm_scale, causal_block, anchor, round_bf16=bf16)

    jdtype = jnp.bfloat16 if bf16 else jnp.float32
    j_out, j_lse = jfa.flash_attention_with_lse(*(jnp.asarray(x, jdtype) for x in (q, k, v)), sm_scale=sm_scale,
                                                block_q=128, block_k=128, causal_block=causal_block, interpret=True)
    ref_out, ref_lse = tfa.flash_attention_ref(*(torch.from_numpy(x) for x in (q, k, v)), sm_scale, causal_block)
    tol_out = 8e-3 if bf16 else 1e-5
    # the LSE: 1e-3 absolute in bf16; in fp32 1e-5 of max(1, |lse|)
    tol_lse = 1e-3 if bf16 else 1e-5 * max(1.0, float(ref_lse.abs().max()))
    got = out.float().numpy()
    assert _rel(got, np.asarray(j_out, np.float32)) <= tol_out, _rel(got, np.asarray(j_out, np.float32))
    assert _rel(got, ref_out.numpy()) <= tol_out, _rel(got, ref_out.numpy())
    assert np.abs(lse.numpy() - np.asarray(j_lse, np.float32)).max() <= tol_lse
    assert np.abs(lse.numpy() - ref_lse.numpy()).max() <= tol_lse


@pytest.mark.parametrize("fault", FWD_FAULTS)
def test_fwd_schedule_with_a_design_fault_fails_the_limits(fault):
    """Each design fault of the forward, on a frame-causal case (the
    running-max loop; the row-max exchange matters only there), puts the
    output or the LSE outside the card's limits (8e-3 of max|ref|, 1e-3)."""
    q, k, v, _ = _torch(_inputs(1, 1, 600, 600, True), torch.bfloat16)
    sm_scale = D ** -0.5
    out, lse = fwd_schedule(q, k, v, sm_scale, 96, None, round_bf16=True, fault=fault)
    ref_out, ref_lse = tfa.flash_attention_ref(q, k, v, sm_scale, 96)
    assert _rel(out.float(), ref_out) > 8e-3 or (lse - ref_lse).abs().max().item() > 1e-3


@pytest.mark.parametrize("bf16", [False, True], ids=["fp32", "bf16"])
@pytest.mark.parametrize("shape,causal_block,qscale", CASES)
def test_bwd_schedule_matches_jax_and_plain_backward(shape, causal_block, qscale, bf16):
    b, h, lq, lk = shape
    q, k, v, do = _inputs(b, h, lq, lk, bf16, qscale)
    sm_scale = D ** -0.5
    out, lse = tfa.flash_attention_ref(*(torch.from_numpy(x) for x in (q, k, v)), sm_scale, causal_block)
    delta = (torch.from_numpy(do) * out).sum(-1)
    lse, delta = lse.numpy(), delta.numpy()
    got = bwd_schedule(*_torch((q, k, v, do), torch.bfloat16 if bf16 else torch.float32), torch.from_numpy(lse),
                       torch.from_numpy(delta), sm_scale, causal_block, round_bf16=bf16)

    jdtype = jnp.bfloat16 if bf16 else jnp.float32
    ref_jax = jfa.partial_flash_backward(*(jnp.asarray(x, jdtype) for x in (q, k, v, do)), jnp.asarray(lse),
                                         jnp.asarray(delta), sm_scale=sm_scale, causal_block=causal_block,
                                         interpret=True)
    ref_plain = tfa.flash_attention_bwd_ref(*(torch.from_numpy(x) for x in (q, k, v, do, lse, delta)),
                                            sm_scale, causal_block)
    tol_jax, tol_plain = (8e-3, 1e-2) if bf16 else (1e-5, 1e-5)
    for name, g, rj, rp in zip(("dq", "dk", "dv"), got, ref_jax, ref_plain):
        g = g.float().numpy()
        assert _rel(g, np.asarray(rj, np.float32)) <= tol_jax, (name, _rel(g, np.asarray(rj, np.float32)))
        assert _rel(g, rp.numpy()) <= tol_plain, (name, _rel(g, rp.numpy()))


@pytest.mark.parametrize("fault", BWD_FAULTS)
def test_bwd_schedule_with_a_design_fault_fails_the_limit(fault):
    """Each design fault of the backward, on a frame-causal case, puts a
    gradient outside the card's limit (1e-2 of its max|ref|)."""
    q, k, v, do = _torch(_inputs(1, 1, 600, 600, True, seed=1), torch.bfloat16)
    sm_scale = D ** -0.5
    out, lse = tfa.flash_attention_ref(q, k, v, sm_scale, 96)
    delta = (do.float() * out).sum(-1)
    got = bwd_schedule(q, k, v, do, lse, delta, sm_scale, 96, round_bf16=True, fault=fault)
    ref = tfa.flash_attention_bwd_ref(q, k, v, do, lse, delta, sm_scale, 96)
    assert max(_rel(g.float(), r) for g, r in zip(got, ref)) > 1e-2
