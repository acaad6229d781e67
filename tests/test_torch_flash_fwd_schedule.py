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

The ring forward's hop kernel (``ring_flash_fwd``, the same main loop in
``csrc/ring_flash_attention.cu``) is emulated too (``ring_hop_schedule``):
the running-max loop only, from the rank's state (m, l, acc) loaded unless
first -- l's whole-row sum on one lane of each quad, the quad's four shares
added at the end -- to the state stored unless last, where out and the LSE
are written instead; a CTA with no key tile returns at once on a middle hop
and leaves its rows' state as it was, and still writes on the first or last
hop. Driven by the port's ring (``ring_forward_shards`` over 4 logical CPU
ranks) it is held against the JAX ring kernel (interpret mode, 4 virtual
devices, local lengths that tile evenly, as tests/test_torch_ring_flash.py
runs it: 5e-5 of max(1, max|ref|) for the output and 2e-5 for the LSE, that
file's limits) and, at ragged local lengths (250 a rank), against the
port's plain dense attention: fp32 1e-5 as above; with bf16 inputs and the
kernel's rounding of P, OUT_RTOL and 1e-3 as on the card.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from opensora_tpu.ops import flash_attention as jfa
from opensora_tpu.ops.ring_flash import ring_flash_attention as j_ring
from opensora_torch.ops import flash_attention as tfa
from opensora_torch.ops import ring_flash as tring
from opensora_torch.parallel.comm import gather, shard

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


# ----------------------------------------------------------------------
# the ring forward's hop: the same main loop from and to the rank's state
# ----------------------------------------------------------------------


def _kv_tiles(lq, lk, m0, causal_block, q_off, k_off):
    """The key tiles the CTA of rows m0 .. m0 + 127 walks (kv_tiles)."""
    kv_end = lk
    if causal_block is not None:
        last_row = q_off + min(m0 + BLOCK_M, lq) - 1
        kv_end = min(lk, max(0, (last_row // causal_block + 1) * causal_block - k_off))
    return -(-kv_end // BLOCK_N)


def ring_hop_schedule(q, k, v, state, out, lse, *, sm_scale, causal_block, q_off, k_off, first, last,
                      round_bf16=False):
    """One hop in the kernel's order of work, in place, with the signature of
    ``ring_fwd_hop_ref``: the running-max loop from the loaded state (m,
    the whole-row l on quad lane 0 of four shares, acc) to the stored state,
    or to out and the LSE on the last hop. A CTA with no key tile returns at
    once on a middle hop."""
    rnd = (lambda x: x.to(torch.bfloat16).float()) if round_bf16 else (lambda x: x)
    m_st, l_st, acc_st = state
    b, h, lq, d = q.shape
    lk = k.shape[2]
    c = sm_scale * LOG2E
    n_m, n_kb = -(-lq // BLOCK_M), -(-max(lk, 1) // BLOCK_N)
    qp = _pad_rows(q.float(), n_m * BLOCK_M)
    kp, vp = (_pad_rows(x.float(), n_kb * BLOCK_N) for x in (k, v))
    quad = (torch.arange(BLOCK_N) % 8) // 2  # the lane of the quad that holds key n0 + i's share
    for bi in range(b):
        for hi in range(h):
            for m0 in range(0, lq, BLOCK_M):
                n_tiles = _kv_tiles(lq, lk, m0, causal_block, q_off, k_off)
                if n_tiles == 0 and not first and not last:
                    continue  # the CTA returns: its rows' state stays as it is
                for wg in range(2):
                    r0 = m0 + WG_ROWS * wg
                    rows = torch.arange(r0, r0 + WG_ROWS)
                    live = rows[rows < lq]
                    n_live = len(live)
                    m = torch.full((WG_ROWS,), NEG_INF)
                    l4 = torch.zeros(WG_ROWS, 4)
                    o = torch.zeros(WG_ROWS, d)
                    if not first:
                        m[:n_live] = m_st[bi, hi, live]
                        l4[:n_live, 0] = l_st[bi, hi, live]
                        o[:n_live] = acc_st[bi, hi, live]
                    for t in range(n_tiles):
                        n0 = t * BLOCK_N
                        keys = torch.arange(n0, n0 + BLOCK_N)
                        s = qp[bi, hi, r0:r0 + WG_ROWS] @ kp[bi, hi, n0:n0 + BLOCK_N].T
                        ok = (keys < lk)[None, :].expand(WG_ROWS, -1)
                        need_mask = n0 + BLOCK_N > lk
                        if causal_block is not None:
                            ok = ok & ((k_off + keys)[None, :] // causal_block
                                       <= (q_off + rows)[:, None] // causal_block)
                            need_mask = need_mask or (
                                (k_off + n0 + BLOCK_N - 1) // causal_block > (q_off + m0) // causal_block)
                        if need_mask:
                            s = torch.where(ok, s, torch.full_like(s, -math.inf))
                        else:
                            assert ok.all(), (m0, wg, n0)
                        m_new = torch.maximum(m, s.amax(-1) * c)
                        m_safe = torch.where(m_new <= NEG_INF * 0.5, torch.zeros_like(m_new), m_new)
                        corr = torch.exp2(m - m_safe)
                        m, l4, o = m_new, l4 * corr[:, None], o * corr[:, None]
                        p = torch.exp2(s * c - m_safe[:, None])
                        l4 = l4 + torch.zeros(WG_ROWS, 4).index_add_(1, quad, p)
                        o = o + rnd(p) @ vp[bi, hi, n0:n0 + BLOCK_N]
                    l = l4.sum(1)
                    if last:
                        l_safe = torch.where(l == 0, torch.ones_like(l), l)
                        out[bi, hi, live] = rnd(o / l_safe[:, None])[:n_live].to(out.dtype)
                        lse[bi, hi, live] = (m * LN2 + torch.log(l_safe))[:n_live]
                    else:
                        m_st[bi, hi, live] = m[:n_live]
                        l_st[bi, hi, live] = l[:n_live]
                        acc_st[bi, hi, live] = o[:n_live]


def _ring_schedule(q, k, v, causal_block, sp=4, round_bf16=False):
    """(out, lse) of the port's ring over ``sp`` logical CPU ranks with the
    emulated hop in place of the plain one."""
    devices = [torch.device("cpu")] * sp
    hop = lambda *a, **kw: ring_hop_schedule(*a, **kw, round_bf16=round_bf16)  # noqa: E731
    orig = tring.ring_fwd_hop_ref
    tring.ring_fwd_hop_ref = hop
    try:
        outs, lses = tring.ring_forward_shards(*(shard(x, 2, devices) for x in (q, k, v)), sm_scale=q.shape[-1] ** -0.5,
                                               causal_block=causal_block, plain=True)
    finally:
        tring.ring_fwd_hop_ref = orig
    return gather(outs, 2, q.device), gather(lses, 2, q.device)


@pytest.fixture(scope="module")
def jmesh4():
    devs = jax.devices()
    if len(devs) < 4:
        pytest.skip("needs 4 virtual devices")
    return Mesh(np.asarray(devs[:4]), ("sp",))


@pytest.mark.parametrize("causal_block", [None, 128])
def test_ring_hop_schedule_matches_jax_ring(jmesh4, causal_block):
    """Local lengths of 128 (one CTA a rank, the JAX kernel's tiling): the
    emulated hops over 4 ranks against the Pallas ring kernel."""
    q, k, v = _inputs(1, 2, 512, 512, False, seed=5)
    j_out, j_lse = j_ring(*(jnp.asarray(x) for x in (q, k, v)), jmesh4, block_q=128, block_k=128,
                          causal_block=causal_block, interpret=True)
    out, lse = _ring_schedule(*(torch.from_numpy(x) for x in (q, k, v)), causal_block)
    j_out, j_lse = np.asarray(j_out, np.float64), np.asarray(j_lse, np.float64)[..., 0]
    assert np.abs(out.numpy() - j_out).max() <= 5e-5 * max(1.0, np.abs(j_out).max())
    assert np.abs(lse.numpy() - j_lse).max() <= 2e-5 * max(1.0, np.abs(j_lse).max())


@pytest.mark.parametrize("bf16", [False, True], ids=["fp32", "bf16"])
@pytest.mark.parametrize("causal_block", [None, 96])
def test_ring_hop_schedule_at_ragged_lengths_matches_dense(causal_block, bf16):
    """L = 1000 over 4 ranks: 250 rows a rank (a full CTA and one of 122
    rows, whose second consumer holds 58), 250 keys a shard (a ragged
    second tile), frames of 96 that the shard edges cut: the emulated ring
    against the port's plain dense attention."""
    q, k, v = (torch.from_numpy(x) for x in _inputs(1, 2, 1000, 1000, bf16, seed=6))
    out, lse = _ring_schedule(q, k, v, causal_block, round_bf16=bf16)
    ref, ref_lse = tfa.flash_attention_ref(q, k, v, None, causal_block)
    tol_out, tol_lse = (8e-3, 1e-3) if bf16 else (1e-5, 1e-5)
    assert _rel(out.numpy(), ref.numpy()) <= tol_out, _rel(out.numpy(), ref.numpy())
    assert np.abs(lse.numpy() - ref_lse.numpy()).max() <= tol_lse


def test_ring_hop_schedule_keeps_the_state_of_ctas_without_keys():
    """The empty-CTA rules at a rank and hop whose keys come wholly from
    later frames for its first CTA: on a middle hop the CTA returns and its
    rows' state stays bitwise as loaded; the same CTA on the first hop
    writes the empty state, and on the last hop out and the LSE from the
    loaded state. The other CTA is a 31-row tail (159 = 128 + 31 rows, the
    last CTA of a 2207-row shard) and folds in the keys it sees."""
    lq = lk = 159
    cb, q_off, k_off = 64, 0, 128  # keys 128..286: CTA 0 (rows 0..127, frames 0, 1) sees none, CTA 1 frame 2
    q, k, v = (torch.from_numpy(x) for x in _inputs(1, 1, lq, lk, False, seed=7))
    assert _kv_tiles(lq, lk, 0, cb, q_off, k_off) == 0 and _kv_tiles(lq, lk, 128, cb, q_off, k_off) == 1
    gen = torch.Generator().manual_seed(8)
    loaded = (torch.randn(1, 1, lq, generator=gen) * 3, torch.rand(1, 1, lq, generator=gen) + 0.5,
              torch.randn(1, 1, lq, 128, generator=gen))
    kw = dict(sm_scale=128 ** -0.5, causal_block=cb, q_off=q_off, k_off=k_off)
    out, lse = torch.zeros(1, 1, lq, 128), torch.zeros(1, 1, lq)
    cta0 = torch.arange(lq) < BLOCK_M
    for first, last in ((False, False), (True, False), (False, True), (True, True)):
        state = tuple(x.clone() for x in loaded)
        ref_state = tuple(x.clone() for x in loaded)
        ref_out, ref_lse = torch.zeros_like(out), torch.zeros_like(lse)
        ring_hop_schedule(q, k, v, state, out, lse, first=first, last=last, **kw)
        tring.ring_fwd_hop_ref(q, k, v, ref_state, ref_out, ref_lse, first=first, last=last, **kw)
        if not first and not last:  # CTA 0 returned: bitwise as loaded
            for got, was in zip(state, loaded):
                assert torch.equal(got[:, :, cta0], was[:, :, cta0])
        if last:  # out and LSE of every row, CTA 0's from the loaded (or empty) state
            assert _rel(out.numpy(), ref_out.numpy()) <= 1e-5
            assert np.abs(lse.numpy() - ref_lse.numpy()).max() <= 1e-5
        else:  # the state of every row
            for got, want in zip(state, ref_state):
                assert np.abs(got.numpy() - want.numpy()).max() <= 1e-5 * max(1.0, want.abs().max().item())
