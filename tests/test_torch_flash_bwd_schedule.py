"""The fused D = 128 flash-attention backward's order of work
(``opensora_torch/csrc/flash_attention_bwd_sm90.cu``), emulated in plain
PyTorch on the CPU and held against the JAX package's Pallas backward
(``partial_flash_backward``, interpret mode) and the port's plain backward
on the same numpy inputs.

The emulation follows the kernel: one 128-key block at a time walks the
64-row query tiles from the causal first tile on; rows outside the tensors
are zero (the TMA's fill) and their LSE and delta 0; P is masked only on
the tiles the kernel masks (and the emulation checks that the others need
no mask and that the tiles it skips see none of the block's keys); P is
rounded to bf16 before the dV product and dS before the dK and dQ
products; each key block's dQ partial is added into an fp32 sum; sm_scale
multiplies the fp32 sums at the end.

Tolerances, of each gradient's max|ref|: in fp32 (no rounding inside),
1e-5 against both (the same sums in another order). With bf16 inputs, the
rounding points of the kernel and the JAX kernel: 8e-3 against JAX (two
bf16 ulps: the outputs are rounded to bf16 on both sides, and an fp32 sum
taken in another order may round a P or dS element the other way), and
1e-2 against the fp32 plain backward (BWD_RTOL, as on the card).
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opensora_tpu.ops import flash_attention as jfa
from opensora_torch.ops import flash_attention as tfa

BLOCK_N, BLOCK_M = 128, 64  # keys per CTA, query rows per tile (the kernel's)
LOG2E = 1.4426950408889634


def _pad_rows(x, n):
    return torch.nn.functional.pad(x, (0, 0) * (x.dim() == 4) + (0, n - x.shape[2]))


def fused_schedule(q, k, v, do, lse, delta, sm_scale, causal_block, round_bf16):
    """(dq, dk, dv) in the kernel's order of work; bf16 roundings where the
    kernel rounds when ``round_bf16``, none otherwise."""
    rnd = (lambda x: x.to(torch.bfloat16).float()) if round_bf16 else (lambda x: x)
    b, h, lq, d = q.shape
    lk = k.shape[2]
    n_qtiles = -(-lq // BLOCK_M)
    n_kblocks = -(-lk // BLOCK_N)
    qp, dop = (_pad_rows(x.float(), n_qtiles * BLOCK_M) for x in (q, do))
    kp, vp = (_pad_rows(x.float(), n_kblocks * BLOCK_N) for x in (k, v))
    lse = lse.float()
    lse2 = _pad_rows(torch.where(lse <= tfa.NEG_INF * 0.5, torch.zeros_like(lse), lse) * LOG2E, n_qtiles * BLOCK_M)
    deltap = _pad_rows(delta.float(), n_qtiles * BLOCK_M)
    c = sm_scale * LOG2E
    dq_acc = torch.zeros(b, h, n_qtiles * BLOCK_M, d)
    dk = torch.zeros(b, h, n_kblocks * BLOCK_N, d)
    dv = torch.zeros_like(dk)
    for n0 in range(0, lk, BLOCK_N):
        keys = torch.arange(n0, n0 + BLOCK_N)
        first = 0
        if causal_block is not None:  # frames before the block's first key frame see none of it
            first = min((n0 // causal_block) * causal_block // BLOCK_M, n_qtiles)
        kt, vt = kp[:, :, n0:n0 + BLOCK_N], vp[:, :, n0:n0 + BLOCK_N]
        dk_blk, dv_blk = torch.zeros(b, h, BLOCK_N, d), torch.zeros(b, h, BLOCK_N, d)
        for qt in range(n_qtiles):
            q0 = qt * BLOCK_M
            rows = slice(q0, q0 + BLOCK_M)
            qrows = torch.arange(q0, q0 + BLOCK_M)
            ok = (keys[:, None] < lk) & (qrows[None, :] < lq)
            need_mask = n0 + BLOCK_N > lk or q0 + BLOCK_M > lq
            if causal_block is not None:
                ok &= keys[:, None] // causal_block <= qrows[None, :] // causal_block
                need_mask = need_mask or (n0 + BLOCK_N - 1) // causal_block > q0 // causal_block
            if qt < first:
                assert not ok.any(), (n0, qt)  # the skipped tile sees none of the keys
                continue
            if not need_mask:
                assert ok.all(), (n0, qt)  # the unmasked tile needs no mask
            st = torch.einsum("bhkd,bhqd->bhkq", kt, qp[:, :, rows])  # S^T
            pt = torch.exp2(st * c - lse2[:, :, None, rows])
            if need_mask:
                pt = torch.where(ok, pt, torch.zeros_like(pt))
            dv_blk += torch.einsum("bhkq,bhqd->bhkd", rnd(pt), dop[:, :, rows])
            dpt = torch.einsum("bhkd,bhqd->bhkq", vt, dop[:, :, rows])
            dst = rnd(pt * (dpt - deltap[:, :, None, rows]))
            dk_blk += torch.einsum("bhkq,bhqd->bhkd", dst, qp[:, :, rows])
            dq_acc[:, :, rows] += torch.einsum("bhkq,bhkd->bhqd", dst, kt)  # this key block's partial
        dk[:, :, n0:n0 + BLOCK_N] = dk_blk * sm_scale
        dv[:, :, n0:n0 + BLOCK_N] = dv_blk
    dq = dq_acc[:, :, :lq] * sm_scale
    return tuple(rnd(x) for x in (dq, dk[:, :, :lk], dv[:, :, :lk]))


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / np.abs(b).max())


# (B, H, Lq, Lk), causal_block: tails of 64-row tiles and 128-key blocks,
# frames that straddle tiles and blocks, B * H > 1, Lq != Lk
CASES = [
    ((1, 2, 100, 100), None),
    ((2, 3, 200, 200), None),
    ((1, 2, 333, 333), None),
    ((1, 2, 200, 200), 48),
    ((2, 2, 333, 333), 96),
    ((1, 2, 200, 333), None),
    ((1, 1, 333, 200), 48),
]


def _inputs(b, h, lq, lk, causal_block, bf16, seed=0):
    rng = np.random.default_rng(seed)
    d = 128
    arrs = [rng.standard_normal((b, h, n, d)).astype(np.float32) for n in (lq, lk, lk, lq)]
    if bf16:  # bf16-representable values, so both sides start from the same inputs
        arrs = [torch.from_numpy(a).to(torch.bfloat16).float().numpy() for a in arrs]
    q, k, v, do = (torch.from_numpy(a) for a in arrs)
    out, lse = tfa.flash_attention_ref(q, k, v, None, causal_block)
    delta = (do * out).sum(-1)
    return arrs, lse.numpy(), delta.numpy()


@pytest.mark.parametrize("bf16", [False, True], ids=["fp32", "bf16"])
@pytest.mark.parametrize("shape,causal_block", CASES)
def test_fused_schedule_matches_jax_and_plain_backward(shape, causal_block, bf16):
    b, h, lq, lk = shape
    (q, k, v, do), lse, delta = _inputs(b, h, lq, lk, causal_block, bf16)
    sm_scale = 1.0 / math.sqrt(q.shape[-1])
    dtype = torch.bfloat16 if bf16 else torch.float32
    tq, tk, tv, tdo = (torch.from_numpy(x).to(dtype) for x in (q, k, v, do))
    got = fused_schedule(tq, tk, tv, tdo, torch.from_numpy(lse), torch.from_numpy(delta), sm_scale, causal_block,
                         round_bf16=bf16)

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
