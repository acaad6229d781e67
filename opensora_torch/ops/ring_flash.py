"""Ring flash attention: sequence-parallel attention whose KV shards rotate
around the ranks of a mesh axis, with the Hopper CUDA hop kernels, their
plain PyTorch versions and the autograd Function over them.

Counterpart of opensora_tpu/ops/ring_flash.py. On the TPU one Pallas cell
per (b, h) runs all sp hops and moves the KV shard to the right neighbour by
in-kernel remote DMA, double-buffered with "ack" semaphores
(``_ring_fwd_kernel``, ``_ring_bwd_kernel``). Here the ring's transport is
:class:`opensora_torch.parallel.comm.RingTransport` (two slots per rank, a
copy stream per rank, "received" and "ack" events) and each (rank, hop) is
one launch of a kernel of ``csrc/ring_flash_attention.cu``:

- ``ring_flash_fwd`` (the dense D = 128 forward's wgmma/TMA main loop at
  the hop's global offsets, running max only) folds the keys of the rank's
  current slot into its fp32 (m, l, acc), loaded unless first and stored
  unless last, and on the last hop writes out and the LSE;
- ``ring_flash_bwd_fused`` (the dense D = 128 backward's fused wgmma/TMA
  main loop at the hop's global offsets) adds the rank's dK, dV into the
  fp32 accumulators that travel with the KV shard (sent on after every
  hop, the last included, so they land home after sp hops, in slot sp %
  2) and its dQ partials into the rank's fp32 ``dq_accum`` (the fused
  kernel's fragment-order layout), which stays home; after the last hop
  the dense backward's epilogue kernel, ``flash_attention_bwd_dq_convert``,
  scales and rounds it once per rank.

Every hop masks at global offsets: the rank's queries start at rank * L_q,
the shard it holds at hop h came from src = (rank - h) mod sp. The kernels
mask the ragged last tile, so any local length runs (the JAX kernel asserts
that each local length tiles evenly). Head dim 128 (the MMDiT's).

The hop wrappers launch the kernels for CUDA tensors and raise on anything
they do not take; CPU tensors go to the plain hop functions
(``*_hop_ref``), which run the same state and accumulator updates in
fp32. A CUDA call never falls back to them. ``plain=True`` in :func:`ring_forward_shards` /
:func:`ring_backward_shards` runs the plain hops in sequence on any device:
the reference ``chip_smoke.py`` holds the kernels against.

Layout (B, H, L, D) for the global tensors; each rank holds the slice
L/sp * rank .. of the sequence.
"""

from __future__ import annotations

import ctypes
import math
from typing import List, Optional, Sequence, Tuple

import torch

from opensora_torch.ops import _build
from opensora_torch.ops import flash_attention as fa
from opensora_torch.ops.flash_attention import LOG2E, NEG_INF
from opensora_torch.parallel.comm import RingTransport, gather, shard

LN2 = math.log(2.0)
SOURCE = "ring_flash_attention"
KERNEL_FWD = "ring_flash_fwd"
KERNEL_BWD = "ring_flash_bwd_fused"
HEAD_DIM = 128

_lib = None


def _kernel_lib():
    global _lib
    if _lib is None:
        lib = _build.load(SOURCE)
        vp, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.ring_flash_fwd.argtypes = [vp] * 8 + [i] * 5 + [f] + [i] * 5 + [vp]
        lib.ring_flash_bwd_fused.argtypes = [vp] * 9 + [i] * 5 + [f] + [i] * 3 + [vp]
        for fn in (lib.ring_flash_fwd, lib.ring_flash_bwd_fused):
            fn.restype = ctypes.c_int
        lib.ring_flash_error_string.argtypes = [ctypes.c_int]
        lib.ring_flash_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def home_slot(sp: int) -> int:
    """The slot where the dK/dV accumulators land after sp hops."""
    return sp % 2


def visible(lq: int, lk: int, q_off: int, k_off: int, causal_block: Optional[int], device) -> Optional[torch.Tensor]:
    """(lq, lk) bool: which keys each query sees under the frame-causal mask
    at global offsets (None: all)."""
    if causal_block is None:
        return None
    qf = (q_off + torch.arange(lq, device=device))[:, None] // causal_block
    kf = (k_off + torch.arange(lk, device=device))[None, :] // causal_block
    return kf <= qf


# ----------------------------------------------------------------------
# plain hop functions (fp32, in place)
# ----------------------------------------------------------------------


def ring_fwd_hop_ref(q, k, v, state, out, lse, *, sm_scale: float, causal_block: Optional[int],
                     q_off: int, k_off: int, first: bool, last: bool) -> None:
    """One hop: fold the keys k, v into state = (m, l, acc) (m in the log2
    domain of the scaled logits, as the kernel keeps it); the first hop
    starts from (-inf, 0, 0), the last writes out = acc / l and the
    natural-log lse."""
    m, l, acc = state
    if first:
        m.fill_(NEG_INF)
        l.zero_()
        acc.zero_()
    if k.shape[2]:
        x = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * (sm_scale * LOG2E)
        mask = visible(q.shape[2], k.shape[2], q_off, k_off, causal_block, q.device)
        if mask is not None:
            x = x.masked_fill(~mask, NEG_INF)
        m_new = torch.maximum(m, x.amax(-1))
        m_safe = torch.where(m_new <= NEG_INF * 0.5, torch.zeros_like(m_new), m_new)
        p = torch.exp2(x - m_safe[..., None])
        corr = torch.exp2(m - m_safe)
        l.mul_(corr).add_(p.sum(-1))
        acc.mul_(corr[..., None]).add_(torch.einsum("bhqk,bhkd->bhqd", p, v.float()))
        m.copy_(m_new)
    if last:
        l_safe = torch.where(l == 0, torch.ones_like(l), l)
        out.copy_(acc / l_safe[..., None])
        lse.copy_(m * LN2 + torch.log(l_safe))


def _p_ds(q, k, v, do, lse, delta, sm_scale, causal_block, q_off, k_off):
    """P from the global LSE (fully masked rows anchored at 0) and dS = P *
    (dO V^T - delta), fp32."""
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float())
    lse = lse.float()
    lse_safe = torch.where(lse <= NEG_INF * 0.5, torch.zeros_like(lse), lse) * LOG2E
    p = torch.exp2(s * (sm_scale * LOG2E) - lse_safe[..., None])
    mask = visible(q.shape[2], k.shape[2], q_off, k_off, causal_block, q.device)
    if mask is not None:
        p = p.masked_fill(~mask, 0.0)
    dp = torch.einsum("bhqd,bhkd->bhqk", do.float(), v.float())
    return p, p * (dp - delta.float()[..., None])


def ring_bwd_hop_ref(q, k, v, do, lse, delta, dk_acc, dv_acc, dq_accum, *, sm_scale: float,
                     causal_block: Optional[int], q_off: int, k_off: int) -> None:
    """One backward hop: dk_acc += sm_scale dS^T Q and dv_acc += P^T dO (the
    slot's travelling accumulators), dq_accum += dS K, unscaled (sm_scale
    multiplies it once, after the last hop). dq_accum is the fused kernel's
    (flash_attention.dq_rows_to_accum), as for the kernel."""
    p, ds = _p_ds(q, k, v, do, lse, delta, sm_scale, causal_block, q_off, k_off)
    dv_acc.add_(torch.einsum("bhqk,bhqd->bhkd", p, do.float()))
    dk_acc.add_(torch.einsum("bhqk,bhqd->bhkd", ds, q.float()) * sm_scale)
    dq_accum.add_(fa.dq_rows_to_accum(torch.einsum("bhqk,bhkd->bhqd", ds, k.float())))


def dq_finish_ref(dq_accum: torch.Tensor, lq: int, *, sm_scale: float, dtype: torch.dtype) -> torch.Tensor:
    """Plain version of :func:`dq_finish`, in ``dtype``."""
    return (fa.dq_accum_to_rows(dq_accum, lq) * sm_scale).to(dtype)


def dq_finish(dq_accum: torch.Tensor, lq: int, *, sm_scale: float, dtype: torch.dtype) -> torch.Tensor:
    """A rank's dq (B, H, Lq, D) in ``dtype`` from its dq_accum: the dense
    backward's epilogue kernel (CUDA tensors; bf16 only), the plain version
    for CPU tensors."""
    if not _route(dq_accum):
        return dq_finish_ref(dq_accum, lq, sm_scale=sm_scale, dtype=dtype)
    if dtype != torch.bfloat16:
        raise ValueError(f"ring backward: the dQ epilogue writes bf16, got {dtype}")
    return fa.flash_attention_bwd_dq_convert(dq_accum, lq, sm_scale=sm_scale)


# ----------------------------------------------------------------------
# kernel wrappers
# ----------------------------------------------------------------------


def _check(bf16=(), fp32=(), like=None):
    """Device, dtype, contiguity and layout of a hop's tensors."""
    q = like
    for name, x in bf16:
        if x.dtype != torch.bfloat16:
            raise TypeError(f"the ring kernels take bf16, got {name}.dtype={x.dtype}")
        if x.dim() != 4 or x.shape[:2] != q.shape[:2] or x.shape[3] != HEAD_DIM:
            raise ValueError(f"{name} must be (B, H, L, {HEAD_DIM}) like q, got {tuple(x.shape)}")
    for name, x in fp32:
        if x.dtype != torch.float32:
            raise TypeError(f"{name} must be fp32, got {x.dtype}")
    for name, x in (*bf16, *fp32):
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if x.device != q.device:
            raise ValueError(f"{name} is on {x.device}, q on {q.device}")


def _launch(fn_name: str, counter: str, ptrs, q, k, *args):
    lib = _kernel_lib()
    b, h, lq, d = q.shape
    with torch.cuda.device(q.device):
        err = getattr(lib, fn_name)(*ptrs, b, h, lq, k.shape[2], d, *args,
                                    torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{fn_name} launch failed: {lib.ring_flash_error_string(err).decode()} ({err})")
    _build.LAUNCHES[counter] += 1


def _route(q) -> bool:
    """True for the kernel (CUDA tensors), False for the plain version (CPU
    tensors); anything else raises."""
    if q.device.type == "cpu":
        return False
    if q.device.type != "cuda":
        raise ValueError(f"ring flash attention runs on cuda or cpu tensors, got {q.device}")
    return True


def ring_fwd_hop(q, k, v, state, out, lse, *, sm_scale: float, causal_block: Optional[int],
                 q_off: int, k_off: int, first: bool, last: bool) -> None:
    """One forward hop by the ``ring_flash_fwd`` kernel (CPU tensors: the
    plain version)."""
    kw = dict(sm_scale=sm_scale, causal_block=causal_block, q_off=q_off, k_off=k_off, first=first, last=last)
    if not _route(q):
        return ring_fwd_hop_ref(q, k, v, state, out, lse, **kw)
    m, l, acc = state
    _check(bf16=(("q", q), ("k", k), ("v", v), ("out", out)), fp32=(("m", m), ("l", l), ("acc", acc), ("lse", lse)),
           like=q)
    if k.shape != v.shape or m.shape != q.shape[:3] or l.shape != m.shape or lse.shape != m.shape \
            or acc.shape != q.shape or out.shape != q.shape:
        raise ValueError("ring_flash_fwd: k and v, and the state, out and lse must match q's shape")
    fa._check_aligned(KERNEL_FWD, (("q", q), ("k", k), ("v", v)))
    ptrs = [x.data_ptr() for x in (q, k, v, m, l, acc, out, lse)]
    _launch("ring_flash_fwd", KERNEL_FWD, ptrs, q, k, sm_scale * LOG2E, causal_block or 0, q_off, k_off,
            int(first), int(last))


def _check_bwd(q, k, v, do, lse, delta, accs):
    _check(bf16=(("q", q), ("k", k), ("v", v), ("do", do)),
           fp32=(("lse", lse), ("delta", delta), *accs), like=q)
    if k.shape != v.shape or do.shape != q.shape or lse.shape != q.shape[:3] or delta.shape != lse.shape:
        raise ValueError("ring backward: k and v, do, lse and delta must match q's shape")


def ring_bwd_hop(q, k, v, do, lse, delta, dk_acc, dv_acc, dq_accum, *, sm_scale: float,
                 causal_block: Optional[int], q_off: int, k_off: int) -> None:
    """One backward hop by the ``ring_flash_bwd_fused`` kernel (CPU tensors:
    the plain version)."""
    kw = dict(sm_scale=sm_scale, causal_block=causal_block, q_off=q_off, k_off=k_off)
    if not _route(q):
        return ring_bwd_hop_ref(q, k, v, do, lse, delta, dk_acc, dv_acc, dq_accum, **kw)
    _check_bwd(q, k, v, do, lse, delta, (("dk_acc", dk_acc), ("dv_acc", dv_acc), ("dq_accum", dq_accum)))
    if dk_acc.shape != k.shape or dv_acc.shape != k.shape:
        raise ValueError("ring_flash_bwd_fused: the dK/dV accumulators must match k's shape")
    fa._check_dq_accum(dq_accum, q.shape[2])
    fa._check_aligned(KERNEL_BWD, (("q", q), ("k", k), ("v", v), ("do", do)))
    ptrs = [x.data_ptr() for x in (q, k, v, do, lse, delta, dk_acc, dv_acc, dq_accum)]
    _launch("ring_flash_bwd_fused", KERNEL_BWD, ptrs, q, k, sm_scale, causal_block or 0, q_off, k_off)


# ----------------------------------------------------------------------
# the ring over the ranks' shards
# ----------------------------------------------------------------------


def ring_forward_shards(qs: Sequence[torch.Tensor], ks: Sequence[torch.Tensor], vs: Sequence[torch.Tensor], *,
                        sm_scale: float, causal_block: Optional[int] = None,
                        plain: bool = False) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
    """Rank r's (out, lse) from its shards qs[r], ks[r], vs[r] (each on the
    rank's device): sp hops, the KV shard moving one rank to the right
    after each (ring_flash.py:97-183)."""
    sp = len(qs)
    hop_fn = ring_fwd_hop_ref if plain else ring_fwd_hop
    t = RingTransport([x.device for x in qs], sequential=plain)
    b, h, lq, d = qs[0].shape
    lk = ks[0].shape[2]
    kv = t.slots((2, b, h, lk, d), ks[0].dtype)  # per rank: [slot][k/v]
    state, outs, lses = [], [], []
    for r in range(sp):
        kv[r][0, 0].copy_(ks[r])
        kv[r][0, 1].copy_(vs[r])
        dev = qs[r].device
        state.append((torch.empty((b, h, lq), dtype=torch.float32, device=dev),
                      torch.empty((b, h, lq), dtype=torch.float32, device=dev),
                      torch.empty((b, h, lq, d), dtype=torch.float32, device=dev)))
        outs.append(torch.empty_like(qs[r]))
        lses.append(torch.empty((b, h, lq), dtype=torch.float32, device=dev))
    t.start()
    for hop in range(sp):
        cur = hop % 2
        for r in range(sp):
            with t.on(r):
                if hop:
                    t.wait_received(r, "kv", cur)
                if hop + 1 < sp:  # the next rank's copy runs while this hop computes
                    t.send(r, "kv", kv, cur)
                hop_fn(qs[r], kv[r][cur, 0], kv[r][cur, 1], state[r], outs[r], lses[r], sm_scale=sm_scale,
                       causal_block=causal_block, q_off=r * lq, k_off=(r - hop) % sp * lk,
                       first=hop == 0, last=hop == sp - 1)
                if hop + 1 < sp:
                    t.release(r, cur)
    t.finish()
    return outs, lses


def ring_backward_shards(qs, ks, vs, outs, lses, dos, *, sm_scale: float, causal_block: Optional[int] = None,
                         plain: bool = False):
    """Rank r's (dq, dk, dv) in the dtypes of its shards: the KV shards
    rotate as in the forward, their fp32 dK/dV accumulators travel with
    them (sent on after this rank's contribution is added, every hop) and
    land home in slot ``home_slot(sp)``; dQ accumulates locally from the
    global LSE in a dq_accum, finished once after the last hop
    (:func:`dq_finish`; ring_flash.py:185-299). delta = rowsum(dO * O) is computed
    here, outside the kernels, as the JAX package does."""
    sp = len(qs)
    hop_fn, finish = (ring_bwd_hop_ref, dq_finish_ref) if plain else (ring_bwd_hop, dq_finish)
    t = RingTransport([x.device for x in qs], sequential=plain)
    b, h, lq, d = qs[0].shape
    lk = ks[0].shape[2]
    kv = t.slots((2, b, h, lk, d), ks[0].dtype)
    grad = t.slots((2, b, h, lk, d), torch.float32, zero_first=True)  # per rank: [slot][dk/dv]
    deltas = [(do.float() * o.float()).sum(-1) for do, o in zip(dos, outs)]
    dq = [torch.zeros((b, h, fa.dq_accum_rows(lq, d), d), dtype=torch.float32, device=q.device) for q in qs]
    for r in range(sp):
        kv[r][0, 0].copy_(ks[r])
        kv[r][0, 1].copy_(vs[r])
    t.start()
    for hop in range(sp):
        cur = hop % 2
        for r in range(sp):
            with t.on(r):
                if hop:
                    t.wait_received(r, "kv", cur)
                    t.wait_received(r, "grad", cur)
                if hop + 1 < sp:
                    t.send(r, "kv", kv, cur)
                kw = dict(sm_scale=sm_scale, causal_block=causal_block, q_off=r * lq, k_off=(r - hop) % sp * lk)
                hop_fn(qs[r], kv[r][cur, 0], kv[r][cur, 1], dos[r], lses[r], deltas[r], grad[r][cur, 0],
                       grad[r][cur, 1], dq[r], **kw)
                t.send(r, "grad", grad, cur)  # after the contribution, on every hop
                t.release(r, cur)
    t.finish()
    home = home_slot(sp)
    return ([finish(g, lq, sm_scale=sm_scale, dtype=q.dtype) for g, q in zip(dq, qs)],
            [grad[r][home, 0].to(ks[r].dtype) for r in range(sp)],
            [grad[r][home, 1].to(vs[r].dtype) for r in range(sp)])


class RingFlashAttentionFunction(torch.autograd.Function):
    """Differentiable ring flash attention over the ranks on ``devices``
    (the JAX package's ``custom_vjp``, ring_flash.py:380-392): global q, k,
    v (B, H, L, D) are cut along L into one shard per rank; returns the
    gathered (out, lse). The LSE takes no gradient."""

    @staticmethod
    def forward(ctx, q, k, v, devices, sm_scale: float, causal_block: Optional[int]):
        outs, lses = ring_forward_shards(*(shard(x, 2, devices) for x in (q, k, v)), sm_scale=sm_scale,
                                         causal_block=causal_block)
        out, lse = gather(outs, 2, q.device), gather(lses, 2, q.device)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.devices, ctx.sm_scale, ctx.causal_block = devices, sm_scale, causal_block
        ctx.mark_non_differentiable(lse)
        return out, lse

    @staticmethod
    def backward(ctx, dout, _dlse):
        q, k, v, out, lse = ctx.saved_tensors
        dout = dout.to(q.dtype)
        parts = [shard(x, 2, ctx.devices) for x in (q, k, v, out, lse, dout)]
        dq, dk, dv = ring_backward_shards(*parts, sm_scale=ctx.sm_scale, causal_block=ctx.causal_block)
        return gather(dq, 2, q.device), gather(dk, 2, k.device), gather(dv, 2, v.device), None, None, None


def ring_devices(mesh, axis: str) -> Tuple[torch.device, ...]:
    """The devices of the ring along ``axis`` (the group of rank 0: the
    other axes hold replicas, as the JAX kernel's in_specs say)."""
    return tuple(mesh.devices[r] for r in mesh.group(axis))


def ring_flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mesh, *, axis: str = "sp",
                         causal_block: Optional[int] = None,
                         sm_scale: Optional[float] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sequence-parallel flash attention over the ranks of ``axis``.

    q, k, v: global (B, H, L, D) with L a multiple of the axis size. Returns
    (out (B, H, L, D) in q's dtype, lse (B, H, L) fp32, natural log).
    Differentiable in q, k, v. CUDA tensors run the ring kernels (bf16, head
    dim 128) or raise; CPU tensors the plain hops."""
    devices = ring_devices(mesh, axis)
    if any(d.type != q.device.type for d in devices):
        raise ValueError(f"the mesh's devices {sorted({str(d) for d in devices})} and q ({q.device}) differ in kind")
    if q.shape[2] % len(devices) or k.shape[2] % len(devices):
        raise ValueError(f"sequence lengths {q.shape[2]}, {k.shape[2]} do not split over {len(devices)} ranks")
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    return RingFlashAttentionFunction.apply(q, k, v, devices, sm_scale, causal_block)
