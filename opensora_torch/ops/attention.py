"""Attention entry point: RoPE + attention core with backend dispatch
(counterpart of opensora_tpu/ops/attention.py:86-147).

Backends: ``None`` runs :func:`flash_attention` (the CUDA kernel for CUDA
tensors, its plain version for CPU tensors); ``"xla"`` runs the plain
version on any device; ``"int8"`` and ``"int8_qk8"`` run the serving-only
:func:`int8_flash_attention` (both products in int8, or only Q K^T),
bidirectional only, with the JAX package's rule
(opensora_tpu/ops/attention.py:66-80): sequences shorter than 128 and head
dims that are not a multiple of 128 take the plain attention.

Sequence-parallel backends, over the mesh set with
``opensora_torch.parallel.context.set_mesh`` (each raises without one, as
the JAX package asserts): ``"ring_rdma"`` runs
:func:`~opensora_torch.ops.ring_flash.ring_flash_attention` (the ring
kernels for CUDA tensors); ``"ring"`` and ``"ulysses"`` run
:mod:`opensora_torch.ops.sp` with the default core, and ``"ring:<inner>"`` /
``"ulysses:<inner>"`` with the backend ``<inner>``.

Layout: q, k, v are (B, L, H, D); the output is (B, L, H * D).

:func:`attention` takes whole sequences. :func:`attention_shards` takes one
sp group of a sequence-sharded model, each rank's chunk of the joint
sequence on its device, and returns each rank's output: the sp backends run
over the shards as they are; any other backend gathers the group's q, k, v
on the first rank's device, makes one call and cuts the output back (as
JAX's GSPMD gathers around the Pallas call under P(data, sp)). An sp group
whose ranks lie in several processes (a ``comm.ShardGroup``) gives this
process's ranks' shards: the sp backends exchange with the other
processes; any other backend gathers the whole group's q, k, v on every
process for one call of its own and keeps its rows, and its backward
gathers dO the same way and keeps this process's slices of dQ, dK and dV
(:class:`_GatheredAcrossProcesses`: every process computes the whole
call, so nothing is reduced and no process waits on another's result).
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence, Tuple

import torch

from opensora_torch.ops import rope as rope_ops
from opensora_torch.ops.flash_attention import (
    flash_attention,
    flash_attention_bwd_ref,
    flash_attention_ref,
    flash_attention_with_lse,
    partial_flash_backward,
)
from opensora_torch.ops.int8_flash import int8_flash_attention
from opensora_torch.ops.ring_flash import ring_flash_attention, ring_flash_shards
from opensora_torch.ops.sp import ring_attention, ring_shards, ulysses_attention, ulysses_shards
from opensora_torch.parallel.comm import ShardGroup, gather, process_all_gather
from opensora_torch.parallel.context import get_mesh


def plain_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal_block: Optional[int] = None
) -> torch.Tensor:
    """O(L^2)-memory fp32 attention over (B, H, L, D), output in q's dtype."""
    return flash_attention_ref(q, k, v, None, causal_block)[0].to(q.dtype)


def scaled_dot_product_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal_block: Optional[int] = None,
    backend: Optional[str] = None,
) -> torch.Tensor:
    """(B, H, L, D) attention core with backend dispatch."""
    if backend is None:
        return flash_attention(q, k, v, causal_block=causal_block)
    if backend == "xla":
        return plain_attention(q, k, v, causal_block)
    if backend in ("int8", "int8_qk8"):
        if causal_block is not None:
            raise ValueError("int8 attention is bidirectional only (causal_block must be None)")
        if min(q.shape[2], k.shape[2]) < 128 or q.shape[-1] % 128:
            return plain_attention(q, k, v)
        return int8_flash_attention(q, k, v, pv_int8=backend == "int8")
    raise ValueError(f"unknown attention backend {backend!r}")


def _sequence_parallel(q, k, v, backend: str) -> torch.Tensor:
    """(B, L, H, D) -> (B, L, H * D) over the current mesh's 'sp' axis."""
    mesh = get_mesh()
    if mesh is None:
        raise ValueError(f"attention backend {backend!r} needs a mesh (opensora_torch.parallel.context.set_mesh)")
    b, l, h, d = q.shape
    if backend == "ring_rdma":
        out, _ = ring_flash_attention(*(x.transpose(1, 2).contiguous() for x in (q, k, v)), mesh)
        return out.transpose(1, 2).reshape(b, l, h * d)
    name, _, inner = backend.partition(":")
    fn = ulysses_attention if name == "ulysses" else ring_attention
    return fn(q, k, v, mesh, backend=inner or None).reshape(b, l, h * d)


def _sequence_parallel_backend(backend) -> bool:
    return backend == "ring_rdma" or (isinstance(backend, str) and backend.split(":")[0] in ("ring", "ulysses"))


def _rope(q, k, pe, rope_convention: str):
    if pe is None:
        return q, k
    cos, sin = pe
    if rope_convention == "split":
        return rope_ops.apply_rope_split(q, cos, sin), rope_ops.apply_rope_split(k, cos, sin)
    if rope_convention == "interleaved":
        return rope_ops.apply_rope_interleaved(q, cos, sin), rope_ops.apply_rope_interleaved(k, cos, sin)
    raise ValueError(f"unknown rope convention {rope_convention!r}")


def attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    pe: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    *,
    rope_convention: str = "split",
    backend: Optional[str] = None,
) -> torch.Tensor:
    """MMDiT attention: optional RoPE, attention core, heads merged.

    q, k, v: (B, L, H, D); pe: (cos, sin) each (B, L, D/2) or None.
    """
    q, k = _rope(q, k, pe, rope_convention)
    if _sequence_parallel_backend(backend):
        return _sequence_parallel(q, k, v, backend)
    qh, kh, vh = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    out = scaled_dot_product_attention(qh, kh, vh, backend=backend)
    b, h, l, d = out.shape
    return out.transpose(1, 2).reshape(b, l, h * d)


class _GatheredAcrossProcesses(torch.autograd.Function):
    """One attention call on an sp group's whole sequence, the group's
    ranks in several processes: this process's ranks' q, k, v (B, L_i, H,
    D), after ``backend`` and the ``comm.Group`` of the processes, each
    holding an equal run of the tokens; returns its ranks' outputs (B, L_i,
    H * D). Forward: q, k, v gathered over the processes, the call (flash:
    the kernel; "xla": the plain attention; int8: forward only). Backward:
    dO gathered the same way, the whole backward from the saved LSE
    (``partial_flash_backward``; "xla": the plain backward), this
    process's slices of dQ, dK and dV."""

    @staticmethod
    def forward(ctx, backend, group, n, *shards):
        lens = [x.shape[1] for x in shards[:n]]
        whole = [process_all_gather(torch.cat(shards[i * n:(i + 1) * n], 1), 1, group).transpose(1, 2).contiguous()
                 for i in range(3)]
        if backend is None:
            out, lse = flash_attention_with_lse(*whole)
        elif backend == "xla":
            out, lse = flash_attention_ref(*whole, None, None)
            out = out.to(whole[0].dtype)
        else:
            out, lse = scaled_dot_product_attention(*whole, backend=backend), None
        ctx.save_for_backward(*whole, out, *(() if lse is None else (lse,)))
        ctx.backend, ctx.group, ctx.lens = backend, group, lens
        ctx.lo = group.index() * sum(lens)
        b, h, _, d = out.shape
        mine = out.transpose(1, 2).narrow(1, ctx.lo, sum(lens)).reshape(b, sum(lens), h * d)
        return tuple(mine.split(lens, 1))

    @staticmethod
    def backward(ctx, *douts):
        if ctx.backend not in (None, "xla"):
            raise NotImplementedError(f"no backward for attention backend {ctx.backend!r}")
        q, k, v, out, lse = ctx.saved_tensors
        b, h, _, d = q.shape
        mine = torch.cat([g.reshape(b, g.shape[1], h, d) for g in douts], 1).to(q.dtype)
        do = process_all_gather(mine.contiguous(), 1, ctx.group).transpose(1, 2).contiguous()
        delta = (do.float() * out.float()).sum(-1)
        if ctx.backend is None:
            grads = partial_flash_backward(q, k, v, do, lse, delta)
        else:
            grads = [g.to(x.dtype) for g, x in zip(flash_attention_bwd_ref(q, k, v, do, lse, delta,
                                                                            1.0 / math.sqrt(d), None), (q, k, v))]
        total = sum(ctx.lens)
        per = [g.transpose(1, 2).narrow(1, ctx.lo, total).split(ctx.lens, 1) for g in grads]
        return (None, None, None, *(x for p in per for x in p))


def attention_shards(
    qs: Sequence[torch.Tensor],
    ks: Sequence[torch.Tensor],
    vs: Sequence[torch.Tensor],
    pes: Sequence[Optional[Tuple[torch.Tensor, torch.Tensor]]],
    *,
    rope_convention: str = "split",
    backend: Optional[str] = None,
    group: Optional[ShardGroup] = None,
) -> List[torch.Tensor]:
    """MMDiT attention over one sp group of a sequence-sharded model: rank
    i's q, k, v (B, L_i, H, D) and pe (its chunk's RoPE tables) on its
    device -> its output (B, L_i, H * D). RoPE per rank, then the sp
    backend over the shards (equal L_i), or one call of any other backend
    on the gathered sequence. ``group``: the sp group, where its ranks lie
    in several processes (this process's ranks given; see the module
    docstring)."""
    qs, ks = zip(*(_rope(q, k, pe, rope_convention) for q, k, pe in zip(qs, ks, pes)))
    b, _, h, d = qs[0].shape
    if group is not None and not group.spans:
        group = None
    if backend == "ring_rdma":
        outs = ring_flash_shards(*([x.transpose(1, 2) for x in xs] for xs in (qs, ks, vs)), group=group)
        return [o.transpose(1, 2).reshape(b, o.shape[2], h * d) for o in outs]
    if _sequence_parallel_backend(backend):
        name, _, inner = backend.partition(":")
        outs = (ulysses_shards if name == "ulysses" else ring_shards)(qs, ks, vs, backend=inner or None, group=group)
        return [o.reshape(b, o.shape[1], h * d) for o in outs]
    if group is not None:
        home = qs[0].device
        parts = [x.to(home) for xs in (qs, ks, vs) for x in xs]
        outs = _GatheredAcrossProcesses.apply(backend, group.comm, len(qs), *parts)
        return [o.to(q.device) for o, q in zip(outs, qs)]
    home = qs[0].device
    out = attention(*(gather(list(xs), 1, home) for xs in (qs, ks, vs)), backend=backend)
    return [o.to(q.device) for o, q in zip(out.split([q.shape[1] for q in qs], 1), qs)]
