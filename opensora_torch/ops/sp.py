"""Sequence parallelism over the 'sp' axis of a mesh: DeepSpeed-Ulysses
all-to-all and ring attention (counterpart of opensora_tpu/ops/sp.py).

Each function comes in two forms. :func:`ulysses_shards` and
:func:`ring_shards` take one sp group's shards, rank i's q, k, v (B, L/sp,
H, D) on its device, and return rank i's output: what a sequence-sharded
model calls, its ranks each holding a chunk of the tokens
(``ops/attention.attention_shards``). :func:`ulysses_attention` and
:func:`ring_attention` take global q, k, v (B, L, H, D), cut them, run the
shard form and gather the output back: the batch splits over the 'data'
axis, the heads over 'tp' and the sequence over 'sp' (the JAX package's
P(data, sp) with the heads of each tp rank), each (data, tp) coordinate
running its own sp group (``parallel/context.sp_groups``; inside a sharded
model's rank scope only that rank's group, on the rows and heads it holds).
The ranks are held by this process (``parallel/mesh.py``), so
``all_to_all`` and ``ppermute`` are moves between the ranks' shards
(``parallel/comm.py``); the shard forms also take an sp group whose ranks
lie in several processes (a ``comm.ShardGroup``, this process's ranks'
shards in and out), and then exchange with the other processes
(``comm.process_all_to_all``, ``comm.ring_shift``):

- :func:`ulysses_attention` scatters heads and gathers the sequence before
  the attention and does the inverse after; autograd differentiates the
  moves.
- :func:`ring_attention` keeps each rank's Q shard and rotates the KV
  shards, merging the per-hop (out, lse) partials by LSE rescaling
  (:func:`_merge_partials`). Its backward mirrors the reference's: dk/dv
  accumulators travel with the rotating KV and arrive home after a full
  circle, dq accumulates locally from the stored global LSE. Each hop runs
  ``flash_attention_with_lse`` / ``partial_flash_backward`` (the flash
  kernels on CUDA tensors) for the default backend, and plain einsums for
  any other.
"""

from __future__ import annotations

import math
from typing import List, Optional

import torch

from opensora_torch.ops.flash_attention import flash_attention_with_lse, partial_flash_backward
from opensora_torch.parallel.comm import ShardGroup, gather, process_all_to_all, ring_shift, shard
from opensora_torch.parallel.context import sp_groups
from opensora_torch.parallel.mesh import SP_AXIS


def _blocks(xs, rows: int, heads: int):
    """Per (data, tp) piece, in row-major order: each of ``xs`` (B, L, H,
    D) cut into ``rows`` pieces of rows, each cut into ``heads`` pieces of
    heads."""
    cut = [[r.chunk(heads, 2) for r in x.chunk(rows, 0)] for x in xs]
    return [tuple(c[d][t] for c in cut) for d in range(rows) for t in range(heads)]


def _join(outs, rows: int, heads: int) -> torch.Tensor:
    """The inverse of :func:`_blocks` for (B, L, H, D) outputs."""
    return torch.cat([torch.cat(outs[d * heads:(d + 1) * heads], 2) for d in range(rows)], 0)


def _check(q, mesh, rows: int, heads: int):
    sp = mesh.shape[SP_AXIS]
    if q.shape[0] % rows or q.shape[1] % sp or q.shape[2] % heads:
        raise ValueError(f"(B, L, H) = {tuple(q.shape[:3])} does not split over (data, sp, tp) = "
                         f"({rows}, {sp}, {heads})")


def ulysses_shards(qs, ks, vs, backend: Optional[str] = None, group: Optional[ShardGroup] = None
                   ) -> List[torch.Tensor]:
    """DeepSpeed-Ulysses attention over one sp group's shards: rank i's q,
    k, v (B, L/sp, H, D) -> its output (B, L/sp, H, D) (over a ``group``
    that spans processes, this process's ranks'). The sp size must divide
    the heads."""
    from opensora_torch.ops.attention import scaled_dot_product_attention

    sp = len(qs) if group is None else group.size
    if qs[0].shape[2] % sp:
        raise ValueError(f"sp size {sp} must divide heads {qs[0].shape[2]}")
    # (B, L/sp, H, D) -> (B, L, H/sp, D)
    qh, kh, vh = (process_all_to_all(list(x), 2, 1, group) for x in (qs, ks, vs))
    outs = [scaled_dot_product_attention(a.transpose(1, 2).contiguous(), b.transpose(1, 2).contiguous(),
                                         c.transpose(1, 2).contiguous(), backend=backend).transpose(1, 2)
            for a, b, c in zip(qh, kh, vh)]
    # (B, L, H/sp, D) -> (B, L/sp, H, D)
    return process_all_to_all(outs, 1, 2, group)


def ulysses_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mesh,
                      backend: Optional[str] = None) -> torch.Tensor:
    """DeepSpeed-Ulysses attention. q, k, v: global (B, L, H, D); the sp
    size must divide the heads."""
    sp = mesh.shape[SP_AXIS]
    groups, rows, heads = sp_groups(mesh)
    _check(q, mesh, rows, heads)
    if (q.shape[2] // heads) % sp:
        raise ValueError(f"sp size {sp} must divide heads {q.shape[2] // heads} (of {q.shape[2]} over tp {heads})")
    parts = [gather(ulysses_shards(*(shard(x, 1, devices) for x in blk), backend=backend), 1, q.device)
             for devices, blk in zip(groups, _blocks((q, k, v), rows, heads))]
    return _join(parts, rows, heads)


def _merge_partials(o1, lse1, o2, lse2):
    """LSE-rescaled merge of two attention partials (reference
    _rescale_out_lse, distributed.py:305-373). o: (B, H, L, D) fp32; lse:
    (B, H, L)."""
    lse_max = torch.maximum(lse1, lse2)
    w1 = torch.exp(lse1 - lse_max)
    w2 = torch.exp(lse2 - lse_max)
    denom = w1 + w2
    o = o1 * (w1 / denom)[..., None] + o2 * (w2 / denom)[..., None]
    return o, lse_max + torch.log(denom)


def _partial(q, k, v, backend):
    """One hop's (out fp32, lse) partial over (B, H, L, D) shards."""
    if backend is None:
        o, lse = flash_attention_with_lse(q, k, v)
        return o.float(), lse
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) / math.sqrt(q.shape[-1])
    lse = torch.logsumexp(s, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", torch.softmax(s, dim=-1), v.float()), lse


def _bwd_partial(q, k, v, do, lse, delta, backend):
    """One hop's (dq, dk, dv) partials in fp32, given the global LSE and
    delta."""
    if backend is None:
        return tuple(g.float() for g in partial_flash_backward(q, k, v, do.to(q.dtype), lse, delta))
    scale = 1.0 / math.sqrt(q.shape[-1])
    qf, kf, vf = q.float(), k.float(), v.float()
    p = torch.exp(torch.einsum("bhqd,bhkd->bhqk", qf, kf) * scale - lse[..., None])
    dv = torch.einsum("bhqk,bhqd->bhkd", p, do)
    ds = p * (torch.einsum("bhqd,bhkd->bhqk", do, vf) - delta[..., None]) * scale
    return torch.einsum("bhqk,bhkd->bhqd", ds, kf), torch.einsum("bhqk,bhqd->bhkd", ds, qf), dv


class _RingAttention(torch.autograd.Function):
    """Ring attention over one sp group's shards: rank i's q, k, v (B, H,
    L/sp, D), contiguous on its device, in that order after ``backend`` and
    the group (None: every rank here; else this process's ranks); returns
    the ranks' outputs."""

    @staticmethod
    def forward(ctx, backend, group, *shards):
        n = len(shards) // 3
        hops = n if group is None else group.size
        qs, ks, vs = list(shards[:n]), list(shards[n:2 * n]), list(shards[2 * n:])
        # hop 0 on the local shard; each later hop rotates first, then
        # computes, so no rotation's result is discarded
        acc = [_partial(a, b, c, backend) for a, b, c in zip(qs, ks, vs)]
        for _ in range(hops - 1):
            ks, vs = ring_shift(ks, group), ring_shift(vs, group)
            acc = [_merge_partials(*ol, *_partial(a, b, c, backend)) for ol, a, b, c in zip(acc, qs, ks, vs)]
        os_, lses = [x[0] for x in acc], [x[1] for x in acc]
        ctx.save_for_backward(*shards, *os_, *lses)
        ctx.n, ctx.hops, ctx.backend, ctx.group = n, hops, backend, group
        return tuple(o.to(q.dtype) for o, q in zip(os_, qs))

    @staticmethod
    def backward(ctx, *grads):
        n, saved = ctx.n, ctx.saved_tensors
        qs, ks, vs, os_, lses = (list(saved[i * n:(i + 1) * n]) for i in range(5))
        dos = [g.float() for g in grads]
        deltas = [(do * o).sum(-1) for do, o in zip(dos, os_)]

        def partials():
            return [_bwd_partial(*a, ctx.backend) for a in zip(qs, ks, vs, dos, lses, deltas)]

        # hop 0 on the local shard; the dk/dv accumulators rotate after
        # every hop's add (hop 0 included): sp hops bring each home
        group = ctx.group
        parts = partials()
        dq = [p[0] for p in parts]
        dk, dv = ring_shift([p[1] for p in parts], group), ring_shift([p[2] for p in parts], group)
        for _ in range(ctx.hops - 1):
            ks, vs = ring_shift(ks, group), ring_shift(vs, group)
            parts = partials()
            dq = [a + p[0] for a, p in zip(dq, parts)]
            dk = ring_shift([a + p[1] for a, p in zip(dk, parts)], group)
            dv = ring_shift([a + p[2] for a, p in zip(dv, parts)], group)
        qs, ks, vs = (list(saved[i * n:(i + 1) * n]) for i in range(3))
        return (None, None, *(g.to(x.dtype) for g, x in zip(dq + dk + dv, qs + ks + vs)))


def ring_shards(qs, ks, vs, backend: Optional[str] = None, group: Optional[ShardGroup] = None
                ) -> List[torch.Tensor]:
    """Ring attention over one sp group's shards: rank i's q, k, v (B,
    L/sp, H, D) -> its output (B, L/sp, H, D) (over a ``group`` that spans
    processes, this process's ranks'). Differentiable (custom backward)."""
    outs = _RingAttention.apply(backend, group, *(x.transpose(1, 2).contiguous() for x in (*qs, *ks, *vs)))
    return [o.transpose(1, 2) for o in outs]


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mesh,
                   backend: Optional[str] = None) -> torch.Tensor:
    """Ring attention: every rank keeps its Q shard; KV shards rotate
    around the 'sp' ring, partials merge by LSE rescaling (reference
    RingAttention, distributed.py:219-373). q, k, v: global (B, L, H, D).
    Differentiable (custom backward)."""
    groups, rows, heads = sp_groups(mesh)
    _check(q, mesh, rows, heads)
    parts = [gather(ring_shards(*(shard(x, 1, devices) for x in blk), backend=backend), 1, q.device)
             for devices, blk in zip(groups, _blocks((q, k, v), rows, heads))]
    return _join(parts, rows, heads)
