"""Moving data between the ranks of a mesh: within one process, and
across processes.

The JAX package moves shards between chips with ``lax.all_to_all`` and
``lax.ppermute`` (ops/sp.py) and, inside the ring kernels, with
``make_async_remote_copy`` plus DMA and "ack" semaphores
(ops/ring_flash.py:108-116,166-181). Within a process, each rank's tensors
live on the rank's device:

- :func:`shard`, :func:`gather`, :func:`all_to_all` and :func:`ppermute`
  are copies between the ranks' tensors, differentiable by autograd;
- :func:`send` is the pipeline's stage-to-stage send (the acyclic
  ``ppermute`` of opensora_tpu/parallel/pipeline.py:138) and
  :func:`broadcast` the last stage's outputs on every stage (its ``psum``,
  :152-160); both are differentiable, each copy's backward the reverse
  copy, so autograd runs the pipeline backwards;
- :func:`all_reduce` (sum), :func:`all_reduce_max`, :func:`all_gather` and
  :func:`reduce_scatter`
  run over a group of ranks (``Mesh.group``), given the ranks' tensors in
  group order; they too are differentiable, and ranks that share a device
  share one result (a mesh of logical ranks on one card computes it once);
- :class:`RingTransport` is the double-buffered ring of the in-kernel ring
  attention. Each rank has two slots per rotating buffer. The copy of a
  rank's slot ``cur`` into its right neighbour's slot ``nxt`` runs on the
  rank's copy stream while the rank computes on ``cur``; a "received" event
  gates the neighbour's next hop on that slot, and an "ack" event, recorded
  after the hop that read a slot and after the sends out of it drained,
  gates the next copy into that slot. Ranks run their hops on their own
  compute streams, so on one card the ranks' hops overlap each other and
  the copies. Every buffer is allocated on the caller's stream before the
  ring starts, and at the end the caller's stream waits on every rank's
  streams, so the caching allocator never hands out a buffer that another
  stream still uses. The copies are real copies between the ranks' slots,
  also when all ranks share a card.

With ``sequential=True`` (always for CPU tensors) the same slot logic runs
in program order on the caller's stream: no streams, no events.

Across processes (a multi-process run, ``parallel/distributed.py``, whose
mesh's axes may each cross them) the collectives are
``torch.distributed``'s over a group of processes (``distributed.Group``,
default every process), each under a profiler span ``"dist_collective"``:
:func:`process_all_reduce` (sum), :func:`process_all_gather` (joined along
a dim), :func:`process_reduce_scatter` (this process's piece of the sum),
:func:`process_gather` (to one process), :func:`process_gather_shards`, the
FSDP all-gather over a 'data' group as an autograd Function whose backward
is the reduce-scatter of the gradients, summed in fp32,
:func:`process_all_to_all` (Ulysses over an sp group, differentiable),
:func:`ring_shift` (the plain ring's shift over an sp group) and
:func:`gather_replicated` (a tensor whose pieces the processes hold, whole
on each, for a computation every process of the group repeats). An sp
group is described by a :class:`ShardGroup`: its size, this process's run
of its ranks, and the group of its processes. :class:`RingTransport` sends
a slot whose right neighbour lies in another process with ``isend`` and
receives its own other slot with ``irecv`` (``RING_REMOTE`` counts those
sends and their bytes). A tp group across processes sums its row-parallel
partials with :func:`all_reduce` / :func:`all_reduce_max` given the group
(:func:`tp_all_reduce`, whose backward sums the gradient over the group
too; ``TP_REMOTE`` counts them and their bytes). Pipeline stages in other
processes exchange a boundary's tensors, of shapes both sides know, packed
in one message, and their gradients back in one message, with
:func:`post_pipeline_messages`: each process posts a slot's messages in
one order that both sides derive from the schedule (``parallel/
pipeline.py``), under one tag, as one ``batch_isend_irecv``; its receives
are waited for at use (:class:`Incoming`); ``PP_REMOTE`` counts the
messages and their bytes and logs each pair's sequence; :func:`wait_sends`
waits for the posted sends. Under ``nccl`` they run on the tensors where they
lie. Under ``gloo`` a CUDA tensor is staged: copied to host memory
(:func:`staged_copy`), the gloo op, copied back; ``STAGED`` counts those
copies and their bytes (gloo is not asked to read device memory).
"""

from __future__ import annotations

import contextlib
import math
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from opensora_torch.parallel import distributed


def shard(x: torch.Tensor, dim: int, devices: Sequence[torch.device]) -> List[torch.Tensor]:
    """``x`` cut into len(devices) equal contiguous pieces along ``dim``,
    piece i on devices[i]."""
    n = len(devices)
    if x.shape[dim] % n:
        raise ValueError(f"dimension {dim} of {tuple(x.shape)} does not split over {n} ranks")
    return [p.to(d).contiguous() for p, d in zip(x.chunk(n, dim), devices)]


def gather(parts: Sequence[torch.Tensor], dim: int, device: torch.device) -> torch.Tensor:
    """The ranks' tensors concatenated along ``dim`` in rank order, on
    ``device``: :func:`all_gather` for the one rank that reads it."""
    return torch.cat([p.to(device) for p in parts], dim)


def all_to_all(parts: Sequence[torch.Tensor], split_dim: int, concat_dim: int) -> List[torch.Tensor]:
    """``lax.all_to_all(tiled=True)`` over the ranks' tensors: rank j
    receives piece j (along ``split_dim``) of every rank, concatenated along
    ``concat_dim`` in rank order."""
    n = len(parts)
    pieces = [p.chunk(n, split_dim) for p in parts]
    return [torch.cat([pieces[i][j].to(parts[j].device) for i in range(n)], concat_dim) for j in range(n)]


def ppermute(parts: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """The ring shift i -> i + 1: rank i receives rank i - 1's tensor."""
    n = len(parts)
    return [parts[(i - 1) % n].to(parts[i].device) for i in range(n)]


def copy_to(x: torch.Tensor, device) -> torch.Tensor:
    """A contiguous copy of ``x`` on ``device`` that shares no storage,
    also where ``device`` is ``x``'s own."""
    out = torch.empty(x.shape, dtype=x.dtype, device=device)
    out.copy_(x)
    return out


class _Send(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, device):
        ctx.source = x.device
        return copy_to(x, device)

    @staticmethod
    def backward(ctx, grad):
        return copy_to(grad, ctx.source), None


def send(parts: Sequence[torch.Tensor], devices: Sequence[torch.device]) -> List[torch.Tensor]:
    """Rank i's tensor copied to ``devices[i]`` (the next pipeline stage's
    rank), a buffer of the receiver's own even on the sender's device, as
    the ranks of a ring hold their own slots. A tensor that several ranks
    share is sent once per destination device. Differentiable: the
    gradient is sent back."""
    done: Dict[Tuple[int, torch.device], torch.Tensor] = {}
    out = []
    for p, d in zip(parts, devices):
        key = (id(p), torch.device(d))
        if key not in done:
            done[key] = _Send.apply(p, d)
        out.append(done[key])
    return out


def broadcast(x: torch.Tensor, source: torch.device, devices: Sequence[torch.device]) -> List[torch.Tensor]:
    """``x``, held by the rank on ``source``, on every rank's device: the
    tensor itself on ``source``, one copy per other distinct device (ranks
    that share a device share it). Its gradient is the sum of the ranks'
    gradients."""
    done: Dict[torch.device, torch.Tensor] = {torch.device(source): x}
    out = []
    for d in devices:
        d = torch.device(d)
        if d not in done:
            done[d] = _Send.apply(x, d)
        out.append(done[d])
    return out


def _per_device(parts: Sequence[torch.Tensor], fn) -> List[torch.Tensor]:
    """``fn(device)`` for each rank's device, computed once per distinct
    device: ranks that share a device share the result."""
    done: Dict[torch.device, torch.Tensor] = {}
    out = []
    for p in parts:
        if p.device not in done:
            done[p.device] = fn(p.device)
        out.append(done[p.device])
    return out


def all_reduce(parts: Sequence[torch.Tensor], dtype=None, bias=None,
               group: Optional[distributed.Group] = None) -> List[torch.Tensor]:
    """The sum of the ranks' tensors, on every rank's device. The sum is
    taken in fp32 and rounded once to ``dtype`` (default: the parts'), so
    that tp partial products summed in bf16 do not drift from the
    unsharded product; ``bias`` (per rank, replicated), where given, is
    added once to the fp32 sum before that rounding (a row-parallel
    product's bias). Differentiable: each part receives the gradient of the
    sum. Where the group's ranks lie in several processes (``group``, the
    processes of a tp group), ``parts`` are this process's ranks': their
    fp32 sum is summed over the processes (:func:`tp_all_reduce`), then the
    bias is added, once, and the total rounded."""
    dtype = dtype or parts[0].dtype
    devices = [p.device for p in parts]
    if group is not None and group.size > 1:
        across = tp_all_reduce(sum(p.to(devices[0]).float() for p in parts), group)

        def summed(device):
            return across.to(device)
    else:
        def summed(device):
            return sum(p.to(device).float() for p in parts)

    def total(device):
        s = summed(device)
        if bias is not None:
            s = s + bias[devices.index(device)].float()
        return s.to(dtype)

    with torch.profiler.record_function("all_reduce"):  # a profile's span of the collective
        return _per_device(parts, total)


def all_reduce_max(parts: Sequence[torch.Tensor], group: Optional[distributed.Group] = None) -> List[torch.Tensor]:
    """The elementwise max of the ranks' tensors, on every rank's device
    (the per-token activation scale of an int8 row-parallel product, whose
    row the ranks hold in slices); over ``group`` (a tp group's processes)
    the max of this process's ranks', then over the processes."""
    if group is None or group.size == 1:
        return _per_device(parts, lambda device: torch.stack([p.to(device) for p in parts]).amax(0))
    home = parts[0].device
    local = torch.stack([p.to(home) for p in parts]).amax(0)
    _count_tp(local)
    total = process_all_reduce(local, group, dist.ReduceOp.MAX)
    return _per_device(parts, lambda device: total.to(device))


def all_gather(parts: Sequence[torch.Tensor], dim: int) -> List[torch.Tensor]:
    """Every rank's tensor concatenated along ``dim`` in rank order, on
    every rank's device. Its gradient is the reduce-scatter: each part
    receives the sum over the ranks of its slice of their gradients."""
    return _per_device(parts, lambda device: gather(parts, dim, device))


def reduce_scatter(parts: Sequence[torch.Tensor], dim: int) -> List[torch.Tensor]:
    """Rank i receives piece i (along ``dim``) of the sum of the ranks'
    tensors, summed in fp32 and rounded once to their dtype."""
    n = len(parts)
    if parts[0].shape[dim] % n:
        raise ValueError(f"dimension {dim} of {tuple(parts[0].shape)} does not split over {n} ranks")
    pieces = [p.chunk(n, dim) for p in parts]
    return [sum(pieces[j][i].to(parts[i].device).float() for j in range(n)).to(parts[i].dtype) for i in range(n)]


# ---------------------------------------------------------------------------
# across processes
# ---------------------------------------------------------------------------

# the staged copies of the gloo collectives on CUDA tensors since the last
# reset: how many, and their bytes
STAGED = {"copies": 0, "bytes": 0}
DIST_SPAN = "dist_collective"  # a profile's span of each collective across processes


def staged_copy(x: torch.Tensor, device) -> torch.Tensor:
    """A copy of ``x`` on ``device``: a gloo collective's host staging of a
    CUDA tensor (into page-locked memory), or its way back. Counted in
    ``STAGED``."""
    STAGED["copies"] += 1
    STAGED["bytes"] += x.numel() * x.element_size()
    if torch.device(device).type == "cpu":
        out = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
        out.copy_(x)
        return out
    return copy_to(x, device)


def _transport_device() -> torch.device:
    """Where the backend reads and writes: host memory for gloo, the
    process's card for nccl."""
    return torch.device("cpu") if distributed.backend() == "gloo" else distributed.group().device


def _send_buffer(x: torch.Tensor) -> torch.Tensor:
    """A contiguous copy of ``x`` on the transport's device, which the
    collective may read and overwrite (a staged copy for a CUDA tensor
    under gloo)."""
    dev = _transport_device()
    return staged_copy(x.contiguous(), dev) if dev.type == "cpu" and x.device.type == "cuda" else copy_to(x, dev)


def _receive_buffer(like: torch.Tensor) -> torch.Tensor:
    """An empty transport buffer shaped like ``like`` (page-locked where
    ``like`` is)."""
    return torch.empty(like.shape, dtype=like.dtype, device=like.device, pin_memory=like.is_pinned())


def _landed(buf: torch.Tensor, device) -> torch.Tensor:
    """A transport buffer on ``device``."""
    device = torch.device(device)
    if buf.device == device:
        return buf
    return staged_copy(buf, device) if buf.device.type == "cpu" and device.type == "cuda" else \
        copy_to(buf, device)


def _transport_buffer(shape, dtype, device) -> torch.Tensor:
    """An empty buffer the backend receives into, for a tensor bound for
    ``device`` (page-locked host memory for a CUDA tensor under gloo)."""
    dev = _transport_device()
    pin = dev.type == "cpu" and torch.device(device).type == "cuda"
    return torch.empty(tuple(shape), dtype=dtype, device=dev, pin_memory=pin)


def _group(group: Optional[distributed.Group]) -> distributed.Group:
    return distributed.world() if group is None else group


def process_all_reduce(x: torch.Tensor, group: Optional[distributed.Group] = None,
                       op=dist.ReduceOp.SUM) -> torch.Tensor:
    """The sum (or ``op``) over the processes of ``group`` (default: every
    process) of their ``x`` (same shape and dtype), a new tensor on ``x``'s
    device."""
    group = _group(group)
    if group.size == 1:
        return x.clone()
    with torch.profiler.record_function(DIST_SPAN):
        buf = _send_buffer(x)
        dist.all_reduce(buf, op=op, group=group.handle)
        return _landed(buf, x.device)


def process_broadcast(x: torch.Tensor, src: int, group: Optional[distributed.Group] = None) -> torch.Tensor:
    """Process ``src``'s ``x`` (same shape and dtype on every process of
    ``group``, default every process), a new tensor on ``x``'s device (on
    ``src``, ``x`` itself)."""
    group = _group(group)
    if group.size == 1:
        return x
    with torch.profiler.record_function(DIST_SPAN):
        buf = _send_buffer(x)
        dist.broadcast(buf, src, group=group.handle)
        return x if distributed.process_index() == src else _landed(buf, x.device)


_PENDING: List[tuple] = []  # (work, buffer) of the sends not yet waited for


def process_isend(x: torch.Tensor, dst: int, tag: int = 0) -> None:
    """``x`` to process ``dst`` without waiting (a copy kept until
    :func:`wait_sends`), which takes it with :func:`process_recv` under the
    same ``tag`` (messages of one tag between two processes arrive in
    order)."""
    with torch.profiler.record_function(DIST_SPAN):
        buf = _send_buffer(x.contiguous())
        _PENDING.append((dist.isend(buf, dst, tag=tag), buf))


def process_recv(shape, dtype, device, src: int, tag: int = 0) -> torch.Tensor:
    """The tensor (of ``shape`` and ``dtype``) process ``src`` sends with
    :func:`process_isend` under ``tag``, waited for, on ``device``."""
    with torch.profiler.record_function(DIST_SPAN):
        buf = _transport_buffer(shape, dtype, device)
        dist.recv(buf, src, tag=tag)
        return _landed(buf, device)


def process_exchange(sends: Sequence[Tuple[int, torch.Tensor]], recvs: Sequence[Tuple[int, torch.Tensor]],
                     group: Optional[distributed.Group] = None) -> List[torch.Tensor]:
    """Tensors to and from other processes of ``group`` (default: every
    process; peers by their rank in the run), posted together as one
    ``batch_isend_irecv`` and waited for: ``sends`` (dst, x); ``recvs``
    (src, like), each received shaped as ``like`` onto its device. Returns
    the received tensors, in order."""
    if not sends and not recvs:
        return []
    handle = _group(group).handle
    with torch.profiler.record_function(DIST_SPAN):
        ops, into = [], []
        for src, like in recvs:
            buf = _transport_buffer(like.shape, like.dtype, like.device)
            into.append((buf, like.device))
            ops.append(dist.P2POp(dist.irecv, buf, src, handle))
        out = [_send_buffer(x.contiguous()) for _, x in sends]
        ops += [dist.P2POp(dist.isend, buf, dst, handle) for (dst, _), buf in zip(sends, out)]
        for work in dist.batch_isend_irecv(ops):
            work.wait()
        return [_landed(buf, device) for buf, device in into]


def wait_sends() -> None:
    """Wait until every send posted so far has left (the buffers freed)."""
    while _PENDING:
        work, _ = _PENDING.pop(0)
        work.wait()


def process_all_gather(x: torch.Tensor, dim: int = 0, group: Optional[distributed.Group] = None) -> torch.Tensor:
    """The ``x`` (same shape) of the processes of ``group`` (default: every
    process) joined along ``dim`` in process order, on ``x``'s device
    (joined there)."""
    group = _group(group)
    if group.size == 1:
        return x
    with torch.profiler.record_function(DIST_SPAN):
        buf = _send_buffer(x)
        parts = [_receive_buffer(buf) for _ in range(group.size)]
        dist.all_gather(parts, buf, group=group.handle)
        return torch.cat([_landed(p, x.device) for p in parts], dim)


def process_reduce_scatter(x: torch.Tensor, dim: int, group: Optional[distributed.Group] = None) -> torch.Tensor:
    """Piece i (of ``group.size`` equal pieces along ``dim``) of the sum
    over the processes of ``group`` (default: every process) of their
    ``x``, on the group's i-th process, on ``x``'s device (the pieces cut
    where ``x`` lies)."""
    group = _group(group)
    n = group.size
    if x.shape[dim] % n:
        raise ValueError(f"dimension {dim} of {tuple(x.shape)} does not split over {n} processes")
    if n == 1:
        return x.clone()
    with torch.profiler.record_function(DIST_SPAN):
        pieces = [_send_buffer(c) for c in x.chunk(n, dim)]
        out = _receive_buffer(pieces[0])
        dist.reduce_scatter(out, pieces, group=group.handle)
        return _landed(out, x.device)


def process_gather(x: torch.Tensor, dst: int = 0) -> Optional[List[torch.Tensor]]:
    """Every process's ``x`` (same shape), in process order, on process
    ``dst`` (on ``x``'s device); None on the others."""
    with torch.profiler.record_function(DIST_SPAN):
        buf = _send_buffer(x)
        parts = [_receive_buffer(buf) for _ in range(distributed.process_count())] \
            if distributed.process_index() == dst else None
        dist.gather(buf, parts, dst=dst)
        return None if parts is None else [_landed(p, x.device) for p in parts]


class _GatherShards(torch.autograd.Function):
    """Forward: this process's shards cast to ``dtype`` and joined along
    ``dim`` on ``device``, then joined with the other processes' of
    ``group`` (the FSDP all-gather over a 'data' group). Backward: the
    reduce-scatter of the gradient over the group, summed in fp32, each
    shard receiving its slice in its own dtype."""

    @staticmethod
    def forward(ctx, dim, dtype, device, group, *shards):
        ctx.dim, ctx.group, ctx.meta = dim, group, [(s.shape[dim], s.device, s.dtype) for s in shards]
        local = torch.cat([s.to(device=device, dtype=dtype) for s in shards], dim)
        return process_all_gather(local, dim, group)

    @staticmethod
    def backward(ctx, grad):
        mine = process_reduce_scatter(grad.float(), ctx.dim, ctx.group)
        pieces = mine.split([n for n, _, _ in ctx.meta], ctx.dim)
        return (None, None, None, None, *(p.to(device=d, dtype=t) for p, (_, d, t) in zip(pieces, ctx.meta)))


def process_gather_shards(shards: Sequence[torch.Tensor], dim: int, dtype, device,
                          group: Optional[distributed.Group] = None) -> torch.Tensor:
    """The FSDP all-gather across the processes of a 'data' ``group``
    (default: every process; see :class:`_GatherShards`): ``shards`` are
    this process's, in 'data' order."""
    return _GatherShards.apply(dim, dtype, torch.device(device), group, *shards)


# ---------------------------------------------------------------------------
# a tp group across processes
# ---------------------------------------------------------------------------

# the tp group's all-reduces across processes since the last reset (the
# row-parallel sums, forward and backward, and int8's row max): how many,
# and their bytes
TP_REMOTE = {"all_reduces": 0, "bytes": 0}


def _count_tp(x: torch.Tensor) -> None:
    TP_REMOTE["all_reduces"] += 1
    TP_REMOTE["bytes"] += x.numel() * x.element_size()


class _TpSum(torch.autograd.Function):
    """Forward: the sum over a tp group's processes; backward: the same sum
    of the gradient. Each process of the group computes the replicated part
    of a block (the modulation, norms and residuals) with its own share of
    the gradient, and the shares meet here, at the row-parallel sums, and in
    the replicated leaves' sum over their holders
    (``ModelSharding.sync_replica_grads``)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        _count_tp(x)
        return process_all_reduce(x, group)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous()
        _count_tp(grad)
        return process_all_reduce(grad, ctx.group), None


def tp_all_reduce(x: torch.Tensor, group: distributed.Group) -> torch.Tensor:
    """The sum of ``x`` over the processes of a tp ``group`` (in fp32 where
    ``x`` is), counted in ``TP_REMOTE``; differentiable, its backward the
    same sum of the gradient: a process's gradient of a tensor the group
    replicates is its share, and the shares add up to the gradient."""
    return _TpSum.apply(x, group)


# ---------------------------------------------------------------------------
# an sp group across processes
# ---------------------------------------------------------------------------

# the ring transport's sends to another process since the last reset: how
# many, and their bytes
RING_REMOTE = {"sends": 0, "bytes": 0}


@dataclass(frozen=True)
class ShardGroup:
    """One sp group: ``size`` ranks, this process's a contiguous run from
    ``first``, ``processes[i]`` the process of rank i, and ``comm`` the
    group of its processes (this process alone where the group lies in
    it)."""

    size: int
    first: int
    processes: Tuple[int, ...]
    comm: distributed.Group

    @classmethod
    def local(cls, n: int) -> "ShardGroup":
        """A group of ``n`` ranks all in this process."""
        me = distributed.process_index()
        return cls(n, 0, (me,) * n, distributed.Group((me,)))

    @property
    def spans(self) -> bool:
        return self.comm.size > 1

    def process_of(self, i: int) -> int:
        return self.processes[i % self.size]


def ring_shift(parts: Sequence[torch.Tensor], group: Optional[ShardGroup] = None) -> List[torch.Tensor]:
    """:func:`ppermute` over an sp group whose ranks may lie in several
    processes: ``parts`` are this process's ranks' tensors; each receives
    its left neighbour's, the first from the previous process."""
    if group is None or not group.spans:
        return ppermute(parts)
    m = len(parts)
    right, left = group.process_of(group.first + m), group.process_of(group.first - 1)
    with torch.profiler.record_function(DIST_SPAN):
        sbuf = _send_buffer(parts[-1])
        rbuf = _receive_buffer(sbuf)  # the ranks' tensors are alike
        # posted together: the receive and the send of a pair never wait on each other
        for w in dist.batch_isend_irecv([dist.P2POp(dist.irecv, rbuf, left, group.comm.handle),
                                         dist.P2POp(dist.isend, sbuf, right, group.comm.handle)]):
            w.wait()
        first = _landed(rbuf, parts[0].device)
    return [first] + [parts[k - 1].to(parts[k].device) for k in range(1, m)]


class _AllToAll(torch.autograd.Function):
    """:func:`all_to_all` over an sp group across processes: this process's
    ranks' tensors in, theirs out; its backward the inverse all-to-all."""

    @staticmethod
    def forward(ctx, group, split_dim, concat_dim, *parts):
        ctx.group, ctx.dims = group, (split_dim, concat_dim)
        return tuple(_all_to_all(parts, split_dim, concat_dim, group))

    @staticmethod
    def backward(ctx, *grads):
        split_dim, concat_dim = ctx.dims
        return (None, None, None, *_all_to_all([g.contiguous() for g in grads], concat_dim, split_dim, ctx.group))


def _all_to_all(parts, split_dim: int, concat_dim: int, group: ShardGroup) -> List[torch.Tensor]:
    """Rank j of this process receives piece j (along ``split_dim``) of
    every rank i of the group: from this process's ranks by a move, from
    another process's in one message per process (its ranks' pieces for
    this process's ranks, stacked i-major)."""
    n, me = group.size, distributed.process_index()
    mine = list(range(group.first, group.first + len(parts)))
    pieces = {i: p.chunk(n, split_dim) for i, p in zip(mine, parts)}
    got: Dict[Tuple[int, int], torch.Tensor] = {}
    with torch.profiler.record_function(DIST_SPAN):
        ops, received = [], {}
        for q in group.comm.ranks:
            if q == me:
                continue
            theirs = [i for i in range(n) if group.processes[i] == q]
            sbuf = _send_buffer(torch.stack([pieces[i][j] for i in mine for j in theirs]))
            received[q] = (theirs, _receive_buffer(sbuf))
            ops += [dist.P2POp(dist.irecv, received[q][1], q, group.comm.handle),
                    dist.P2POp(dist.isend, sbuf, q, group.comm.handle)]
        for w in dist.batch_isend_irecv(ops):
            w.wait()
        for q, (theirs, rbuf) in received.items():
            rows = _landed(rbuf, parts[0].device).unbind(0)
            for a, i in enumerate(theirs):
                for b, j in enumerate(mine):
                    got[(i, j)] = rows[a * len(mine) + b]
    return [torch.cat([(pieces[i][j] if i in pieces else got[(i, j)]).to(p.device) for i in range(n)], concat_dim)
            for j, p in zip(mine, parts)]


def process_all_to_all(parts: Sequence[torch.Tensor], split_dim: int, concat_dim: int,
                       group: Optional[ShardGroup] = None) -> List[torch.Tensor]:
    """:func:`all_to_all` over an sp group whose ranks may lie in several
    processes: this process's ranks' tensors in and out (rank j receives
    piece j of every rank, joined in rank order); differentiable."""
    if group is None or not group.spans:
        return all_to_all(parts, split_dim, concat_dim)
    return list(_AllToAll.apply(group, split_dim, concat_dim, *(p.contiguous() for p in parts)))


class _GatherReplicated(torch.autograd.Function):
    @staticmethod
    def forward(ctx, dim, sizes, group, x, *anchors):
        ctx.dim, ctx.lo, ctx.n = dim, sum(sizes[:group.index()]), x.shape[dim]
        ctx.anchors = [(a.shape, a.dtype, a.device) for a in anchors]
        pad = max(sizes) - x.shape[dim]
        padded = torch.cat([x, x.new_zeros((*x.shape[:dim], pad, *x.shape[dim + 1:]))], dim) if pad else x
        whole = process_all_gather(padded.contiguous(), dim, group)
        return torch.cat([p.narrow(dim, 0, n) for p, n in zip(whole.chunk(group.size, dim), sizes)], dim)

    @staticmethod
    def backward(ctx, grad):
        return (None, None, None, grad.narrow(ctx.dim, ctx.lo, ctx.n),
                *(torch.zeros(s, dtype=t, device=d) for s, t, d in ctx.anchors))


def gather_replicated(x: torch.Tensor, dim: int, sizes: Sequence[int], group: distributed.Group,
                      anchors: Sequence[torch.Tensor] = ()) -> torch.Tensor:
    """The processes' pieces (``sizes[i]`` long along ``dim`` on the group's
    i-th process; ``x`` this process's) joined in process order, on every
    process. Differentiable for a computation that every process of the
    group repeats on the joined tensor: a piece's gradient is then the
    slice of its own process's gradient, taken with no exchange (the
    masked loss of an sp group's output, which every process of the group
    computes whole). ``anchors`` (tensors the piece came from) receive a
    zero gradient, so that the backward runs through everything they came
    from even where the piece is empty: a process whose ranks hold only
    text tokens still takes part in the backward's exchanges of the sp
    group, and its tokens' gradients arrive through them."""
    if group.size == 1:
        return x
    return _GatherReplicated.apply(dim, list(sizes), group, x, *anchors)


_STREAMS: Dict[Tuple[int, int, str], torch.cuda.Stream] = {}


def _stream(device: torch.device, rank: int, kind: str) -> "torch.cuda.Stream":
    key = (device.index if device.index is not None else torch.cuda.current_device(), rank, kind)
    if key not in _STREAMS:
        _STREAMS[key] = torch.cuda.Stream(device=device)
    return _STREAMS[key]


class RingTransport:
    """The slots, streams and events of one ring: this process's ranks of
    an sp group (``group``, default: every rank here), rank r (local index,
    the group's rank ``group.first + r``) on devices[r]; its right
    neighbour is the next rank of the group. Use: allocate slots with
    :meth:`slots`, fill slot 0, :meth:`start`, then per hop and rank,
    inside ``with t.on(r)``: :meth:`wait_received`, :meth:`send`, the hop's
    compute, :meth:`release`; last :meth:`finish`.

    A send to a neighbour in another process (from this process's last
    rank) posts, with its ``isend``, the ``irecv`` of this process's first
    rank's other slot from the previous process (``batch_isend_irecv``,
    the receive first). "Received" is then the receive's completion and
    the copy in (from host memory under gloo); the "ack" of the sent slot
    is the send's completion, waited for in :meth:`release`. Under gloo a
    CUDA slot is staged through page-locked host memory (``STAGED``); the
    sends are counted in ``RING_REMOTE``. Every process posts its ring's
    sends and receives in the same hop order, and a ring has waited for
    all of them when :meth:`finish` returns: the rings of other tp ranks,
    run one after another, never meet its messages."""

    def __init__(self, devices: Sequence[torch.device], sequential: bool = False,
                 group: Optional[ShardGroup] = None):
        self.devices = [torch.device(d) for d in devices]
        self.m = len(self.devices)
        self.group = group or ShardGroup.local(self.m)
        self.n = self.group.size
        self.sequential = sequential or self.devices[0].type != "cuda"
        if not self.sequential:
            self.compute = [_stream(d, r, "compute") for r, d in enumerate(self.devices)]
            self.copy = [_stream(d, r, "copy") for r, d in enumerate(self.devices)]
        self._received: Dict[Tuple[str, int, int], torch.cuda.Event] = {}
        self._ack: Dict[Tuple[int, int], torch.cuda.Event] = {}
        self._sent: Dict[Tuple[int, int], List[torch.cuda.Event]] = {}
        # a receive from another process: per (name, rank, slot), its work, host buffer (or None) and slots
        self._incoming: Dict[Tuple[str, int, int], tuple] = {}
        self._outgoing: Dict[Tuple[int, int], list] = {}  # sends to another process: (work, its buffer)

    def slots(self, shape, dtype, zero_first: bool = False) -> List[torch.Tensor]:
        """Per rank a (2, *shape) buffer: slot 0 and slot 1 (slot 0 zeroed
        with ``zero_first``), allocated on the caller's stream."""
        out = [torch.empty((2, *shape), dtype=dtype, device=d) for d in self.devices]
        if zero_first:
            for b in out:
                b[0].zero_()
        return out

    def start(self) -> None:
        """Every rank's streams wait for the caller's stream (the buffers
        and inputs it prepared)."""
        if self.sequential:
            return
        for r, d in enumerate(self.devices):
            ready = torch.cuda.Event()
            ready.record(torch.cuda.current_stream(d))
            self.compute[r].wait_event(ready)
            self.copy[r].wait_event(ready)

    @contextlib.contextmanager
    def on(self, r: int):
        """Rank r's compute stream as the current stream."""
        if self.sequential:
            yield
            return
        with torch.cuda.device(self.devices[r]), torch.cuda.stream(self.compute[r]):
            yield

    def wait_received(self, r: int, name: str, slot: int) -> None:
        """Rank r's compute waits until its ``slot`` of ``name`` arrived."""
        incoming = self._incoming.pop((name, r, slot), None)
        if incoming is not None:
            self._land(name, *incoming, slot)
        ev = self._received.get((name, r, slot))
        if ev is not None:
            self.compute[r].wait_event(ev)

    def _land(self, name: str, work, buf: Optional[torch.Tensor], slots: torch.Tensor, slot: int) -> None:
        """A receive from another process completes, then (from host
        memory) the copy into ``slots[slot]``, on the current stream."""
        work.wait()
        if buf is not None:
            STAGED["copies"] += 1
            STAGED["bytes"] += buf.numel() * buf.element_size()
            slots[slot].copy_(buf, non_blocking=True)

    def send(self, r: int, name: str, bufs: Sequence[torch.Tensor], cur: int) -> None:
        """Copy rank r's slot ``cur`` of ``bufs`` into its right neighbour's
        other slot, once what r's compute stream has queued so far is done
        and the neighbour acknowledged its last use of that slot (to
        another process: see the class docstring)."""
        nxt = 1 - cur
        if self.group.spans and r == self.m - 1:
            self._send_remote(r, name, bufs, cur)
            return
        right = (r + 1) % self.m
        src, dst = bufs[r][cur], bufs[right][nxt]
        if self.sequential:
            dst.copy_(src)
            return
        stream = self.copy[r]
        ready = torch.cuda.Event()
        ready.record(self.compute[r])
        stream.wait_event(ready)
        ack = self._ack.get((right, nxt))
        if ack is not None:
            stream.wait_event(ack)
        with torch.cuda.device(self.devices[r]), torch.cuda.stream(stream):
            dst.copy_(src, non_blocking=True)
        done = torch.cuda.Event()
        done.record(stream)
        self._received[(name, right, nxt)] = done
        self._sent.setdefault((r, cur), []).append(done)

    def _send_remote(self, r: int, name: str, bufs: Sequence[torch.Tensor], cur: int) -> None:
        """Rank r's slot ``cur`` to the next process, and this process's
        first rank's other slot from the previous one (on rank r's compute
        stream, which first waits for the first rank's last use of that
        slot)."""
        nxt, g = 1 - cur, self.group
        src, dst = bufs[r][cur], bufs[0][nxt]
        RING_REMOTE["sends"] += 1
        RING_REMOTE["bytes"] += src.numel() * src.element_size()
        right, left = g.process_of(g.first + self.m), g.process_of(g.first - 1)
        ack = None if self.sequential else self._ack.get((0, nxt))
        if ack is not None:
            self.compute[r].wait_event(ack)
        staged = src.device.type == "cuda" and distributed.backend() == "gloo"
        with torch.profiler.record_function(DIST_SPAN), (contextlib.nullcontext() if self.sequential else self.on(r)):
            out = staged_copy(src, "cpu") if staged else src
            into = torch.empty(dst.shape, dtype=dst.dtype, pin_memory=True) if staged else dst
            works = dist.batch_isend_irecv([dist.P2POp(dist.irecv, into, left, g.comm.handle),
                                            dist.P2POp(dist.isend, out, right, g.comm.handle)])
        # nccl coalesces the pair into one work
        self._incoming[(name, 0, nxt)] = (works[0], into if staged else None, bufs[0])
        self._outgoing.setdefault((r, cur), []).append((works[-1], out))

    def release(self, r: int, slot: int) -> None:
        """Rank r is done with ``slot``: its reads are queued and its sends
        out of it drain first; then the left neighbour may overwrite it."""
        for work, _ in self._outgoing.pop((r, slot), []):
            work.wait()
        if self.sequential:
            return
        for ev in self._sent.pop((r, slot), []):
            self.compute[r].wait_event(ev)
        ack = torch.cuda.Event()
        ack.record(self.compute[r])
        self._ack[(r, slot)] = ack

    def finish(self) -> None:
        """The receives still open land (the dK/dV accumulators' last
        hop), then the caller's stream waits on every rank's streams."""
        for (name, r, slot), incoming in list(self._incoming.items()):
            with self.on(r):
                self._land(name, *incoming, slot)
        self._incoming.clear()
        if self.sequential:
            return
        for r, d in enumerate(self.devices):
            caller = torch.cuda.current_stream(d)
            for s in (self.compute[r], self.copy[r]):
                ev = torch.cuda.Event()
                ev.record(s)
                caller.wait_event(ev)


# ---------------------------------------------------------------------------
# pipeline stages across processes
# ---------------------------------------------------------------------------

# the pipeline's messages since the last reset (:func:`reset_pp_remote`):
# "sends" and "bytes" count those this process posted (a stage boundary's
# activation, its tensors packed in one message, and, back, the gradients of
# those of its tensors that carry one); "log" holds, per peer process, every
# message posted to it or received from it, in posting order, as (direction,
# bytes): the sequence both processes of a pair must agree on
PP_REMOTE: dict = {"sends": 0, "bytes": 0, "log": {}}
PIPELINE_TAG = 1  # every pipeline message's tag: one tag, so a pair's messages meet in posting order


def reset_pp_remote() -> None:
    PP_REMOTE.update(sends=0, bytes=0, log={})


def _nbytes(like: Sequence[torch.Tensor]) -> int:
    return sum(math.prod(s.shape) * s.dtype.itemsize for s in like)


def _pack(xs: Sequence[torch.Tensor]) -> torch.Tensor:
    """Tensors joined, in order, into one byte buffer (on the first one's
    device)."""
    dev = xs[0].device
    return torch.cat([x.detach().contiguous().view(-1).view(torch.uint8).to(dev) for x in xs])


def _unpack(buf: torch.Tensor, like: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """The tensors, shaped as ``like``'s, that :func:`_pack` joined into
    ``buf`` (views of it where the offset allows)."""
    out, at = [], 0
    for s in like:
        n = math.prod(s.shape) * s.dtype.itemsize
        piece = buf[at:at + n]
        if at % s.dtype.itemsize:  # a view needs an offset aligned to the element
            piece = piece.clone()
        out.append(piece.view(s.dtype).view(s.shape))
        at += n
    return out


class Incoming:
    """A posted receive of tensors shaped as ``like`` (meta tensors), on
    ``device``: :meth:`wait` waits for it and returns them."""

    def __init__(self, work, buf: torch.Tensor, like: Sequence[torch.Tensor], device: torch.device):
        self.work, self.buf, self.like, self.device = work, buf, list(like), device
        self.out: Optional[List[torch.Tensor]] = None

    def wait(self) -> List[torch.Tensor]:
        if self.out is None:
            with torch.profiler.record_function(DIST_SPAN):
                self.work.wait()
                self.out = _unpack(_landed(self.buf, self.device), self.like)
            self.work = self.buf = None
        return self.out


def post_pipeline_messages(ops: Sequence[tuple]) -> List[Incoming]:
    """One slot's pipeline messages, posted in the given order as one
    ``batch_isend_irecv`` under :data:`PIPELINE_TAG`: ``("send", dst,
    tensors)`` sends the tensors packed in one message (kept until
    :func:`wait_sends`); ``("recv", src, like, device)`` receives one shaped
    as ``like`` onto ``device``, returned, in order, as an
    :class:`Incoming`. Both processes of a pair post a message in the same
    slot and place, so that a backend which pairs messages in posting order
    (nccl; gloo too, under one tag) pairs them right, and a pair's sends in
    both directions of one slot go out together (nccl runs a communicator's
    operations in order: a send posted alone before a receive, met by the
    same on the other side, waits forever once it outgrows nccl's
    buffers). Counted in ``PP_REMOTE``."""
    p2p, bufs, incoming = [], [], []
    with torch.profiler.record_function(DIST_SPAN):
        for op in ops:
            if op[0] == "send":
                _, peer, xs = op
                buf = _send_buffer(_pack(xs))
                PP_REMOTE["sends"] += 1
                PP_REMOTE["bytes"] += buf.numel()
                p2p.append(dist.P2POp(dist.isend, buf, peer, tag=PIPELINE_TAG))
            else:
                _, peer, like, device = op
                buf = _transport_buffer((_nbytes(like),), torch.uint8, device)
                p2p.append(dist.P2POp(dist.irecv, buf, peer, tag=PIPELINE_TAG))
                incoming.append((buf, like, torch.device(device)))
            PP_REMOTE["log"].setdefault(peer, []).append((op[0], buf.numel()))
            bufs.append(buf)
        works = dist.batch_isend_irecv(p2p) if p2p else []
    if len(works) != len(p2p):  # nccl: one work for the coalesced batch
        works = works[-1:] * len(p2p)
    received = iter(incoming)
    out = []
    for op, work, buf in zip(ops, works, bufs):
        if op[0] == "send":
            _PENDING.append((work, buf))
        else:
            out.append(Incoming(work, *next(received)))
    return out
