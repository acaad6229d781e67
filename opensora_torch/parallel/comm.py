"""Moving data between the ranks of a mesh held by one process.

The JAX package moves shards between chips with ``lax.all_to_all`` and
``lax.ppermute`` (ops/sp.py) and, inside the ring kernels, with
``make_async_remote_copy`` plus DMA and "ack" semaphores
(ops/ring_flash.py:108-116,166-181). Here every rank's tensors live in this
process, on the rank's device:

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

Across processes (a multi-process run, ``parallel/distributed.py``; only
the mesh's 'data' axis crosses them) the collectives are
``torch.distributed``'s over every process, each under a profiler span
``"dist_collective"``: :func:`process_all_reduce` (sum),
:func:`process_all_gather` (joined along a dim), :func:`process_reduce_scatter`
(this process's piece of the sum), :func:`process_gather` (to one process)
and :func:`process_gather_shards`, the FSDP all-gather as an autograd
Function whose backward is the reduce-scatter of the gradients, summed in
fp32. Under ``nccl`` they run on the tensors where they lie. Under ``gloo``
a CUDA tensor is staged: copied to host memory (:func:`staged_copy`), the
gloo op, copied back; ``STAGED`` counts those copies and their bytes (gloo
is not asked to read device memory).
"""

from __future__ import annotations

import contextlib
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


def all_reduce(parts: Sequence[torch.Tensor], dtype=None, bias=None) -> List[torch.Tensor]:
    """The sum of the ranks' tensors, on every rank's device. The sum is
    taken in fp32 and rounded once to ``dtype`` (default: the parts'), so
    that tp partial products summed in bf16 do not drift from the
    unsharded product; ``bias`` (per rank, replicated), where given, is
    added once to the fp32 sum before that rounding (a row-parallel
    product's bias). Differentiable: each part receives the gradient of the
    sum."""
    dtype = dtype or parts[0].dtype

    def total(device):
        s = sum(p.to(device).float() for p in parts)
        if bias is not None:
            s = s + bias[[p.device for p in parts].index(device)].float()
        return s.to(dtype)

    with torch.profiler.record_function("all_reduce"):  # a profile's span of the collective
        return _per_device(parts, total)


def all_reduce_max(parts: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """The elementwise max of the ranks' tensors, on every rank's device
    (the per-token activation scale of an int8 row-parallel product, whose
    row the ranks hold in slices)."""
    return _per_device(parts, lambda device: torch.stack([p.to(device) for p in parts]).amax(0))


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


def _received(buf: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """A transport buffer on ``like``'s device."""
    if buf.device == like.device:
        return buf
    return staged_copy(buf, like.device) if buf.device.type == "cpu" and like.device.type == "cuda" else \
        copy_to(buf, like.device)


def process_all_reduce(x: torch.Tensor) -> torch.Tensor:
    """The sum over the processes of their ``x`` (same shape and dtype), a
    new tensor on ``x``'s device."""
    with torch.profiler.record_function(DIST_SPAN):
        buf = _send_buffer(x)
        dist.all_reduce(buf)
        return _received(buf, x)


def process_all_gather(x: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """The processes' ``x`` (same shape) joined along ``dim`` in process
    order, on ``x``'s device (joined there)."""
    with torch.profiler.record_function(DIST_SPAN):
        buf = _send_buffer(x)
        parts = [_receive_buffer(buf) for _ in range(distributed.process_count())]
        dist.all_gather(parts, buf)
        return torch.cat([_received(p, x) for p in parts], dim)


def process_reduce_scatter(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Piece p (of process_count() equal pieces along ``dim``) of the sum
    over the processes of their ``x``, on process p, on ``x``'s device
    (the pieces cut where ``x`` lies)."""
    n = distributed.process_count()
    if x.shape[dim] % n:
        raise ValueError(f"dimension {dim} of {tuple(x.shape)} does not split over {n} processes")
    with torch.profiler.record_function(DIST_SPAN):
        pieces = [_send_buffer(c) for c in x.chunk(n, dim)]
        out = _receive_buffer(pieces[0])
        dist.reduce_scatter(out, pieces)
        return _received(out, x)


def process_gather(x: torch.Tensor, dst: int = 0) -> Optional[List[torch.Tensor]]:
    """Every process's ``x`` (same shape), in process order, on process
    ``dst`` (on ``x``'s device); None on the others."""
    with torch.profiler.record_function(DIST_SPAN):
        buf = _send_buffer(x)
        parts = [_receive_buffer(buf) for _ in range(distributed.process_count())] \
            if distributed.process_index() == dst else None
        dist.gather(buf, parts, dst=dst)
        return None if parts is None else [_received(p, x) for p in parts]


class _GatherShards(torch.autograd.Function):
    """Forward: this process's shards cast to ``dtype`` and joined along
    ``dim`` on ``device``, then joined with the other processes' (the
    FSDP all-gather). Backward: the reduce-scatter of the gradient, summed
    in fp32, each shard receiving its slice in its own dtype."""

    @staticmethod
    def forward(ctx, dim, dtype, device, *shards):
        ctx.dim, ctx.meta = dim, [(s.shape[dim], s.device, s.dtype) for s in shards]
        local = torch.cat([s.to(device=device, dtype=dtype) for s in shards], dim)
        return process_all_gather(local, dim)

    @staticmethod
    def backward(ctx, grad):
        mine = process_reduce_scatter(grad.float(), ctx.dim)
        pieces = mine.split([n for n, _, _ in ctx.meta], ctx.dim)
        return (None, None, None, *(p.to(device=d, dtype=t) for p, (_, d, t) in zip(pieces, ctx.meta)))


def process_gather_shards(shards: Sequence[torch.Tensor], dim: int, dtype, device) -> torch.Tensor:
    """The FSDP all-gather across processes (see :class:`_GatherShards`):
    ``shards`` are this process's, in 'data' order."""
    return _GatherShards.apply(dim, dtype, torch.device(device), *shards)


_STREAMS: Dict[Tuple[int, int, str], torch.cuda.Stream] = {}


def _stream(device: torch.device, rank: int, kind: str) -> "torch.cuda.Stream":
    key = (device.index if device.index is not None else torch.cuda.current_device(), rank, kind)
    if key not in _STREAMS:
        _STREAMS[key] = torch.cuda.Stream(device=device)
    return _STREAMS[key]


class RingTransport:
    """The slots, streams and events of one ring over ``devices`` (rank r on
    devices[r]; its right neighbour is r + 1 mod n). Use: allocate slots
    with :meth:`slots`, fill slot 0, :meth:`start`, then per hop and rank,
    inside ``with t.on(r)``: :meth:`wait_received`, :meth:`send`, the hop's
    compute, :meth:`release`; last :meth:`finish`."""

    def __init__(self, devices: Sequence[torch.device], sequential: bool = False):
        self.devices = [torch.device(d) for d in devices]
        self.n = len(self.devices)
        self.sequential = sequential or self.devices[0].type != "cuda"
        if not self.sequential:
            self.compute = [_stream(d, r, "compute") for r, d in enumerate(self.devices)]
            self.copy = [_stream(d, r, "copy") for r, d in enumerate(self.devices)]
        self._received: Dict[Tuple[str, int, int], torch.cuda.Event] = {}
        self._ack: Dict[Tuple[int, int], torch.cuda.Event] = {}
        self._sent: Dict[Tuple[int, int], List[torch.cuda.Event]] = {}

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
        ev = self._received.get((name, r, slot))
        if ev is not None:
            self.compute[r].wait_event(ev)

    def send(self, r: int, name: str, bufs: Sequence[torch.Tensor], cur: int) -> None:
        """Copy rank r's slot ``cur`` of ``bufs`` into its right neighbour's
        other slot, once what r's compute stream has queued so far is done
        and the neighbour acknowledged its last use of that slot."""
        right, nxt = (r + 1) % self.n, 1 - cur
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

    def release(self, r: int, slot: int) -> None:
        """Rank r is done with ``slot``: its reads are queued and its sends
        out of it drain first; then the left neighbour may overwrite it."""
        if self.sequential:
            return
        for ev in self._sent.pop((r, slot), []):
            self.compute[r].wait_event(ev)
        ack = torch.cuda.Event()
        ack.record(self.compute[r])
        self._ack[(r, slot)] = ack

    def finish(self) -> None:
        """The caller's stream waits on every rank's streams."""
        if self.sequential:
            return
        for r, d in enumerate(self.devices):
            caller = torch.cuda.current_stream(d)
            for s in (self.compute[r], self.copy[r]):
                ev = torch.cuda.Event()
                ev.record(s)
                caller.wait_event(ev)
