"""GPipe pipeline parallelism over a mesh's 'pp' ranks (counterpart of
opensora_tpu/parallel/pipeline.py).

The JAX package runs the schedule as one SPMD program: every device holds
one stage's slice of the scanned block stack, and a ``lax.scan`` over the
clock ticks moves activations from stage s to s + 1 with ``lax.ppermute``;
``jax.grad`` through the scan gives the reverse pipeline. Here one process
holds every rank (``parallel/mesh.py``): a stage is a list of blocks whose
parameters lie on the stage's devices (``parallel/sharding.py``), the tick
loop runs in Python, activations move by the differentiable
``parallel/comm.send``, and autograd runs the backward pipeline in reverse
order.

The schedule is JAX's: ``n_micro + S - 1`` ticks, and at tick t stage s
runs microbatch t - s. Two differences that change no result: JAX's bubble
ticks compute on garbage and mask it, where this loop runs no bubble work
(each block runs ``n_micro`` times per data and tp rank); and the ticks
keep their order on one device too, where launches queue on one stream, so
that on distinct cards of one host the stages' work overlaps.

An activation is a list with one pytree of tensors per tp rank of the
stage held by this process (a tensor that several ranks on one device share
is one object and is sent once). Per-sample state the stages need but do
not change (the conditioning vector, the RoPE table cut by rows) rides in
it, as opensora_tpu/parallel/pipeline.py:77-81 asks.

Across processes (a mesh whose 'pp' axis crosses them, ``parallel/
mesh.py``: each process holds one stage, or a run of stages, of its data
coordinate's pipeline, and possibly part of each stage's tp group) every
process runs the same tick loop and only its own stages' ticks. Where the
next stage, or a stage the last stage's output is delivered to, lies in
another process, the activation goes there as one message (its tensors
packed, their shapes given by the caller's ``like``, which both sides
know); this process's tp ranks meet the same tp ranks of the other stage,
which that process holds.

The messages carry no key: every pipeline message has one tag, and both
processes of a pair post their side of each message in one order that
each derives from the schedule alone. NCCL needs that order: it pairs a
process pair's messages in the order they are posted and ignores tags
(gloo, under one tag, does the same, so a gloo run checks the order). The
order is the tick loop's: slot (tick, stage s, data coordinate), in that
nesting; in a slot the process that holds stage s sends the output (to
stage s + 1's process, or, from the last stage, to each process of a
``deliver`` stage in process order), and each receiving process posts its
receive in the same slot, to be waited for when its stage runs
(``comm.post_pipeline_messages``, one ``batch_isend_irecv`` a slot).

The backward runs the same slots in reverse order, explicitly, on every
process (:class:`PipelineTape`, recorded by the forward): the pipeline cuts
its graph where a message crosses processes, so autograd never chooses
the order. A received activation is a leaf; in its slot's backward its
gradient goes back to the sender in one message. A sent activation, and
the last stage's output kept here for the caller (a leaf, too, whose
gradient the caller's backward gives), are roots; in their slot's
backward this process receives the gradients from the stages they went
to, adds those of the local leaf, and runs autograd from the root back to
the slot's leaves. The caller's loss backward runs first (the loss's
gradient of each microbatch's last-stage output), then the slots from the
last tick to the first, then the stage-0 inputs' cut (``training/pp.py``).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch
from torch.utils._pytree import tree_flatten, tree_unflatten

from opensora_torch.parallel.comm import Incoming, broadcast, post_pipeline_messages, send
from opensora_torch.parallel.mesh import PP_AXIS, TP_AXIS, Mesh

Activation = List[Any]  # one pytree of tensors per tp rank (of this process)


def split_stages(layers: Sequence[Any], n_stages: int) -> List[List[Any]]:
    """The layers of a stack cut into ``n_stages`` consecutive stages:
    layer i goes to stage i // (L / S) (``split_scan_params``,
    opensora_tpu/parallel/pipeline.py:36-50). L must divide."""
    n = len(layers)
    if n % n_stages:
        raise ValueError(f"layers {n} not divisible by stages {n_stages}")
    per = n // n_stages
    return [list(layers[s * per:(s + 1) * per]) for s in range(n_stages)]


def merge_stages(stages: Sequence[Sequence[Any]]) -> List[Any]:
    """Inverse of :func:`split_stages` (``merge_scan_params``)."""
    return [layer for stage in stages for layer in stage]


def local_tps(mesh: Mesh, data: int, stage: int) -> List[int]:
    """The tp coordinates of this process's ranks of stage ``stage`` at
    data coordinate ``data`` (none where another process holds the
    stage)."""
    return [t for t in range(mesh.shape.get(TP_AXIS, 1)) if mesh.is_local(mesh.rank((data, stage, t)))]


def holds(mesh: Mesh, data: int, stage: int) -> bool:
    """Whether this process holds ranks of stage ``stage`` at ``data``."""
    return bool(local_tps(mesh, data, stage))


def stage_devices(mesh: Mesh, data: int, stage: int, axis: str = PP_AXIS) -> List[torch.device]:
    """The devices of this process's tp ranks of pipeline stage ``stage`` at
    data coordinate ``data``."""
    return [mesh.devices[mesh.rank((data, stage, t))] for t in local_tps(mesh, data, stage)]


def peer(mesh: Mesh, data: int, stage: int, ours: int) -> int:
    """The process that holds stage ``stage``'s ranks at ``data`` with the
    tp coordinates this process holds at stage ``ours``."""
    return mesh.processes[mesh.rank((data, stage, local_tps(mesh, data, ours)[0]))]


def send_activation(act: Activation, devices: Sequence[torch.device]) -> Activation:
    """Tp rank t's pytree sent to ``devices[t]`` (``comm.send``)."""
    flat = [tree_flatten(a) for a in act]
    n = len(flat[0][0])
    moved = [send([leaves[i] for leaves, _ in flat], devices) for i in range(n)]
    return [tree_unflatten([moved[i][t] for i in range(n)], spec) for t, (_, spec) in enumerate(flat)]


def broadcast_activation(act: Activation, mesh: Mesh, data: int, source: int, axis: str = PP_AXIS,
                         stages: Optional[Sequence[int]] = None) -> Dict[int, Activation]:
    """The activation of stage ``source`` on each of ``stages`` (default:
    every stage) of data rank ``data`` (``comm.broadcast`` per tp rank and
    leaf), each held by this process: element s is stage s's copy."""
    stages = range(mesh.shape[axis]) if stages is None else stages
    src = stage_devices(mesh, data, source, axis)
    out: Dict[int, Activation] = {s: [None] * len(act) for s in stages}
    for t, a in enumerate(act):
        leaves, spec = tree_flatten(a)
        dests = [stage_devices(mesh, data, s, axis)[t] for s in stages]
        per_leaf = [broadcast(x, src[t], dests) for x in leaves]
        for k, s in enumerate(stages):
            out[s][t] = tree_unflatten([p[k] for p in per_leaf], spec)
    return out


def check_transport(mesh: Mesh, axis: str = PP_AXIS) -> bool:
    """Whether this process's pipelines span processes (their messages then
    go through ``comm.post_pipeline_messages``, under any backend)."""
    return len(mesh.processes_along(axis, mesh.local_ranks[0])) > 1


# ---------------------------------------------------------------------------
# the slots of a pipeline across processes, and their backward
# ---------------------------------------------------------------------------


class _Box:
    """The gradients a :class:`_Roots` node hands to autograd."""

    grads: Optional[List[torch.Tensor]] = None


class _Roots(torch.autograd.Function):
    """A zero scalar over tensors whose gradients are known only later (from
    other processes, or from the leaves that stand for them here): its
    backward returns the gradients put in ``box``, so that one
    ``autograd.backward`` of the scalar runs the graph behind the tensors."""

    @staticmethod
    def forward(ctx, box, *xs):
        ctx.box = box
        return xs[0].new_zeros(())

    @staticmethod
    def backward(ctx, _):
        grads, ctx.box.grads = ctx.box.grads, None
        return (None, *grads)


@dataclass
class _Slot:
    """What one (call, tick, stage, data) slot did on this process, for its
    backward. Forward: ``source``, the process this slot's output came from
    (a receive posted here), whose leaves are ``received``; ``sends``, the
    processes this process sent the output to; ``kept``, the leaves of the
    output kept here for the caller. The gradient-carrying tensors of the
    output (``specs``: one tp rank's message as meta tensors, repeated) are
    ``roots``' inputs."""

    key: Tuple[int, ...]  # (call, tick, stage, data, microbatch, n_micro)
    specs: List[torch.Tensor]
    source: Optional[int] = None
    received: List[torch.Tensor] = field(default_factory=list)
    sends: List[int] = field(default_factory=list)
    kept: List[torch.Tensor] = field(default_factory=list)
    roots: Optional[torch.Tensor] = None
    box: Optional[_Box] = None
    where: List[Tuple[torch.device, torch.dtype]] = field(default_factory=list)
    live: List[int] = field(default_factory=list)  # the positions in ``specs`` that ``roots`` takes


def sent_back(slot: _Slot) -> List[torch.Tensor]:
    """The gradients a received activation sends back: those of its
    gradient-carrying leaves (zeros where a leaf got none)."""
    return [torch.zeros_like(x) if x.grad is None else x.grad for x in slot.received]


def backward_order(slots: Sequence[_Slot]) -> List[_Slot]:
    """The slots in the order their backwards run: the reverse of the
    forward's, on every process."""
    return list(reversed(slots))


class PipelineTape:
    """The slots a pipeline forward across processes ran on this process, in
    forward order (with grad on), and the cuts around it (``training/
    pp.py``): :meth:`backward` runs them in reverse (see the module
    docstring)."""

    def __init__(self):
        self.slots: List[_Slot] = []

    def record(self, key, y_leaves: Sequence[torch.Tensor] = (), specs: Sequence[torch.Tensor] = ()) -> _Slot:
        """A slot, appended; where this process computed its output
        (``y_leaves``, flattened over this process's tp ranks, ``specs``
        alike), the gradient-carrying tensors become ``roots``' inputs."""
        xs = [x for x, s in zip(y_leaves, specs) if s.requires_grad]
        if any(x.requires_grad and not s.requires_grad for x, s in zip(y_leaves, specs)):
            raise ValueError(f"pipeline slot {key}: a tensor that requires grad would get no gradient back")
        slot = _Slot(key, [s for s in specs if s.requires_grad], where=[(x.device, x.dtype) for x in xs])
        slot.live = [i for i, x in enumerate(xs) if x.requires_grad]
        if slot.live:
            slot.box = _Box()
            slot.roots = _Roots.apply(slot.box, *(xs[i] for i in slot.live))
        self.slots.append(slot)
        return slot

    def cut(self, key, xs: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        """Leaves that stand for ``xs`` (those that require grad; the others
        themselves) in the graph after them, and a slot whose backward runs
        from ``xs`` with the leaves' gradients."""
        specs = [torch.empty(x.shape, dtype=x.dtype, device="meta", requires_grad=x.requires_grad) for x in xs]
        slot = self.record(key, xs, specs)
        slot.kept = [x.detach().requires_grad_() for x in xs if x.requires_grad]
        it = iter(slot.kept)
        return [next(it) if x.requires_grad else x for x in xs]

    def backward(self, loss: Optional[torch.Tensor] = None) -> None:
        """The loss's backward (where this process computes it), then each
        slot's, in :func:`backward_order`."""
        if loss is not None:
            torch.autograd.backward(loss)
        for slot in backward_order(self.slots):
            _slot_backward(slot)
        self.slots = []


def _slot_backward(slot: _Slot) -> None:
    """One slot's backward: its forward's messages mirrored (a received
    activation's gradient back to its sender, the gradients of a sent one
    from each process it went to), posted in the forward's order, then
    autograd from the slot's roots with the gradients received and those
    of the leaves kept here."""
    ops = [("send", slot.source, sent_back(slot))] if slot.source is not None and slot.received else []
    device = slot.where[0][0] if slot.where else None
    ops += [("recv", dst, slot.specs, device) for dst in slot.sends] if slot.specs else []
    incoming = post_pipeline_messages(ops)
    slot.received = []
    if slot.roots is None:
        return
    grads: List[Optional[torch.Tensor]] = [x.grad for x in slot.kept] if slot.kept else [None] * len(slot.specs)
    for inc in incoming:
        grads = [r if g is None else g + r.to(g.device) for g, r in zip(grads, inc.wait())]
    slot.box.grads = [torch.zeros(slot.specs[i].shape, dtype=t, device=d) if grads[i] is None
                      else grads[i].to(device=d, dtype=t) for i, (d, t) in
                      ((i, slot.where[i]) for i in slot.live)]
    roots, slot.roots, slot.kept = slot.roots, None, []
    torch.autograd.backward(roots)


_TAPE: List[Optional[PipelineTape]] = [None]


def start_tape() -> PipelineTape:
    """A new tape for a pipeline forward across processes (the last one
    left untaken is dropped)."""
    _TAPE[0] = PipelineTape()
    return _TAPE[0]


def take_tape() -> Optional[PipelineTape]:
    """The tape of the last pipeline forward across processes, if any."""
    tape, _TAPE[0] = _TAPE[0], None
    return tape


class _Pending:
    """A stage's activation from another process: the posted receive, and
    the slot whose backward sends its gradient back."""

    def __init__(self, incoming: Incoming, like_tree, devices: Sequence[torch.device], slot: Optional[_Slot]):
        self.incoming, self.like_tree, self.devices, self.slot = incoming, like_tree, list(devices), slot

    def take(self) -> Activation:
        """The activation on the stage's devices (waited for); with grad on,
        its gradient-carrying tensors are leaves."""
        specs, spec = tree_flatten(self.like_tree)
        out = self.incoming.wait()
        if self.slot is not None:
            out = [x.detach().requires_grad_() if s.requires_grad else x for x, s in zip(out, specs)]
            self.slot.received = [x for x, s in zip(out, specs) if s.requires_grad]
        tree = tree_unflatten(out, spec)
        return tree if len(set(self.devices)) == 1 else send_activation(tree, self.devices)


def pipeline_apply(
    stage_fn: Callable[[Any, Activation, int, int], Activation],
    stages: Sequence[Any],
    x_mb: Sequence[Sequence[Optional[Activation]]],
    mesh: Mesh,
    axis: str = PP_AXIS,
    deliver: Optional[Sequence[int]] = None,
    like: Any = None,
    call: int = 0,
    tape: Optional[PipelineTape] = None,
) -> List[List[Dict[int, Activation]]]:
    """Run every microbatch through all stages (``pipeline_apply``,
    opensora_tpu/parallel/pipeline.py:63-166).

    ``x_mb[k][m]``: the rows of microbatch m of data rank d, the k-th of
    this process's data coordinates (``Mesh.local_data``; one process: d =
    k), on the devices of stage 0 (ranks (d, 0, t)); None where another
    process holds stage 0. ``stage_fn(stages[s], act, d, s)`` maps one
    microbatch through stage s's layers on the ranks (d, s, ·) and returns
    an activation of the same structure. Returns ``out[k][m][s]``: the last
    stage's output on stage s's devices, for each s of ``deliver``
    (default: every stage) that this process holds (replicated over
    ``axis``, as JAX's ``psum`` of the last stage's values leaves it).

    Across processes (see the module docstring) ``like`` is one tp rank's
    activation between two stages as meta tensors (those that carry a
    gradient back require grad), ``call`` numbers this call's slots in the
    step, and ``tape`` (with grad on) records the slots for the backward."""
    n_stages = mesh.shape[axis]
    if len(stages) != n_stages:
        raise ValueError(f"{len(stages)} stages over a '{axis}' axis of {n_stages}")
    deliver = list(range(n_stages)) if deliver is None else list(deliver)
    local = mesh.local_data
    n_micro = len(x_mb[0])
    last = n_stages - 1
    received: Dict[tuple, Any] = {}  # (k, s, m): what stage s - 1 sent (an activation, or a _Pending)
    delivered: Dict[tuple, tuple] = {}  # (k, m): the last stage's output from its process, and its stage here
    out: List[List[Dict[int, Activation]]] = [[{} for _ in range(n_micro)] for _ in local]
    if check_transport(mesh, axis) and like is None:
        raise ValueError("pipeline_apply across processes: pass the activation's shapes (like)")

    def specs_for(n):  # n tp ranks' messages: ``like`` repeated
        return tree_flatten([like] * n)[0]

    for tick in range(n_micro + n_stages - 1):
        for s in range(n_stages):
            m = tick - s
            if not 0 <= m < n_micro:
                continue  # a bubble: no work
            for k, d in enumerate(local):
                key = (call, tick, s, d, m, n_micro)
                here = [t for t in deliver if holds(mesh, d, t)]
                if not holds(mesh, d, s):  # another process runs this slot: receive its output here?
                    to = s + 1 if s < last and holds(mesh, d, s + 1) else here[0] if s == last and here else None
                    if to is None:
                        continue
                    devices = stage_devices(mesh, d, to, axis)
                    specs = specs_for(len(devices))
                    slot = None
                    if tape is not None:
                        slot = tape.record(key)
                        slot.source = peer(mesh, d, s, to)
                    inc = post_pipeline_messages([("recv", peer(mesh, d, s, to), specs, devices[0])])[0]
                    pending = _Pending(inc, [like] * len(devices), devices, slot)
                    if s < last:
                        received[(k, s + 1, m)] = pending
                    else:
                        delivered[(k, m)] = (pending, to)
                    continue
                if s == 0:
                    act = x_mb[k][m]
                else:
                    act = received.pop((k, s, m))
                    if isinstance(act, _Pending):
                        act = act.take()
                y = stage_fn(stages[s], act, d, s)
                if s < last and holds(mesh, d, s + 1):
                    received[(k, s + 1, m)] = send_activation(y, stage_devices(mesh, d, s + 1, axis))
                    continue
                if s < last:
                    dsts = [peer(mesh, d, s + 1, s)]
                else:  # each other process that takes a stage of ``deliver``, once, in process order
                    dsts = sorted({peer(mesh, d, t, s) for t in deliver if not holds(mesh, d, t)})
                leaves, spec = tree_flatten(y)
                if tape is not None:
                    slot = tape.record(key, leaves, specs_for(len(y)))
                    slot.sends = dsts
                    if s == last and here:  # the output kept here: leaves for the caller
                        slot.kept = [x.detach().requires_grad_() for x, sp in zip(leaves, specs_for(len(y)))
                                     if sp.requires_grad]
                        it = iter(slot.kept)
                        y = tree_unflatten([next(it) if sp.requires_grad else x
                                            for x, sp in zip(leaves, specs_for(len(y)))], spec)
                if dsts:
                    post_pipeline_messages([("send", dst, leaves) for dst in dsts])
                if s == last and here:
                    out[k][m] = broadcast_activation(y, mesh, d, s, axis, here)
    for (k, m), (pending, to) in delivered.items():
        d = local[k]
        out[k][m] = broadcast_activation(pending.take(), mesh, d, to, axis, [t for t in deliver if holds(mesh, d, t)])
    return out
