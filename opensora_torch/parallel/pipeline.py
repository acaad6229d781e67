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
coordinates' pipelines, and possibly part of each stage's tp group) every
process runs the same tick loop and only its own stages' ticks. Where the
next stage, or a stage the last stage's output is delivered to, lies in
another process, the activation goes there by ``comm.send_tree`` (its
tensors packed in one message, their shapes given by the caller's
``like``, which both sides know) and comes out of ``comm.receive_tree``;
this process's tp ranks meet the same tp ranks of the other stage, which
that process holds. The received tensors' backward sends their gradients
back in one message, and each send leaves an anchor (``comm.take_anchors``)
whose backward receives them, a root of the process's backward, so that a
process without the last stage runs its backward too. Every message is
tagged by (call, microbatch, data index, from stage, to stage, direction),
so a receive takes its own message whatever order autograd runs the
microbatches' backwards in. That needs a backend that matches tags: gloo.
NCCL pairs a process pair's messages in the order they are posted, which
neither the tick loop (a process posts its sends before the receives of a
stage it does not hold) nor autograd keeps alike on both sides, so a
pipeline across processes under nccl raises (:func:`check_transport`).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Sequence

import torch
from torch.utils._pytree import tree_flatten, tree_unflatten

from opensora_torch.parallel import distributed
from opensora_torch.parallel.comm import broadcast, receive_tree, send, send_tree
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


ACROSS_PROCESSES_UNDER_NCCL = ("a pipeline across processes under nccl: its messages need one order on both "
                               "sides (ROADMAP Queue 1, \"Pipeline stages across processes under NCCL\"); "
                               "run it under gloo or with each pipeline in one process")


def check_transport(mesh: Mesh, axis: str = PP_AXIS) -> bool:
    """Whether this process's pipelines span processes; raises where they
    do under nccl (see the module docstring)."""
    spans = len(mesh.processes_along(axis, mesh.local_ranks[0])) > 1
    if spans and distributed.backend() == "nccl":
        raise NotImplementedError(ACROSS_PROCESSES_UNDER_NCCL)
    return spans


def _receive(mesh: Mesh, data: int, from_stage: int, to_stage: int, key, axis: str, like) -> Activation:
    """Stage ``from_stage``'s activation for this process's ranks of stage
    ``to_stage``, from the process that holds them."""
    devices = stage_devices(mesh, data, to_stage, axis)
    tree = receive_tree([like] * len(devices), peer(mesh, data, from_stage, to_stage), key, devices[0])
    return tree if len(set(devices)) == 1 else send_activation(tree, devices)


def pipeline_apply(
    stage_fn: Callable[[Any, Activation, int, int], Activation],
    stages: Sequence[Any],
    x_mb: Sequence[Sequence[Optional[Activation]]],
    mesh: Mesh,
    axis: str = PP_AXIS,
    deliver: Optional[Sequence[int]] = None,
    like: Any = None,
    call: int = 0,
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
    gradient back require grad), and ``call`` tells this call's messages
    from another's in the same step."""
    n_stages = mesh.shape[axis]
    if len(stages) != n_stages:
        raise ValueError(f"{len(stages)} stages over a '{axis}' axis of {n_stages}")
    deliver = list(range(n_stages)) if deliver is None else list(deliver)
    local = mesh.local_data
    n_micro = len(x_mb[0])
    last = n_stages - 1
    received = {}  # (k, s, m): what stage s - 1 sent
    out: List[List[Dict[int, Activation]]] = [[{} for _ in range(n_micro)] for _ in local]
    if check_transport(mesh, axis) and like is None:
        raise ValueError("pipeline_apply across processes: pass the activation's shapes (like)")

    def remote(y, d, from_stage, to_stage, key):
        send_tree(y, [like] * len(y), peer(mesh, d, to_stage, from_stage), key)

    for tick in range(n_micro + n_stages - 1):
        for s in range(n_stages):
            m = tick - s
            if not 0 <= m < n_micro:
                continue  # a bubble: no work
            for k, d in enumerate(local):
                here = [t for t in deliver if holds(mesh, d, t)]
                if not holds(mesh, d, s):
                    if s == last and here:  # the last stage's output, from its process
                        act = _receive(mesh, d, s, here[0], (call, m, k, s, here[0]), axis, like)
                        out[k][m] = broadcast_activation(act, mesh, d, here[0], axis, here)
                    continue
                if s == 0:
                    act = x_mb[k][m]
                elif holds(mesh, d, s - 1):
                    act = received.pop((k, s, m))
                else:
                    act = _receive(mesh, d, s - 1, s, (call, m, k, s - 1, s), axis, like)
                y = stage_fn(stages[s], act, d, s)
                if s < last:
                    if holds(mesh, d, s + 1):
                        received[(k, s + 1, m)] = send_activation(y, stage_devices(mesh, d, s + 1, axis))
                    else:
                        remote(y, d, s, s + 1, (call, m, k, s, s + 1))
                    continue
                out[k][m] = broadcast_activation(y, mesh, d, s, axis, here)
                # each other process that takes a stage of ``deliver``, once
                targets = {}
                for t in deliver:
                    if not holds(mesh, d, t):
                        targets.setdefault(peer(mesh, d, t, s), t)
                for t in sorted(targets.values()):
                    remote(y, d, s, t, (call, m, k, s, t))
    return out
