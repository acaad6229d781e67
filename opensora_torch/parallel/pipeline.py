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
stage (a tensor that several ranks on one device share is one object and
is sent once). Per-sample state the stages need but do not change (the
conditioning vector, the RoPE table cut by rows) rides in it, as
opensora_tpu/parallel/pipeline.py:77-81 asks.
"""

from __future__ import annotations

from typing import Any, Callable, List, Sequence

import torch
from torch.utils._pytree import tree_flatten, tree_unflatten

from opensora_torch.parallel.comm import broadcast, send
from opensora_torch.parallel.mesh import PP_AXIS, TP_AXIS, Mesh

Activation = List[Any]  # one pytree of tensors per tp rank


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


def stage_devices(mesh: Mesh, data: int, stage: int, axis: str = PP_AXIS) -> List[torch.device]:
    """The devices of the tp ranks of pipeline stage ``stage`` at data
    coordinate ``data``."""
    return [mesh.devices[mesh.rank((data, stage, t))] for t in range(mesh.shape.get(TP_AXIS, 1))]


def send_activation(act: Activation, devices: Sequence[torch.device]) -> Activation:
    """Tp rank t's pytree sent to ``devices[t]`` (``comm.send``)."""
    flat = [tree_flatten(a) for a in act]
    n = len(flat[0][0])
    moved = [send([leaves[i] for leaves, _ in flat], devices) for i in range(n)]
    return [tree_unflatten([moved[i][t] for i in range(n)], spec) for t, (_, spec) in enumerate(flat)]


def broadcast_activation(act: Activation, mesh: Mesh, data: int, source: int, axis: str = PP_AXIS
                         ) -> List[Activation]:
    """The activation of stage ``source`` on every stage of data rank
    ``data`` (``comm.broadcast`` per tp rank and leaf): element s is stage
    s's copy."""
    n_stages = mesh.shape[axis]
    src = stage_devices(mesh, data, source, axis)
    out: List[Activation] = [[None] * len(act) for _ in range(n_stages)]
    for t, a in enumerate(act):
        leaves, spec = tree_flatten(a)
        dests = [mesh.devices[mesh.rank((data, s, t))] for s in range(n_stages)]
        per_leaf = [broadcast(x, src[t], dests) for x in leaves]
        for s in range(n_stages):
            out[s][t] = tree_unflatten([p[s] for p in per_leaf], spec)
    return out


def pipeline_apply(
    stage_fn: Callable[[Any, Activation, int, int], Activation],
    stages: Sequence[Any],
    x_mb: Sequence[Sequence[Activation]],
    mesh: Mesh,
    axis: str = PP_AXIS,
) -> List[List[List[Activation]]]:
    """Run every microbatch through all stages (``pipeline_apply``,
    opensora_tpu/parallel/pipeline.py:63-166).

    ``x_mb[k][m]``: the rows of microbatch m of data rank d, the k-th of
    this process's data coordinates (``Mesh.local_data``; one process: d =
    k), on the devices of stage 0 (ranks (d, 0, t)). ``stage_fn(stages[s],
    act, d, s)`` maps one microbatch through stage s's layers on the ranks
    (d, s, ·) and returns an activation of the same structure. Returns
    ``out[k][m][s]``: the last stage's output, broadcast to stage s's
    devices (replicated over ``axis``, as JAX's ``psum`` of the last
    stage's values leaves it)."""
    n_stages = mesh.shape[axis]
    if len(stages) != n_stages:
        raise ValueError(f"{len(stages)} stages over a '{axis}' axis of {n_stages}")
    local = mesh.local_data
    n_micro = len(x_mb[0])
    received = {}  # (k, s, m): what stage s - 1 sent
    out: List[List[Any]] = [[None] * n_micro for _ in local]
    for tick in range(n_micro + n_stages - 1):
        for s in range(n_stages):
            m = tick - s
            if not 0 <= m < n_micro:
                continue  # a bubble: no work
            for k, d in enumerate(local):
                act = x_mb[k][m] if s == 0 else received.pop((k, s, m))
                y = stage_fn(stages[s], act, d, s)
                if s + 1 < n_stages:
                    received[(k, s + 1, m)] = send_activation(y, stage_devices(mesh, d, s + 1, axis))
                else:
                    out[k][m] = broadcast_activation(y, mesh, d, s, axis)
    return out
