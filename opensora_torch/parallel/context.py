"""The process-wide mesh that model code reads to decide whether and how to
run sequence-parallel attention (counterpart of
opensora_tpu/parallel/context.py:17-48), and the rank scope of a sharded
model's forward.

A process holds every rank of the mesh, or, in a multi-process run, the
ranks at its own (data, sp) coordinates (``parallel/mesh.py``). A model
sharded by ``parallel/sharding.py`` runs its ranks one after another; while
it runs rank (d, m, t), the scope is (d, t, m): the sharded parameters then
read that rank's shards on its device. ``m`` is the rank's coordinate on
the mesh's middle axis: on an sp mesh the sp rank, on a pipeline mesh the
stage. A scope is only ever opened for a rank of this process; an sp group
whose other ranks lie in other processes reaches them through its
``comm.ShardGroup`` (``RankGroup.shard_group``), never through a scope.

On an sp mesh whose joint sequence splits over 'sp', each sp rank holds
and computes its own chunk of the tokens (``models/mmdit/model.py``), and
an attention call over the group takes the ranks' shards as they are,
with no cut and no gather (``ops/attention.attention_shards``). Where the
tokens stay whole (a length 'sp' does not divide), the ranks at sp
coordinate 0 compute, and the attention called in scope (d, t, 0) cuts the
rows and heads it is given over the sp group through (d, 0, t) and gathers
the output back. Outside a scope, the attention splits the rows over
'data' and the heads over 'tp' and runs each (d, t) group itself
(:func:`sp_groups`).
"""

from __future__ import annotations

import contextlib
from typing import List, Optional, Tuple

import torch

from opensora_torch.parallel.mesh import DATA_AXIS, SP_AXIS, TP_AXIS, Mesh

_MESH: Optional[Mesh] = None
_SCOPE: Optional[Tuple[int, int, int]] = None


def set_mesh(mesh: Optional[Mesh]) -> None:
    global _MESH
    _MESH = mesh


def get_mesh() -> Optional[Mesh]:
    return _MESH


def axis_size(axis: str) -> int:
    if _MESH is None:
        return 1
    return _MESH.shape.get(axis, 1)


def dp_size() -> int:
    return axis_size(DATA_AXIS)


def sp_size() -> int:
    return axis_size(SP_AXIS)


def tp_size() -> int:
    return axis_size(TP_AXIS)


def sp_enabled() -> bool:
    return sp_size() > 1


@contextlib.contextmanager
def rank_scope(data: int, tp: int, mid: int = 0):
    """Run rank (data, mid, tp): ``mid`` is the sp rank on an sp mesh, the
    stage on a pipeline mesh (see the module docstring)."""
    global _SCOPE
    outer, _SCOPE = _SCOPE, (data, tp, mid)
    try:
        yield
    finally:
        _SCOPE = outer


def get_scope() -> Optional[Tuple[int, int, int]]:
    return _SCOPE


def sp_groups(mesh: Mesh) -> Tuple[List[List[torch.device]], int, int]:
    """The devices of the sp groups that an attention call on whole
    sequences runs over, and the number of pieces its rows and its heads
    are cut into: inside a rank scope (d, t, ·) the one group through (d,
    0, t), uncut; else the group of every (d, t) in row-major order, rows
    cut over 'data' and heads over 'tp'. (An attention over sequence
    shards is given its group's shards and needs none of this.)"""
    def devices(d: int, t: int) -> List[torch.device]:
        return [mesh.devices[r] for r in mesh.group(SP_AXIS, mesh.rank((d, 0, t)))]

    if _SCOPE is not None:
        return [devices(*_SCOPE[:2])], 1, 1
    dp, tp = mesh.shape[DATA_AXIS], mesh.shape[TP_AXIS]
    return [devices(d, t) for d in range(dp) for t in range(tp)], dp, tp
