"""The process-wide mesh that model code reads to decide whether and how to
run sequence-parallel attention (counterpart of
opensora_tpu/parallel/context.py:17-48)."""

from __future__ import annotations

from typing import Optional

from opensora_torch.parallel.mesh import SP_AXIS, Mesh

_MESH: Optional[Mesh] = None


def set_mesh(mesh: Optional[Mesh]) -> None:
    global _MESH
    _MESH = mesh


def get_mesh() -> Optional[Mesh]:
    return _MESH


def axis_size(axis: str) -> int:
    if _MESH is None:
        return 1
    return _MESH.shape.get(axis, 1)


def sp_size() -> int:
    return axis_size(SP_AXIS)


def sp_enabled() -> bool:
    return sp_size() > 1
