"""The device mesh: axis sizes (data, sp, tp), or (data, pp, tp) for a
pipeline, and one device per rank (counterpart of
opensora_tpu/parallel/mesh.py:33-105 and of ``create_pp_mesh``,
opensora_tpu/training/pp.py:193-211).

JAX drives a mesh from one controller process; the counterpart here is one
process that holds every rank of the mesh and its device. Ranks are
numbered in row-major order over the mesh's axes, as JAX flattens logical
device ids; the middle axis is 'sp' or 'pp'. A device may appear more than once: several *logical ranks*
then share one device, as the JAX package's tests put a mesh on virtual CPU
devices. ``[torch.device("cuda", 0)] * 4`` is a 4-rank mesh on one card;
``[torch.device("cuda", i) for i in range(4)]`` the same mesh over four
cards of one host. Collectives between the ranks are moves between their
tensors (``parallel/comm.py``); a transport across processes is not part of
this module.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple, Union

import torch

DATA_AXIS = "data"
SP_AXIS = "sp"
TP_AXIS = "tp"
PP_AXIS = "pp"
AXES = (DATA_AXIS, SP_AXIS, TP_AXIS)
PP_AXES = (DATA_AXIS, PP_AXIS, TP_AXIS)


@dataclass
class MeshConfig:
    """Mirrors the reference plugin_config dict (tp_size/sp_size/...)."""

    dp_size: int = -1  # -1: fill remaining devices
    sp_size: int = 1
    tp_size: int = 1

    def resolve(self, n_devices: int) -> Tuple[int, int, int]:
        sizes = [self.dp_size, self.sp_size, self.tp_size]
        fills = [i for i, s in enumerate(sizes) if s == -1]
        if len(fills) > 1:
            raise ValueError("only one mesh axis may be -1 (fill remaining)")
        if fills:
            known = math.prod(s for s in sizes if s != -1)
            if n_devices % known:
                raise ValueError(f"{n_devices} devices not divisible by fixed axes product {known}")
            sizes[fills[0]] = n_devices // known
        dp, sp, tp = sizes
        if dp * sp * tp != n_devices:
            raise ValueError(f"dp*sp*tp={dp * sp * tp} != n_devices={n_devices}")
        return dp, sp, tp


def _indexed(device: torch.device) -> torch.device:
    """``cuda`` as ``cuda:<current>``: tensors name their device with its
    index, and the mesh's devices are compared with theirs."""
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


class Mesh:
    """Axis sizes and the device of each rank (row-major over ``axes``:
    ``AXES``, or ``PP_AXES`` for a pipeline)."""

    def __init__(self, sizes: Sequence[int], devices: Sequence[torch.device], axes: Sequence[str] = AXES):
        if len(sizes) != len(axes) or math.prod(sizes) != len(devices):
            raise ValueError(f"mesh {tuple(sizes)} over {len(devices)} devices")
        self.axes = tuple(axes)
        self.shape: Dict[str, int] = dict(zip(self.axes, (int(s) for s in sizes)))
        self.devices: List[torch.device] = [_indexed(torch.device(d)) for d in devices]

    def coords(self, rank: int) -> Tuple[int, ...]:
        out = []
        for name in reversed(self.axes):
            rank, c = divmod(rank, self.shape[name])
            out.append(c)
        return tuple(reversed(out))

    def rank(self, coords: Sequence[int]) -> int:
        r = 0
        for name, c in zip(self.axes, coords):
            r = r * self.shape[name] + c
        return r

    def group(self, axis: str, rank: int = 0) -> List[int]:
        """The ranks along ``axis`` through ``rank``, in axis order: the
        other coordinates stay (a ring keeps its data and tp group)."""
        i = self.axes.index(axis)
        coords = list(self.coords(rank))
        out = []
        for c in range(self.shape[axis]):
            coords[i] = c
            out.append(self.rank(coords))
        return out

    def home(self, data: int, tp: int, stage: int = 0) -> torch.device:
        """The device of rank (data, stage, tp): with stage 0 on an sp mesh,
        where the ranks at (data, ·, tp) compute outside the
        sequence-parallel attention; on a pipeline mesh, the device of that
        pipeline stage."""
        return self.devices[self.rank((data, stage, tp))]

    def __repr__(self) -> str:
        names = sorted({str(d) for d in self.devices})
        return f"Mesh({self.shape}, {len(self.devices)} ranks on {', '.join(names)})"


def create_mesh(mesh_config: Union[MeshConfig, dict, None] = None,
                devices: Optional[Sequence[torch.device]] = None) -> Mesh:
    """A mesh over ``devices`` (default: every CUDA device of the host, one
    rank each)."""
    if isinstance(mesh_config, dict):
        mesh_config = MeshConfig(**mesh_config)
    mesh_config = mesh_config or MeshConfig()
    if devices is None:
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    if not devices:
        raise RuntimeError("no devices for the mesh")
    return Mesh(mesh_config.resolve(len(devices)), devices)


def create_pp_mesh(pp: int, data: int = 1, tp: int = 1, devices: Optional[Sequence[torch.device]] = None) -> Mesh:
    """A (data, pp, tp) mesh over the first data * pp * tp of ``devices``
    (default: every CUDA device of the host), row-major; a device may
    repeat. ``tp`` > 1 cuts each pipeline stage's blocks over 'tp' (the
    PP x TP hybrid, ``training/pp.py``)."""
    n = data * pp * tp
    if devices is None:
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devices = list(devices)[:n]
    if len(devices) != n:
        raise ValueError(f"a (data {data}, pp {pp}, tp {tp}) mesh needs {n} devices, got {len(devices)}")
    return Mesh((data, pp, tp), devices, PP_AXES)


def local_batch_size(global_batch: int, mesh: Mesh) -> int:
    """The rows of each data rank (opensora_tpu/parallel/mesh.py:94-97)."""
    dp = mesh.shape[DATA_AXIS]
    if global_batch % dp:
        raise ValueError(f"global batch {global_batch} does not split over the mesh 'data' axis ({dp})")
    return global_batch // dp


def round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def pad_to_multiple(length: int, multiple: int) -> int:
    return int(math.ceil(length / multiple) * multiple)
