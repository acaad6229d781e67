"""The device mesh: axis sizes (data, sp, tp), or (data, pp, tp) for a
pipeline, and one device per rank (counterpart of
opensora_tpu/parallel/mesh.py:33-105 and of ``create_pp_mesh``,
opensora_tpu/training/pp.py:193-211).

JAX drives a mesh from one controller process per host; the counterpart
here is one process that holds every rank of the mesh and its device, or,
in a multi-process run (``parallel/distributed.py``), the ranks at its own
'data' coordinates. Ranks are numbered in row-major order over the mesh's
axes, as JAX flattens logical device ids; the middle axis is 'sp' or 'pp'.
A device may appear more than once: several *logical ranks* then share one
device, as the JAX package's tests put a mesh on virtual CPU devices.
``[torch.device("cuda", 0)] * 4`` is a 4-rank mesh on one card;
``[torch.device("cuda", i) for i in range(4)]`` the same mesh over four
cards of one host. Collectives between the ranks of a process are moves
between their tensors (``parallel/comm.py``).

Across processes, ``processes[r]`` names the process that holds rank r.
Each process holds a contiguous run of ranks in row-major order, as the
hosts of a pod cut JAX's mesh (opensora_tpu/parallel/mesh.py:61-79): whole
'data' coordinates, or a contiguous run of one data coordinate's ranks. So
every axis may cross processes: a process may hold some of a tp group's
ranks, some of a pipeline's stages, or some sp ranks, each at its own
coordinates. Every 'data', 'sp' (or 'pp') and 'tp' group that spans
several processes, and each data coordinate's processes (its *block*,
which reads the same samples and feeds the model the same inputs), gets a
``torch.distributed`` subgroup (:meth:`Mesh.process_group`,
:attr:`Mesh.block_group`), made when the mesh is, in one order on every
process. Two processes on one card both name their device ``cuda:0``, so a
rank's identity is (process, device) (:meth:`Mesh.home_key`), never the
device alone.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple, Union

import torch

from opensora_torch.parallel import distributed

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
    """Axis sizes, the device of each rank (row-major over ``axes``:
    ``AXES``, or ``PP_AXES`` for a pipeline) and the process that holds it
    (``processes``, default: this process for every rank; see the module
    docstring for the layouts over processes)."""

    def __init__(self, sizes: Sequence[int], devices: Sequence[torch.device], axes: Sequence[str] = AXES,
                 processes: Optional[Sequence[int]] = None):
        if len(sizes) != len(axes) or math.prod(sizes) != len(devices):
            raise ValueError(f"mesh {tuple(sizes)} over {len(devices)} devices")
        self.axes = tuple(axes)
        self.shape: Dict[str, int] = dict(zip(self.axes, (int(s) for s in sizes)))
        self.devices: List[torch.device] = [_indexed(torch.device(d)) for d in devices]
        self.process = distributed.process_index()
        self.processes: List[int] = [self.process] * len(self.devices) if processes is None else list(processes)
        self.n_processes = len(set(self.processes))
        if len(self.processes) != len(self.devices):
            raise ValueError(f"{len(self.processes)} processes for {len(self.devices)} ranks")
        self._check_runs()
        if self.n_processes > 1 and sorted(set(self.processes)) != list(range(distributed.process_count())):
            raise ValueError(f"a mesh over processes {sorted(set(self.processes))} in a run of "
                             f"{distributed.process_count()}")
        self.local_ranks: List[int] = [r for r, p in enumerate(self.processes) if p == self.process]
        self.local_data: List[int] = self.process_data(self.process)
        # the middle coordinates (sp ranks, or pipeline stages) of this process's ranks
        self.local_mid: List[int] = sorted({self.coords(r)[1] for r in self.local_ranks})
        # the 'data' blocks: the processes of one data coordinate read the same samples
        self.data_blocks = self.shape[DATA_AXIS] // len(self.local_data)
        self.data_block = self.local_data[0] // len(self.local_data)
        # the processes of this process's tp group (1 where it holds whole tp groups)
        self.tp_processes = len(self.processes_along(TP_AXIS, self.local_ranks[0]))
        if self.n_processes > 1:
            distributed.make_groups([self.processes_along(axis, r) for axis in (DATA_AXIS, self.axes[1], TP_AXIS)
                                     for r in range(len(self.devices))]
                                    + [self.block_processes(b) for b in range(self.data_blocks)])
        self.block_group = distributed.subgroup(self.block_processes(self.data_block))

    def _check_runs(self) -> None:
        """Each process holds a contiguous run of ranks: whole data
        coordinates, or a run of one data coordinate's ranks."""
        per_data = len(self.devices) // self.shape[DATA_AXIS]
        runs = {}
        for r, p in enumerate(self.processes):
            runs.setdefault(p, []).append(r)
        for p, ranks in runs.items():
            n = len(ranks)
            if ranks != list(range(ranks[0], ranks[0] + n)) or (n % per_data and per_data % n) or ranks[0] % n:
                raise ValueError(f"process {p} holds ranks {ranks} of a {self.shape} mesh: a process holds a "
                                 f"contiguous run of whole data coordinates or of one coordinate's ranks")

    def processes_along(self, axis: str, rank: int) -> List[int]:
        """The processes that hold the ranks along ``axis`` through
        ``rank``, in axis order (each once)."""
        out: List[int] = []
        for r in self.group(axis, rank):
            if self.processes[r] not in out:
                out.append(self.processes[r])
        return out

    def process_group(self, axis: str, rank: int) -> distributed.Group:
        """The :class:`~opensora_torch.parallel.distributed.Group` of the
        processes along ``axis`` through ``rank`` (of this process alone
        where the group lies in it)."""
        return distributed.subgroup(self.processes_along(axis, rank))

    def block_processes(self, block: int) -> List[int]:
        """The processes of data block ``block`` (they hold the same 'data'
        coordinates, and so read the same rows)."""
        n = len(self.local_data)
        return sorted({p for r, p in enumerate(self.processes) if self.coords(r)[0] // n == block})

    def process_data(self, process: int) -> List[int]:
        """The 'data' coordinates of ``process``'s ranks, in order (a
        contiguous run)."""
        return sorted({self.coords(r)[0] for r, p in enumerate(self.processes) if p == process})

    def is_local(self, rank: int) -> bool:
        """Whether this process holds ``rank``."""
        return self.processes[rank] == self.process

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

    def home(self, data: int, tp: int, mid: int = 0) -> torch.device:
        """The device of rank (data, mid, tp), ``mid`` the coordinate on the
        middle axis: on an sp mesh the sp rank, which holds and computes
        its own chunk of the tokens (``models/mmdit/model.py``; 0 where
        the tokens stay whole on the ranks at (data, 0, tp)); on a
        pipeline mesh the stage."""
        return self.devices[self.rank((data, mid, tp))]

    def home_key(self, data: int, tp: int, mid: int = 0) -> Tuple[int, torch.device]:
        """The identity of :meth:`home`'s rank: (process, device)."""
        r = self.rank((data, mid, tp))
        return self.processes[r], self.devices[r]

    def __repr__(self) -> str:
        names = sorted({str(d) for d in self.devices})
        procs = f" in {self.n_processes} processes" if self.n_processes > 1 else ""
        return f"Mesh({self.shape}, {len(self.devices)} ranks on {', '.join(names)}{procs})"


def _over_processes(devices: Optional[Sequence[torch.device]]) -> Tuple[List[torch.device], Optional[List[int]]]:
    """The mesh's devices and their processes. In a multi-process run:
    every process's ``devices`` (default: its own device), in process
    order, as ``jax.devices()`` orders them; else ``devices`` (default:
    every CUDA device of the host) and None."""
    if distributed.process_count() == 1:
        if devices is None:
            devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
        return list(devices), None
    local = [str(_indexed(torch.device(d))) for d in (devices or [distributed.group().device])]
    per = distributed.all_gather_object(local)
    if len({len(p) for p in per}) != 1:
        raise ValueError(f"the processes hold different numbers of ranks: {[len(p) for p in per]}")
    return [torch.device(d) for p in per for d in p], [i for i, p in enumerate(per) for _ in p]


def create_mesh(mesh_config: Union[MeshConfig, dict, None] = None,
                devices: Optional[Sequence[torch.device]] = None) -> Mesh:
    """A mesh over ``devices`` (default: every CUDA device of the host, one
    rank each). In a multi-process run ``devices`` are this process's
    (default: its device) and the mesh is over every process's, in process
    order (a collective: every process calls it)."""
    if isinstance(mesh_config, dict):
        mesh_config = MeshConfig(**mesh_config)
    mesh_config = mesh_config or MeshConfig()
    devices, processes = _over_processes(devices)
    if not devices:
        raise RuntimeError("no devices for the mesh")
    return Mesh(mesh_config.resolve(len(devices)), devices, processes=processes)


def create_pp_mesh(pp: int, data: int = 1, tp: int = 1, devices: Optional[Sequence[torch.device]] = None) -> Mesh:
    """A (data, pp, tp) mesh over the first data * pp * tp of ``devices``
    (default: every CUDA device of the host), row-major; a device may
    repeat. ``tp`` > 1 cuts each pipeline stage's blocks over 'tp' (the
    PP x TP hybrid, ``training/pp.py``). In a multi-process run ``devices``
    are this process's, each process an equal run of the mesh's ranks:
    whole pipelines, or stages of one, or part of a stage's tp group (a
    collective, as :func:`create_mesh`)."""
    n = data * pp * tp
    devices, processes = _over_processes(devices)
    if processes is None:
        devices = devices[:n]
    if len(devices) != n:
        raise ValueError(f"a (data {data}, pp {pp}, tp {tp}) mesh needs {n} devices, got {len(devices)}")
    return Mesh((data, pp, tp), devices, PP_AXES, processes=processes)


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
