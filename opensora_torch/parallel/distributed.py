"""Processes of a multi-process run (counterpart of
``jax.distributed.initialize``, ``jax.process_index()`` and
``jax.process_count()``, which scripts/diffusion/train.py:69-72 calls under
``multi_host=True``).

``torchrun`` (``python -m torch.distributed.run``) starts the processes and
sets ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``LOCAL_WORLD_SIZE``,
``MASTER_ADDR`` and ``MASTER_PORT``; :func:`initialize` reads them, picks
the process's device and the backend, and joins the process group.

- The device: local process i of n on a host takes card ``i * n_cards //
  n`` (the spread of ``train.pipeline_mesh``), so two processes on a
  one-card host both use ``cuda:0``; a CPU device puts every process on
  the CPU.
- The backend: ``nccl`` where every process's device is a CUDA device no
  other process of its host uses (as many cards as local processes),
  ``gloo`` otherwise (the CPU, and processes that share a card). It is
  decided once from the host's own counts (torchrun starts as many
  processes on every host, and the hosts are alike) and logged; a backend
  that fails to initialise raises, it is not swapped for the other one.

Without a process group, :func:`process_index` is 0 and
:func:`process_count` 1, and :func:`barrier` returns at once.

A mesh whose 'data', 'sp', 'tp' or 'pp' groups span processes
(``parallel/mesh.py``) runs each of their collectives over a
:class:`Group`: the processes of one such group and its
``torch.distributed`` subgroup, made by
:func:`make_groups` on every process in one fixed order (``dist.new_group``
is a collective of the whole world) and cached, with the group's timeout.
A group of every process uses the default group.
"""

from __future__ import annotations

import datetime
import logging
import os
from dataclasses import dataclass
from typing import Dict, Iterable, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

logger = logging.getLogger(__name__)

ENV = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "LOCAL_WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")


@dataclass(frozen=True)
class ProcessGroup:
    """What :func:`initialize` set up: the process's rank, the world size,
    its device and the backend."""

    rank: int
    world_size: int
    device: torch.device
    backend: str
    timeout: Optional[datetime.timedelta] = None


_GROUP: Optional[ProcessGroup] = None


@dataclass(frozen=True)
class Group:
    """Some processes of the run, in order, and their ``torch.distributed``
    group (``handle``; None for every process: the default group)."""

    ranks: Tuple[int, ...]
    handle: object = None

    @property
    def size(self) -> int:
        return len(self.ranks)

    def index(self) -> int:
        """This process's place in the group."""
        return self.ranks.index(process_index())


_SUBGROUPS: Dict[Tuple[int, ...], Group] = {}


def read_env() -> dict:
    """torchrun's variables, as ints (``MASTER_ADDR`` as given); a missing
    one raises, naming every missing one."""
    missing = [k for k in ENV if k not in os.environ]
    if missing:
        raise RuntimeError(f"multi-process run: {', '.join(missing)} not set; start the processes with "
                           f"`python -m torch.distributed.run --nproc-per-node N -m ...`, which sets {', '.join(ENV)}")
    return {k: os.environ[k] if k == "MASTER_ADDR" else int(os.environ[k]) for k in ENV}


def process_device(device, local_rank: int, local_world_size: int) -> torch.device:
    """Local process ``local_rank`` of ``local_world_size``: card
    ``local_rank * n_cards // local_world_size`` for a CUDA ``device``,
    else ``device`` itself."""
    device = torch.device(device)
    if device.type != "cuda":
        return device
    n_cards = torch.cuda.device_count()
    if n_cards == 0:
        raise RuntimeError("multi-process run on cuda: this host has no CUDA device")
    return torch.device("cuda", local_rank * n_cards // local_world_size)


def choose_backend(device: torch.device, local_world_size: int) -> str:
    """``nccl`` where each local process has a card of its own, else
    ``gloo`` (the CPU, or processes sharing a card)."""
    if device.type == "cuda" and torch.cuda.device_count() >= local_world_size:
        return "nccl"
    return "gloo"


def initialize(device="cuda", timeout: Optional[datetime.timedelta] = None) -> torch.device:
    """Join the process group torchrun's variables describe and return the
    process's device (see the module docstring). Calling it again in an
    initialised process returns the same device."""
    global _GROUP
    if _GROUP is not None:
        return _GROUP.device
    env = read_env()
    dev = process_device(device, env["LOCAL_RANK"], env["LOCAL_WORLD_SIZE"])
    backend = choose_backend(dev, env["LOCAL_WORLD_SIZE"])
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    logger.info("process %d of %d on %s, backend %s (%d local processes, %d card(s))", env["RANK"],
                env["WORLD_SIZE"], dev, backend, env["LOCAL_WORLD_SIZE"],
                torch.cuda.device_count() if dev.type == "cuda" else 0)
    kw = {} if timeout is None else {"timeout": timeout}
    dist.init_process_group(backend, init_method=f"tcp://{env['MASTER_ADDR']}:{env['MASTER_PORT']}",
                            rank=env["RANK"], world_size=env["WORLD_SIZE"], **kw)
    _GROUP = ProcessGroup(env["RANK"], env["WORLD_SIZE"], dev, backend, timeout)
    return dev


def shutdown() -> None:
    """Leave the process group (a no-op without one)."""
    global _GROUP
    if _GROUP is not None:
        dist.destroy_process_group()
        _SUBGROUPS.clear()
        _GROUP = None


def make_groups(sets: Iterable[Sequence[int]]) -> None:
    """The subgroups of ``sets`` (process ranks), each made once: a
    collective that every process calls with the same sets in the same
    order (sets of one process make none)."""
    for ranks in sets:
        ranks = tuple(sorted(ranks))
        if 1 < len(ranks) < process_count() and ranks not in _SUBGROUPS:
            kw = {} if _GROUP.timeout is None else {"timeout": _GROUP.timeout}
            _SUBGROUPS[ranks] = Group(ranks, dist.new_group(list(ranks), **kw))


def subgroup(ranks: Sequence[int]) -> Group:
    """The group of ``ranks`` (made by :func:`make_groups`; one process:
    a group without a handle, over which nothing is sent)."""
    ranks = tuple(sorted(ranks))
    if len(ranks) == 1 or ranks == tuple(range(process_count())):
        return Group(ranks)
    if ranks not in _SUBGROUPS:
        raise RuntimeError(f"no process group for processes {ranks}: make it with make_groups on every process")
    return _SUBGROUPS[ranks]


def world() -> Group:
    """Every process of the run."""
    return Group(tuple(range(process_count())))


def group() -> Optional[ProcessGroup]:
    return _GROUP


def process_index() -> int:
    return _GROUP.rank if _GROUP is not None else 0


def process_count() -> int:
    return _GROUP.world_size if _GROUP is not None else 1


def is_main_process() -> bool:
    return process_index() == 0


def backend() -> Optional[str]:
    return _GROUP.backend if _GROUP is not None else None


def barrier() -> None:
    """Every process waits for the others (nothing without a group)."""
    if _GROUP is not None:
        if _GROUP.backend == "nccl":
            dist.barrier(device_ids=[_GROUP.device.index])
        else:
            dist.barrier()


def broadcast_object(obj, src: int = 0, over: Optional[Group] = None):
    """``obj`` of process ``src`` on every process of ``over`` (default:
    every process; picklable; ``obj`` itself without a group)."""
    if _GROUP is None or (over is not None and over.size == 1):
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=src, group=None if over is None else over.handle,
                               device=_GROUP.device if _GROUP.backend == "nccl" else None)
    return box[0]


def all_gather_object(obj) -> list:
    """Every process's ``obj``, in process order (``[obj]`` without a
    group)."""
    if _GROUP is None:
        return [obj]
    out = [None] * _GROUP.world_size
    dist.all_gather_object(out, obj)
    return out
