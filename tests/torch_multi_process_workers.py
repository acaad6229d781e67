"""The worker side of tests/test_torch_multi_process.py and
tests/test_torch_sp_processes.py: functions that run in each of the
processes a test starts, and :class:`Processes`, which starts them.

Imports torch and the port only: the workers are started with the
``spawn`` method (the pytest process has JAX initialised, so ``fork`` is
unsafe), and each imports this module afresh. A worker joins a gloo group
on the CPU through ``opensora_torch.parallel.distributed.initialize`` with
the variables torchrun would set, runs its function, and saves the result
for the test to read.
"""

from __future__ import annotations

import contextlib
import datetime
import math
import multiprocessing
import os
import socket
import tempfile
import time
import traceback
import unittest.mock
from typing import Optional

import numpy as np
import torch

CPU = torch.device("cpu")
JOIN_TIMEOUT = 120.0  # seconds a test waits for its processes
GROUP_TIMEOUT = datetime.timedelta(seconds=90)  # a collective that waits longer raises


def free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _entry(fn, rank: int, world: int, port: int, out: str) -> None:
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE=str(world),
                      MASTER_ADDR="localhost", MASTER_PORT=str(port))
    torch.set_num_threads(1)
    from opensora_torch.parallel import distributed

    try:
        distributed.initialize("cpu", timeout=GROUP_TIMEOUT)
        result = fn(*torch.load(f"{out}.args.pt", weights_only=False))
        torch.save(result, f"{out}.{rank}.pt")
    except BaseException:
        with open(f"{out}.{rank}.err", "w") as f:
            f.write(traceback.format_exc())
        raise
    finally:
        distributed.shutdown()


class Processes:
    """``fn(*args)`` in ``world`` spawned processes of one gloo group,
    started at once; :meth:`results` waits for them (the caller may work
    meanwhile) and returns their results in process order. A process that
    fails or outlives ``timeout`` (counted from the start) fails it; the
    others are stopped. ``args`` go through a file: a start then returns
    at once, where a pipe larger than its buffer would wait for the child
    to import torch."""

    def __init__(self, fn, *args, world: int = 2, timeout: float = JOIN_TIMEOUT):
        ctx = multiprocessing.get_context("spawn")
        self.tmp = tempfile.TemporaryDirectory()
        self.out, self.world = os.path.join(self.tmp.name, "result"), world
        torch.save(args, f"{self.out}.args.pt")
        port = free_port()
        self.procs = [ctx.Process(target=_entry, args=(fn, r, world, port, self.out)) for r in range(world)]
        for p in self.procs:
            p.start()
        self.deadline = time.monotonic() + timeout
        self.timeout = timeout

    def results(self) -> list:
        out, world = self.out, self.world
        try:
            for p in self.procs:
                p.join(max(0.0, self.deadline - time.monotonic()))
            hung = [r for r, p in enumerate(self.procs) if p.is_alive()]
            errors = {r: open(f"{out}.{r}.err").read() for r in range(world) if os.path.exists(f"{out}.{r}.err")}
            if hung:
                raise AssertionError(f"processes {hung} still ran after {self.timeout} s; errors: {errors}")
            codes = [p.exitcode for p in self.procs]
            if any(codes) or errors:
                raise AssertionError(f"exit codes {codes}; errors: {errors}")
            return [torch.load(f"{out}.{r}.pt", weights_only=False) for r in range(world)]
        finally:
            for p in self.procs:
                if p.is_alive():
                    p.kill()
                    p.join(10)
            self.tmp.cleanup()


def run_calls(calls) -> list:
    """Each (function name of this module, args, kwargs) of ``calls`` in
    turn, in every process: one start-up for many cases."""
    return [globals()[name](*args, **kwargs) for name, args, kwargs in calls]


# ----------------------------------------------------------------------
# the sharded train step over processes
# ----------------------------------------------------------------------


def port_state(params: dict, geom: dict, opt: dict, backend: Optional[str] = "xla"):
    """The port's MMDiT from the JAX package's numpy params (fp32), and its
    train state with an EMA."""
    from opensora_torch.models.mmdit.model import MMDiTConfig, MMDiTModel
    from opensora_torch.training import diffusion as tdiff
    from opensora_torch.utils import optimizer as topt
    from opensora_torch.utils.weights import load_numpy_state_dict, mmdit_state_dict

    tm = MMDiTModel(MMDiTConfig(**geom, dtype="fp32", attn_backend=backend, remat=True), device="meta",
                    dtype=torch.float32)
    load_numpy_state_dict(tm, {k: v.copy() for k, v in mmdit_state_dict(params).items()})
    tm.requires_grad_(True)
    return tm, tdiff.TrainState.create(tm, topt.create_optimizer(list(tm.parameters()), **opt), ema=True)


def block_rows(batch: dict, mesh) -> dict:
    """This process's data block's rows of a global numpy batch (the
    processes of one data coordinate share them), as torch tensors."""
    return _rows(batch, mesh.data_block, mesh.data_blocks)


def _rows(batch: dict, p: int, n: int) -> dict:
    out = {}
    for k, v in batch.items():
        per = v.shape[0] // n
        out[k] = torch.from_numpy(np.ascontiguousarray(v[p * per:(p + 1) * per]))
    return out


def _unsummed(flat, group=None):
    """Known-wrong: the replicated leaves' gradients are not summed across
    processes (the all-reduce runs, its sum is dropped)."""
    from opensora_torch.parallel.comm import process_all_reduce

    process_all_reduce(flat, group)
    return flat


def _local_draws(batch, text_dropout_prob, generator):
    """Known-wrong: each process draws t, x1 and the dropout choices for its
    own rows only (every process's rows get the same draws)."""
    from opensora_torch.parallel import distributed
    from opensora_torch.training.diffusion import draw_step

    mesh = batch["x0"].mesh
    x0 = torch.cat([batch["x0"].rows(d) for d in mesh.local_data])
    alpha = torch.cat([batch["shift_alpha"].rows(d) for d in mesh.local_data])
    draws = draw_step(dict(x0=x0, shift_alpha=alpha), text_dropout_prob, generator)
    return {k: torch.cat([v] * distributed.process_count()) for k, v in draws.items()}


def _undivided(loss, n_processes, group=None):
    """Known-wrong: the loss is not divided across processes (its value the
    mean, its gradient the process's own mean's)."""
    from opensora_torch.parallel.comm import process_all_reduce

    return loss - loss.detach() + process_all_reduce(loss.detach() / n_processes, group)


def _own_kv(self, name, work, buf, slots, slot):
    """Known-wrong: the ring's cross-process KV hop skipped: the receiving
    rank reuses its own KV (its other slot) in place of its left
    neighbour's."""
    work.wait()
    if name == "kv":
        slots[slot].copy_(slots[1 - slot])
    elif buf is not None:
        slots[slot].copy_(buf)


def _gather_over_every_process(shards, dim, dtype, device, group=None):
    """Known-wrong: the FSDP all-gather over every process instead of the
    rank's 'data' group (it joins the sp ranks' copies of one shard)."""
    from opensora_torch.parallel import comm

    return comm.process_gather_shards(shards, dim, dtype, device)


def _tp_grad_local(ctx, grad):
    """Known-wrong: the backward of the tp group's cross-process sum left
    out (each process keeps its own share of the gradient)."""
    return grad, None


def _tp_bias_each_process(parts, dtype=None, bias=None, group=None):
    """Known-wrong: the row bias added on each process of a tp group, before
    the sum across them (so once per process)."""
    from opensora_torch.parallel import comm

    if bias is not None and group is not None and group.size > 1:
        parts = [parts[0].float() + bias[0].float()] + [p.float() for p in parts[1:]]
        bias, dtype = None, dtype or parts[0].dtype
    return comm.all_reduce(parts, dtype, bias, group)


def _gradient_not_sent(slot):
    """Known-wrong: a pipeline stage's received activation sends back a zero
    gradient, so the stages before it get none from it."""
    return [torch.zeros_like(x) for x in slot.received]


def _microbatches_forward(slots):
    """Known-wrong: the slots' backwards run in the reverse order, but each
    with the microbatch of the mirrored one (the microbatches' backwards in
    forward order): the messages keep their sizes and places, so the
    gradients meet the wrong microbatches."""
    at = {s.key: s for s in slots}
    out = []
    for s in reversed(slots):
        if len(s.key) == 6:
            call, tick, stage, d, m, n = s.key
            s = at[(call, tick + n - 1 - 2 * m, stage, d, n - 1 - m, n)]
        out.append(s)
    return out


VARIANTS = {
    "right": None,
    "tp_grad_local": ("opensora_torch.parallel.comm._TpSum.backward", _tp_grad_local),
    "tp_bias_each_process": ("opensora_torch.parallel.sharding.all_reduce", _tp_bias_each_process),
    "pp_gradient_not_sent": ("opensora_torch.parallel.pipeline.sent_back", _gradient_not_sent),
    "pp_microbatches_forward": ("opensora_torch.parallel.pipeline.backward_order", _microbatches_forward),
    "unsummed": ("opensora_torch.parallel.sharding.process_all_reduce", _unsummed),
    "local_draws": ("opensora_torch.training.diffusion.global_draws", _local_draws),
    "undivided": ("opensora_torch.training.diffusion.process_mean", _undivided),
    "kv_skipped": ("opensora_torch.parallel.comm.RingTransport._land", _own_kv),
    "world_gather": ("opensora_torch.parallel.sharding.process_gather_shards", _gather_over_every_process),
}


def _gathered(state) -> dict:
    """A state dict gathered on process 0 (None elsewhere), with the AdamW
    moments by parameter name."""
    sd = state.state_dict()
    if sd is None:
        return None
    names = list(sd["params"])
    moments = {names[i]: {k: st[k] for k in ("exp_avg", "exp_avg_sq")}
               for i, st in sd["optimizer"]["adamw"]["state"].items()}
    return dict(params=sd["params"], ema=sd["ema"], moments=moments, step=sd["step"])


def sharded_steps(params, batch, geom, opt, sizes, draws=None, seed=None, variant="right", n_steps=2,
                  prob=0.5, ckpt_dir=None, backend="xla") -> dict:
    """``n_steps`` steps of the full-finetune train step over a (dp, sp, tp)
    mesh whose 'data' (and 'sp') axes cross the processes, each holding an
    equal run of the ranks, from the JAX package's params, each process
    given its data block's rows of ``batch``: with ``draws`` (a list per
    step, the global batch's) or drawn from a generator seeded ``seed``,
    under the named known-wrong ``variant``, the model's attention
    ``backend``. Returns the metrics per step, and on process 0 the
    gathered state; ``ckpt_dir``: the state is also saved there by
    ``CheckpointIO`` (every process calls it). A variant that raises
    returns its error."""
    from opensora_torch.parallel import comm, distributed
    from opensora_torch.parallel.context import set_mesh
    from opensora_torch.parallel.mesh import MeshConfig, create_mesh
    from opensora_torch.training import diffusion as tdiff
    from opensora_torch.utils.ckpt import CheckpointIO

    dp, sp, tp = sizes
    mesh = create_mesh(MeshConfig(dp, sp, tp), [CPU] * (dp * sp * tp // distributed.process_count()))
    set_mesh(mesh)
    tm, state = port_state(params, geom, opt, backend)
    state = tdiff.shard_state(mesh, state, tm, fsdp=True)
    step = tdiff.make_train_step(tm, ema_decay=0.9, text_dropout_prob=prob, use_masked_loss=True)
    mine = block_rows(batch, mesh)
    gen = None if seed is None else torch.Generator().manual_seed(seed)
    patch = VARIANTS[variant]
    metrics, tp_remote = [], []
    with unittest.mock.patch(patch[0], patch[1]) if patch else contextlib.nullcontext():
        try:
            for i in range(n_steps):
                comm.TP_REMOTE.update(all_reduces=0, bytes=0)
                m = step(state, mine, generator=gen, draws=None if draws is None else draws[i])
                metrics.append({k: float(v) for k, v in m.items()})
                tp_remote.append(dict(comm.TP_REMOTE))
        except RuntimeError as e:
            if variant == "right":
                raise
            set_mesh(None)
            return dict(error=str(e))
    leaves = sum(p.numel() for p in state.params.values())
    out = dict(metrics=metrics, state=_gathered(state), mesh=repr(mesh), local_leaf_numel=leaves,
               replica_ids=len(state.optimizer.replica_ids), tp_remote=tp_remote)
    if ckpt_dir is not None:
        out["ckpt"] = CheckpointIO().save(ckpt_dir, state, 0, n_steps, n_steps)
    set_mesh(None)
    return out


def load_sharded(params, geom, opt, sizes, ckpt) -> dict:
    """A sharded state across the processes (from ``params``) loaded from
    an unsharded state's checkpoint, gathered on process 0."""
    from opensora_torch.parallel import distributed
    from opensora_torch.parallel.context import set_mesh
    from opensora_torch.parallel.mesh import MeshConfig, create_mesh
    from opensora_torch.training import diffusion as tdiff
    from opensora_torch.utils.ckpt import CheckpointIO

    dp, sp, tp = sizes
    mesh = create_mesh(MeshConfig(dp, sp, tp), [CPU] * (dp * sp * tp // distributed.process_count()))
    set_mesh(mesh)
    tm, state = port_state(params, geom, opt)
    state = tdiff.shard_state(mesh, state, tm, fsdp=True)
    _, running, _ = CheckpointIO().load(ckpt, state)
    out = dict(state=_gathered(state), running=running, count=state.optimizer.count)
    set_mesh(None)
    return out


def lora_steps(params: dict, factors: dict, batch: dict, geom: dict, opt: dict, sizes, rank: int, scale: float,
               draws: list, prob: float = 0.5) -> dict:
    """LoRA steps over a (dp, sp, tp) mesh whose 'data' (or 'tp') axis
    crosses the processes: the base from the JAX package's params (frozen,
    FSDP + TP), the factors (``lora_state_dict`` names) replicated, each
    process given its data block's rows of ``batch``, the global batch's
    ``draws`` per step. Returns
    the metrics, the factors gathered on process 0, and how many FSDP
    gathers and reduce-scatters crossed the processes (the frozen base's
    gathers take no gradient: no reduce-scatter)."""
    from opensora_torch.models.mmdit.model import MMDiTConfig, MMDiTModel
    from opensora_torch.parallel import comm
    from opensora_torch.parallel.context import set_mesh
    from opensora_torch.parallel.mesh import MeshConfig, create_mesh
    from opensora_torch.training import diffusion as tdiff
    from opensora_torch.training.lora import apply_lora
    from opensora_torch.utils import optimizer as topt
    from opensora_torch.utils.weights import load_numpy_state_dict, mmdit_state_dict

    dp, sp, tp = sizes
    mesh = create_mesh(MeshConfig(dp, sp, tp), [CPU] * (dp * sp * tp // 2))
    set_mesh(mesh)
    tm = MMDiTModel(MMDiTConfig(**geom, dtype="fp32", attn_backend="xla", remat=True), device="meta",
                    dtype=torch.float32)
    load_numpy_state_dict(tm, {k: v.copy() for k, v in mmdit_state_dict(params).items()})
    apply_lora(tm, rank=rank, scale=scale)
    tm.load_state_dict({k: torch.from_numpy(v.copy()) for k, v in factors.items()}, strict=False)
    state = tdiff.TrainState.create(
        tm, topt.create_optimizer([p for p in tm.parameters() if p.requires_grad], **opt), ema=False)
    state = tdiff.shard_state(mesh, state, tm, fsdp=True)
    step = tdiff.make_train_step(tm, ema_decay=0.9, text_dropout_prob=prob, use_masked_loss=True)
    counts = {"gathers": 0, "reduce_scatters": 0}

    def counted(fn, key):
        def wrapped(*args, **kwargs):
            counts[key] += 1
            return fn(*args, **kwargs)
        return wrapped

    mine = block_rows(batch, mesh)
    with unittest.mock.patch.multiple(comm, process_all_gather=counted(comm.process_all_gather, "gathers"),
                                      process_reduce_scatter=counted(comm.process_reduce_scatter,
                                                                     "reduce_scatters")):
        metrics = [{k: float(v) for k, v in step(state, mine, draws=d).items()} for d in draws]
    sd = state.state_dict()
    set_mesh(None)
    return dict(metrics=metrics, factors=None if sd is None else sd["params"], ema=None if sd is None else sd["ema"],
                **counts)


def pp_step(state_dict: dict, geom: dict, opt: dict, sizes, n_micro: int, batch: dict, seed: int,
            bucket: Optional[int] = None, variant: str = "right") -> dict:
    """One GPipe step over a (pp, data, tp) mesh (``sizes``), from
    ``state_dict``, on this process's data block's rows of ``batch``, the
    draws from a generator seeded ``seed``: over processes, each holds an
    equal run of the ranks (its data rows' whole pipelines, or stages of
    one, or part of a stage's tp group); in one process (no group), every
    rank. Returns the
    metrics, the gathered state (None off process 0) and the pipeline's and
    the tp groups' traffic across processes (``comm.PP_REMOTE``,
    ``comm.TP_REMOTE``), under the named known-wrong ``variant``; with
    ``bucket``, the cross-process gradient sum runs in buckets of that many
    elements, and ``buckets`` lists, per call of ``sharding._buckets``, its
    buckets' leaf sizes."""
    from opensora_torch.models.mmdit.model import MMDiTConfig, MMDiTModel
    from opensora_torch.parallel import comm, distributed, sharding
    from opensora_torch.parallel.context import set_mesh
    from opensora_torch.parallel.mesh import create_pp_mesh
    from opensora_torch.training import diffusion as tdiff
    from opensora_torch.training.pp import make_pp_forward, pp_state_shardings
    from opensora_torch.utils import optimizer as topt

    pp, data, tp = sizes
    tm = MMDiTModel(MMDiTConfig(**geom, dtype="fp32", attn_backend="xla", remat=True), device="cpu",
                    dtype=torch.float32)
    tm.load_state_dict(state_dict)
    tm.requires_grad_(True)
    mesh = create_pp_mesh(pp, data, tp, [CPU] * (pp * data * tp // distributed.process_count()))
    set_mesh(mesh)
    state = tdiff.TrainState.create(tm, topt.create_optimizer(list(tm.parameters()), **opt), ema=True)
    state = tdiff.shard_state(mesh, state, tm, shardings=pp_state_shardings(mesh, state, tm))
    step = tdiff.make_train_step(tm, ema_decay=0.9, forward_fn=make_pp_forward(tm, mesh, n_micro))
    seen, cut = [], sharding._buckets

    def recorded(groups, limit):
        runs = cut(groups, limit)
        seen.append([[g[0].numel() for g in run] for run in runs])
        return runs

    comm.reset_pp_remote()
    comm.TP_REMOTE.update(all_reduces=0, bytes=0)
    patch = VARIANTS[variant]
    if variant == "pp_microbatches_forward" and distributed.process_index():
        patch = None  # process 0 alone runs its microbatches' backwards in forward order
    with unittest.mock.patch.multiple(sharding, REPLICA_BUCKET=bucket, _buckets=recorded) if bucket \
            else contextlib.nullcontext(), unittest.mock.patch(patch[0], patch[1]) if patch \
            else contextlib.nullcontext():
        m = step(state, block_rows(batch, mesh), generator=torch.Generator().manual_seed(seed))
    out = dict(metrics=[{k: float(v) for k, v in m.items()}], state=_gathered(state), mesh=repr(mesh),
               buckets=seen, pp_remote={k: comm.PP_REMOTE[k] for k in ("sends", "bytes")},
               pp_log={p: list(v) for p, v in comm.PP_REMOTE["log"].items()}, tp_remote=dict(comm.TP_REMOTE))
    set_mesh(None)
    return out


def pp_forward(state_dict: dict, geom: dict, sizes, n_micro: int, inputs: dict) -> torch.Tensor:
    """The GPipe forward (``make_pp_forward``) over a (pp, data, tp) mesh
    (``sizes``; each process an equal run of its ranks) on ``inputs`` (the
    model's keyword arguments, numpy): the output (None on a process without
    the last stage)."""
    from opensora_torch.models.mmdit.model import MMDiTConfig, MMDiTModel
    from opensora_torch.parallel import distributed
    from opensora_torch.parallel.mesh import create_pp_mesh
    from opensora_torch.training.pp import make_pp_forward, shard_pp

    pp, data, tp = sizes
    tm = MMDiTModel(MMDiTConfig(**geom, dtype="fp32", attn_backend="xla"), device="cpu", dtype=torch.float32)
    tm.load_state_dict(state_dict)
    mesh = create_pp_mesh(pp, data, tp, [CPU] * (pp * data * tp // distributed.process_count()))
    shard_pp(mesh, tm)
    with torch.no_grad():
        return make_pp_forward(tm, mesh, n_micro)(**{k: torch.from_numpy(v) for k, v in inputs.items()})


def pp_under_nccl(state_dict: dict, geom: dict, n_micro: int, inputs: dict) -> dict:
    """``make_pp_forward`` with the backend taken for nccl (its buffers then
    lie where the tensors do, unstaged), over (pp 2, data 1), one stage a
    process, and over (pp 2, data 2), whole pipelines a process: per mesh,
    whether the pipeline spans the processes and the forward's output on
    ``inputs`` (None on a process without the last stage)."""
    from opensora_torch.models.mmdit.model import MMDiTConfig, MMDiTModel
    from opensora_torch.parallel import distributed
    from opensora_torch.parallel.mesh import create_pp_mesh
    from opensora_torch.parallel.pipeline import check_transport
    from opensora_torch.training.pp import make_pp_forward, shard_pp

    out = {}
    for sizes in ((2, 1, 1), (2, 2, 1)):
        tm = MMDiTModel(MMDiTConfig(**geom, dtype="fp32", attn_backend="xla"), device="cpu", dtype=torch.float32)
        tm.load_state_dict(state_dict)
        mesh = create_pp_mesh(*sizes, [CPU] * (math.prod(sizes) // distributed.process_count()))
        shard_pp(mesh, tm)
        with unittest.mock.patch.object(distributed, "backend", lambda: "nccl"), torch.no_grad():
            fwd = make_pp_forward(tm, mesh, n_micro)
            rows = _rows(inputs, mesh.data_block, mesh.data_blocks)
            out[sizes] = dict(spans=check_transport(mesh), out=fwd(**rows))
    return out


def tp_max(seed: int, shape) -> dict:
    """``comm.all_reduce_max`` over a tp group spanning every process, each
    holding two ranks' tensors drawn from ``seed`` and its index, and
    ``all_reduce`` of the same tensors with a bias: the results and the
    cross-process all-reduces counted."""
    from opensora_torch.parallel import comm, distributed

    p = distributed.process_index()
    gen = torch.Generator().manual_seed(seed + p)
    parts = [torch.randn(shape, generator=gen) for _ in range(2)]
    bias = torch.randn(shape[-1], generator=torch.Generator().manual_seed(seed))
    comm.TP_REMOTE.update(all_reduces=0, bytes=0)
    group = distributed.world()
    out = dict(parts=parts, max=comm.all_reduce_max(parts, group), sum=comm.all_reduce(parts, bias=[bias] * 2,
                                                                                        group=group))
    out["tp_remote"] = dict(comm.TP_REMOTE)
    return out


# ----------------------------------------------------------------------
# the data layer, the logger, the mesh
# ----------------------------------------------------------------------


def data_layer(n_rows: int, table: list, buckets: dict, seed: int) -> dict:
    """``make_global_batch`` from this process's rows (each rank's pieces,
    the global tensor back, the error for rows that do not divide), the
    sampler's indices of ``prepare_dataloader`` with its defaults (the
    index sampler and the bucket sampler), and what the logger writes."""
    import logging

    from opensora_torch.datasets.dataloader import prepare_dataloader
    from opensora_torch.parallel import distributed
    from opensora_torch.parallel.data import make_global_batch
    from opensora_torch.parallel.mesh import MeshConfig, create_mesh
    from opensora_torch.utils.logger import create_logger

    out = {}
    mesh = create_mesh(MeshConfig(4, 2, 1), [CPU] * 4)
    p = distributed.process_index()
    x = torch.arange(n_rows * 6 * 3, dtype=torch.float32).reshape(n_rows, 6, 3) + 1000 * p
    placed = make_global_batch(mesh, {"x0": x, "y_vec": x[:, 0], "cond": None})
    out["shape"] = tuple(placed["x0"].shape)
    out["spec"] = placed["x0"].spec
    out["shards"] = [None if s is None else s.clone() for s in placed["x0"].shards]
    out["rows"] = {d: placed["x0"].rows(d).clone() for d in mesh.local_data}
    out["full"] = placed["x0"].full().clone()
    out["full_y"] = placed["y_vec"].full().clone()
    try:
        make_global_batch(create_mesh(MeshConfig(4, 1, 1), [CPU] * 2), {"x0": torch.zeros(3, 2)})
    except ValueError as e:
        out["error"] = str(e)
    try:
        make_global_batch(mesh, {"x0": torch.zeros(2 + 2 * p, 2)})
    except ValueError as e:
        out["shape_error"] = str(e)

    class Data:
        data = table

        def __len__(self):
            return len(table)

    _, index_sampler = prepare_dataloader(Data(), batch_size=3, seed=seed, spatial_compression=16)
    _, bucket_sampler = prepare_dataloader(Data(), bucket_config=buckets, seed=seed, spatial_compression=16)
    out["index_sampler"] = list(index_sampler)
    bucket_sampler.set_epoch(1)
    out["bucket_sampler"] = list(bucket_sampler)
    out["replicas"] = (index_sampler.num_replicas, index_sampler.rank, bucket_sampler.num_replicas,
                       bucket_sampler.rank)

    with tempfile.TemporaryDirectory() as tmp:
        exp = os.path.join(tmp, f"p{p}")
        logger = create_logger(exp, name="multi_process_test")
        logger.info("a line from process %d", p)
        for h in logger.handlers:
            h.flush()
        out["handlers"] = [type(h).__name__ for h in logger.handlers]
        out["log_exists"] = os.path.exists(os.path.join(exp, "log.txt"))
        logging.getLogger("multi_process_test").handlers.clear()
    return out


def spanning_meshes() -> dict:
    """``Mesh((1, 1, 2), ..., processes=[0, 1])`` (a tp group across the
    two processes) and a (pp 2) pipeline mesh with one stage a process,
    built in each process: their reprs, this process's ranks and the
    processes of its tp group."""
    from opensora_torch.parallel import distributed
    from opensora_torch.parallel.mesh import Mesh, create_pp_mesh

    tp = Mesh((1, 1, 2), [CPU, CPU], processes=[0, 1])
    pp = create_pp_mesh(2, 1, 1, [CPU])
    return dict(tp=repr(tp), tp_ranks=tp.local_ranks, tp_processes=tp.tp_processes, pp=repr(pp),
                pp_ranks=pp.local_ranks, pp_stages=pp.local_mid, process=distributed.process_index())


# ----------------------------------------------------------------------
# the Trainer's iteration
# ----------------------------------------------------------------------


def trainer_iteration(cfg_path: str, video: np.ndarray, texts: list, state_path: str) -> dict:
    """``Trainer.run_batch`` over the config's mesh across the processes
    (``train_mesh``: (data 2, 1, 1) without a ``mesh`` key), each given its
    data block's rows of ``video`` / ``texts``, from the unsharded
    trainer's saved state: the metrics, the mask conditions, and the
    masters on process 0."""
    from opensora_torch.parallel.context import set_mesh
    from opensora_torch.train import Trainer, train_mesh
    from opensora_torch.utils.config import parse_configs

    cfg = parse_configs([cfg_path])
    mesh = train_mesh(cfg, "cpu")
    trainer = Trainer(cfg, "cpu", mesh=mesh)
    trainer.state.load_state_dict(torch.load(state_path, weights_only=False))
    rows = block_rows({"video": video}, mesh)["video"]
    p, n = mesh.data_block, mesh.data_blocks
    per = len(texts) // n
    m = trainer.run_batch({"video": rows, "text": texts[p * per:(p + 1) * per]})
    sd = trainer.state.state_dict()
    set_mesh(None)
    return dict(loss=float(m["loss"]), grad_norm=float(m["grad_norm"]), mask_conds=trainer.mask_conds,
                mesh=repr(mesh), params=None if sd is None else sd["params"])


# ----------------------------------------------------------------------
# sp groups across processes
# ----------------------------------------------------------------------


def sampler_step(params, pool: dict, geom: dict, opt: dict, sizes, seed: int, wrong: bool = False,
                 batch_size: int = 4) -> dict:
    """One step over a (dp, sp, tp) mesh across the processes on the first
    batch that ``prepare_dataloader``'s sampler gives this process from the
    rows of ``pool``: the sampler's replicas those of the mesh's data blocks
    (its defaults under the mesh), or, ``wrong``, one a process
    (known-wrong: the sp ranks of one data coordinate read different
    samples). Draws from a generator seeded ``seed``. Returns the indices
    read, the metrics and the gathered masters (process 0)."""
    from opensora_torch.datasets.dataloader import prepare_dataloader
    from opensora_torch.parallel import distributed
    from opensora_torch.parallel.context import set_mesh
    from opensora_torch.parallel.mesh import MeshConfig, create_mesh
    from opensora_torch.training import diffusion as tdiff

    dp, sp, tp = sizes
    mesh = create_mesh(MeshConfig(dp, sp, tp), [CPU] * (dp * sp * tp // distributed.process_count()))
    set_mesh(mesh)
    n = len(next(iter(pool.values())))

    class Pool:
        def __len__(self):
            return n

    kw = dict(num_replicas=distributed.process_count(), rank=distributed.process_index()) if wrong else {}
    _, sampler = prepare_dataloader(Pool(), batch_size=batch_size, seed=seed, spatial_compression=16, **kw)
    index = list(sampler)[:batch_size]
    tm, state = port_state(params, geom, opt)
    state = tdiff.shard_state(mesh, state, tm, fsdp=True)
    step = tdiff.make_train_step(tm, ema_decay=0.9, text_dropout_prob=0.5, use_masked_loss=True)
    rows = {k: torch.from_numpy(np.ascontiguousarray(v[index])) for k, v in pool.items()}
    m = step(state, rows, generator=torch.Generator().manual_seed(seed))
    sd = state.state_dict()
    set_mesh(None)
    return dict(index=index, metrics=[{k: float(v) for k, v in m.items()}],
                params=None if sd is None else sd["params"])


def ring_traffic(params, batch, geom, opt, sizes, draws) -> dict:
    """``ring_rdma`` steps (one per entry of ``draws``) over a mesh whose sp
    group spans the processes (this process's ranks logical ranks on the
    CPU): the metrics, the gathered state (process 0) and the ring's
    cross-process sends (``comm.RING_REMOTE``)."""
    from opensora_torch.parallel import comm

    comm.RING_REMOTE.update(sends=0, bytes=0)
    out = sharded_steps(params, batch, geom, opt, sizes, draws=draws, n_steps=len(draws), backend="ring_rdma")
    out["ring_remote"] = dict(comm.RING_REMOTE)
    return out


# ----------------------------------------------------------------------
# the HunyuanVAE's height sharding over processes
# ----------------------------------------------------------------------


def _halo_from_own_rows(self, xs, top, bottom):
    """Known-wrong: no halo rows across the process boundary: a process's
    end strips take their own edge rows, replicated, for the neighbouring
    process's."""
    return ((xs[0][:, :, :, :1].expand(-1, -1, -1, top, -1) if self.group.first > 0 and top else None),
            (xs[-1][:, :, :, -1:].expand(-1, -1, -1, bottom, -1)
             if self.group.first + len(xs) < self.n and bottom else None))


def vae_cp_passes(state_dict: dict, cfg: dict, sp: int, x: np.ndarray, noise: np.ndarray, z: np.ndarray,
                  zt: np.ndarray, tiled: dict) -> dict:
    """The HunyuanVAE (``cfg``, fp32, weights ``state_dict``) over a (data 1,
    sp) mesh, the sp ranks split evenly over the processes: the encode of
    ``x`` with the posterior ``noise``, the decode of ``z``, the tiled
    decode of ``zt`` and encode of ``x`` (``tiled``: the config's tiling
    keys for each), and
    the encode with the cross-process halo left out; per pass, the
    ``VAE_REMOTE`` counts."""
    from opensora_torch.models.hunyuan_vae.model import AutoEncoder3DConfig, AutoencoderKLCausal3D
    from opensora_torch.parallel import distributed, vae_sharding
    from opensora_torch.parallel.mesh import MeshConfig, create_mesh

    def vae(**kw):
        ae = AutoencoderKLCausal3D(AutoEncoder3DConfig(**cfg, dtype="fp32", **kw), device="cpu",
                                   dtype=torch.float32).eval()
        ae.load_state_dict(state_dict)
        return ae

    mesh = create_mesh(MeshConfig(1, sp, 1), [CPU] * (sp // distributed.process_count()))
    x, noise, z, zt = (torch.from_numpy(a) for a in (x, noise, z, zt))
    out, counts = {}, {}

    def run(name, fn, *args, **kwargs):
        vae_sharding.reset_vae_remote()
        with torch.no_grad():
            out[name] = fn(*args, **kwargs)
        counts[name] = dict(vae_sharding.VAE_REMOTE)

    plain = vae()
    run("encode", vae_sharding.make_sharded_vae_fn(plain, mesh, "encode"), x, noise=noise)
    run("decode", vae_sharding.make_sharded_vae_fn(plain, mesh, "decode"), z)
    run("tiled_decode", vae_sharding.make_sharded_vae_fn(vae(**tiled["decode"]), mesh, "decode"), zt)
    run("tiled_encode", vae_sharding.make_sharded_vae_fn(vae(**tiled["encode"]), mesh, "encode"), x, noise=noise)
    with unittest.mock.patch.object(vae_sharding.HeightStrips, "_edges", _halo_from_own_rows):
        run("halo_left_out", vae_sharding.make_sharded_vae_fn(plain, mesh, "encode"), x, noise=noise)
    return dict(out=out, counts=counts, mesh=repr(mesh))


def vae_rows_over_processes(state_dict: dict, cfg: dict, x: np.ndarray, noise: np.ndarray, z: np.ndarray) -> dict:
    """The HunyuanVAE's sharded encode and decode over (data 2, sp 1), one
    data coordinate a process: each process computes its rows and gets the
    other's from it, so both return the whole result."""
    from opensora_torch.models.hunyuan_vae.model import AutoEncoder3DConfig, AutoencoderKLCausal3D
    from opensora_torch.parallel import distributed
    from opensora_torch.parallel.mesh import MeshConfig, create_mesh
    from opensora_torch.parallel.vae_sharding import make_sharded_vae_fn

    vae = AutoencoderKLCausal3D(AutoEncoder3DConfig(**cfg, dtype="fp32"), device="cpu", dtype=torch.float32).eval()
    vae.load_state_dict(state_dict)
    mesh = create_mesh(MeshConfig(2, 1, 1), [CPU] * (2 // distributed.process_count()))
    with torch.no_grad():
        return dict(mesh=repr(mesh), encode=make_sharded_vae_fn(vae, mesh, "encode")(
            torch.from_numpy(x), noise=torch.from_numpy(noise)), decode=make_sharded_vae_fn(vae, mesh, "decode")(
            torch.from_numpy(z)))
