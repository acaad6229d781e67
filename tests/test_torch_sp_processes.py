"""Sequence parallelism across processes on the CPU: a mesh whose 'sp' group
(and 'data' axis) spans gloo processes (``parallel/mesh.py``), each process
holding the ranks at its own (data, sp) coordinates and computing only
their token chunks, against the JAX package's sharded train step on the
same mesh of virtual CPU devices and against the port's single-process
step over the same mesh of logical ranks.

Geometry: tests/test_torch_data_parallel.py's tiny MMDiT (4 heads of 16)
on tests/test_torch_training.py's batch (8 text + 12 image tokens, 5 a
rank at sp 4), fp32, remat on. The processes are started once per world
size (4: one sp rank each; 2: two logical sp ranks each, the mixed ring),
with the ``spawn`` method, running the functions of
``torch_multi_process_workers.py`` while this process computes the
references; every start has a time limit and fails instead of hanging.
The training CLI runs under torchrun beside them.

Tolerances: against JAX, ``TOL`` / ``UPDATE_TOL`` / ``EMA_TOL`` of
tests/test_torch_data_parallel.py (fp32, other summation orders); against
the single-process port, ``STEP_TOL`` / ``UPDATE_TOL`` of
tests/test_torch_sp_blocks.py (the sp ranks' weight gradients summed
across processes in another order). Every known-wrong variant (replica
gradients not summed across the sp group's processes, the ring's
cross-process KV hop skipped, the FSDP gather over every process instead
of the 'data' group, the sampler read by process index) fails those
limits. Checkpoints cross between the processes and one process bitwise.
"""

import copy
import os
import re
import signal
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from opensora_torch.datasets.sampler import StatefulDistributedSampler
from opensora_torch.parallel.context import set_mesh
from opensora_torch.training import diffusion as tdiff
from opensora_torch.utils.ckpt import CheckpointIO
from opensora_torch.utils.weights import mmdit_state_dict
from test_torch_data_parallel import DEMO, EMA_TOL, GEOM, OPT, PROB, TOL, _jax_steps, _mesh, _params, _port_state, \
    _rel_l2
from test_torch_multi_process import _write_videos
from test_torch_sp_blocks import STEP_TOL, UPDATE_TOL
from test_torch_training import _batch, _jax_draws
from torch_multi_process_workers import JOIN_TIMEOUT, Processes, free_port, run_calls
from torch_parity_utils import one_torch_thread

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), os.pardir))
SP4 = (1, 4, 1)
FSDP = (2, 2, 1)
BACKENDS = [None, "ulysses", "ring", "ring_rdma"]
WRONG = ["unsummed", "kv_skipped", "world_gather", "sampler"]
SEED = 5  # the sampler's and its step's generator
POOL = 16  # rows the sampler reads from
# the mixed ring's cross-process sends per process and step: 2 blocks,
# forward and recompute 3 KV hops each, the backward 3 KV + 4 dK/dV hops
# each; each slot (2, B 4, H 4, 5 tokens, D 16) fp32
MIXED_SENDS = 2 * (2 * 3) + 2 * (3 + 4)
SLOT_BYTES = 2 * 4 * 4 * 5 * 16 * 4
CLI_CFG = "_base_ = [{demo!r}]\nbucket_config = {{'64px': {{5: (1.0, 1)}}}}\nmesh = dict(dp_size=1, sp_size=2)\n"

_thread = pytest.fixture(autouse=True, scope="module")(one_torch_thread)


@pytest.fixture(scope="module", autouse=True)
def cli(tmp_path_factory):
    """The training CLI under torchrun on 2 gloo processes over stage2's
    layout cut to (data 1, sp 2) (:func:`test_training_cli_sp_across_processes`),
    started first so that it runs beside the other cases."""
    tmp = tmp_path_factory.mktemp("cli")
    csv = _write_videos(str(tmp / "videos"), 2)
    cfg = tmp / "cfg.py"
    cfg.write_text(CLI_CFG.format(demo=DEMO))
    out = str(tmp / "out")
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=REPO)
    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "LOCAL_WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
        env.pop(k, None)
    cmd = [sys.executable, "-m", "torch.distributed.run", "--nproc-per-node", "2", "--master-addr", "localhost",
           "--master-port", str(free_port()), "-m", "opensora_torch.train", str(cfg), "--multi_host", "True",
           "--device", "cpu", "--outputs", out, "--exp_name", "sp", "--dataset.data_path", csv,
           "--warmup_steps", "0", "--lr", "1e-3"]
    proc = subprocess.Popen(cmd, cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                            start_new_session=True)
    try:
        yield dict(proc=proc, cfg=str(cfg), out=out)
    finally:
        if proc.poll() is None:
            os.killpg(proc.pid, signal.SIGKILL)
        proc.communicate()


def _one_process(params, batch, sizes, backend=None, draws=None, seed=None, n_steps=2) -> dict:
    """The port's step over the same mesh of logical ranks in this process."""
    mesh = _mesh(*sizes)
    set_mesh(mesh)
    tm, state = _port_state(params, backend)
    state = tdiff.shard_state(mesh, state, tm, fsdp=True)
    step = tdiff.make_train_step(tm, ema_decay=0.9, text_dropout_prob=PROB, use_masked_loss=True)
    gen = None if seed is None else torch.Generator().manual_seed(seed)
    tb = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in batch.items()}
    metrics = [{k: float(v) for k, v in step(state, tb, generator=gen,
                                             draws=None if draws is None else draws[i]).items()}
               for i in range(n_steps)]
    sd = state.state_dict()
    set_mesh(None)
    return dict(metrics=metrics, params=sd["params"], ema=sd["ema"])


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every case in one start of 4 processes and one of 2, and this
    process's references computed meanwhile."""
    tmp = tmp_path_factory.mktemp("sp_processes")
    params, batch = _params(), _batch(B=4)
    rng = jax.random.PRNGKey(11)
    draws = [_jax_draws(batch, rng, i, PROB) for i in range(2)]
    pool = _batch(B=POOL, seed=9)
    # an unsharded state one step on, saved: the 4-process state loads it
    tm_u, unsharded = _port_state(params)
    tdiff.make_train_step(tm_u, ema_decay=0.9, text_dropout_prob=PROB, use_masked_loss=True)(
        unsharded, {k: torch.from_numpy(v) for k, v in batch.items()}, draws=draws[0])
    ckpt_u = CheckpointIO().save(str(tmp / "unsharded"), unsharded, 0, 1, 1)

    steps = ("sharded_steps", (params, batch, GEOM, OPT))
    four = [(steps[0], steps[1] + (SP4,), dict(draws=draws, backend=b)) for b in BACKENDS]
    four += [(steps[0], steps[1] + (FSDP,), dict(draws=draws, backend=None, ckpt_dir=str(tmp / "fsdp")))]
    four += [(steps[0], steps[1] + (SP4,), dict(draws=draws[:1], n_steps=1, variant="unsummed", backend=None)),
             (steps[0], steps[1] + (SP4,), dict(draws=draws[:1], n_steps=1, variant="kv_skipped",
                                                backend="ring_rdma")),
             (steps[0], steps[1] + (FSDP,), dict(draws=draws[:1], n_steps=1, variant="world_gather", backend=None))]
    four += [("sampler_step", (params, pool, GEOM, OPT, SP4, SEED), dict(wrong=w)) for w in (False, True)]
    four += [("load_sharded", (params, GEOM, OPT, SP4, ckpt_u), {})]
    procs4 = Processes(run_calls, four, world=4)
    procs2 = Processes(run_calls, [("ring_traffic", (params, batch, GEOM, OPT, SP4, draws), {})], world=2)

    jax_ref = {sizes: _jax_steps(params, batch, sizes, "xla", rng) for sizes in (SP4, FSDP)}
    port = {b: _one_process(params, batch, SP4, b, draws) for b in BACKENDS}
    port[FSDP] = _one_process(params, batch, FSDP, None, draws)
    port["one_step"] = _one_process(params, batch, SP4, None, draws[:1], n_steps=1)
    index = list(StatefulDistributedSampler(POOL, num_replicas=1, rank=0, shuffle=True, seed=SEED))[:4]
    port["sampler"] = _one_process(params, {k: v[index] for k, v in pool.items()}, SP4, seed=SEED, n_steps=1)
    port["sampler"]["index"] = index

    r4, r2 = procs4.results(), procs2.results()
    names = [f"sp4_{b}" for b in BACKENDS] + ["fsdp", "unsummed", "kv_skipped", "world_gather", "sampler_right",
                                             "sampler", "load"]
    by_name = {n: [r[i] for r in r4] for i, n in enumerate(names)}
    by_name["mixed"] = [r[0] for r in r2]
    return dict(by_name=by_name, jax=jax_ref, port=port, params=params, unsharded=unsharded)


def _held(out: list, ref: dict, p0: dict, loss_tol: float, update_tol: float) -> dict:
    """Every process's run against a reference: the worst relative
    difference of the loss and norm, and of a master's change (process 0's
    gathered state)."""
    if "error" in out[0]:
        return dict(error=out[0]["error"], within=False)
    n = len(out[0]["metrics"])
    metric = max(abs(r["metrics"][i][k] - ref["metrics"][i][k]) / abs(ref["metrics"][i][k])
                 for r in out for i in range(n) for k in ("loss", "grad_norm"))
    got = out[0]["state"]["params"] if "state" in out[0] else out[0]["params"]
    change = max(_rel_l2(got[k].numpy() - p0[k], np.asarray(ref["params"][k]) - p0[k]) for k in ref["params"])
    return dict(metric=metric, change=change, within=metric <= loss_tol and change <= update_tol)


def _vs_jax(out: list, ref, p0: dict) -> dict:
    metrics, params, ema = ref
    d = _held(out, dict(metrics=metrics, params=params), p0, TOL, UPDATE_TOL)
    st = out[0]["state"]
    d["ema"] = max(_rel_l2(st["ema"][k].numpy() - p0[k], ema[k] - p0[k]) for k in ema)
    d["within"] = d["within"] and d["ema"] <= EMA_TOL
    return d


def _vs_port(out: list, ref: dict, p0: dict) -> dict:
    return _held(out, dict(metrics=ref["metrics"], params={k: v.numpy() for k, v in ref["params"].items()}), p0,
                 STEP_TOL, UPDATE_TOL)


@pytest.mark.parametrize("backend", BACKENDS, ids=str)
def test_four_processes_one_sp_rank_each(runs, backend):
    """Two steps over stage2's (1, 4, 1) with one sp rank in each of 4
    processes, each computing its chunk only: the loss and norm on every
    process, and every master's and EMA's change, against JAX's sharded
    step on 4 virtual devices (its attention gathered by GSPMD) and against
    the port over 4 logical ranks in one process with the same backend."""
    out = runs["by_name"][f"sp4_{backend}"]
    assert "in 4 processes" in out[0]["mesh"] and all(r["state"] is None for r in out[1:])
    p0 = mmdit_state_dict(runs["params"])
    d = _vs_jax(out, runs["jax"][SP4], p0)
    assert d["within"], d
    d = _vs_port(out, runs["port"][backend], p0)
    assert d["within"], d


def test_mixed_ring_two_processes_two_logical_ranks_each(runs):
    """``ring_rdma`` over (1, 4, 1) with ranks 0-1 in process 0 and 2-3 in
    process 1 (logical ranks on each process's CPU): both the in-process hop
    (0 -> 1, 2 -> 3) and the cross-process one (1 -> 2, 3 -> 0); two steps
    against JAX and the single-process ring, and exactly the sends the ring
    makes across the processes (``comm.RING_REMOTE``)."""
    out = runs["by_name"]["mixed"]
    assert "in 2 processes" in out[0]["mesh"]
    p0 = mmdit_state_dict(runs["params"])
    d = _vs_jax(out, runs["jax"][SP4], p0)
    assert d["within"], d
    d = _vs_port(out, runs["port"]["ring_rdma"], p0)
    assert d["within"], d
    for r in out:
        assert r["ring_remote"] == dict(sends=2 * MIXED_SENDS, bytes=2 * MIXED_SENDS * SLOT_BYTES), r["ring_remote"]


def test_fsdp_over_data_and_sp_across_processes(runs):
    """(2, 2, 1) with FSDP over 4 processes, one rank each: 'data' and 'sp'
    both cross the processes (the FSDP gather over the rank's 'data' group,
    the replicas summed over the sp group's processes); two steps against
    JAX's and the single-process port's."""
    out = runs["by_name"]["fsdp"]
    p0 = mmdit_state_dict(runs["params"])
    d = _vs_jax(out, runs["jax"][FSDP], p0)
    assert d["within"], d
    d = _vs_port(out, runs["port"][FSDP], p0)
    assert d["within"], d


@pytest.mark.parametrize("variant", WRONG)
def test_known_wrong_variants_fail(runs, variant):
    """Each known-wrong variant lies outside the limits against the
    single-process port (the FSDP gather over every process joins a weight
    twice its size and raises)."""
    p0 = mmdit_state_dict(runs["params"])
    out = runs["by_name"][variant]
    ref = runs["port"]["sampler" if variant == "sampler" else "one_step"]
    d = _vs_port(out, ref, p0)
    assert not d["within"], d
    if variant == "world_gather":
        assert "size" in d["error"] or "shape" in d["error"], d
    if variant == "sampler":
        assert len({tuple(r["index"]) for r in out}) == 4


def test_the_processes_of_one_data_coordinate_read_the_same_samples(runs):
    """``prepare_dataloader`` under a mesh whose sp group spans the
    processes: its sampler's replicas are the data blocks (here one), so
    every process reads the same indices, those of a single process, and
    the step on them equals the single-process step."""
    out, ref = runs["by_name"]["sampler_right"], runs["port"]["sampler"]
    assert all(r["index"] == ref["index"] for r in out)
    d = _vs_port(out, ref, mmdit_state_dict(runs["params"]))
    assert d["within"], d


def test_checkpoint_round_trip_with_one_process(runs, tmp_path):
    """The (2, 2, 1) 4-process state's checkpoint (written by process 0
    alone) loads bitwise into an unsharded state; an unsharded state's
    checkpoint loads into the (1, 4, 1) 4-process state, gathered equal
    bitwise."""
    out = runs["by_name"]["fsdp"]
    ckpt = out[0]["ckpt"]
    assert all(r["ckpt"] == ckpt for r in out) and sorted(os.listdir(ckpt)) == ["running_states.json", "state.pt"]
    _, fresh = _port_state(_params(seed=12))
    CheckpointIO().load(ckpt, fresh)
    st = out[0]["state"]
    for n, p in fresh.params.items():
        assert torch.equal(p.detach(), st["params"][n]) and torch.equal(fresh.ema[n], st["ema"][n]), n
    loaded = runs["by_name"]["load"]
    assert all(r["state"] is None for r in loaded[1:])
    want, got = runs["unsharded"].state_dict(), loaded[0]["state"]
    assert got["step"] == want["step"] == 1
    for n in want["params"]:
        assert torch.equal(got["params"][n], want["params"][n]) and torch.equal(got["ema"][n], want["ema"][n]), n


def test_training_cli_sp_across_processes(cli):
    """``python -m torch.distributed.run --nproc-per-node 2 -m
    opensora_torch.train <demo, mesh dp 1 sp 2> --multi_host True --device
    cpu``: both processes exit 0, read the same clips, one log.txt
    (process 0's) logs the 2 steps, and the checkpoint loads into a
    single-process Trainer equal to its file."""
    from opensora_torch.train import Trainer
    from opensora_torch.utils.config import parse_configs

    try:
        stdout, stderr = cli["proc"].communicate(timeout=JOIN_TIMEOUT)
    except subprocess.TimeoutExpired:
        raise AssertionError(f"the CLI still ran after {JOIN_TIMEOUT} s") from None
    assert cli["proc"].returncode == 0, stdout[-3000:] + stderr[-3000:]
    exp = os.path.join(cli["out"], "sp")
    with open(os.path.join(exp, "log.txt")) as f:
        log = f.read()
    assert len(re.findall(r" loss (-?\d+\.\d+)", log)) == 2, log
    assert log.count("experiment dir") == 1 and "in 2 processes" in log
    read = [eval(m) for m in re.findall(r"samples by process (\[.*\])", log)]
    assert len(read) == 2 and all(r[0] == r[1] for r in read), read
    ckpt = os.path.join(exp, "epoch0-global_step2")
    saved = torch.load(os.path.join(ckpt, "state.pt"), weights_only=False)
    trainer = Trainer(parse_configs([cli["cfg"]]), "cpu")
    CheckpointIO().load(ckpt, trainer.state)
    again = copy.deepcopy(trainer.state.state_dict())
    assert again["step"] == saved["step"] == 2
    for n, p in saved["params"].items():
        assert torch.equal(again["params"][n], p) and torch.equal(again["ema"][n], saved["ema"][n]), n


def test_jax_reader_gives_the_sp_ranks_of_one_data_coordinate_different_samples(runs, monkeypatch):
    """ROADMAP Queue 3's R12 (a fault of the JAX package, which is not
    edited): its reader takes one part of the epoch a process
    (opensora_tpu/datasets/dataloader.py:105-108), and
    ``make_array_from_process_local_data`` builds each host's shards from
    its own rows (opensora_tpu/parallel/data.py:59-68), so over a mesh whose
    sp group spans 4 processes of one data coordinate, each process's sp
    rank reads other samples than the others: the processes' first batches
    are disjoint. The port's processes, over the same mesh, read one batch
    (the case above)."""
    from opensora_tpu.datasets import dataloader as jloader

    class Pool:
        def __len__(self):
            return POOL

    first = []
    for r in range(4):
        monkeypatch.setattr(jax, "process_count", lambda: 4)
        monkeypatch.setattr(jax, "process_index", lambda r=r: r)
        _, sampler = jloader.prepare_dataloader(Pool(), batch_size=4, seed=SEED, num_workers=0)
        first.append(list(sampler)[:4])
    assert all(not set(first[a]) & set(first[b]) for a in range(4) for b in range(a + 1, 4)), first
    assert len({tuple(r["index"]) for r in runs["by_name"]["sampler_right"]}) == 1
