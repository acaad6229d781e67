"""Training across processes (``multi_host``) on the CPU: two gloo processes
(``parallel/distributed.py``), each holding the mesh's ranks at its own
'data' coordinates, against the JAX package's sharded train step on the
same mesh and against the port's single-process step over logical ranks.
JAX's step runs at (data 2, 1, 2) only: at (data 2, 1, 1) the
single-process port is held against it by
tests/test_torch_data_parallel.py::test_sharded_train_step_matches_jax,
and the 2-process step against that port here.

The processes are started with the ``spawn`` method (this process has JAX
initialised) and run the functions of ``torch_multi_process_workers.py``
once for every case (one start-up), while this process computes the
references; each start has a time limit (``JOIN_TIMEOUT``) and fails
instead of hanging.

Tolerances: against JAX, ``TOL`` / ``UPDATE_TOL`` / ``EMA_TOL`` of
tests/test_torch_data_parallel.py (fp32, other summation orders). Against
the single-process port on the same mesh of logical ranks: the loss and the
gradient norm within 1e-6 relative (the same fp32 products, the data
ranks' gradients summed across processes in another order; the norm's
squares summed in fp64), each parameter's change within 1e-5 in relative L2
and the AdamW moments within 1e-5 of their scale. Each known-wrong variant
(a replicated leaf's gradient not summed across processes, each process
drawing its rows' noise alone, the loss not divided across processes) must
fail those limits. Checkpoints cross between the 2-process and the
unsharded state bitwise, both ways.
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

from opensora_tpu.datasets.sampler import StatefulDistributedSampler as JIndexSampler
from opensora_tpu.datasets.sampler import VariableVideoBatchSampler as JBucketSampler

from opensora_torch.parallel.context import set_mesh
from opensora_torch.training import diffusion as tdiff
from opensora_torch.utils.ckpt import CheckpointIO
from opensora_torch.utils.weights import lora_state_dict, mmdit_state_dict
from test_torch_data_parallel import (
    DEMO,
    EMA_TOL,
    GEOM,
    OPT,
    PROB,
    TOL,
    UPDATE_TOL,
    _jax_steps,
    _mesh,
    _params,
    _port_state,
    _rel_l2,
)
from test_torch_lora_sharded import RANK, SCALE, lora_inputs, port_lora_steps
from test_torch_training import _batch, _jax_draws
from torch_multi_process_workers import JOIN_TIMEOUT, Processes, free_port, pp_step, run_calls
from torch_parity_utils import one_torch_thread

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), os.pardir))
MESHES = [(2, 1, 1), (2, 1, 2)]
JAX_MESHES = [(2, 1, 2)]  # (2, 1, 1): see the module's docstring
BUCKET = 3000  # elements of a cross-process gradient sum in the bucketed GPipe case
PORT_TOL = 1e-6  # loss and gradient norm against the single-process port
PORT_UPDATE_TOL = 1e-5  # each parameter's change, relative L2
MOMENT_TOL = 1e-5  # the AdamW moments, of their scale
WRONG = ("unsummed", "local_draws", "undivided")
SEED = 5  # the generator of the variants' draws
COND_CFG = "_base_ = [{demo!r}]\ncondition_config = dict(t2v=0.1, i2v_head=0.3, i2v_tail=0.3, i2v_loop=0.3)\n"

# torch on one thread here too: the processes share the cores
_thread = pytest.fixture(autouse=True, scope="module")(one_torch_thread)


def _table(n=24, seed=0):
    rng = np.random.default_rng(seed)
    return [dict(path=f"v{i}.mp4", text=f"clip {i}", height=int(rng.choice([64, 96])),
                 width=int(rng.choice([64, 96])), num_frames=int(rng.choice([1, 5, 9])), fps=8.0)
            for i in range(n)]


BUCKETS = {"64px": {1: (1.0, 3), 5: (1.0, 2), 9: (1.0, 2)}}
# the GPipe cases: tests/test_torch_pp.py's geometry at depth 2 + 2, (pp,
# data, tp) meshes whose data rows lie one in each process, 2 microbatches
PP_GEOM = dict(in_channels=8, vec_in_dim=16, context_in_dim=24, hidden_size=64, mlp_ratio=2.0, num_heads=4,
               axes_dim=[4, 6, 6], depth=2, depth_single_blocks=2, qkv_bias=True, guidance_embed=False,
               cond_embed=False)
PP_MESHES = [(2, 2, 1), (2, 2, 2)]
SPAN_PP = (2, 1, 1)  # (pp 2, data 1): one stage a process


def _pp_inputs():
    """The GPipe cases' weights (torch's init from a seed) and batch."""
    from opensora_torch.models.mmdit.model import MMDiTConfig, MMDiTModel

    torch.manual_seed(0)
    model = MMDiTModel(MMDiTConfig(**PP_GEOM, dtype="fp32", attn_backend="xla"), device="cpu", dtype=torch.float32)
    rng = np.random.default_rng(7)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    batch = dict(x0=f(8, 32, 8), img_ids=rng.integers(0, 6, (8, 32, 3)).astype(np.float32), txt=f(8, 8, 24),
                 txt_ids=np.zeros((8, 8, 3), np.float32), y_vec=f(8, 16), shift_alpha=np.full((8,), 1.5, np.float32))
    return {k: v.detach().clone() for k, v in model.state_dict().items()}, batch


def _single_process(params, batch, sizes, draws=None, seed=None, n_steps=2):
    """The port's step over the same mesh of logical ranks in this process."""
    mesh = _mesh(*sizes)
    set_mesh(mesh)
    tm, state = _port_state(params)
    state = tdiff.shard_state(mesh, state, tm, fsdp=True)
    step = tdiff.make_train_step(tm, ema_decay=0.9, text_dropout_prob=PROB, use_masked_loss=True)
    gen = None if seed is None else torch.Generator().manual_seed(seed)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    metrics = []
    for i in range(n_steps):
        m = step(state, tb, generator=gen, draws=None if draws is None else draws[i])
        metrics.append({k: float(v) for k, v in m.items()})
    sd = state.state_dict()
    names = list(sd["params"])
    moments = {names[i]: st for i, st in sd["optimizer"]["adamw"]["state"].items()}
    set_mesh(None)
    return dict(metrics=metrics, params=sd["params"], ema=sd["ema"], moments=moments)


def _write_videos(root, n, frames=5, size=64):
    import cv2

    os.makedirs(root, exist_ok=True)
    rng = np.random.default_rng(0)
    rows = []
    for i in range(n):
        path = os.path.join(root, f"v{i}.mp4")
        w = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), 8.0, (size, size))
        base = rng.integers(0, 255, (size, size, 3), np.uint8)
        for k in range(frames):
            w.write(np.roll(base, k * 3, axis=1))
        w.release()
        rows.append(f"{path},demo video {i},{size},{size},{frames},8.0")
    csv = os.path.join(root, "meta.csv")
    with open(csv, "w") as f:
        f.write("path,text,height,width,num_frames,fps\n" + "\n".join(rows) + "\n")
    return csv


@pytest.fixture(scope="module", autouse=True)
def cli(tmp_path_factory):
    """The training CLI under torchrun on 2 gloo processes
    (:func:`test_training_cli_multi_host_under_torchrun`), started before
    the other cases so that it runs beside them; stopped, with its
    processes, at the end."""
    tmp = tmp_path_factory.mktemp("cli")
    csv = _write_videos(str(tmp / "videos"), 4)
    cfg = tmp / "cfg.py"
    cfg.write_text(f"_base_ = [{DEMO!r}]\nbucket_config = {{'64px': {{5: (1.0, 1)}}}}\n")
    out = str(tmp / "out")
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=REPO)
    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "LOCAL_WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
        env.pop(k, None)
    cmd = [sys.executable, "-m", "torch.distributed.run", "--nproc-per-node", "2", "--master-addr", "localhost",
           "--master-port", str(free_port()), "-m", "opensora_torch.train", str(cfg), "--multi_host", "True",
           "--device", "cpu", "--outputs", out, "--exp_name", "mh", "--dataset.data_path", csv,
           "--warmup_steps", "0", "--lr", "1e-3"]
    proc = subprocess.Popen(cmd, cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                            start_new_session=True)
    try:
        yield dict(proc=proc, cfg=str(cfg), out=out)
    finally:
        if proc.poll() is None:
            os.killpg(proc.pid, signal.SIGKILL)
        proc.communicate()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every 2-process case in one start of the processes, and this
    process's references computed meanwhile."""
    from opensora_torch.train import Trainer
    from opensora_torch.utils.config import parse_configs

    tmp = tmp_path_factory.mktemp("multi_process")
    params, batch = _params(), _batch(B=4)
    rng = jax.random.PRNGKey(11)
    draws = [_jax_draws(batch, rng, i, PROB) for i in range(2)]
    # an unsharded state one step on, saved: the 2-process state loads it
    tm_u, unsharded = _port_state(params)
    tdiff.make_train_step(tm_u, ema_decay=0.9, text_dropout_prob=PROB, use_masked_loss=True)(
        unsharded, {k: torch.from_numpy(v) for k, v in batch.items()}, draws=draws[0])
    ckpt_u = CheckpointIO().save(str(tmp / "unsharded"), unsharded, 0, 1, 1)
    # the Trainer's iteration: a demo config with visual conditions, its state saved
    cfg_path = tmp / "cond.py"
    cfg_path.write_text(COND_CFG.format(demo=DEMO))
    cfg = parse_configs([str(cfg_path)])
    state_path = str(tmp / "trainer_state.pt")
    torch.save(Trainer(cfg, "cpu").state.state_dict(), state_path)
    video = np.random.default_rng(3).uniform(-1, 1, (4, 3, 9, 32, 32)).astype(np.float32)
    texts = ["a red fox", "a blue lake", "a green hill", "a grey city"]

    calls = [("sharded_steps", (params, batch, GEOM, OPT, sizes), dict(draws=draws, ckpt_dir=str(tmp / f"s{i}")))
             for i, sizes in enumerate(MESHES)]
    calls += [("sharded_steps", (params, batch, GEOM, OPT, (2, 1, 1)), dict(seed=SEED, n_steps=1, variant=v))
              for v in ("right",) + WRONG]
    pp_sd, pp_batch = _pp_inputs()
    calls += [("pp_step", (pp_sd, PP_GEOM, OPT, sizes, 2, pp_batch, SEED), {}) for sizes in PP_MESHES]
    calls += [("pp_step", (pp_sd, PP_GEOM, OPT, PP_MESHES[-1], 2, pp_batch, SEED), dict(bucket=BUCKET))]
    calls += [("load_sharded", (params, GEOM, OPT, (2, 1, 2), ckpt_u), {}),
              ("data_layer", (4, _table(), BUCKETS, 7), {}),
              ("sharded_steps", (params, batch, GEOM, OPT, (1, 1, 2)), dict(seed=SEED, n_steps=1)),
              ("sharded_steps", (params, batch, GEOM, OPT, (1, 2, 1)), dict(seed=SEED, n_steps=1)),
              ("pp_step", (pp_sd, PP_GEOM, OPT, SPAN_PP, 2, pp_batch, SEED), {}),
              ("trainer_iteration", (str(cfg_path), video, texts, state_path), {})]
    l_params, l_factors, l_batch = lora_inputs()
    l_draws = [_jax_draws(l_batch, jax.random.PRNGKey(11), 0, PROB)]
    calls += [("lora_steps", (l_params, lora_state_dict(l_factors), l_batch, GEOM, OPT, (2, 1, 2), RANK, SCALE,
                              l_draws), {})]
    procs = Processes(run_calls, calls)

    ref = {sizes: dict(jax=_jax_steps(params, batch, sizes, "xla", rng) if sizes in JAX_MESHES else None,
                       port=_single_process(params, batch, sizes, draws=draws)) for sizes in MESHES}
    gen_ref = _single_process(params, batch, (2, 1, 1), seed=SEED, n_steps=1)
    span_tp_ref = _single_process(params, batch, (1, 1, 2), seed=SEED, n_steps=1)
    pp_ref = {sizes: pp_step(pp_sd, PP_GEOM, OPT, sizes, 2, pp_batch, SEED) for sizes in PP_MESHES + [SPAN_PP]}
    trainer = Trainer(cfg, "cpu", mesh=_mesh(2, 1, 1))
    trainer.state.load_state_dict(torch.load(state_path, weights_only=False))
    m = trainer.run_batch({"video": torch.from_numpy(video), "text": texts})
    trainer_ref = dict(loss=float(m["loss"]), grad_norm=float(m["grad_norm"]), mask_conds=trainer.mask_conds,
                       params=trainer.state.state_dict()["params"])
    set_mesh(None)
    l_metrics, l_state, _ = port_lora_steps(l_params, l_factors, l_batch, (2, 1, 2), l_draws)
    lora_ref = dict(metrics=l_metrics, factors=l_state.state_dict()["params"], start=lora_state_dict(l_factors))
    results = procs.results()
    names = ["mesh_" + "x".join(map(str, s)) for s in MESHES] + ["gen_right"] + [f"gen_{v}" for v in WRONG] + \
        ["pp_" + "x".join(map(str, s)) for s in PP_MESHES] + ["pp_bucketed", "load", "data", "span_tp", "span_sp",
                                                               "span_pp", "trainer", "lora"]
    return dict(by_name={n: [r[i] for r in results] for i, n in enumerate(names)}, ref=ref, gen_ref=gen_ref,
                span_tp_ref=span_tp_ref,
                pp_ref=pp_ref, pp_start=pp_sd, trainer_ref=trainer_ref, lora_ref=lora_ref, params=params,
                unsharded=unsharded, ckpt_u=ckpt_u, tmp=tmp)


def _changes(got: dict, want: dict, p0: dict) -> dict:
    """Per parameter, the relative L2 of got's change from p0 against
    want's."""
    return {n: _rel_l2(np.asarray(got[n]) - p0[n], np.asarray(want[n]) - p0[n]) for n in want}


@pytest.mark.parametrize("sizes", JAX_MESHES, ids=lambda s: "x".join(map(str, s)))
def test_two_process_fsdp_step_matches_jax(runs, sizes):
    """Two steps of the full-finetune step (masked loss, text dropout, clip,
    AdamW with weight decay, EMA) over (data 2, 1, 2) across 2 processes
    (2 logical tp ranks each), from the same weights,
    batch and draws as JAX's sharded step on the same mesh: loss, norm,
    and each parameter's and EMA's change, gathered on process 0."""
    j_metrics, j_params, j_ema = runs["ref"][sizes]["jax"]
    out = runs["by_name"]["mesh_" + "x".join(map(str, sizes))]
    assert out[1]["state"] is None and out[0]["state"] is not None  # gathered on process 0 only
    assert "in 2 processes" in out[0]["mesh"]
    for i in range(2):
        for r in out:  # every process reports the global loss and norm
            assert r["metrics"][i]["loss"] == pytest.approx(j_metrics[i]["loss"], rel=TOL)
            assert r["metrics"][i]["grad_norm"] == pytest.approx(j_metrics[i]["grad_norm"], rel=TOL)
    p0 = mmdit_state_dict(runs["params"])
    st = out[0]["state"]
    assert sorted(st["params"]) == sorted(j_params)
    assert max(_changes({n: p.numpy() for n, p in st["params"].items()}, j_params, p0).values()) <= UPDATE_TOL
    assert max(_changes({n: p.numpy() for n, p in st["ema"].items()}, j_ema, p0).values()) <= EMA_TOL


def _held(out: dict, ref: dict, p0: dict) -> dict:
    """The 2-process run against the single-process port: the worst
    relative difference of the loss and norm, of a parameter's change, of
    a moment (of its scale)."""
    st = out[0]["state"]
    metric = max(abs(r["metrics"][i][k] - ref["metrics"][i][k]) / abs(ref["metrics"][i][k])
                 for r in out for i in range(len(ref["metrics"])) for k in ("loss", "grad_norm"))
    change = max(_changes({n: p.numpy() for n, p in st["params"].items()},
                          {n: p.numpy() for n, p in ref["params"].items()}, p0).values())
    moment = max(float((st["moments"][n][k] - ref["moments"][n][k]).abs().max())
                 / (float(ref["moments"][n][k].abs().max()) or 1.0)
                 for n in ref["moments"] for k in ("exp_avg", "exp_avg_sq"))
    return dict(metric=metric, change=change, moment=moment)


def _within(d: dict) -> bool:
    return d["metric"] <= PORT_TOL and d["change"] <= PORT_UPDATE_TOL and d["moment"] <= MOMENT_TOL


@pytest.mark.parametrize("sizes", MESHES, ids=lambda s: "x".join(map(str, s)))
def test_two_process_step_matches_the_single_process_port(runs, sizes):
    """The same two steps against the port's single-process step over the
    same mesh of logical ranks; each process holds its 'data' coordinates'
    leaves only (the FSDP shards of the other process absent)."""
    out = runs["by_name"]["mesh_" + "x".join(map(str, sizes))]
    d = _held(out, runs["ref"][sizes]["port"], mmdit_state_dict(runs["params"]))
    assert _within(d), d
    total = sum(v.size for v in mmdit_state_dict(runs["params"]).values())
    assert all(r["local_leaf_numel"] < total for r in out)


def test_known_wrong_variants_fail_and_the_right_step_holds(runs):
    """One step with the draws from a generator (seed SEED), against the
    single-process port with the same generator: right within the limits;
    each known-wrong variant outside them."""
    p0, ref = mmdit_state_dict(runs["params"]), runs["gen_ref"]
    right = _held(runs["by_name"]["gen_right"], ref, p0)
    assert _within(right), right
    for v in WRONG:
        d = _held(runs["by_name"][f"gen_{v}"], ref, p0)
        assert not _within(d), (v, d)
        assert d["metric"] > 100 * PORT_TOL or d["change"] > 100 * PORT_UPDATE_TOL, (v, d)


@pytest.mark.parametrize("sizes", PP_MESHES, ids=lambda s: "x".join(map(str, s)))
def test_two_process_pipeline_step_matches_one_process(runs, sizes):
    """GPipe over (pp 2, data 2) and (pp 2, data 2, tp 2) with each data
    row's pipeline in a process of its own (its rows microbatched over its
    data rank, the draws the global batch's from one generator, every
    gradient summed across the processes) against the same mesh in one
    process: the loss and norm (1e-6), each parameter's change (1e-5)."""
    out, ref = runs["by_name"]["pp_" + "x".join(map(str, sizes))], runs["pp_ref"][sizes]
    assert "in 2 processes" in out[0]["mesh"] and out[1]["state"] is None
    for r in out:
        for k in ("loss", "grad_norm"):
            assert r["metrics"][0][k] == pytest.approx(ref["metrics"][0][k], rel=PORT_TOL), k
    p0 = {n: v.numpy() for n, v in runs["pp_start"].items()}
    got = {n: p.numpy() for n, p in out[0]["state"]["params"].items()}
    want = {n: p.numpy() for n, p in ref["state"]["params"].items()}
    assert max(_changes(got, want, p0).values()) <= PORT_UPDATE_TOL


def test_cross_process_gradient_sum_runs_in_buckets_per_stage_and_tp_rank(runs):
    """The GPipe step over (pp 2, data 2, tp 2) with the cross-process
    gradient sum cut into buckets of at most BUCKET elements: one call of
    ``_buckets`` for each (stage, tp index), whose leaves lie on one
    device; every bucket of several leaves within the limit and at least
    one leaf larger than it alone; the state and metrics bitwise those of
    the step with the default bucket."""
    out, whole = runs["by_name"]["pp_bucketed"], runs["by_name"]["pp_2x2x2"]
    for r, w in zip(out, whole):
        assert r["metrics"] == w["metrics"]
        assert len(r["buckets"]) == 2 * 2, r["buckets"]  # pp x tp
        runs_ = [run for call in r["buckets"] for run in call]
        assert all(sum(run) <= BUCKET for run in runs_ if len(run) > 1)
        assert any(len(run) == 1 and run[0] > BUCKET for run in runs_) and len(runs_) > 2 * 2 * 2
    for n, p in whole[0]["state"]["params"].items():
        assert torch.equal(out[0]["state"]["params"][n], p), n


def test_checkpoint_crosses_between_processes_and_one_state(runs):
    """The 2-process state's checkpoint (written by process 0) loads
    bitwise into an unsharded state; an unsharded state's checkpoint
    loads into the 2-process state, whose gathered state equals it
    bitwise (parameters, EMA, moments, counts)."""
    out = runs["by_name"]["mesh_2x1x2"]
    ckpt = out[0]["ckpt"]
    assert out[1]["ckpt"] == ckpt and sorted(os.listdir(ckpt)) == ["running_states.json", "state.pt"]
    _, fresh = _port_state(_params(seed=12))
    CheckpointIO().load(ckpt, fresh)
    st = out[0]["state"]
    for n, p in fresh.params.items():
        assert torch.equal(p.detach(), st["params"][n]) and torch.equal(fresh.ema[n], st["ema"][n]), n
    moments = fresh.optimizer.adamw.state_dict()["state"]
    for i, n in enumerate(fresh.params):
        assert torch.equal(moments[i]["exp_avg"], st["moments"][n]["exp_avg"]), n

    loaded = runs["by_name"]["load"]
    assert loaded[1]["state"] is None and loaded[0]["running"] == {"epoch": 0, "step": 1, "global_step": 1}
    want, got = runs["unsharded"].state_dict(), loaded[0]["state"]
    assert got["step"] == want["step"] == 1 and all(r["count"] == 1 for r in loaded)
    names = list(want["params"])
    for n in names:
        assert torch.equal(got["params"][n], want["params"][n]) and torch.equal(got["ema"][n], want["ema"][n]), n
    for i, stt in want["optimizer"]["adamw"]["state"].items():
        for k in ("exp_avg", "exp_avg_sq"):
            assert torch.equal(got["moments"][names[i]][k], stt[k]), (names[i], k)


def test_make_global_batch_from_local_rows(runs):
    """Each process gives its 4 rows: the global batch is 8 rows, process
    p's ranks hold the pieces of its rows (tokens on 'sp'), the other
    process's are None, and ``full`` gathers the global tensor on both. A
    global batch that does not divide over 'data' raises with JAX's
    message (the global count in it), and so do batches that differ in
    shape between the processes."""
    out = runs["by_name"]["data"]
    x = [torch.arange(4 * 6 * 3, dtype=torch.float32).reshape(4, 6, 3) + 1000 * p for p in range(2)]
    full = torch.cat(x)
    for p, r in enumerate(out):
        assert r["shape"] == (8, 6, 3) and r["spec"] == ("data", "sp", None)
        assert [s is None for s in r["shards"]] == [q != p for q in range(2) for _ in range(4)]
        for rank in range(4 * p, 4 * p + 4):
            d, s = divmod(rank, 2)
            assert torch.equal(r["shards"][rank], full[2 * d:2 * d + 2, 3 * s:3 * s + 3])
        for d, rows in r["rows"].items():
            assert torch.equal(rows, full[2 * d:2 * d + 2])
        assert torch.equal(r["full"], full) and torch.equal(r["full_y"], full[:, 0])
        assert re.search(r"global batch 6 \(key 'x0'\) not divisible by the mesh 'data' axis \(4\)", r["error"])
        assert "differ in shape" in r["shape_error"]


def test_sampler_reads_each_process_part_as_jax(runs):
    """``prepare_dataloader`` with its defaults takes the process group's
    size and rank: each process's indices equal JAX's samplers' at
    num_replicas=2, rank=r (the index sampler and the bucket sampler), and
    the processes read disjoint parts of the epoch (24 rows: no padding
    repeats one)."""
    import pandas as pd

    out = runs["by_name"]["data"]
    table = _table()

    class JData:
        data = pd.DataFrame(table)

        def __len__(self):
            return len(table)

    for r, res in enumerate(out):
        assert res["replicas"] == (2, r, 2, r)
        js = JIndexSampler(len(table), num_replicas=2, rank=r, seed=7)
        assert res["index_sampler"] == list(js)
        jb = JBucketSampler(JData(), BUCKETS, num_replicas=2, rank=r, seed=7)
        jb.set_epoch(1)
        assert res["bucket_sampler"] == list(jb) and len(res["bucket_sampler"]) > 2
    assert not set(out[0]["index_sampler"]) & set(out[1]["index_sampler"])


def test_only_process_0_logs(runs):
    """Process 0's logger writes stdout and log.txt; process 1's holds a
    NullHandler and writes nothing."""
    p0, p1 = runs["by_name"]["data"]
    assert p0["handlers"] == ["StreamHandler", "FileHandler"] and p0["log_exists"]
    assert p1["handlers"] == ["NullHandler"] and not p1["log_exists"]


def test_a_group_other_than_data_across_processes_raises(runs):
    """A mesh whose tp group, a pipeline whose stages, or an sp group spans
    the two processes builds its mesh and takes the step (one rank, or one
    stage, a process): the tp group's step against the single-process
    port's over (1, 1, 2) and the pipeline's against the single-process
    pipeline's over (pp 2, data 1) on the same global batch and draws (the
    loss and norm within 1e-6, each parameter's change within 1e-5); the sp
    group's loss and norm those of the single-process port's step over
    (data 2, 1, 1) (tests/test_torch_tp_pp_processes.py holds these
    layouts against JAX)."""
    p0 = mmdit_state_dict(runs["params"])
    out = runs["by_name"]["span_tp"]
    assert all("in 2 processes" in r["mesh"] for r in out)
    d = _held(out, runs["span_tp_ref"], p0)
    assert _within(d), d
    out, ref = runs["by_name"]["span_pp"], runs["pp_ref"][SPAN_PP]
    assert "'pp': 2" in out[0]["mesh"] and "in 2 processes" in out[0]["mesh"] and out[1]["state"] is None
    for r in out:
        for k in ("loss", "grad_norm"):
            assert r["metrics"][0][k] == pytest.approx(ref["metrics"][0][k], rel=PORT_TOL), k
    start = {n: v.numpy() for n, v in runs["pp_start"].items()}
    got = {n: p.numpy() for n, p in out[0]["state"]["params"].items()}
    want = {n: p.numpy() for n, p in ref["state"]["params"].items()}
    assert max(_changes(got, want, start).values()) <= PORT_UPDATE_TOL
    out, ref = runs["by_name"]["span_sp"], runs["gen_ref"]["metrics"][0]
    for r in out:
        assert "in 2 processes" in r["mesh"]
        for k in ("loss", "grad_norm"):
            assert r["metrics"][0][k] == pytest.approx(ref[k], rel=PORT_UPDATE_TOL), k


def test_trainer_iteration_across_processes_equals_one_process(runs):
    """``Trainer.run_batch`` over (data 2, 1, 1) across 2 processes, each
    encoding its 2 clips: the posterior noise, the visual conditions (with
    their single-frame encodes) and the step's draws are the global
    batch's, cut to the process's rows, so the iteration equals the
    single-process trainer's on the same 4 clips and mesh: the mask
    conditions, the loss and norm (1e-6), each master's change (1e-5)."""
    out, ref = runs["by_name"]["trainer"], runs["trainer_ref"]
    assert "in 2 processes" in out[0]["mesh"] and out[1]["params"] is None
    assert any(mc != "t2v" for mc in ref["mask_conds"])
    for r in out:
        assert r["mask_conds"] == ref["mask_conds"]
        assert r["loss"] == pytest.approx(ref["loss"], rel=PORT_TOL)
        assert r["grad_norm"] == pytest.approx(ref["grad_norm"], rel=PORT_TOL)
    state = torch.load(os.path.join(runs["tmp"], "trainer_state.pt"), weights_only=False)["params"]
    for n, p in ref["params"].items():
        assert _rel_l2(out[0]["params"][n].numpy() - state[n].numpy(), p.numpy() - state[n].numpy()) <= \
            PORT_UPDATE_TOL, n


def test_two_process_lora_step_matches_the_single_process_port(runs):
    """One LoRA step over (data 2, 1, 2) across 2 processes (the frozen
    base FSDP-cut over the processes and TP-cut, the factors replicated in
    both): the loss and norm on every process (1e-6) and each factor's
    change (1e-5) against the port's single-process step over the same mesh
    of logical ranks; the base's FSDP gathers cross the processes, and no
    reduce-scatter runs (the frozen base takes no gradient), no EMA."""
    out, ref = runs["by_name"]["lora"], runs["lora_ref"]
    assert out[1]["factors"] is None and out[0]["ema"] is None
    for r in out:
        assert r["gathers"] > 0 and r["reduce_scatters"] == 0, r
        for k in ("loss", "grad_norm"):
            assert r["metrics"][0][k] == pytest.approx(ref["metrics"][0][k], rel=PORT_TOL), k
    got = {n: p.numpy() for n, p in out[0]["factors"].items()}
    want = {n: p.numpy() for n, p in ref["factors"].items()}
    assert sorted(got) == sorted(ref["start"]) and max(_changes(got, want, ref["start"]).values()) <= PORT_UPDATE_TOL


def test_training_cli_multi_host_under_torchrun(cli):
    """``python -m torch.distributed.run --nproc-per-node 2 -m
    opensora_torch.train <demo> --multi_host True --device cpu``: 4 clips
    in a 1-clip bucket, so 2 steps of a global batch of 2; both processes
    exit 0, one log.txt (process 0's) logs both steps and the disjoint
    samples each process read, process 0 writes the checkpoint, which
    loads into a single-process Trainer and equals its file."""
    from opensora_torch.train import Trainer
    from opensora_torch.utils.config import parse_configs

    try:
        stdout, stderr = cli["proc"].communicate(timeout=JOIN_TIMEOUT)
    except subprocess.TimeoutExpired:
        raise AssertionError(f"the CLI still ran after {JOIN_TIMEOUT} s") from None
    assert cli["proc"].returncode == 0, stdout[-3000:] + stderr[-3000:]
    exp = os.path.join(cli["out"], "mh")
    with open(os.path.join(exp, "log.txt")) as f:
        log = f.read()
    assert len(re.findall(r" loss (-?\d+\.\d+)", log)) == 2, log
    assert log.count("experiment dir") == 1  # one writer
    read = [eval(m) for m in re.findall(r"samples by process (\[.*\])", log)]
    assert len(read) == 2 and all(len(r) == 2 and not set(r[0]) & set(r[1]) for r in read), read
    assert sorted(i for r in read for p in r for i in p) == [0, 1, 2, 3]
    ckpt = os.path.join(exp, "epoch0-global_step2")
    assert sorted(os.listdir(ckpt)) == ["running_states.json", "state.pt"]
    saved = torch.load(os.path.join(ckpt, "state.pt"), weights_only=False)
    trainer = Trainer(parse_configs([cli["cfg"]]), "cpu")
    CheckpointIO().load(ckpt, trainer.state)
    again = copy.deepcopy(trainer.state.state_dict())
    assert again["step"] == saved["step"] == 2
    for n, p in saved["params"].items():
        assert torch.equal(again["params"][n], p) and torch.equal(again["ema"][n], saved["ema"][n]), n
