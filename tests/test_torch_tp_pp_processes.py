"""Tp groups and pipeline stages across processes on the CPU: a mesh whose
'tp' group, or a pipeline whose stages, span gloo processes
(``parallel/mesh.py``), one rank or one stage a process, against the JAX
package's sharded train step and GPipe forward on the same mesh of virtual
CPU devices and against the port's single-process step over the same mesh
of logical ranks.

Geometry: tests/test_torch_data_parallel.py's tiny MMDiT (4 heads of 16,
depth 1 + 1) on tests/test_torch_training.py's batch for the tp cases;
tests/test_torch_pp.py's (depth 4 + 8, hidden 64, 8 rows of 32 + 8 tokens)
for the pipeline, 2 microbatches. The processes are started once per world
size (2 and 4) with the ``spawn`` method, running the functions of
``torch_multi_process_workers.py`` while this process computes the
references; every start has a time limit and fails instead of hanging.
The training CLI runs under torchrun beside them, once with
``--mesh.tp_size 2`` and once with ``--pipeline.pp_size 2``.

Tolerances: against JAX, ``TOL`` / ``UPDATE_TOL`` / ``EMA_TOL`` of
tests/test_torch_data_parallel.py for the step (fp32, other summation
orders) and tests/test_torch_pp.py's atol 1e-4 for the GPipe forward;
against the single-process port, the loss and norm within ``PORT_TOL``
(1e-6) relative, each parameter's change within ``PORT_UPDATE_TOL`` (1e-5)
in relative L2 and the AdamW moments within 1e-5 of their scale
(tests/test_torch_multi_process.py's limits). Each known-wrong variant
(the tp group's cross-process sum left out of the backward, the row bias
added on each process, a stage's received activation sending back no
gradient) fails those limits by more than 100 times. The cross-process
traffic is exact: the tp all-reduces (forward, the remat recompute and the
backward of each row-parallel product) and the pipeline's sends.
"""

import os
import re
import signal
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opensora_tpu.models.mmdit.model import MMDiTConfig as JConfig
from opensora_tpu.models.mmdit.model import MMDiTModel as JModel
from opensora_tpu.training import pp as jpp

from opensora_torch.utils.ckpt import CheckpointIO
from opensora_torch.utils.weights import lora_state_dict, mmdit_state_dict
from test_torch_data_parallel import DEMO, EMA_TOL, GEOM, OPT, PROB, TOL, UPDATE_TOL, _jax_steps, _mesh, _params, \
    _rel_l2
from test_torch_lora_sharded import RANK, SCALE, lora_inputs, port_lora_steps
from test_torch_multi_process import COND_CFG, PORT_TOL, PORT_UPDATE_TOL, _changes, _held, _single_process, \
    _within, _write_videos
from test_torch_pp import GEOM as PP_GEOM
from test_torch_pp import _batch as pp_batch
from test_torch_pp import _model_inputs
from test_torch_training import _batch, _jax_draws
from torch_multi_process_workers import JOIN_TIMEOUT, Processes, free_port, pp_step, run_calls
from torch_parity_utils import one_torch_thread, randomize, to_numpy

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), os.pardir))
STAGE1 = os.path.join(REPO, "configs", "diffusion", "train", "stage1.py")
# (data, sp, tp) over a world of processes, one rank each; (1, 2, 2) puts
# the sp and the tp group across processes at once
TP_MESHES = [((1, 1, 2), 2), ((2, 1, 2), 4), ((1, 2, 2), 4)]
JAX_TP = [(1, 1, 2), (2, 1, 2)]
# (pp, data, tp) over a world of processes, one stage (and tp rank) each
PP_MESHES = [((2, 1, 1), 2), ((2, 1, 2), 4)]
N_MICRO = 2
SEED = 5  # the generator of the controls' and the pipeline's draws
TP_WRONG = ("tp_grad_local", "tp_bias_each_process")
FWD_ATOL = 1e-4  # tests/test_torch_pp.py's forward against JAX
CLI_CFG = """_base_ = [{stage1!r}]
model = dict(_delete_=True, type="flux", in_channels=16, vec_in_dim=32, context_in_dim=64, hidden_size=64,
             mlp_ratio=2.0, num_heads=2, depth=2, depth_single_blocks=2, axes_dim=[8, 12, 12], qkv_bias=True,
             guidance_embed=False, cond_embed=True, remat=True, attn_backend="xla", dtype="fp32")
ae = dict(_delete_=True, type="hunyuan_vae", block_out_channels=[8, 8, 8, 8], latent_channels=4, norm_num_groups=4,
          layers_per_block=1, dtype="fp32")
t5 = dict(_delete_=True, type="text_embedder", from_pretrained="", max_length=16, _tiny=True)
clip = dict(_delete_=True, type="text_embedder", from_pretrained="clip-tiny", max_length=16, _tiny=True)
bucket_config = {{"_delete_": True, "64px": {{5: (1.0, 2)}}}}
warmup_steps = 0
epochs = 1
log_every = 1
"""
# the Trainer case's AdamW eps: at the demo's 1e-8 the first step's update
# g / (|g| + eps) turns the tp sums' other order (a relative 1e-7 in a
# gradient element near 1e-8) into 2e-4 of a master's change
BLOCK_ADAM_EPS = 1e-3
CLI_RUNS = {"tp": ["--mesh.tp_size", "2"], "pp": ["--pipeline.pp_size", "2", "--pipeline.n_micro", "2"]}

_thread = pytest.fixture(autouse=True, scope="module")(one_torch_thread)


def _name(sizes) -> str:
    return "x".join(map(str, sizes))


@pytest.fixture(scope="module", autouse=True)
def clis(tmp_path_factory):
    """The training CLI under torchrun on 2 gloo processes, stage1.py at a
    tiny width and 2 + 2 blocks: over (1, 1, 2) and over (pp 2, data 1),
    started first so that they run beside the other cases; stopped, with
    their processes, at the end."""
    tmp = tmp_path_factory.mktemp("cli")
    csv = _write_videos(str(tmp / "videos"), 4)
    cfg = tmp / "cfg.py"
    cfg.write_text(CLI_CFG.format(stage1=STAGE1))
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=REPO)
    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "LOCAL_WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
        env.pop(k, None)
    runs = {}
    for tag, extra in CLI_RUNS.items():
        out = str(tmp / tag)
        cmd = [sys.executable, "-m", "torch.distributed.run", "--nproc-per-node", "2", "--master-addr", "localhost",
               "--master-port", str(free_port()), "-m", "opensora_torch.train", str(cfg), "--multi_host", "True",
               "--device", "cpu", "--outputs", out, "--exp_name", tag, "--dataset.data_path", csv, *extra]
        runs[tag] = dict(proc=subprocess.Popen(cmd, cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                               text=True, start_new_session=True), out=out)
    try:
        yield dict(runs=runs, cfg=str(cfg))
    finally:
        for r in runs.values():
            if r["proc"].poll() is None:
                os.killpg(r["proc"].pid, signal.SIGKILL)
            r["proc"].communicate()


def _pp_weights():
    """tests/test_torch_pp.py's randomized JAX weights, as the port's state
    dict too."""
    jm = JModel(JConfig(**PP_GEOM, attn_backend="xla", dtype="fp32", param_dtype="fp32"))
    b, lt = pp_batch()["x0"].shape[:2], pp_batch()["txt"].shape[1]
    z = lambda *s: jnp.zeros(s)  # noqa: E731
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0), z(*b, 8), z(*b, 3), z(b[0], lt, 24), z(b[0], lt, 3),
                            z(b[0]), z(b[0], 16))
    params = randomize(to_numpy(shapes["params"]), 3, scale=0.1)
    return jm, params, {k: torch.from_numpy(v.copy()) for k, v in mmdit_state_dict(params).items()}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every case in one start of 2 processes and one of 4, and this
    process's references computed meanwhile."""
    from opensora_torch.parallel.context import set_mesh
    from opensora_torch.train import Trainer
    from opensora_torch.utils.config import parse_configs

    params, batch = _params(), _batch(B=4)
    rng = jax.random.PRNGKey(11)
    draws = [_jax_draws(batch, rng, i, PROB) for i in range(2)]
    jm, pp_params, pp_sd = _pp_weights()
    pbatch = pp_batch()
    ts = np.linspace(0.1, 0.9, pbatch["x0"].shape[0]).astype(np.float32)
    inputs = _model_inputs(pbatch, ts)
    l_params, l_factors, l_batch = lora_inputs()
    l_draws = [_jax_draws(l_batch, jax.random.PRNGKey(11), 0, PROB)]

    calls = {2: [], 4: []}
    names = {2: [], 4: []}

    def add(world, name, fn, args, kwargs=None):
        calls[world].append((fn, args, kwargs or {}))
        names[world].append(name)

    for sizes, world in TP_MESHES:
        add(world, "tp_" + _name(sizes), "sharded_steps", (params, batch, GEOM, OPT, sizes), dict(draws=draws))
    for v in ("right",) + TP_WRONG:
        add(2, v, "sharded_steps", (params, batch, GEOM, OPT, (1, 1, 2)), dict(seed=SEED, n_steps=1, variant=v))
    for sizes, world in PP_MESHES:
        add(world, "pp_" + _name(sizes), "pp_step", (pp_sd, PP_GEOM, OPT, sizes, N_MICRO, pbatch, SEED))
        add(world, "fwd_" + _name(sizes), "pp_forward", (pp_sd, PP_GEOM, sizes, N_MICRO, inputs))
    add(2, "pp_gradient_not_sent", "pp_step", (pp_sd, PP_GEOM, OPT, PP_MESHES[0][0], N_MICRO, pbatch, SEED),
        dict(variant="pp_gradient_not_sent"))
    add(2, "lora", "lora_steps", (l_params, lora_state_dict(l_factors), l_batch, GEOM, OPT, (1, 1, 2), RANK, SCALE,
                                  l_draws))
    # the Trainer's iteration with a data block of 2 processes (a tp group
    # across them): the demo config with visual conditions, its state saved
    tmp = tmp_path_factory.mktemp("block")
    (tmp / "cond.py").write_text(COND_CFG.format(demo=DEMO) + f"adam_eps = {BLOCK_ADAM_EPS}\n")
    (tmp / "cond_tp.py").write_text(f"_base_ = [{str(tmp / 'cond.py')!r}]\nmesh = dict(tp_size=2)\n")
    cfg = parse_configs([str(tmp / "cond.py")])
    state_path = str(tmp / "trainer_state.pt")
    torch.save(Trainer(cfg, "cpu").state.state_dict(), state_path)
    video = np.random.default_rng(3).uniform(-1, 1, (4, 3, 9, 32, 32)).astype(np.float32)
    texts = ["a red fox", "a blue lake", "a green hill", "a grey city"]
    add(2, "trainer", "trainer_iteration", (str(tmp / "cond_tp.py"), video, texts, state_path))
    add(4, "max", "tp_max", (3, (5, 7)))
    procs = {w: Processes(run_calls, calls[w], world=w) for w in (4, 2)}

    ref = {}
    for sizes, _ in TP_MESHES:
        ref[sizes] = dict(port=_single_process(params, batch, sizes, draws=draws),
                          jax=_jax_steps(params, batch, sizes, "xla", rng) if sizes in JAX_TP else None)
    gen_ref = _single_process(params, batch, (1, 1, 2), seed=SEED, n_steps=1)
    pp_ref, jax_fwd = {}, {}
    jb = {k: jnp.asarray(v) for k, v in inputs.items()}
    for sizes, _ in PP_MESHES:
        pp_ref[sizes] = pp_step(pp_sd, PP_GEOM, OPT, sizes, N_MICRO, pbatch, SEED)
        pp, data, tp = sizes
        fwd = jpp.make_pp_forward(jm, jpp.create_pp_mesh(pp=pp, data=data, tp=tp), n_micro=N_MICRO)
        jax_fwd[sizes] = np.asarray(jax.jit(lambda p: fwd(p, **jb))(jax.tree.map(jnp.asarray, pp_params)))
    trainer = Trainer(cfg, "cpu", mesh=_mesh(1, 1, 2))
    trainer.state.load_state_dict(torch.load(state_path, weights_only=False))
    m = trainer.run_batch({"video": torch.from_numpy(video), "text": texts})
    trainer_ref = dict(loss=float(m["loss"]), grad_norm=float(m["grad_norm"]), mask_conds=trainer.mask_conds,
                       params=trainer.state.state_dict()["params"], start=torch.load(state_path)["params"])
    set_mesh(None)
    l_metrics, l_state, _ = port_lora_steps(l_params, l_factors, l_batch, (1, 1, 2), l_draws)
    lora_ref = dict(metrics=l_metrics, factors=l_state.state_dict()["params"], start=lora_state_dict(l_factors))
    by_name = {}
    for w, p in procs.items():
        results = p.results()
        by_name.update({n: [r[i] for r in results] for i, n in enumerate(names[w])})
    return dict(by_name=by_name, ref=ref, gen_ref=gen_ref, pp_ref=pp_ref, jax_fwd=jax_fwd, pp_start=pp_sd,
                lora_ref=lora_ref, trainer_ref=trainer_ref, params=params, batch=batch, pbatch=pbatch)


def _tp_expected(batch, sizes, process: int) -> dict:
    """The cross-process tp all-reduces of ``process`` (one rank a process)
    per step: the row-parallel products of a double + single block (the img
    and txt proj and MLP out, over the rank's image and text tokens, each
    skipped where the rank holds none; linear2 over all its tokens), each in
    the forward, its remat recompute and the backward, fp32 (B / dp rows,
    hidden 64)."""
    from opensora_torch.parallel.data import joint_chunks

    dp, sp, tp = sizes
    s = (process // tp) % sp
    rows = batch["x0"].shape[0] // dp
    ts, is_ = joint_chunks(batch["txt"].shape[1], batch["x0"].shape[1], sp)[s]
    n_img, n_txt = is_.stop - is_.start, ts.stop - ts.start
    parts = [n for n in (n_img, n_txt) if n] * 2 + [n_img + n_txt]
    return dict(all_reduces=3 * len(parts), bytes=3 * sum(parts) * rows * GEOM["hidden_size"] * 4)


@pytest.mark.parametrize("sizes", JAX_TP, ids=_name)
def test_tp_across_processes_matches_jax(runs, sizes):
    """Two steps of the full-finetune step (masked loss, text dropout, clip,
    AdamW with weight decay, EMA, FSDP where dp > 1) over a mesh whose tp
    groups span the processes, one rank each, from the same weights, batch
    and draws as JAX's sharded step on the same mesh: loss, norm, and each
    parameter's and EMA's change, gathered on process 0."""
    j_metrics, j_params, j_ema = runs["ref"][sizes]["jax"]
    out = runs["by_name"]["tp_" + _name(sizes)]
    assert out[0]["state"] is not None and all(r["state"] is None for r in out[1:])
    p0 = mmdit_state_dict(runs["params"])
    for i in range(2):
        for r in out:
            assert r["metrics"][i]["loss"] == pytest.approx(j_metrics[i]["loss"], rel=TOL)
            assert r["metrics"][i]["grad_norm"] == pytest.approx(j_metrics[i]["grad_norm"], rel=TOL)
    st = out[0]["state"]
    assert max(_changes({n: p.numpy() for n, p in st["params"].items()}, j_params, p0).values()) <= UPDATE_TOL
    assert max(_changes({n: p.numpy() for n, p in st["ema"].items()}, j_ema, p0).values()) <= EMA_TOL


@pytest.mark.parametrize("sizes,world", TP_MESHES, ids=lambda v: _name(v) if isinstance(v, tuple) else str(v))
def test_tp_across_processes_matches_the_single_process_port(runs, sizes, world):
    """The same two steps against the port's single-process step over the
    same mesh of logical ranks (within PORT_TOL / PORT_UPDATE_TOL /
    MOMENT_TOL), each process holding its rank's leaves only; the tp
    all-reduces across processes, per process and step, exact."""
    out = runs["by_name"]["tp_" + _name(sizes)]
    assert all(f"in {world} processes" in r["mesh"] for r in out)
    d = _held(out, runs["ref"][sizes]["port"], mmdit_state_dict(runs["params"]))
    assert _within(d), d
    for p, r in enumerate(out):
        want = _tp_expected(runs["batch"], sizes, p)
        assert r["tp_remote"] == [want, want], (p, r["tp_remote"], want)


def test_tp_known_wrong_variants_fail(runs):
    """One step from a generator (seed SEED) over (1, 1, 2) across 2
    processes against the single-process port: right within the limits;
    the tp group's cross-process sum left out of the backward, and the row
    bias added on each process, each outside them by over 100 times."""
    p0, ref = mmdit_state_dict(runs["params"]), runs["gen_ref"]
    right = _held(runs["by_name"]["right"], ref, p0)
    assert _within(right), right
    for v in TP_WRONG:
        d = _held(runs["by_name"][v], ref, p0)
        assert d["metric"] > 100 * PORT_TOL or d["change"] > 100 * PORT_UPDATE_TOL, (v, d)


def _pp_expected(pbatch) -> list:
    """The pipeline's messages per process and step over (pp 2, data 1), one
    stage a process (a stage's tp ranks split over processes each send
    their own, as many), fp32, each boundary's tensors packed in one
    message and their gradients in one back: per microbatch, stage 0's
    process sends the double stack's (img, txt, vec, pe) and the single
    stack's (x, vec, pe) forward, and the gradients of the double stack's
    output (img, txt, vec) back; the last stage's sends the double stack's
    output (img, txt, vec, pe) to stage 0 and the gradients of its two
    inputs ((img, txt, vec), (x, vec)). pe is RoPE's cos and sin, each (mb,
    L, D / 2)."""
    b, n_img, _ = pbatch["x0"].shape
    n_txt, h = pbatch["txt"].shape[1], PP_GEOM["hidden_size"]
    mb = b // N_MICRO
    img, txt, vec, x = (mb * n * h * 4 for n in (n_img, n_txt, 1, n_img + n_txt))
    pe = 2 * mb * (n_img + n_txt) * sum(PP_GEOM["axes_dim"]) // 2 * 4
    first = dict(sends=3, bytes=(img + txt + vec + pe) + (x + vec + pe) + (img + txt + vec))
    last = dict(sends=3, bytes=(img + txt + vec + pe) + (img + txt + vec) + (x + vec))
    return [{k: N_MICRO * v for k, v in e.items()} for e in (first, last)]


@pytest.mark.parametrize("sizes,world", PP_MESHES, ids=lambda v: _name(v) if isinstance(v, tuple) else str(v))
def test_pp_across_processes_matches_one_process_and_jax(runs, sizes, world):
    """GPipe with one stage a process (and, at tp 2, one tp rank a process):
    the forward on fixed timesteps against JAX's ``make_pp_forward`` on the
    same mesh (atol 1e-4), on the last stage's processes (the others return
    None); one step from a generator against the same mesh in one process
    (the loss and norm, on every process, within 1e-6, each parameter's
    change within 1e-5); the messages across processes per process
    exact."""
    fwd = runs["by_name"]["fwd_" + _name(sizes)]
    per_stage = world // 2
    assert all(y is None for y in fwd[:per_stage])
    for y in fwd[per_stage:]:
        np.testing.assert_allclose(y.numpy(), runs["jax_fwd"][sizes], atol=FWD_ATOL)
    out, ref = runs["by_name"]["pp_" + _name(sizes)], runs["pp_ref"][sizes]
    assert f"in {world} processes" in out[0]["mesh"] and all(r["state"] is None for r in out[1:])
    for r in out:
        for k in ("loss", "grad_norm"):
            assert r["metrics"][0][k] == pytest.approx(ref["metrics"][0][k], rel=PORT_TOL), k
    p0 = {n: v.numpy() for n, v in runs["pp_start"].items()}
    got = {n: p.numpy() for n, p in out[0]["state"]["params"].items()}
    want = {n: p.numpy() for n, p in ref["state"]["params"].items()}
    assert sorted(got) == sorted(want) and max(_changes(got, want, p0).values()) <= PORT_UPDATE_TOL
    first, last = _pp_expected(runs["pbatch"])
    for p, r in enumerate(out):
        assert r["pp_remote"] == (first if p < per_stage else last), (p, r["pp_remote"])
        assert (r["tp_remote"]["all_reduces"] > 0) == (sizes[2] > 1)


def test_pp_gradient_not_sent_back_fails(runs):
    """Known-wrong: the last stage's received activations send back zero
    gradients, so stage 0's blocks and the embedders get none from the
    loss: outside the limits by over 100 times."""
    sizes = PP_MESHES[0][0]
    out, ref = runs["by_name"]["pp_gradient_not_sent"], runs["pp_ref"][sizes]
    metric = max(abs(r["metrics"][0][k] - ref["metrics"][0][k]) / abs(ref["metrics"][0][k])
                 for r in out for k in ("loss", "grad_norm"))
    p0 = {n: v.numpy() for n, v in runs["pp_start"].items()}
    got = {n: p.numpy() for n, p in out[0]["state"]["params"].items()}
    want = {n: p.numpy() for n, p in ref["state"]["params"].items()}
    change = max(_changes(got, want, p0).values())
    assert metric > 100 * PORT_TOL or change > 100 * PORT_UPDATE_TOL, (metric, change)


def test_trainer_iteration_with_a_data_block_of_two_processes(runs):
    """``Trainer.run_batch`` over (1, 1, 2), a tp rank a process: the data
    block's first process alone encodes the 4 clips (the posterior noise,
    the visual conditions and their single frames), the other takes its
    inputs and random state, so the iteration equals the single-process
    trainer's on the same mesh of logical ranks: the mask conditions on
    both processes, the loss and norm (1e-6), each master's change within
    UPDATE_TOL (the tp sums run in another order across the processes;
    BLOCK_ADAM_EPS)."""
    out, ref = runs["by_name"]["trainer"], runs["trainer_ref"]
    assert "in 2 processes" in out[0]["mesh"] and "'tp': 2" in out[0]["mesh"] and out[1]["params"] is None
    assert any(mc != "t2v" for mc in ref["mask_conds"])
    for r in out:
        assert r["mask_conds"] == ref["mask_conds"]
        assert r["loss"] == pytest.approx(ref["loss"], rel=PORT_TOL)
        assert r["grad_norm"] == pytest.approx(ref["grad_norm"], rel=PORT_TOL)
    for n, p in ref["params"].items():
        start = ref["start"][n].numpy()
        assert _rel_l2(out[0]["params"][n].numpy() - start, p.numpy() - start) <= UPDATE_TOL, n


def test_lora_step_with_tp_across_processes(runs):
    """One LoRA step over (1, 1, 2) across 2 processes (the frozen base
    TP-cut, the factors replicated, each tp rank's share of their gradient
    summed over the processes): the loss and norm (1e-6) and each factor's
    change (1e-5) against the port's single-process step."""
    out, ref = runs["by_name"]["lora"], runs["lora_ref"]
    assert out[1]["factors"] is None
    for r in out:
        for k in ("loss", "grad_norm"):
            assert r["metrics"][0][k] == pytest.approx(ref["metrics"][0][k], rel=PORT_TOL), k
    got = {n: p.numpy() for n, p in out[0]["factors"].items()}
    want = {n: p.numpy() for n, p in ref["factors"].items()}
    assert sorted(got) == sorted(ref["start"]) and max(_changes(got, want, ref["start"]).values()) <= PORT_UPDATE_TOL


def test_all_reduce_max_and_sum_over_a_spanning_tp_group(runs):
    """``comm.all_reduce_max`` over a tp group of 4 processes, two ranks
    each: every rank gets the elementwise max of all 8 tensors;
    ``all_reduce`` with a bias: the fp32 sum of all 8 plus the bias once;
    one cross-process all-reduce each."""
    out = runs["by_name"]["max"]
    parts = [x for r in out for x in r["parts"]]
    want_max = torch.stack(parts).amax(0)
    want_sum = torch.stack(parts).sum(0) + torch.randn(7, generator=torch.Generator().manual_seed(3))
    for r in out:
        assert r["tp_remote"] == dict(all_reduces=2, bytes=2 * 5 * 7 * 4)
        for m, s in zip(r["max"], r["sum"]):
            assert torch.equal(m, want_max)
            torch.testing.assert_close(s, want_sum, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("tag", list(CLI_RUNS))
def test_training_cli_under_torchrun(clis, tag):
    """``python -m torch.distributed.run --nproc-per-node 2 -m
    opensora_torch.train <stage1 at a tiny width> --multi_host True
    --device cpu`` with ``--mesh.tp_size 2`` (one tp rank a process) and
    with ``--pipeline.pp_size 2`` (one stage a process): both processes exit
    0, process 0 logs the mesh across the processes and both steps (both
    processes read the same samples: one data coordinate), and its
    checkpoint loads into a single-process Trainer, equal to the file."""
    from opensora_torch.train import Trainer
    from opensora_torch.utils.config import parse_configs

    run = clis["runs"][tag]
    try:
        stdout, stderr = run["proc"].communicate(timeout=JOIN_TIMEOUT)
    except subprocess.TimeoutExpired:
        raise AssertionError(f"the CLI still ran after {JOIN_TIMEOUT} s") from None
    assert run["proc"].returncode == 0, stdout[-3000:] + stderr[-3000:]
    exp = os.path.join(run["out"], tag)
    with open(os.path.join(exp, "log.txt")) as f:
        log = f.read()
    assert re.search(r"in 2 processes", log) and ("'tp': 2" in log if tag == "tp" else "'pp': 2" in log), log
    assert len(re.findall(r" loss (-?\d+\.\d+)", log)) == 2, log
    read = [eval(m) for m in re.findall(r"samples by process (\[.*\])", log)]
    assert len(read) == 2 and all(r[0] == r[1] for r in read), read
    ckpt = os.path.join(exp, "epoch0-global_step2")
    saved = torch.load(os.path.join(ckpt, "state.pt"), weights_only=False)
    trainer = Trainer(parse_configs([clis["cfg"]]), "cpu")
    CheckpointIO().load(ckpt, trainer.state)
    again = trainer.state.state_dict()
    assert again["step"] == saved["step"] == 2
    for n, p in saved["params"].items():
        assert torch.equal(again["params"][n], p) and torch.equal(again["ema"][n], saved["ema"][n]), n
    for i, st in saved["optimizer"]["adamw"]["state"].items():
        assert torch.equal(again["optimizer"]["adamw"]["state"][i]["exp_avg"], st["exp_avg"]), i
