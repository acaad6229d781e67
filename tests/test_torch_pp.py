"""GPipe pipeline parallelism of the port over logical CPU ranks
(opensora_torch/parallel/pipeline.py, opensora_torch/training/pp.py, the
training CLI's ``pipeline`` key) against the JAX package's
(opensora_tpu/parallel/pipeline.py, opensora_tpu/training/pp.py) on its 8
virtual CPU devices, at tests/test_pp_train.py's config (hidden 64, depth
4 + 8, fp32), with the same weights, batch and draws.

Tolerances are JAX's own: the pipeline primitive within 1e-5
(tests/test_pipeline.py), the MMDiT forward within atol 1e-4, one train
step's loss within rtol 2e-5, its gradient norm within rtol 2e-4 and the
updated parameters and EMA within atol 5e-4 (tests/test_pp_train.py:97-113),
PP x TP against PP within 1e-4 of the loss (``dryrun_pp_tp``,
__graft_entry__.py:430-437). Within the port, a pipeline over ranks on
distinct device keys equals the one over a shared device bitwise, and a
state crosses between the PP and the unsharded layouts bitwise.
"""

import copy
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opensora_tpu.models.mmdit.model import MMDiTConfig as JConfig
from opensora_tpu.models.mmdit.model import MMDiTModel as JModel
from opensora_tpu.parallel.pipeline import create_pipeline_mesh, merge_scan_params, shard_pipeline_params
from opensora_tpu.parallel.pipeline import pipeline_apply as j_pipeline_apply
from opensora_tpu.parallel.pipeline import split_scan_params
from opensora_tpu.training import diffusion as jdiff
from opensora_tpu.training import pp as jpp
from opensora_tpu.utils import optimizer as jopt

from opensora_torch.models.mmdit.model import MMDiTConfig, MMDiTModel
from opensora_torch.parallel.mesh import create_pp_mesh
from opensora_torch.parallel.pipeline import merge_stages, pipeline_apply, split_stages
from opensora_torch.training import diffusion as tdiff
from opensora_torch.training.pp import make_pp_forward, pp_param_specs, pp_state_shardings, shard_pp
from opensora_torch.utils import optimizer as topt
from opensora_torch.utils.weights import load_numpy_state_dict, mmdit_state_dict
from test_torch_training import _jax_draws
from torch_parity_utils import one_torch_thread, randomize, t, to_numpy

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), os.pardir))
DEMO = os.path.join(REPO, "configs", "diffusion", "train", "demo.py")
STAGE1 = os.path.join(REPO, "configs", "diffusion", "train", "stage1.py")
CPU = torch.device("cpu")
GEOM = dict(in_channels=8, vec_in_dim=16, context_in_dim=24, hidden_size=64, mlp_ratio=2.0, num_heads=4,
            axes_dim=[4, 6, 6], depth=4, depth_single_blocks=8, qkv_bias=True, guidance_embed=False,
            cond_embed=False)
B, L, LT = 8, 32, 8
N_MICRO = 4
# AdamW with eps well above the gradients' fp32 rounding: at test_pp_train.py's
# eps (1e-8) the first update is lr * g / (|g| + eps), and a gradient element
# of ~1e-8 turns a 1e-9 difference in the sum's order into an lr-sized one
# (one element of 12288 moved 1.1e-3 here); with eps = lr = 1e-2 the update is
# near linear in the gradient, so the parameters compare the gradients
OPT = dict(lr=1e-2, weight_decay=1e-4, eps=1e-2, warmup_steps=0)
EMA = 0.9  # the EMA moves by a tenth of the parameters' change (0.9999 would move it by 1e-4 of it)
# relative L2 of each change (tests/test_torch_data_parallel.py), for the
# parameters that move by at least MOVED: a smaller change (the text query
# norms' scales move by 4e-5) is read through fp32 roundings of the
# parameter itself (1.5e-8 at 0.15), and atol covers it
UPDATE_TOL, EMA_TOL, MOVED = 1e-4, 1e-3, 1e-3

_thread = pytest.fixture(autouse=True)(one_torch_thread)


def _batch(seed=7):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    return dict(x0=f(B, L, 8), img_ids=rng.integers(0, 6, (B, L, 3)).astype(np.float32), txt=f(B, LT, 24),
                txt_ids=np.zeros((B, LT, 3), np.float32), y_vec=f(B, 16),
                shift_alpha=np.full((B,), 1.5, np.float32))


def _model_inputs(batch, timesteps):
    return dict(img=batch["x0"], img_ids=batch["img_ids"], txt=batch["txt"], txt_ids=batch["txt_ids"],
                timesteps=timesteps, y_vec=batch["y_vec"])


@pytest.fixture(scope="module")
def jax_pp():
    """JAX's PP forward and one PP train step over create_pp_mesh(pp=4,
    data=2), from randomized weights."""
    jm = JModel(JConfig(**GEOM, attn_backend="xla", dtype="fp32", param_dtype="fp32"))
    batch = _batch()
    z = lambda *s: jnp.zeros(s)  # noqa: E731
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0), z(B, L, 8), z(B, L, 3), z(B, LT, 24), z(B, LT, 3),
                            z(B), z(B, 16))
    params = randomize(to_numpy(shapes["params"]), 3, scale=0.1)
    mesh = jpp.create_pp_mesh(pp=4, data=2)
    fwd = jpp.make_pp_forward(jm, mesh, n_micro=N_MICRO)
    ts = np.linspace(0.1, 0.9, B).astype(np.float32)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    out = jax.jit(lambda p: fwd(p, **_model_inputs(jb, jnp.asarray(ts))))(jax.tree.map(jnp.asarray, params))

    tx = jopt.create_optimizer(**OPT)
    state = jdiff.TrainState.create(jax.tree.map(jnp.asarray, params), tx, ema=True)
    shardings = jpp.pp_state_shardings(mesh, state)
    state = jax.device_put(state, shardings)
    step = jdiff.make_train_step(jm, tx, ema_decay=EMA, forward_fn=fwd)
    rng = jax.random.PRNGKey(42)
    new, metrics = jax.jit(step, in_shardings=(shardings, None, None), out_shardings=(shardings, None))(
        state, jb, rng)
    return dict(params=params, batch=batch, ts=ts, out=np.asarray(out), rng=rng,
                metrics={k: float(v) for k, v in metrics.items()},
                new_params=mmdit_state_dict(to_numpy(new.params)), new_ema=mmdit_state_dict(to_numpy(new.ema_params)))


def _rel_l2(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _port_model(params, remat=True, **kw):
    tm = MMDiTModel(MMDiTConfig(**{**GEOM, **kw}, dtype="fp32", attn_backend="xla", remat=remat), device="meta",
                    dtype=torch.float32)
    load_numpy_state_dict(tm, {k: v.copy() for k, v in mmdit_state_dict(params).items()})
    return tm.requires_grad_(True)


def _state(tm):
    return tdiff.TrainState.create(tm, topt.create_optimizer([p for p in tm.parameters()], **OPT), ema=True)


def _pp(params, sizes, devices=None):
    """A PP model and its state over (pp, data, tp), the state cut from the
    unsharded one by pp_state_shardings."""
    pp, data, tp = sizes
    tm = _port_model(params)
    mesh = create_pp_mesh(pp, data, tp, devices or [CPU] * (pp * data * tp))
    state = _state(tm)
    state = tdiff.shard_state(mesh, state, tm, shardings=pp_state_shardings(mesh, state, tm))
    return tm, mesh, state


def _step(tm, mesh, state, jp, n_micro=N_MICRO):
    fwd = None if mesh is None else make_pp_forward(tm, mesh, n_micro)
    step = tdiff.make_train_step(tm, ema_decay=EMA, forward_fn=fwd)
    draws = {k: v for k, v in _jax_draws(jp["batch"], jp["rng"], 0, 0.0).items() if k in ("t", "x1")}
    return step(state, {k: t(v) for k, v in jp["batch"].items()}, draws=draws)


# ----------------------------------------------------------------------
# the primitive: tests/test_pipeline.py's stack
# ----------------------------------------------------------------------

N_LAYERS, D, MLP = 8, 16, 32


def _layer(p, x):
    return x + torch.tanh(x @ p["w1"] + p["b1"]) @ p["w2"]


def test_pipeline_apply_matches_jax_forward_and_backward():
    """The port's tick loop over (data 2, pp 4) against JAX's
    ``pipeline_apply`` on the same stack: outputs on every stage, and the
    gradients of mean(out^2) through the sends (the reverse pipeline)."""
    rng = np.random.default_rng(0)
    params = {"w1": 0.3 * rng.standard_normal((N_LAYERS, D, MLP)).astype(np.float32),
              "b1": 0.1 * rng.standard_normal((N_LAYERS, MLP)).astype(np.float32),
              "w2": 0.3 * rng.standard_normal((N_LAYERS, MLP, D)).astype(np.float32)}
    x_mb = rng.standard_normal((6, 2, D)).astype(np.float32)

    jmesh = create_pipeline_mesh(pp_size=4, data_size=2)

    def stage_fn(p, x):
        return jax.lax.scan(lambda h, q: (x_layer(q, h), None), x, p)[0]

    def x_layer(q, h):
        return h + jnp.tanh(h @ q["w1"] + q["b1"]) @ q["w2"]

    def loss(p, x):
        return (j_pipeline_apply(stage_fn, p, x, mesh=jmesh, axis="pp") ** 2).mean()

    staged = shard_pipeline_params(split_scan_params(jax.tree.map(jnp.asarray, params), 4), jmesh, "pp")
    j_out = np.asarray(jax.jit(lambda p, x: j_pipeline_apply(stage_fn, p, x, mesh=jmesh, axis="pp"))(staged, x_mb))
    j_grads = to_numpy(merge_scan_params(jax.jit(jax.grad(loss))(staged, jnp.asarray(x_mb))))

    layers = [{k: torch.tensor(v[i], requires_grad=True) for k, v in params.items()} for i in range(N_LAYERS)]
    stages = split_stages(layers, 4)
    assert merge_stages(stages) == layers
    mesh = create_pp_mesh(4, 2, 1, [CPU] * 8)
    ran = []

    def port_stage(stage, act, d, s):
        ran.append((d, s))
        h = act[0]
        for p in stage:
            h = _layer(p, h)
        return [h]

    x = torch.from_numpy(x_mb)
    out = pipeline_apply(port_stage, stages, [[[x[m, d:d + 1]] for m in range(6)] for d in range(2)], mesh)
    assert len(ran) == 6 * 4 * 2  # no bubble work
    for s in range(4):
        got = torch.stack([torch.cat([out[d][m][s][0] for d in range(2)]) for m in range(6)])
        np.testing.assert_allclose(got.detach().numpy(), j_out, atol=1e-5)
    got = torch.stack([torch.cat([out[d][m][0][0] for d in range(2)]) for m in range(6)])
    (got ** 2).mean().backward()
    for k in params:
        g = torch.stack([p[k].grad for p in layers]).numpy()
        np.testing.assert_allclose(g, j_grads[k], atol=1e-5, err_msg=k)


def test_split_stages_rejects_an_uneven_cut():
    with pytest.raises(ValueError, match="layers 6 not divisible by stages 4"):
        split_stages(list(range(6)), 4)


# ----------------------------------------------------------------------
# the MMDiT forward and train step against JAX's
# ----------------------------------------------------------------------


def test_pp_forward_matches_jax(jax_pp):
    """The port's make_pp_forward over (data 2, pp 4), against JAX's on
    create_pp_mesh(pp=4, data=2) and the port's unsharded forward."""
    tm = _port_model(jax_pp["params"], remat=False)
    inputs = {k: t(v) for k, v in _model_inputs(jax_pp["batch"], jax_pp["ts"]).items()}
    with torch.no_grad():
        ref = tm(**inputs)
        mesh = create_pp_mesh(4, 2, 1, [CPU] * 8)
        shard_pp(mesh, tm)
        out = make_pp_forward(tm, mesh, N_MICRO)(**inputs)
    np.testing.assert_allclose(out.numpy(), jax_pp["out"], atol=1e-4)
    np.testing.assert_allclose(out.numpy(), ref.numpy(), atol=1e-5)


def test_pp_train_step_matches_jax(jax_pp):
    """One step over (data 2, pp 4) from the same weights, batch and
    draws: loss, gradient norm, updated parameters and EMA."""
    tm, mesh, state = _pp(jax_pp["params"], (4, 2, 1))
    m = _step(tm, mesh, state, jax_pp)
    jm = jax_pp["metrics"]
    assert float(m["loss"]) == pytest.approx(jm["loss"], rel=2e-5)
    assert float(m["grad_norm"]) == pytest.approx(jm["grad_norm"], rel=2e-4)
    sd, p0, moved = state.state_dict(), mmdit_state_dict(jax_pp["params"]), 0
    assert sorted(sd["params"]) == sorted(jax_pp["new_params"])
    for n, p in sd["params"].items():
        np.testing.assert_allclose(p.numpy(), jax_pp["new_params"][n], atol=5e-4, err_msg=n)
        np.testing.assert_allclose(sd["ema"][n].numpy(), jax_pp["new_ema"][n], atol=5e-4, err_msg=n)
        if np.abs(jax_pp["new_params"][n] - p0[n]).max() >= MOVED:
            moved += 1
            assert _rel_l2(p.numpy() - p0[n], jax_pp["new_params"][n] - p0[n]) <= UPDATE_TOL, n
            assert _rel_l2(sd["ema"][n].numpy() - p0[n], jax_pp["new_ema"][n] - p0[n]) <= EMA_TOL, n
    assert moved > 100


def test_pp_tp_matches_pp(jax_pp):
    """PP x TP over (data 2, pp 2, tp 2): each stage's linears cut over
    its tp ranks (qkv by heads); the loss within 1e-4 of PP's and of
    JAX's, the gradient norm within 2e-4."""
    specs = pp_param_specs(_port_model(jax_pp["params"]), 2, tp=True)
    tm, mesh, state = _pp(jax_pp["params"], (2, 2, 2))
    assert specs["double_blocks.1.img_attn.qkv.weight"] == (0, ("tp", None))
    assert specs["single_blocks.4.linear2.weight"] == (1, (None, "tp"))
    assert specs["img_in.weight"] == (None, (None, None))
    m = _step(tm, mesh, state, jax_pp)
    tm_pp, mesh_pp, state_pp = _pp(jax_pp["params"], (4, 2, 1))
    m_pp = _step(tm_pp, mesh_pp, state_pp, jax_pp)
    assert abs(float(m["loss"]) - float(m_pp["loss"])) < 1e-4
    assert abs(float(m["loss"]) - jax_pp["metrics"]["loss"]) < 1e-4
    assert float(m["grad_norm"]) == pytest.approx(float(m_pp["grad_norm"]), rel=2e-4)


def test_pp_over_distinct_devices_sums_replica_gradients(jax_pp, monkeypatch):
    """(data 1, pp 2, tp 2) over cpu:0..3: the embedders and the final
    layer have a replica on each rank's device, the stage-0 and last-stage
    replicas each receive their ranks' part of the gradient, and the
    summed step equals the step over one shared device (in the order of
    its fp32 sums: the relative L2 of each moved parameter's change within
    UPDATE_TOL), every replica updated alike. Without the sum the gradient
    norm moves far off."""
    devices = [torch.device("cpu", i) for i in range(4)]
    tm_s, mesh_s, state_s = _pp(jax_pp["params"], (2, 1, 2))
    m_s = _step(tm_s, mesh_s, state_s, jax_pp)
    tm, mesh, state = _pp(jax_pp["params"], (2, 1, 2), devices)
    m = _step(tm, mesh, state, jax_pp)
    assert [k[2] for k in tm.sharding.placements["img_in.weight"].keys] == [(0, d) for d in devices]
    block = tm.sharding.placements["single_blocks.7.linear1.weight"]
    assert block.stage == 1 and [k[2] for k in block.keys] == [(0, d) for d in devices[2:]]
    groups = tm.sharding.replicas()
    assert len(groups) > 10 and len(state.optimizer.replica_ids) == sum(len(g) - 1 for g in groups)
    for g in groups:
        assert all(torch.equal(p.detach(), g[0].detach()) for p in g[1:])
    assert float(m["loss"]) == pytest.approx(float(m_s["loss"]), rel=1e-6)
    assert float(m["grad_norm"]) == pytest.approx(float(m_s["grad_norm"]), rel=1e-5)
    sd, want, p0 = state.state_dict(), state_s.state_dict(), mmdit_state_dict(jax_pp["params"])
    for n, p in sd["params"].items():
        change = want["params"][n].numpy() - p0[n]
        if np.abs(change).max() >= MOVED:
            assert _rel_l2(p.numpy() - p0[n], change) <= UPDATE_TOL, n

    monkeypatch.setattr(type(tm.sharding), "sync_replica_grads", lambda self: None)
    tm, mesh, state = _pp(jax_pp["params"], (2, 1, 2), devices)
    assert abs(float(_step(tm, mesh, state, jax_pp)["grad_norm"]) / float(m_s["grad_norm"]) - 1) > 1e-2


def test_pp_errors(jax_pp, tmp_path):
    """Depths that do not divide by pp (the port's and JAX's error), a
    model placed on another mesh, a batch that does not divide by n_micro
    or its microbatches by 'data'; the CLI's mesh with no room for a
    pipeline."""
    from opensora_torch.train import pipeline_mesh
    from opensora_torch.utils.config import parse_configs

    bad = MMDiTModel(MMDiTConfig(**{**GEOM, "depth": 3}, dtype="fp32", attn_backend="xla"), dtype=torch.float32)
    mesh = create_pp_mesh(4, 2, 1, [CPU] * 8)
    with pytest.raises(ValueError, match=r"block depths \(3, 8\) must divide by pp=4"):
        shard_pp(mesh, bad)
    with pytest.raises(ValueError, match="must divide by pp"):
        jpp.make_pp_forward(JModel(JConfig(**{**GEOM, "depth": 3}, attn_backend="xla", dtype="fp32")),
                            jpp.create_pp_mesh(pp=4, data=2), n_micro=4)
    tm = shard_pp(mesh, _port_model(jax_pp["params"]))
    with pytest.raises(ValueError, match="place the model on the mesh first"):
        make_pp_forward(tm, create_pp_mesh(4, 2, 1, [CPU] * 8), 4)
    inputs = {k: t(v[:6]) for k, v in _model_inputs(jax_pp["batch"], jax_pp["ts"]).items()}
    with pytest.raises(ValueError, match="batch 6 not divisible by n_micro 4"):
        make_pp_forward(tm, mesh, 4)(**inputs)
    with pytest.raises(ValueError, match=r"microbatch 3 \(batch 6 / n_micro 2\) not divisible by the mesh 'data'"):
        make_pp_forward(tm, mesh, 2)(**inputs)
    cfg = tmp_path / "pp.py"
    cfg.write_text(f"_base_ = [{DEMO!r}]\npipeline = dict(pp_size=2)\n")
    with pytest.raises(ValueError, match="hold no pp_size x tp_size = 2 ranks"):
        pipeline_mesh(parse_configs([str(cfg)]), "cpu")


def test_pp_state_crosses_to_and_from_the_unsharded_layout(jax_pp):
    """A PP state's state_dict is the unsharded layout: an unsharded state
    loads it, and a PP state loads an unsharded state's; the next step from
    either equals the uninterrupted one bitwise."""
    tm, mesh, state = _pp(jax_pp["params"], (2, 2, 2))
    _step(tm, mesh, state, jax_pp)
    # a deep copy, as a checkpoint file is: a state dict holds the live
    # tensors (a whole leaf gathered on the host is the leaf itself)
    saved = copy.deepcopy(state.state_dict())
    tm_u = _port_model(jax_pp["params"])
    unsharded = _state(tm_u)
    unsharded.load_state_dict(saved)
    for n, p in unsharded.params.items():
        assert torch.equal(p, saved["params"][n]) and torch.equal(unsharded.ema[n], saved["ema"][n]), n
    back_tm, back_mesh, back = _pp(jax_pp["params"], (2, 2, 2))
    back.load_state_dict(copy.deepcopy(unsharded.state_dict()))
    m_next, m_back = _step(tm, mesh, state, jax_pp), _step(back_tm, back_mesh, back, jax_pp)
    assert float(m_next["loss"]) == float(m_back["loss"])
    for n, p in state.state_dict()["params"].items():
        assert torch.equal(p, back.state_dict()["params"][n]), n


def _demo_models():
    from opensora_torch.utils.config import parse_configs

    demo = parse_configs([DEMO])
    return {k: dict(demo[k]) for k in ("model", "ae", "t5", "clip")}


def _write_videos(root, n=4, frames=5, size=64):
    import cv2

    os.makedirs(root, exist_ok=True)
    rng = np.random.default_rng(0)
    rows = []
    for i in range(n):
        path = os.path.join(root, f"v{i}.mp4")
        w = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), 8.0, (size, size))
        for _ in range(frames):
            w.write(rng.integers(0, 255, (size, size, 3), np.uint8))
        w.release()
        rows.append(f"{path},clip {i},{size},{size},{frames},8.0")
    csv = os.path.join(root, "meta.csv")
    with open(csv, "w") as f:
        f.write("path,text,height,width,num_frames,fps\n" + "\n".join(rows) + "\n")
    return csv


def test_training_cli_takes_a_pipeline_key(tmp_path):
    """``python -m opensora_torch.train`` with stage1.py (its visual
    conditions, text dropout and "dots" remat) at demo.py's tiny widths, 2
    + 2 blocks, and ``pipeline = dict(pp_size=2, tp_size=2, data_size=1,
    n_micro=2)`` on the CPU: four logical ranks, one finite step, a
    checkpoint in the unsharded layout; with a ``lora_config`` it
    raises."""
    from opensora_torch import train as train_cli
    from opensora_torch.utils.logger import close_logger

    csv = _write_videos(str(tmp_path / "videos"))
    cfg = tmp_path / "pp.py"
    tiny = {k: {**v, "_delete_": True} for k, v in _demo_models().items()}
    cfg.write_text(f"_base_ = [{STAGE1!r}]\nbucket_config = {{'_delete_': True, '64px': {{5: (1.0, 4)}}}}\n"
                   + "".join(f"{k} = {v!r}\n" for k, v in tiny.items())
                   + "log_every = 1\npipeline = dict(pp_size=2, tp_size=2, data_size=1, n_micro=2)\n")
    out = str(tmp_path / "out")
    try:
        trainer = train_cli.main([str(cfg), "--device", "cpu", "--outputs", out, "--dataset.data_path", csv,
                                  "--model.depth", "2", "--model.depth_single_blocks", "2",
                                  "--warmup_steps", "0", "--exp_name", "pp", "--epochs", "1"])
    finally:
        close_logger()
    assert trainer.mesh.shape == {"data": 1, "pp": 2, "tp": 2} and trainer.state.step == 1
    assert trainer.model.sharding.placements["double_blocks.1.img_attn.qkv.weight"].stage == 1
    with open(os.path.join(out, "pp", "log.txt")) as f:
        log = f.read()
    assert "global_step 1 loss" in log and "nan" not in log
    saved = torch.load(os.path.join(out, "pp", "epoch0-global_step1", "state.pt"), weights_only=False)
    assert saved["params"]["double_blocks.1.img_attn.qkv.weight"].shape == (3 * 64, 64)

    lora = tmp_path / "pp_lora.py"
    lora.write_text(f"_base_ = [{str(cfg)!r}]\nlora_config = dict(r=4)\n")
    with pytest.raises(NotImplementedError, match="pipeline \\+ lora_config"):
        train_cli.main([str(lora), "--device", "cpu"])
