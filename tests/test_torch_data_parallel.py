"""Data parallelism and FSDP of the port over logical CPU ranks
(opensora_torch/parallel/data.py, training/diffusion.py's sharded state and
step) against the JAX package's sharded train step on its 8 virtual CPU
devices (``shard_state``, ``make_train_step``, ``jit_train_step`` on the
same mesh, as __graft_entry__.py:144-232 runs it).

Tolerances, fp32 on both sides: ``TOL`` = 1e-5 relative for the loss and
the gradients' global norm; in relative L2 of each tensor's change over
two steps, ``UPDATE_TOL`` = 1e-4 for the parameters and ``EMA_TOL`` = 1e-3
for the EMA (XLA and torch sum the same fp32 products in other orders and
round the EMA's update differently; the EMA moves by a tenth of the
parameters' change, so an fp32 rounding of the EMA itself is ~1e-4 of its
change: measured worst 4.6e-5 and 2.5e-4, the same for the unsharded
port). Sharded against unsharded within the port: the FSDP moments equal
the unsharded moments' slices within 1e-5 of their scale (the data ranks'
gradients are summed in another order; the second moment squares them:
measured 1.2e-6), and a
checkpoint crosses both ways bitwise.
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
from opensora_tpu.parallel import context as jcontext
from opensora_tpu.parallel.data import make_global_batch as j_make_global_batch
from opensora_tpu.parallel.mesh import MeshConfig as JMeshConfig
from opensora_tpu.parallel.mesh import create_mesh as j_create_mesh
from opensora_tpu.parallel.sharding import make_shardings, mmdit_param_specs as j_specs
from opensora_tpu.training import diffusion as jdiff
from opensora_tpu.utils import optimizer as jopt

from opensora_torch.models.mmdit.model import MMDiTConfig, MMDiTModel
from opensora_torch.parallel import data as tdata
from opensora_torch.parallel import sharding as tsh
from opensora_torch.parallel.context import set_mesh
from opensora_torch.parallel.mesh import MeshConfig, create_mesh, local_batch_size
from opensora_torch.training import diffusion as tdiff
from opensora_torch.utils import optimizer as topt
from opensora_torch.utils.ckpt import CheckpointIO
from opensora_torch.utils.weights import load_numpy_state_dict, mmdit_state_dict
from test_torch_training import _batch, _jax_draws
from torch_multi_process_workers import Processes, run_calls
from torch_parity_utils import one_torch_thread, randomize, t, to_numpy

TOL = 1e-5
UPDATE_TOL = 1e-4
EMA_TOL = 1e-3
CPU = torch.device("cpu")
PROB = 0.5
DEMO = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "configs", "diffusion", "train",
                    "demo.py")
GEOM = dict(in_channels=16, vec_in_dim=32, context_in_dim=64, hidden_size=64, mlp_ratio=2.0,
            num_heads=4, depth=1, depth_single_blocks=1, axes_dim=[4, 6, 6], qkv_bias=True,
            guidance_embed=False, cond_embed=True)
OPT = dict(lr=1e-2, weight_decay=0.1, eps=1e-2, warmup_steps=0, grad_clip=0.05)

_thread = pytest.fixture(autouse=True)(one_torch_thread)


@pytest.fixture(autouse=True)
def _no_mesh():
    yield
    set_mesh(None)
    jcontext.set_mesh(None)


def _mesh(dp, sp, tp):
    return create_mesh(MeshConfig(dp, sp, tp), [CPU] * (dp * sp * tp))


# ----------------------------------------------------------------------
# batch placement: the cases of tests/test_mesh.py:23-67
# ----------------------------------------------------------------------


def test_make_global_batch_placement():
    """Rows on 'data', token dims on 'sp' where they divide, values kept;
    each rank's piece on its device, and each data rank's rows read back."""
    mesh = _mesh(4, 2, 1)
    rng = np.random.default_rng(0)
    batch = {
        "x0": rng.normal(size=(4, 6, 3)).astype(np.float32),
        "txt": rng.normal(size=(4, 8, 5)).astype(np.float32),
        "y_vec": rng.normal(size=(4, 5)).astype(np.float32),
        "guidance": rng.normal(size=(4,)).astype(np.float32),
        "cond": None,
        "odd_tokens": rng.normal(size=(4, 7, 3)).astype(np.float32),
    }
    out = tdata.make_global_batch(mesh, {k: None if v is None else torch.from_numpy(v) for k, v in batch.items()})
    assert out["cond"] is None
    assert out["x0"].spec == ("data", "sp", None)
    assert out["txt"].spec == ("data", "sp", None)
    assert out["y_vec"].spec == ("data", None)
    assert out["guidance"].spec == ("data",)
    assert out["odd_tokens"].spec == ("data", None, None)
    for k in ("x0", "txt", "y_vec", "guidance", "odd_tokens"):
        assert np.array_equal(out[k].full().numpy(), batch[k])
        for d in range(4):
            assert np.array_equal(out[k].rows(d).numpy(), batch[k][d:d + 1])
    assert [tuple(s.shape) for s in out["x0"].shards] == [(1, 3, 3)] * 8
    assert np.array_equal(out["x0"].shards[3].numpy(), batch["x0"][1:2, 3:])  # rank 3 = (data 1, sp 1)
    assert local_batch_size(4, mesh) == 1


def test_make_global_batch_token_fallback():
    out = tdata.make_global_batch(_mesh(4, 2, 1), {"x0": torch.zeros(4, 7, 3)})
    assert out["x0"].spec == ("data", None, None)


def test_make_global_batch_rows_must_divide():
    with pytest.raises(ValueError, match=r"global batch 3 \(key 'x0'\) not divisible by the mesh 'data' axis \(2\)"):
        tdata.make_global_batch(_mesh(2, 1, 1), {"x0": torch.zeros(3, 4, 2)})
    with pytest.raises(ValueError, match="divisible"):
        j_make_global_batch(j_create_mesh(JMeshConfig(2, 1, 1), jax.devices()[:2]), {"x0": np.zeros((3, 4, 2))})


# ----------------------------------------------------------------------
# the sharded train step against JAX's
# ----------------------------------------------------------------------


def _params(seed=7):
    jm = JModel(JConfig(**GEOM, attn_backend="xla", dtype="fp32"))
    z = lambda *s: jnp.zeros(s)  # noqa: E731
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0), z(1, 12, 16), z(1, 12, 3), z(1, 8, 64),
                            z(1, 8, 3), z(1), z(1, 32), z(1, 12, 20), None)
    return randomize(to_numpy(shapes["params"]), seed, scale=0.1)


def _port_state(params, backend="xla", remat=True):
    tm = MMDiTModel(MMDiTConfig(**GEOM, dtype="fp32", attn_backend=backend, remat=remat), device="meta",
                    dtype=torch.float32)
    load_numpy_state_dict(tm, {k: v.copy() for k, v in mmdit_state_dict(params).items()})
    tm.requires_grad_(True)
    return tm, tdiff.TrainState.create(tm, topt.create_optimizer(list(tm.parameters()), **OPT), ema=True)


def _jax_steps(params, batch, sizes, backend, rng, n=2):
    dp, sp, tp = sizes
    jmesh = j_create_mesh(JMeshConfig(dp, sp, tp), jax.devices()[:dp * sp * tp])
    jcontext.set_mesh(jmesh)
    jm = JModel(JConfig(**GEOM, attn_backend=backend, dtype="fp32", remat=True))
    tx = jopt.create_optimizer(**OPT)
    placed = jax.device_put(jax.tree.map(jnp.asarray, params), make_shardings(jmesh, j_specs(params, fsdp=True)))
    state, _ = jdiff.shard_state(jmesh, jdiff.TrainState.create(placed, tx, ema=True), fsdp=True)
    step = jdiff.jit_train_step(jdiff.make_train_step(jm, tx, ema_decay=0.9, text_dropout_prob=PROB,
                                                      use_masked_loss=True), jmesh, state, fsdp=True)
    jbatch = j_make_global_batch(jmesh, batch)
    metrics = []
    for _ in range(n):
        state, m = step(state, jbatch, rng)
        metrics.append({k: float(v) for k, v in m.items()})
    jcontext.set_mesh(None)
    return metrics, mmdit_state_dict(to_numpy(state.params)), mmdit_state_dict(to_numpy(state.ema_params))


def _rel_l2(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


@pytest.mark.parametrize("sizes,backend", [
    ((2, 1, 1), ("xla", "xla")),
    ((4, 1, 1), ("xla", "xla")),
    ((1, 1, 2), ("xla", "xla")),
    ((2, 2, 2), ("ulysses:xla", "ulysses:xla")),
])
def test_sharded_train_step_matches_jax(sizes, backend):
    """Two steps of the full-finetune train step (masked loss, text
    dropout, clip, AdamW with weight decay, EMA) over the same mesh, from
    the same fp32 weights, batch and draws: loss, gradient norm, and each
    parameter's and EMA's change, gathered."""
    params = _params()
    batch = _batch(B=4)
    rng = jax.random.PRNGKey(11)
    j_metrics, j_params, j_ema = _jax_steps(params, batch, sizes, backend[0], rng)

    mesh = _mesh(*sizes)
    set_mesh(mesh)
    tm, state = _port_state(params, backend[1])
    p0 = {k: v.copy() for k, v in mmdit_state_dict(params).items()}
    state = tdiff.shard_state(mesh, state, tm, fsdp=True)
    assert len(state.params) > len(p0) and tm.sharding.dp == sizes[0] and tm.sharding.tp == sizes[2]
    step = tdiff.make_train_step(tm, ema_decay=0.9, text_dropout_prob=PROB, use_masked_loss=True)
    tbatch = {k: t(v) for k, v in batch.items()}
    for i in range(2):
        m = step(state, tbatch, draws=_jax_draws(batch, rng, i, PROB))
        assert float(m["loss"]) == pytest.approx(j_metrics[i]["loss"], rel=TOL), i
        assert float(m["grad_norm"]) == pytest.approx(j_metrics[i]["grad_norm"], rel=TOL), i
    sd = state.state_dict()
    assert sorted(sd["params"]) == sorted(j_params)
    for n, p in sd["params"].items():
        assert _rel_l2(p.numpy() - p0[n], j_params[n] - p0[n]) <= UPDATE_TOL, n
        assert _rel_l2(sd["ema"][n].numpy() - p0[n], j_ema[n] - p0[n]) <= EMA_TOL, n


def _one_step(state, tm, batch, draws):
    step = tdiff.make_train_step(tm, ema_decay=0.9, text_dropout_prob=PROB, use_masked_loss=True)
    return step(state, {k: t(v) for k, v in batch.items()}, draws=draws)


def test_fsdp_moments_are_the_unsharded_moments_slices():
    params, batch = _params(seed=8), _batch(B=4, seed=9)
    draws = _jax_draws(batch, jax.random.PRNGKey(3), 0, PROB)
    tm, ref = _port_state(params)
    _one_step(ref, tm, batch, draws)
    want = ref.optimizer.adamw.state_dict()["state"]
    names = list(ref.params)
    mesh = _mesh(2, 1, 2)
    tm2, state = _port_state(params)
    state = tdiff.shard_state(mesh, state, tm2, fsdp=True)
    _one_step(state, tm2, batch, draws)
    got = state.optimizer.adamw.state_dict()["state"]
    layout = state._layout()
    assert [n for n, _, _ in layout] == names
    cut = 0
    for i, (name, pl, idx) in enumerate(layout):
        cut += len(idx) > 1
        for key in ("exp_avg", "exp_avg_sq"):
            full = want[i][key]
            for n, j in enumerate(idx):
                piece = pl.piece(full, *pl.keys[n][:2])
                scale = float(full.abs().max()) or 1.0
                assert got[j][key].shape == piece.shape, (name, key)
                assert float((got[j][key] - piece).abs().max()) <= 1e-5 * scale, (name, key, n)
    assert cut > 10


def test_checkpoint_crosses_between_sharded_and_unsharded_runs(tmp_path):
    """A sharded state saves the unsharded state's files (gathered): an
    unsharded state loads them, and a sharded state loads an unsharded
    state's; the next step from either equals the uninterrupted one."""
    params, batch = _params(seed=10), _batch(B=4, seed=11)
    draws = [_jax_draws(batch, jax.random.PRNGKey(5), i, PROB) for i in range(2)]
    io = CheckpointIO()
    mesh = _mesh(2, 1, 2)

    tm_s, sharded = _port_state(params)
    sharded = tdiff.shard_state(mesh, sharded, tm_s, fsdp=True)
    _one_step(sharded, tm_s, batch, draws[0])
    ckpt = io.save(str(tmp_path / "sharded"), sharded, 0, 1, 1)
    saved = torch.load(os.path.join(ckpt, "state.pt"), weights_only=False)
    tm_u, unsharded = _port_state(params)
    assert sorted(saved["params"]) == sorted(unsharded.params)
    assert sorted(saved["optimizer"]["adamw"]["state"]) == list(range(len(unsharded.params)))

    io.load(ckpt, unsharded)
    for n, p in unsharded.params.items():
        assert torch.equal(p.detach(), saved["params"][n]) and torch.equal(unsharded.ema[n], saved["ema"][n]), n
    m_u = _one_step(unsharded, tm_u, batch, draws[1])
    m_s = _one_step(sharded, tm_s, batch, draws[1])
    assert float(m_u["loss"]) == pytest.approx(float(m_s["loss"]), rel=TOL)

    back = io.save(str(tmp_path / "unsharded"), unsharded, 0, 2, 2)
    tm_r, resharded = _port_state(_params(seed=12))
    resharded = tdiff.shard_state(mesh, resharded, tm_r, fsdp=True)
    io.load(back, resharded)
    again = resharded.state_dict()
    for n, p in unsharded.params.items():
        assert torch.equal(again["params"][n], p.detach()) and torch.equal(again["ema"][n], unsharded.ema[n]), n
    want = unsharded.optimizer.adamw.state_dict()["state"]
    for i, st in again["optimizer"]["adamw"]["state"].items():
        assert torch.equal(st["exp_avg"], want[i]["exp_avg"]) and torch.equal(st["exp_avg_sq"], want[i]["exp_avg_sq"])
    assert resharded.step == 2 and resharded.optimizer.count == unsharded.optimizer.count


def _own_device_mesh(dp, sp, tp):
    """Each rank on a device of its own, as over the cards of one host: the
    devices are cpu:0, cpu:1, ... (their tensors all live on the CPU, but
    the mesh tells them apart), so a shard that several ranks read gets a
    replica on each rank's device."""
    return create_mesh(MeshConfig(dp, sp, tp), [torch.device("cpu", i) for i in range(dp * sp * tp)])


def test_replicas_on_several_devices_sum_their_gradients_and_count_once(monkeypatch):
    """Over (data 2, tp 2) with every rank on its own device, the replicated
    parameters (norms, row biases, and under tp the embedders and
    modulation) hold one replica per device. Each replica receives its
    ranks' part of the gradient: the step sums them (the DP all-reduce),
    leaves the replicas out of the norm and the clip, and so equals the
    unsharded step, every replica updated alike. Without the sum, or with
    the replicas counted in the norm, the gradient norm moves far off."""
    params, batch = _params(seed=17), _batch(B=4, seed=18)
    draws = _jax_draws(batch, jax.random.PRNGKey(8), 0, PROB)

    def run(mesh):
        tm, st = _port_state(params)
        if mesh is not None:
            set_mesh(mesh)
            st = tdiff.shard_state(mesh, st, tm, fsdp=True)
        m = _one_step(st, tm, batch, draws)
        set_mesh(None)
        return tm, st, float(m["loss"]), float(m["grad_norm"])

    p0 = {k: torch.as_tensor(v.copy()) for k, v in mmdit_state_dict(params).items()}
    _, ref, ref_loss, ref_norm = run(None)
    tm, st, loss, norm = run(_own_device_mesh(2, 1, 2))
    groups = tm.sharding.replicas()
    assert len(groups) > 10 and len(tm.sharding.non_canonical()) == sum(len(g) - 1 for g in groups)
    for pl in tm.sharding.placements.values():
        for shard in {k[:2] for k in pl.keys}:
            devices = [k[2] for k in pl.keys if k[:2] == shard]
            assert len(set(devices)) == len(devices)
    for g in groups:
        assert all(torch.equal(p.detach(), g[0].detach()) for p in g[1:])
    assert loss == pytest.approx(ref_loss, rel=TOL) and norm == pytest.approx(ref_norm, rel=TOL)
    sd, want = st.state_dict(), ref.state_dict()
    for n, p in sd["params"].items():
        assert _rel_l2(p.numpy() - p0[n].numpy(), want["params"][n].numpy() - p0[n].numpy()) <= UPDATE_TOL, n
        assert _rel_l2(sd["ema"][n].numpy() - p0[n].numpy(), want["ema"][n].numpy() - p0[n].numpy()) <= UPDATE_TOL, n

    with monkeypatch.context() as m:
        m.setattr(tsh.ModelSharding, "sync_replica_grads", lambda self: None)
        unsummed = run(_own_device_mesh(2, 1, 2))[3]
    with monkeypatch.context() as m:
        m.setattr(tsh.ModelSharding, "non_canonical", lambda self: set())
        counted = run(_own_device_mesh(2, 1, 2))[3]
    for wrong in (unsummed, counted):
        assert abs(wrong - ref_norm) > 100 * TOL * ref_norm, (ref_norm, unsummed, counted)


def _summed_gradients(losses):
    """The global loss's value, with the gradient of the data ranks' sum."""
    stacked = torch.stack(losses)
    return stacked.mean().detach() + (stacked.sum() - stacked.sum().detach())


def test_known_wrong_data_parallel_variants_fail(monkeypatch):
    """One data rank's rows used twice, and FSDP gradients summed over the
    data ranks without the division by dp: each moves the loss or the
    gradient norm far outside the tolerance of the right step."""
    params, batch = _params(seed=13), _batch(B=4, seed=14)
    draws = _jax_draws(batch, jax.random.PRNGKey(6), 0, PROB)
    mesh = _mesh(2, 1, 1)

    def run():
        tm, st = _port_state(params)
        st = tdiff.shard_state(mesh, st, tm, fsdp=True)
        m = _one_step(st, tm, batch, draws)
        return float(m["loss"]), float(m["grad_norm"])

    right = run()
    with monkeypatch.context() as m:
        m.setattr(tdata, "row_slice", lambda n, dp, d: slice(0, n // dp))
        twice = run()
    with monkeypatch.context() as m:
        m.setattr(tdiff, "data_mean", _summed_gradients)
        undivided = run()
    assert abs(twice[0] - right[0]) > 100 * TOL * abs(right[0]), (right, twice)
    assert abs(undivided[1] - right[1]) > 100 * TOL * abs(right[1]), (right, undivided)


def test_trainer_with_a_data_and_tp_mesh_takes_the_unsharded_step():
    """Trainer(mesh=...) over (data 2, tp 2) shards the model, the moments
    and the EMA (FSDP) and places each batch; loading the unsharded
    trainer's saved state (resharded), its step equals the trainer's
    without a mesh: loss, gradient norm, and the parameters gathered. The
    training CLI's mesh is None on the CPU."""
    from opensora_torch.train import Trainer, train_mesh
    from opensora_torch.utils.config import parse_configs

    rng = np.random.default_rng(0)
    batch = {"video_latents": rng.standard_normal((2, 4, 2, 4, 4)).astype(np.float32),
             "text_t5": rng.standard_normal((2, 8, 64)).astype(np.float32),
             "text_clip": rng.standard_normal((2, 32)).astype(np.float32)}
    cfg = parse_configs([DEMO, "--cached_video", "True"])
    assert train_mesh(cfg, "cpu") is None
    runs, saved = [], None
    for mesh in (None, _mesh(2, 1, 2)):
        trainer = Trainer(cfg, "cpu", mesh=mesh)
        assert (trainer.state.sharding is not None) == (mesh is not None)
        if saved is None:
            saved = copy.deepcopy(trainer.state.state_dict())
        else:
            assert sorted(trainer.state.ema) == sorted(trainer.state.params)
            trainer.state.load_state_dict(saved)
        metrics = trainer.run_batch(batch)
        sd = trainer.state.state_dict()
        runs.append((float(metrics["loss"]), float(metrics["grad_norm"]), sd["params"]))
        set_mesh(None)
    (l0, g0, w0), (l1, g1, w1) = runs
    assert l1 == pytest.approx(l0, rel=TOL) and g1 == pytest.approx(g0, rel=TOL)
    assert sorted(w0) == sorted(w1)
    assert max(float((w1[n] - w0[n]).abs().max()) for n in w0) <= 1e-6


def test_state_shardings_give_moments_and_ema_their_parameters_specs():
    """The counterparts of JAX's state_shardings / match_opt_shardings:
    the EMA and each AdamW moment take their parameter's spec (matched by
    position and shape), the step is replicated."""
    params, batch = _params(seed=15), _batch(B=4, seed=16)
    tm, state = _port_state(params)
    _one_step(state, tm, batch, _jax_draws(batch, jax.random.PRNGKey(7), 0, PROB))
    specs = tdiff.state_shardings(_mesh(2, 1, 2), state, fsdp=True)
    names = list(state.params)
    assert specs["step"] == () and specs["ema"] == specs["params"] == tsh.mmdit_param_specs(tm, fsdp=True)
    # one data rank: every 'data' dim stays whole
    whole = tdiff.state_shardings(_mesh(1, 1, 2), state, fsdp=True)["params"]
    assert not any("data" in s for s in whole.values()) and whole["double_blocks.0.img_attn.qkv.weight"] == ("tp", None)
    assert sorted(specs["optimizer"]) == list(range(len(names)))
    for i, entry in specs["optimizer"].items():
        assert entry["exp_avg"] == entry["exp_avg_sq"] == specs["params"][names[i]], names[i]
        assert entry["step"] == ()
    assert specs["params"]["double_blocks.0.img_attn.qkv.weight"] == ("tp", "data")


def test_training_cli_names_the_queued_slices(tmp_path, monkeypatch):
    from opensora_torch.parallel.distributed import ENV
    from opensora_torch.parallel.mesh import create_pp_mesh
    from opensora_torch.train import Trainer, main
    from opensora_torch.utils.config import parse_configs

    for name in ENV:
        monkeypatch.delenv(name, raising=False)

    # LoRA runs over a data / tp mesh (tests/test_torch_lora_sharded.py);
    # pipeline + lora_config raises, as the JAX script does
    lora = tmp_path / "lora.py"
    lora.write_text(f"_base_ = [{DEMO!r}]\nlora_config = dict(r=4)\ncached_video = True\n"
                    "pipeline = dict(pp_size=2, data_size=1)\n")
    with pytest.raises(NotImplementedError, match=r"pipeline \+ lora_config"):
        main([str(lora), "--device", "cpu"])
    with pytest.raises(NotImplementedError, match=r"pipeline \+ lora_config"):
        Trainer(parse_configs([str(lora)]), "cpu", mesh=create_pp_mesh(2, 1, 1, [CPU, CPU]))

    # multi_host is ported for every axis across processes: in two processes
    # Mesh((1, 1, 2), processes=[0, 1]) and a pipeline with one stage a
    # process build, and the tp group's step holds against one process's
    # over the same mesh of logical ranks; multi_host outside torchrun names
    # its variables
    params, batch = _params(), _batch(B=4)
    procs = Processes(run_calls, [("spanning_meshes", (), {}),
                                  ("sharded_steps", (params, batch, GEOM, OPT, (1, 1, 2)), dict(seed=5, n_steps=1))])
    mesh = _mesh(1, 1, 2)
    set_mesh(mesh)
    tm, state = _port_state(params)
    state = tdiff.shard_state(mesh, state, tm, fsdp=True)
    step = tdiff.make_train_step(tm, ema_decay=0.9, text_dropout_prob=PROB, use_masked_loss=True)
    ref = {k: float(v) for k, v in step(state, {k: torch.from_numpy(v) for k, v in batch.items()},
                                         generator=torch.Generator().manual_seed(5)).items()}
    ref_params = state.state_dict()["params"]
    set_mesh(None)
    results = procs.results()
    for p, (meshes, out) in enumerate(results):
        assert meshes["tp"] == "Mesh({'data': 1, 'sp': 1, 'tp': 2}, 2 ranks on cpu in 2 processes)"
        assert meshes["tp_ranks"] == [p] and meshes["tp_processes"] == 2
        assert "'pp': 2" in meshes["pp"] and meshes["pp_stages"] == [p]
        for k in ("loss", "grad_norm"):
            assert out["metrics"][0][k] == pytest.approx(ref[k], rel=1e-6), k
        assert out["tp_remote"][0]["all_reduces"] > 0
    p0, got = mmdit_state_dict(params), results[0][1]["state"]["params"]
    for n, want in ref_params.items():
        assert _rel_l2(got[n].numpy() - p0[n], want.numpy() - p0[n]) <= 1e-5, n
    cfg = tmp_path / "multi_host.py"
    cfg.write_text(f"_base_ = [{DEMO!r}]\nmulti_host = True\n")
    with pytest.raises(RuntimeError, match="RANK, WORLD_SIZE, LOCAL_RANK, LOCAL_WORLD_SIZE, MASTER_ADDR, MASTER_PORT "
                                           "not set"):
        main([str(cfg), "--device", "cpu"])
