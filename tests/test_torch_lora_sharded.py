"""LoRA training of the port over a sharded mesh of logical CPU ranks
(training/lora.py on parallel/sharding.py: the frozen base cut by the TP +
FSDP rules, the factors replicated) against the JAX package's LoRA step on
the same mesh of its virtual CPU devices (``make_train_step(lora_scale=)``
+ ``jit_train_step(frozen_shardings=)``, as scripts/diffusion/train.py:
245-254 runs it), from the same numpy base weights and factors (B nonzero,
so the merge moves the forward), batch and draws.

Tolerances, fp32 on both sides, those of tests/test_torch_data_parallel.py:
``TOL`` for the loss and the gradients' global norm, ``UPDATE_TOL`` in
relative L2 for each factor's change over two steps (the same fp32
products summed in other orders). A known-wrong factor cut (lora_B's rows
cut contiguously where the weight's fused rows are cut per segment, as
chip_smoke.py's phase-25 control does) must exceed them. Factor
checkpoints cross between a sharded and an unsharded LoRA state bitwise.
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
from opensora_tpu.training import lora as jlora
from opensora_tpu.utils import optimizer as jopt

from opensora_torch.models.mmdit.model import MMDiTConfig, MMDiTModel
from opensora_torch.parallel.context import get_scope, set_mesh
from opensora_torch.training import diffusion as tdiff
from opensora_torch.training import lora as tlora
from opensora_torch.utils import optimizer as topt
from opensora_torch.utils.ckpt import CheckpointIO
from opensora_torch.utils.weights import load_numpy_state_dict, lora_state_dict, mmdit_state_dict
from test_torch_data_parallel import DEMO, GEOM, OPT, PROB, TOL, UPDATE_TOL, _mesh, _params, _rel_l2
from test_torch_training import _batch, _jax_draws
from torch_parity_utils import one_torch_thread, to_numpy

RANK = 4
SCALE = 2.0
MESHES = [(2, 1, 1), (1, 1, 2), (2, 1, 2)]

_thread = pytest.fixture(autouse=True)(one_torch_thread)


@pytest.fixture(autouse=True)
def _no_mesh():
    yield
    set_mesh(None)
    jcontext.set_mesh(None)


def lora_inputs(seed=7):
    """Base params, a JAX factor tree with nonzero B, and a batch."""
    params = _params(seed=seed)
    tree = to_numpy(jlora.init_lora_params(params, jax.random.PRNGKey(0), rank=RANK))
    rng = np.random.default_rng(seed + 1)
    factors = jax.tree.map(lambda x: rng.standard_normal(x.shape).astype(np.float32) * 0.1, tree)
    return params, factors, _batch(B=4, seed=seed + 2)


def port_lora_state(params, factors):
    """The port's MMDiT on the base params with the factors loaded, and its
    factor-only train state (no EMA)."""
    tm = MMDiTModel(MMDiTConfig(**GEOM, dtype="fp32", attn_backend="xla", remat=True), device="meta",
                    dtype=torch.float32)
    load_numpy_state_dict(tm, {k: v.copy() for k, v in mmdit_state_dict(params).items()})
    tlora.apply_lora(tm, rank=RANK, scale=SCALE)
    missing, unexpected = tm.load_state_dict({k: torch.from_numpy(v.copy())
                                              for k, v in lora_state_dict(factors).items()}, strict=False)
    assert not unexpected and not [m for m in missing if "lora_" in m]
    opt = topt.create_optimizer([p for p in tm.parameters() if p.requires_grad], **OPT)
    return tm, tdiff.TrainState.create(tm, opt, ema=False)


def jax_lora_steps(params, factors, batch, sizes, rng, n=2):
    dp, sp, tp = sizes
    jmesh = j_create_mesh(JMeshConfig(dp, sp, tp), jax.devices()[:dp * sp * tp])
    jcontext.set_mesh(jmesh)
    jm = JModel(JConfig(**GEOM, attn_backend="xla", dtype="fp32", remat=True))
    tx = jopt.create_optimizer(**OPT)
    frozen_shardings = make_shardings(jmesh, j_specs(params, fsdp=True))
    frozen = jax.device_put(jax.tree.map(jnp.asarray, params), frozen_shardings)
    state, _ = jdiff.shard_state(jmesh, jdiff.TrainState.create(jax.tree.map(jnp.asarray, factors), tx, ema=False),
                                 fsdp=True)
    step = jdiff.jit_train_step(
        jdiff.make_train_step(jm, tx, ema_decay=0.9, text_dropout_prob=PROB, use_masked_loss=True, lora_scale=SCALE),
        jmesh, state, fsdp=True, frozen_shardings=frozen_shardings)
    jbatch = j_make_global_batch(jmesh, batch)
    metrics = []
    for _ in range(n):
        state, m = step(state, jbatch, rng, frozen)
        metrics.append({k: float(v) for k, v in m.items()})
    jcontext.set_mesh(None)
    return metrics, lora_state_dict(to_numpy(state.params))


def port_lora_steps(params, factors, batch, sizes, draws):
    """The port's LoRA steps over ``sizes`` (None: unsharded): metrics and
    the factors (gathered)."""
    tm, state = port_lora_state(params, factors)
    if sizes is not None:
        mesh = _mesh(*sizes)
        set_mesh(mesh)
        state = tdiff.shard_state(mesh, state, tm, fsdp=True)
    step = tdiff.make_train_step(tm, ema_decay=0.9, text_dropout_prob=PROB, use_masked_loss=True)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    metrics = [{k: float(v) for k, v in step(state, tb, draws=d).items()} for d in draws]
    set_mesh(None)
    return metrics, state, tm


def _worst_change(got, want, start) -> float:
    return max(_rel_l2(np.asarray(got[n]) - start[n], np.asarray(want[n]) - start[n]) for n in want)


_right_factors = tlora.rank_factors


def _contiguous_b(placement, a, b):
    """Known-wrong: lora_B's rows cut as one contiguous block per rank where
    the weight's fused rows are cut per segment."""
    if placement.tp_dim == 0:
        return a, b.chunk(placement.sharding.tp, 0)[get_scope()[1]]
    return _right_factors(placement, a, b)


@pytest.mark.parametrize("sizes", MESHES, ids=lambda s: "x".join(map(str, s)))
def test_sharded_lora_step_matches_jax(sizes):
    """Two LoRA steps (masked loss, text dropout, clip, AdamW with weight
    decay, no EMA) over the same mesh: the loss, the norm, and each
    factor's change, gathered; the base is sharded (FSDP and TP), the
    factors replicated, and only the factors are trained."""
    params, factors, batch = lora_inputs()
    rng = jax.random.PRNGKey(11)
    j_metrics, j_factors = jax_lora_steps(params, factors, batch, sizes, rng)
    draws = [_jax_draws(batch, rng, i, PROB) for i in range(2)]
    metrics, state, tm = port_lora_steps(params, factors, batch, sizes, draws)
    for i in range(2):
        assert metrics[i]["loss"] == pytest.approx(j_metrics[i]["loss"], rel=TOL), i
        assert metrics[i]["grad_norm"] == pytest.approx(j_metrics[i]["grad_norm"], rel=TOL), i
    placements = tm.sharding.placements
    assert all(pl.spec == (None, None) and pl.dtype == torch.float32 for n, pl in placements.items()
               if "lora_" in n)
    qkv = placements["double_blocks.0.img_attn.qkv.weight"]
    assert qkv.leaves[0].shape == (qkv.shape[0] // sizes[2], qkv.shape[1] // sizes[0])
    assert not any(p.requires_grad for n, pl in placements.items() if "lora_" not in n for p in pl.leaves)
    sd = state.state_dict()
    assert sd["ema"] is None and sorted(sd["params"]) == sorted(j_factors)
    start = lora_state_dict(factors)
    assert _worst_change({n: p.numpy() for n, p in sd["params"].items()}, j_factors, start) <= UPDATE_TOL


def test_known_wrong_factor_cut_fails(monkeypatch):
    """Over (1, 1, 2), lora_B cut as one contiguous block per tp rank (the
    fused qkv / linear1 rows are cut per segment): the loss, the norm and
    the factors' change move far outside the limits of the right cut."""
    params, factors, batch = lora_inputs(seed=9)
    draws = [_jax_draws(batch, jax.random.PRNGKey(4), i, PROB) for i in range(2)]
    ref, ref_state, _ = port_lora_steps(params, factors, batch, None, draws)
    want = {n: p.detach().numpy() for n, p in ref_state.params.items()}
    start = lora_state_dict(factors)
    right, state, _ = port_lora_steps(params, factors, batch, (1, 1, 2), draws)
    got = {n: p.numpy() for n, p in state.state_dict()["params"].items()}
    assert right[0]["loss"] == pytest.approx(ref[0]["loss"], rel=TOL)
    assert _worst_change(got, want, start) <= UPDATE_TOL
    monkeypatch.setattr(tlora, "rank_factors", _contiguous_b)
    wrong, state, _ = port_lora_steps(params, factors, batch, (1, 1, 2), draws)
    got = {n: p.numpy() for n, p in state.state_dict()["params"].items()}
    assert abs(wrong[0]["loss"] - ref[0]["loss"]) > 100 * TOL * abs(ref[0]["loss"]), (wrong, ref)
    assert _worst_change(got, want, start) > 100 * UPDATE_TOL


def test_lora_checkpoint_crosses_between_sharded_and_unsharded(tmp_path):
    """The sharded LoRA state saves the unsharded state's factors and
    moments (gathered): an unsharded LoRA state loads them bitwise, and a
    sharded state loads the unsharded one's bitwise; the next step from
    either equals the other's."""
    params, factors, batch = lora_inputs(seed=10)
    draws = [_jax_draws(batch, jax.random.PRNGKey(5), i, PROB) for i in range(2)]
    io = CheckpointIO()
    _, sharded, tm_s = port_lora_steps(params, factors, batch, (2, 1, 2), draws[:1])
    ckpt = io.save(str(tmp_path / "sharded"), sharded, 0, 1, 1)
    saved = torch.load(os.path.join(ckpt, "state.pt"), weights_only=False)
    tm_u, unsharded = port_lora_state(params, factors)
    assert saved["ema"] is None and sorted(saved["params"]) == sorted(unsharded.params)
    io.load(ckpt, unsharded)
    for n, p in unsharded.params.items():
        assert torch.equal(p.detach(), saved["params"][n]), n
    step = tdiff.make_train_step(tm_u, ema_decay=0.9, text_dropout_prob=PROB, use_masked_loss=True)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    m_u = step(unsharded, tb, draws=draws[1])
    set_mesh(tm_s.sharding.mesh)
    m_s = tdiff.make_train_step(tm_s, ema_decay=0.9, text_dropout_prob=PROB, use_masked_loss=True)(
        sharded, tb, draws=draws[1])
    set_mesh(None)
    assert float(m_u["loss"]) == pytest.approx(float(m_s["loss"]), rel=TOL)

    back = io.save(str(tmp_path / "unsharded"), unsharded, 0, 2, 2)
    tm_r, resharded = port_lora_state(*lora_inputs(seed=12)[:2])
    resharded = tdiff.shard_state(_mesh(2, 1, 2), resharded, tm_r, fsdp=True)
    io.load(back, resharded)
    again, want = resharded.state_dict(), unsharded.state_dict()
    for n, p in want["params"].items():
        assert torch.equal(again["params"][n], p), n
    for i, st in again["optimizer"]["adamw"]["state"].items():
        ref = want["optimizer"]["adamw"]["state"][i]
        assert torch.equal(st["exp_avg"], ref["exp_avg"]) and torch.equal(st["exp_avg_sq"], ref["exp_avg_sq"])
    assert resharded.step == 2 and resharded.optimizer.count == unsharded.optimizer.count


def test_trainer_lora_over_a_mesh_takes_the_unsharded_step(tmp_path):
    """Trainer(mesh=...) with a lora_config over (data 2, tp 2) shards the
    frozen base and replicates the factors (no EMA); from the unsharded
    LoRA trainer's state (the factors drawn from the same seed), its step
    equals the trainer's without a mesh: the loss, the norm, the factors;
    only pipeline + lora_config still raises."""
    from opensora_torch.train import Trainer
    from opensora_torch.parallel.mesh import create_pp_mesh
    from opensora_torch.utils.config import parse_configs

    cfg_path = tmp_path / "lora.py"
    cfg_path.write_text(f"_base_ = [{DEMO!r}]\nlora_config = dict(r=4, lora_alpha=8)\ncached_video = True\n"
                        "warmup_steps = 0\nlr = 1e-2\nadam_eps = 1e-2\n")
    cfg = parse_configs([str(cfg_path)])
    rng = np.random.default_rng(0)
    batch = {"video_latents": rng.standard_normal((2, 4, 2, 4, 4)).astype(np.float32),
             "text_t5": rng.standard_normal((2, 8, 64)).astype(np.float32),
             "text_clip": rng.standard_normal((2, 32)).astype(np.float32)}
    runs, saved = [], None
    for mesh in (None, _mesh(2, 1, 2)):
        trainer = Trainer(cfg, "cpu", mesh=mesh)
        assert trainer.state.ema is None and all("lora_" in n for n in trainer.state.params)
        assert (trainer.state.sharding is not None) == (mesh is not None)
        if saved is None:
            trainer.run_batch(batch)  # B moves off zero: the next step's merge is seen
            saved = copy.deepcopy(trainer.state.state_dict())
            rng_states = trainer.gen.get_state(), copy.deepcopy(trainer.host_rng.bit_generator.state)
        else:
            trainer.state.load_state_dict(saved)
            trainer.gen.set_state(rng_states[0])
            trainer.host_rng.bit_generator.state = rng_states[1]
        metrics = trainer.run_batch(batch)
        runs.append((float(metrics["loss"]), float(metrics["grad_norm"]), trainer.state.state_dict()["params"]))
        set_mesh(None)
    (l0, g0, w0), (l1, g1, w1) = runs
    assert l1 == pytest.approx(l0, rel=TOL) and g1 == pytest.approx(g0, rel=TOL)
    assert sorted(w0) == sorted(w1)
    for n in w0:
        change = w0[n] - saved["params"][n]
        assert _rel_l2((w1[n] - saved["params"][n]).numpy(), change.numpy()) <= UPDATE_TOL, n
    with pytest.raises(NotImplementedError, match="pipeline \\+ lora_config"):
        Trainer(cfg, "cpu", mesh=create_pp_mesh(2, 1, 1, [torch.device("cpu")] * 2))


def test_factors_on_ranks_with_devices_of_their_own_are_summed_and_counted_once(monkeypatch):
    """Over (data 2, tp 2) with every rank on a device of its own (cpu:0..3:
    the mesh tells them apart), each factor has a replica per device, each
    receiving its ranks' part of the gradient: the step sums them and
    counts one replica in the norm and the clip, so it equals the unsharded
    step; with the replicas counted, the norm moves far off."""
    from opensora_torch.parallel import sharding as tsh
    from test_torch_data_parallel import _own_device_mesh

    params, factors, batch = lora_inputs(seed=13)
    draws = [_jax_draws(batch, jax.random.PRNGKey(6), 0, PROB)]
    ref, ref_state, _ = port_lora_steps(params, factors, batch, None, draws)
    want = {n: p.detach().numpy() for n, p in ref_state.params.items()}

    def run():
        tm, state = port_lora_state(params, factors)
        mesh = _own_device_mesh(2, 1, 2)
        set_mesh(mesh)
        state = tdiff.shard_state(mesh, state, tm, fsdp=True)
        step = tdiff.make_train_step(tm, ema_decay=0.9, text_dropout_prob=PROB, use_masked_loss=True)
        m = step(state, {k: torch.from_numpy(v) for k, v in batch.items()}, draws=draws[0])
        set_mesh(None)
        return tm, state, float(m["loss"]), float(m["grad_norm"])

    tm, state, loss, norm = run()
    factor_leaves = [pl.leaves for n, pl in tm.sharding.placements.items() if "lora_" in n]
    assert all(len(leaves) == 4 for leaves in factor_leaves)
    assert loss == pytest.approx(ref[0]["loss"], rel=TOL) and norm == pytest.approx(ref[0]["grad_norm"], rel=TOL)
    got = {n: p.numpy() for n, p in state.state_dict()["params"].items()}
    assert _worst_change(got, want, lora_state_dict(factors)) <= UPDATE_TOL
    for leaves in factor_leaves:
        assert all(torch.equal(p.detach(), leaves[0].detach()) for p in leaves[1:])
    with monkeypatch.context() as m:
        m.setattr(tsh.ModelSharding, "non_canonical", lambda self: set())
        counted = run()[3]
    assert abs(counted - ref[0]["grad_norm"]) > 100 * TOL * ref[0]["grad_norm"]
