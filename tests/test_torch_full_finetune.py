"""Full finetuning of the MMDiT in the port: fp32 master weights under bf16
compute, against the JAX package's train step on the CPU with the same
numpy weights, batch and ``jax.random`` draws; ``remat_policy="offload"``
against "full"; checkpoint resume; the trainer's default.

Tolerances:
- exact: fp32 masters computing in bf16 against a bf16 copy of the same
  weights (the cast at use rounds each weight as the copy does), "offload"
  against "full" (the same recompute; only where the saved inputs wait
  differs) and a resumed step against the uninterrupted one;
- ``BF16_TOL`` = 1e-2 relative for the loss and the gradients' global norm,
  and ``UPDATE_TOL`` = 5e-2 in relative L2 for each parameter's and EMA's
  change since the start, against the JAX step: both compute in bf16, and
  XLA on the CPU keeps fused elementwise chains in fp32 where torch rounds
  each op's output to bf16, so the two differ by bf16 roundings (2^-8 each)
  carried through the forward and backward of a 1 + 1-block model
  (measured worst: loss 7e-4, gradient norm 2.5e-3, a change 1.6e-2).
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from opensora_tpu.models.mmdit.model import MMDiTConfig as JConfig
from opensora_tpu.models.mmdit.model import MMDiTModel as JModel
from opensora_tpu.training import diffusion as jdiff
from opensora_tpu.utils import optimizer as jopt

from opensora_torch.models.mmdit.model import Flux, MMDiTConfig, MMDiTModel
from opensora_torch.training import diffusion as tdiff
from opensora_torch.utils import optimizer as topt
from opensora_torch.utils.ckpt import CheckpointIO
from opensora_torch.utils.weights import load_numpy_state_dict, mmdit_state_dict
from test_torch_training import GEOM, _batch, _jax_draws
from torch_parity_utils import randomize, t, to_numpy

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), os.pardir))
BF16_TOL = 1e-2
UPDATE_TOL = 5e-2
PROB = 0.5


def _jax_params(seed=7, **kw):
    jm = JModel(JConfig(**GEOM, attn_backend="xla", dtype="bf16", param_dtype="fp32", **kw))
    z = lambda *s: jnp.zeros(s)  # noqa: E731
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0), z(1, 12, 16), z(1, 12, 3), z(1, 8, 64),
                            z(1, 8, 3), z(1), z(1, 32), z(1, 12, 20), None)
    params = randomize(to_numpy(shapes["params"]), seed, scale=0.1)
    assert all(v.dtype == np.float32 for v in jax.tree.leaves(params))
    return jm, params


def _port_model(params, **kw) -> MMDiTModel:
    """The tiny MMDiT with fp32 masters computing in bf16, all trainable, on
    copies of ``params`` (a meta module takes the arrays' memory as its own,
    and the steps update it in place)."""
    tm = MMDiTModel(MMDiTConfig(**GEOM, dtype="bf16", param_dtype="fp32", **kw), device="meta",
                    dtype=torch.float32, compute_dtype=torch.bfloat16)
    load_numpy_state_dict(tm, {k: v.copy() for k, v in mmdit_state_dict(params).items()})
    return tm.requires_grad_(True)


def _port_state(tm, opt_kw):
    opt = topt.create_optimizer(list(tm.parameters()), **opt_kw)
    return tdiff.TrainState.create(tm, opt, ema=True)


@pytest.fixture
def without_onednn():
    """The bitwise comparisons run without oneDNN: its bf16 CPU kernels are
    not bitwise repeatable from run to run (seen at the trainer's size)."""
    with torch.backends.mkldnn.flags(enabled=False):
        yield


def _rel_l2(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def test_fp32_masters_compute_what_a_bf16_copy_computes():
    """Every float parameter stays fp32 and the model computes in bf16: its
    output equals, bitwise, that of a bf16 model holding the masters
    rounded to bf16. Inference keeps its bf16 weights: ``Flux`` without
    ``param_dtype`` builds them in the compute dtype."""
    _, params = _jax_params()
    tm = _port_model(params)
    assert {p.dtype for p in tm.parameters()} == {torch.float32} and tm.dtype == torch.bfloat16
    ref = MMDiTModel(MMDiTConfig(**GEOM, dtype="bf16"), device="meta", dtype=torch.bfloat16)
    load_numpy_state_dict(ref, mmdit_state_dict(params))
    assert ref.dtype == torch.bfloat16
    b = {k: t(v) for k, v in _batch().items()}
    inputs = dict(img=b["x0"], img_ids=b["img_ids"], txt=b["txt"], txt_ids=b["txt_ids"],
                  timesteps=torch.tensor([0.3, 0.8]), y_vec=b["y_vec"], cond=b["cond"])
    with torch.no_grad():
        out, want = tm(**inputs), ref(**inputs)
    assert out.dtype == torch.bfloat16 and torch.equal(out, want)

    served = Flux(**GEOM, dtype="bf16", device="meta")
    assert {p.dtype for p in served.parameters()} == {torch.bfloat16} and served.dtype == torch.bfloat16
    masters = Flux(**GEOM, dtype="bf16", param_dtype="fp32", device="meta")
    assert {p.dtype for p in masters.parameters()} == {torch.float32} and masters.dtype == torch.bfloat16


def test_checkpoint_loads_into_fp32_masters_cast(tmp_path):
    """``from_pretrained`` into an fp32-master model: the file's bf16 values,
    cast to fp32, exactly."""
    from opensora_torch.utils.safetensors_io import save_file

    _, params = _jax_params(seed=3)
    sd = {k: torch.from_numpy(np.ascontiguousarray(v)).to(torch.bfloat16) for k, v in mmdit_state_dict(params).items()}
    path = str(tmp_path / "mmdit.safetensors")
    save_file(sd, path)
    model = Flux(from_pretrained=path, **GEOM, dtype="bf16", param_dtype="fp32", device="cpu")
    own = model.state_dict()
    assert sorted(own) == sorted(sd)
    for k, v in sd.items():
        assert own[k].dtype == torch.float32 and torch.equal(own[k], v.float()), k


@pytest.mark.parametrize("remat_policy,jax_policy,opt_kw", [
    ("dots", "dots", dict(lr=1e-2, weight_decay=0.1, eps=1e-2, warmup_steps=0, grad_clip=0.05)),
    # the JAX package's "offload" names host memory, which its CPU backend
    # has not; its "full" recomputes the same values. Warmup: the first
    # update has lr = 0
    ("offload", "full", dict(lr=1e-2, weight_decay=0.1, eps=1e-2, warmup_steps=1, grad_clip=0.05)),
    # two accumulated steps a update, the clip on the mean gradient
    ("full", "full", dict(lr=1e-2, weight_decay=0.1, eps=1e-2, warmup_steps=0, grad_clip=0.05,
                          accumulation_steps=2)),
])
def test_full_finetune_two_steps_match_jax(remat_policy, jax_policy, opt_kw):
    """Two train steps from the same fp32 weights, batch and draws: after
    each, the loss and gradient norm, the fp32 parameters after clip +
    AdamW (warmup, accumulation, weight decay as optax applies them) and
    the fp32 EMA."""
    jm, params = _jax_params(remat=True, remat_policy=jax_policy)
    batch = _batch()
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    rng = jax.random.PRNGKey(11)
    tx = jopt.create_optimizer(**opt_kw)
    jstate = jdiff.TrainState.create(jax.tree.map(jnp.asarray, params), tx, ema=True)
    jstep = jax.jit(jdiff.make_train_step(jm, tx, ema_decay=0.9, text_dropout_prob=PROB, use_masked_loss=True))

    tm = _port_model(params, remat=True, remat_policy=remat_policy)
    state = _port_state(tm, opt_kw)
    step = tdiff.make_train_step(tm, ema_decay=0.9, text_dropout_prob=PROB, use_masked_loss=True)
    p0 = {n: p.detach().clone() for n, p in state.params.items()}
    tbatch = {k: t(v) for k, v in batch.items()}
    first_frozen = opt_kw["warmup_steps"] > 0 or opt_kw.get("accumulation_steps", 1) > 1
    for i in range(2):
        jstate, jmetrics = jstep(jstate, jbatch, rng)
        metrics = step(state, tbatch, draws=_jax_draws(batch, rng, i, PROB))
        assert float(metrics["loss"]) == pytest.approx(float(jmetrics["loss"]), rel=BF16_TOL), i
        assert float(metrics["grad_norm"]) == pytest.approx(float(jmetrics["grad_norm"]), rel=BF16_TOL), i
        want_p = mmdit_state_dict(to_numpy(jstate.params))
        want_e = mmdit_state_dict(to_numpy(jstate.ema_params))
        assert sorted(state.params) == sorted(want_p)
        for n, p in state.params.items():
            assert p.dtype == torch.float32 and state.ema[n].dtype == torch.float32
            d_want = want_p[n] - p0[n].numpy()
            if not d_want.any():  # no update yet (lr = 0, or an accumulating step): both still equal
                assert torch.equal(p.detach(), p0[n]), (i, n)
                continue
            assert _rel_l2(p.detach().numpy() - p0[n].numpy(), d_want) <= UPDATE_TOL, (i, n)
            assert _rel_l2(state.ema[n].numpy() - p0[n].numpy(), want_e[n] - p0[n].numpy()) <= UPDATE_TOL, (i, n)
        moved = [n for n, p in state.params.items() if not torch.equal(p.detach(), p0[n])]
        # the first step moves nothing under warmup (lr = 0) or accumulation
        assert bool(moved) == (i == 1 or not first_frozen), i
    assert state.step == 2 and state.optimizer.count == (1 if opt_kw.get("accumulation_steps") else 2)


def test_remat_offload_equals_full_bitwise(monkeypatch, without_onednn):
    """One step with "offload" from the same state, batch and draws as one
    with "full": loss, gradient norm, parameters and EMA bitwise equal, and
    every block's saved inputs went through the host-memory hooks."""
    _, params = _jax_params(seed=9)
    batch = {k: t(v) for k, v in _batch(seed=10).items()}
    draws = _jax_draws(_batch(seed=10), jax.random.PRNGKey(4), 0, PROB)
    opt_kw = dict(lr=1e-2, weight_decay=0.1, eps=1e-8, warmup_steps=0, grad_clip=1.0)
    packed = []
    real = torch.autograd.graph.save_on_cpu

    class counting(real):
        def __init__(self, pin_memory=False, device_type="cuda"):
            super().__init__(pin_memory, device_type)
            pack = self.pack_hook

            def count(x):
                packed.append(tuple(x.shape))
                return pack(x)

            self.pack_hook = count

    monkeypatch.setattr(torch.autograd.graph, "save_on_cpu", counting)
    out = {}
    for policy in ("full", "offload"):
        tm = _port_model(params, remat=True, remat_policy=policy)
        state = _port_state(tm, opt_kw)
        metrics = tdiff.make_train_step(tm, ema_decay=0.9, text_dropout_prob=PROB, use_masked_loss=True)(
            state, batch, draws=draws)
        out[policy] = (metrics, state)
        if policy == "full":
            assert not packed
    (mf, sf), (mo, so) = out["full"], out["offload"]
    assert torch.equal(mf["loss"], mo["loss"]) and torch.equal(mf["grad_norm"], mo["grad_norm"])
    for n, p in sf.params.items():
        assert torch.equal(p, so.params[n]) and torch.equal(sf.ema[n], so.ema[n]), n
    # the double block's (img, txt, vec) and the single block's (x, vec); the
    # RoPE tables, one (cos, sin) pair that every block shares, stay put
    b, n_img, n_txt = batch["x0"].shape[0], batch["x0"].shape[1], batch["txt"].shape[1]
    assert packed == [(b, n_img, 64), (b, n_txt, 64), (b, 64), (b, n_txt + n_img, 64), (b, 64)], packed


def test_checkpoint_resume_is_bitwise(tmp_path, without_onednn):
    """Two steps straight, against one step, a checkpoint (fp32 masters, EMA,
    AdamW moments and counters through ``CheckpointIO``), a fresh model
    restored from it and the second step: bitwise equal."""
    _, params = _jax_params(seed=12)
    opt_kw = dict(lr=1e-2, weight_decay=0.1, eps=1e-8, warmup_steps=1, grad_clip=1.0)
    batch = {k: t(v) for k, v in _batch(seed=13).items()}
    draws = [_jax_draws(_batch(seed=13), jax.random.PRNGKey(5), i, PROB) for i in range(2)]

    def run(state, model, i):
        return tdiff.make_train_step(model, ema_decay=0.9, text_dropout_prob=PROB, use_masked_loss=True)(
            state, batch, draws=draws[i])

    tm = _port_model(params)
    straight = _port_state(tm, opt_kw)
    run(straight, tm, 0)
    io = CheckpointIO()
    ckpt = io.save(str(tmp_path), straight, 0, 1, 1)
    m_straight = run(straight, tm, 1)

    fresh = _port_model(_jax_params(seed=14)[1])
    resumed = _port_state(fresh, opt_kw)
    _, running, _ = io.load(ckpt, resumed)
    assert running["global_step"] == 1 and resumed.step == 1 and resumed.optimizer.count == 1
    m_resumed = run(resumed, fresh, 1)
    assert torch.equal(m_straight["loss"], m_resumed["loss"])
    for n, p in straight.params.items():
        assert p.dtype == torch.float32
        assert torch.equal(p, resumed.params[n]) and torch.equal(straight.ema[n], resumed.ema[n]), n
    adam_a, adam_b = straight.optimizer.adamw.state_dict()["state"], resumed.optimizer.adamw.state_dict()["state"]
    for k, s in adam_a.items():
        for key in ("exp_avg", "exp_avg_sq", "step"):
            assert torch.equal(s[key], adam_b[k][key]), (k, key)


def test_trainer_full_finetune_keeps_fp32_masters_of_a_bf16_config():
    """A bf16 config without ``lora_config`` (it raised before) trains fp32
    masters computing in bf16, with an fp32 EMA, and the step moves them;
    with ``lora_config`` the base stays the config's bf16."""
    from opensora_torch.train import Trainer
    from opensora_torch.utils.config import parse_configs

    demo = os.path.join(REPO, "configs", "diffusion", "train", "demo.py")
    cfg = parse_configs([demo, "--model.dtype", "bf16", "--warmup_steps", "0"])
    trainer = Trainer(cfg, "cpu")
    assert trainer.cfg.model["param_dtype"] == "fp32" and "param_dtype" not in cfg.model
    model = trainer.model
    assert {p.dtype for p in model.parameters()} == {torch.float32} and model.dtype == torch.bfloat16
    assert all(p.requires_grad for p in model.parameters())
    assert set(trainer.state.params) == {n for n, _ in model.named_parameters()}
    assert {e.dtype for e in trainer.state.ema.values()} == {torch.float32}
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    video = torch.rand((2, 3, 5, 64, 64), generator=torch.Generator().manual_seed(0)) * 2 - 1
    metrics = trainer.run_batch({"video": video, "text": ["a cat", "a dog"]})
    assert np.isfinite(float(metrics["loss"])) and float(metrics["grad_norm"]) > 0
    assert not torch.equal(model.img_in.weight, before["img_in.weight"])

    lora = parse_configs([demo, "--model.dtype", "bf16"])
    lora["lora_config"] = {"r": 4}
    lora_trainer = Trainer(lora, "cpu")
    base = [p for n, p in lora_trainer.model.named_parameters() if "lora_" not in n]
    assert {p.dtype for p in base} == {torch.bfloat16} and not any(p.requires_grad for p in base)
    assert "param_dtype" not in lora_trainer.cfg.model
