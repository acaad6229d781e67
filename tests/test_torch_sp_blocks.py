"""The MMDiT's sequence-sharded forward and step over logical CPU ranks:
``MMDiTModel.forward_rank`` on a mesh with an 'sp' axis, each sp rank
holding its chunk of the joint [txt, img] tokens through every block
(``parallel/data.joint_chunks``, ``parallel/sharding.RankGroup`` with
``seq``, ``ops/attention.attention_shards``), against the JAX MMDiT with
the ``xla`` attention on the same weights and against the port's
unsharded model.

Geometry: tests/test_torch_mmdit.py's ``TINY`` with 4 heads of 16 (axes
[4, 6, 6]), so that Ulysses splits the heads over sp 4 and over tp 2 x
sp 2. 8 text + 12 image tokens: 5 a rank at sp 4 (rank 0 text only, rank
1 both parts, ranks 2-3 image only), 10 at sp 2.

Tolerances, fp32: ``TOL`` = 2e-4 of the output's scale against JAX
(test_torch_mmdit.py's: fp32 sums in another order); the int8 forward
under SP against the unsharded int8 forward to ``INT8_TOL`` = 1e-5 of the
output's scale (each token is quantized against its own row, so the cut
changes no int8 product; the tp ranks' fp32 partials sum in another
order); the step's loss and gradient norm to ``STEP_TOL`` = 1e-5 relative
and each master's change to ``UPDATE_TOL`` = 1e-4 in relative L2
(test_torch_data_parallel.py's limits: the ranks' weight gradients are
summed in another order).
"""

import contextlib
import copy
import functools
import logging

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from opensora_tpu.training import diffusion as jdiff

from opensora_torch.models.mmdit.model import MMDiTConfig, MMDiTModel
from opensora_torch.ops.quant import quantize_model_
from opensora_torch.parallel import sharding as tsh
from opensora_torch.parallel.context import set_mesh
from opensora_torch.parallel.mesh import MeshConfig, create_mesh
from opensora_torch.training import diffusion as tdiff
from opensora_torch.utils import optimizer as topt
from opensora_torch.utils.weights import load_numpy_state_dict, mmdit_state_dict
from test_torch_mmdit import TINY, TOL, _jax_model
from test_torch_training import GEOM as STEP_GEOM
from test_torch_training import _batch, _jax_draws
from torch_parity_utils import max_rel_err, one_torch_thread, randomize, t, to_numpy

GEOM = dict(TINY, num_heads=4, axes_dim=[4, 6, 6])
INT8_TOL = 1e-5
STEP_TOL = 1e-5
UPDATE_TOL = 1e-4
OPT = dict(lr=1e-2, weight_decay=0.1, eps=1e-2, warmup_steps=0, grad_clip=0.05)
PROB = 0.5
CPU = torch.device("cpu")
MESHES = [(1, 4, 1), (1, 2, 2), (2, 2, 1)]
BACKENDS = ["ring", "ring_rdma", "ulysses", "ring:xla", None]
# (image grid h x w, text tokens): the main case, sp dividing L but not the
# text (the seq_align case), and sp dividing neither
CASES = {"main": (3, 4, 8), "seq_align": (2, 5, 6), "undividable": (3, 3, 6)}

_thread = pytest.fixture(autouse=True)(one_torch_thread)


@pytest.fixture(autouse=True)
def _no_mesh():
    yield
    set_mesh(None)


def _mesh(sizes, devices=None):
    return create_mesh(MeshConfig(*sizes), devices or [CPU] * int(np.prod(sizes)))


def _inputs(case, B=2, seed=0):
    h, w, lt = CASES[case]
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    li = h * w
    ids = np.stack(np.meshgrid(np.arange(1), np.arange(h), np.arange(w), indexing="ij"), -1).reshape(1, li, 3)
    return dict(img=f(B, li, GEOM["in_channels"]), img_ids=np.broadcast_to(ids, (B, li, 3)).astype(np.float32),
                txt=f(B, lt, GEOM["context_in_dim"]), txt_ids=np.zeros((B, lt, 3), np.float32),
                timesteps=rng.uniform(0, 1, B).astype(np.float32), y_vec=f(B, GEOM["vec_in_dim"]),
                cond=f(B, li, GEOM["in_channels"] + 4), guidance=np.full((B,), 4.0, np.float32))


@functools.lru_cache(maxsize=None)
def _jax_forward(case):
    """The JAX MMDiT's seeded params and its output on ``case``'s inputs."""
    jm, params = _jax_model(GEOM)
    x = _inputs(case)
    return params, np.asarray(jax.jit(jm.apply)({"params": params}, **{k: jnp.asarray(v) for k, v in x.items()}))


def _port(params, **kw) -> MMDiTModel:
    tm = MMDiTModel(MMDiTConfig(**GEOM, dtype="fp32", **kw), device="meta", dtype=torch.float32).eval()
    load_numpy_state_dict(tm, mmdit_state_dict(params))
    return tm


@contextlib.contextmanager
def _token_counts(model):
    """Per block call, the tokens of the residual stream each rank holds
    (its text + image parts, or its joint chunk), and the token count of
    every input of the blocks' linears (qkv, proj, the MLPs, linear1,
    linear2)."""
    seen = {"blocks": [], "linears": []}
    hooks = []
    for name, m in model.named_modules():
        if name.startswith(("double_blocks", "single_blocks")) and name.rsplit(".", 1)[-1] in (
                "qkv", "proj", "linear1", "linear2", "0", "2"):
            hooks.append(m.register_forward_pre_hook(lambda mod, args: seen["linears"].append(args[0].shape[1])))
    for blocks, n_streams in ((model.double_blocks, 2), (model.single_blocks, 1)):
        for block in blocks:
            def recorded(g, *args, fwd=block.forward_tp, n=n_streams):
                seen["blocks"].append([sum(s[r].shape[1] for s in args[:n]) for r in range(len(args[0]))])
                return fwd(g, *args)

            block.forward_tp = recorded
    try:
        yield seen
    finally:
        for h in hooks:
            h.remove()
        for block in (*model.double_blocks, *model.single_blocks):
            del block.forward_tp


def _sharded_forward(model, sizes, x, devices=None):
    mesh = _mesh(sizes, devices)
    tsh.shard_params(mesh, model, fsdp=False)
    set_mesh(mesh)
    with _token_counts(model) as seen, torch.no_grad():
        out = model(**{k: t(v) for k, v in x.items()})
    return out, seen


@pytest.mark.parametrize("sizes", MESHES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("backend", BACKENDS, ids=lambda b: str(b))
def test_sequence_sharded_mmdit_matches_jax(backend, sizes):
    """The MMDiT over (data, sp, tp) logical ranks with every backend:
    each sp rank's blocks see L / sp tokens, and every rank of the group
    runs every block; the output equals JAX's."""
    params, ref = _jax_forward("main")
    model = _port(params, attn_backend=backend)
    out, seen = _sharded_forward(model, sizes, _inputs("main"))
    dp, sp, tp = sizes
    n_blocks = GEOM["depth"] + GEOM["depth_single_blocks"]
    assert seen["blocks"] == [[20 // sp] * (sp * tp)] * (n_blocks * dp)
    assert seen["linears"] and max(seen["linears"]) <= 20 // sp
    assert max_rel_err(out.numpy(), ref) <= TOL, max_rel_err(out.numpy(), ref)


@pytest.mark.parametrize("case,backend", [("seq_align", "ring"), ("seq_align", None), ("undividable", None)])
def test_token_layouts_match_jax(case, backend, caplog):
    """sp 4 over 6 text + 10 image tokens (the seq_align case: rank 0 text
    only, rank 1 both parts, ranks 2-3 image only) runs the chunks of 4;
    over 6 + 9 tokens, which sp does not divide, the blocks run the whole
    sequence on sp rank 0 (logged) and the attention is cut as before.
    Both equal JAX's output."""
    params, ref = _jax_forward(case)
    model = _port(params, attn_backend=backend)
    x = _inputs(case)
    n = x["img"].shape[1] + x["txt"].shape[1]
    with caplog.at_level(logging.INFO, logger="opensora_torch.models.mmdit.model"):
        out, seen = _sharded_forward(model, (1, 4, 1), x)
    per_rank = [[n // 4] * 4] if case == "seq_align" else [[n]]
    assert seen["blocks"] == per_rank * 2
    assert ("do not split over sp 4" in caplog.text) == (case == "undividable")
    assert max_rel_err(out.numpy(), ref) <= TOL, max_rel_err(out.numpy(), ref)


@pytest.mark.parametrize("sizes", [(1, 4, 1), (1, 2, 2)], ids=lambda s: "x".join(map(str, s)))
def test_int8_forward_under_sp_equals_unsharded(sizes):
    """A w8a8 MMDiT over sp ranks against the unsharded w8a8 MMDiT on the
    same inputs: per-token activation scales make the cut exact; the int8
    linears of a chunk's empty text part are never called."""
    params, _ = _jax_forward("main")
    model = quantize_model_(_port(params), "w8a8")
    x = _inputs("main")
    with torch.no_grad():
        want = model(**{k: t(v) for k, v in x.items()})
    out, seen = _sharded_forward(copy.deepcopy(model), sizes, x)
    assert min(seen["linears"]) > 0
    assert max_rel_err(out.numpy(), want.numpy()) <= INT8_TOL, max_rel_err(out.numpy(), want.numpy())


def test_unshard_params_gives_back_the_model():
    """A model sharded over (1, 2, 2) and unsharded: the same parameters,
    modules and output as before."""
    params, _ = _jax_forward("main")
    model = _port(params, attn_backend="ring")
    want = {k: v.clone() for k, v in model.state_dict().items()}
    out, _ = _sharded_forward(model, (1, 2, 2), _inputs("main"))
    set_mesh(None)
    tsh.unshard_params(model)
    assert model.sharding is None and type(model.final_layer.linear).__name__ == "Linear"
    got = model.state_dict()
    assert sorted(got) == sorted(want) and all(torch.equal(got[k], v) for k, v in want.items())
    model = _port(params)
    with torch.no_grad():
        ref = model(**{k: t(v) for k, v in _inputs("main").items()})
    assert max_rel_err(out.numpy(), ref.numpy()) <= TOL


@functools.lru_cache(maxsize=None)
def _jax_step_loss():
    """The JAX package's step on the step geometry (remat "full": its
    "offload" names host memory, which its CPU backend has not): its seeded
    params and its loss."""
    from test_torch_training import _jax_model as jax_step_model

    jm, params = jax_step_model(seed=7, remat=True, remat_policy="full")
    state = jdiff.TrainState.create(jax.tree.map(jnp.asarray, params), optax.sgd(1.0), ema=False)
    step = jax.jit(jdiff.make_train_step(jm, optax.sgd(1.0), ema_decay=0.9, text_dropout_prob=PROB,
                                         use_masked_loss=True))
    _, metrics = step(state, {k: jnp.asarray(v) for k, v in _batch().items()}, jax.random.PRNGKey(11))
    return params, float(metrics["loss"])


def _step(params, mesh):
    """One stage2-style full-finetune step (fp32 masters, remat "offload",
    the default attention) from ``params``, unsharded or over ``mesh``:
    the metrics, each master's change and the blocks' token counts."""
    tm = MMDiTModel(MMDiTConfig(**STEP_GEOM, dtype="fp32", remat=True, remat_policy="offload"), device="meta",
                    dtype=torch.float32)
    load_numpy_state_dict(tm, {k: v.copy() for k, v in mmdit_state_dict(params).items()})
    tm.requires_grad_(True)
    start = {k: v.clone() for k, v in tm.state_dict().items()}
    state = tdiff.TrainState.create(tm, topt.create_optimizer(list(tm.parameters()), **OPT), ema=True)
    if mesh is not None:
        state = tdiff.shard_state(mesh, state, tm)
        set_mesh(mesh)
    batch = _batch()
    draws = _jax_draws(batch, jax.random.PRNGKey(11), 0, PROB)
    step = tdiff.make_train_step(tm, ema_decay=0.9, text_dropout_prob=PROB, use_masked_loss=True)
    with _token_counts(tm) as seen:
        metrics = step(state, {k: t(v) for k, v in batch.items()}, draws=draws)
    set_mesh(None)
    params_now = state.state_dict()["params"]
    change = {k: params_now[k].float() - start[k] for k in params_now}
    return float(metrics["loss"]), float(metrics["grad_norm"]), change, seen


@pytest.mark.parametrize("mesh", ["1x2x1", "2x2x1", "1x2x1_two_devices"])
def test_stage2_step_over_sp_matches_the_unsharded_step(mesh):
    """A full-finetune step over sp ranks, as stage2.py trains (sp 2 here:
    the 20 tokens, 10 a rank; with data 2 and FSDP; and over two devices,
    whose weight replicas meet in ``sync_replica_grads`` and count once in
    the norm): the loss, the gradient norm and every master's change equal
    the port's unsharded step from the same params, batch and draws, and
    the loss equals the JAX package's."""
    params, jax_loss = _jax_step_loss()
    sizes = (2, 2, 1) if mesh.startswith("2x2") else (1, 2, 1)
    devices = [torch.device("cpu", i) for i in range(2)] if mesh.endswith("two_devices") else None
    loss0, norm0, change0, _ = _step(params, None)
    loss, norm, change, seen = _step(params, _mesh(sizes, devices))
    assert loss0 == pytest.approx(jax_loss, rel=STEP_TOL)
    assert loss == pytest.approx(loss0, rel=STEP_TOL) and norm == pytest.approx(norm0, rel=STEP_TOL)
    assert sorted(change) == sorted(change0)
    for k, c in change.items():
        err = float((c - change0[k]).norm() / change0[k].norm().clamp(min=1e-30))
        assert err <= UPDATE_TOL, (k, err)
    # forward and the recompute of each of the 2 blocks, each data rank
    assert seen["blocks"] == [[10, 10]] * (2 * 2 * sizes[0])
    assert max(seen["linears"]) <= 10
