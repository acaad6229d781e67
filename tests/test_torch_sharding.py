"""TP + FSDP placement of the port's MMDiT (opensora_torch/parallel/
sharding.py) against the JAX package's rules and its sharded forward on the
CPU: logical ranks ([cpu] * n) on the port's side, JAX's 8 virtual CPU
devices (tests/conftest.py) on the other.

- the rule table: every tensor that JAX's ``mmdit_param_specs`` (fsdp on
  and off) puts on 'tp' or 'data' is put on the same axis by the port,
  through the ``utils/weights.py`` name map, in both qkv layouts;
- shard -> gather round trips are exact;
- the TP forward over [cpu] * 2 and [cpu] * 4 matches JAX's forward under
  a (1, 1, tp) mesh within ``TOL`` = 1e-5 of the output's scale (fp32: the
  per-rank products and the fp32 all-reduce sum in another order than one
  product, a few ulps), and two known-wrong variants exceed it: the fused
  axes cut contiguously instead of per segment, the row bias added on
  every tp rank.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opensora_tpu.models.mmdit.model import MMDiTConfig as JConfig
from opensora_tpu.models.mmdit.model import MMDiTModel as JModel
from opensora_tpu.parallel import context as jcontext
from opensora_tpu.parallel.mesh import MeshConfig as JMeshConfig
from opensora_tpu.parallel.mesh import create_mesh as j_create_mesh
from opensora_tpu.parallel.sharding import make_shardings, mmdit_param_specs as j_specs

from opensora_torch.models.mmdit.model import MMDiTConfig, MMDiTModel
from opensora_torch.ops.quant import quantize_model_
from opensora_torch.parallel import comm
from opensora_torch.parallel import sharding as tsh
from opensora_torch.parallel.context import rank_scope
from opensora_torch.parallel.mesh import MeshConfig, create_mesh
from opensora_torch.utils.weights import load_numpy_state_dict, mmdit_state_dict
from torch_parity_utils import max_rel_err, one_torch_thread, randomize, to_numpy

TOL = 1e-5
CPU = torch.device("cpu")
# four heads of 16, so that tp 4 (and tp 2 x sp 2) divides them
GEOM = dict(in_channels=16, vec_in_dim=32, context_in_dim=64, hidden_size=64, mlp_ratio=2.0,
            num_heads=4, depth=1, depth_single_blocks=1, axes_dim=[4, 6, 6], qkv_bias=True,
            guidance_embed=True, cond_embed=True)

_thread = pytest.fixture(autouse=True)(one_torch_thread)


def _inputs(B=2, seed=0):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    ids = np.stack(np.meshgrid(np.arange(1), np.arange(3), np.arange(4), indexing="ij"), -1)
    return dict(img=f(B, 12, 16), img_ids=np.broadcast_to(ids.reshape(1, 12, 3), (B, 12, 3)).astype(np.float32),
                txt=f(B, 8, 64), txt_ids=np.zeros((B, 8, 3), np.float32),
                timesteps=rng.uniform(0, 1, B).astype(np.float32), y_vec=f(B, 32), cond=f(B, 12, 20),
                guidance=np.full((B,), 4.0, np.float32))


def _jax(fused_qkv=True, seed=1):
    jm = JModel(JConfig(**GEOM, fused_qkv=fused_qkv, attn_backend="xla", dtype="fp32"))
    x = _inputs(B=1)
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0), **{k: jnp.asarray(v) for k, v in x.items()})
    return jm, randomize(to_numpy(shapes["params"]), seed, scale=0.1)


def _port(params, fused_qkv=True) -> MMDiTModel:
    tm = MMDiTModel(MMDiTConfig(**GEOM, fused_qkv=fused_qkv, dtype="fp32", attn_backend="xla"), device="meta",
                    dtype=torch.float32).eval()
    load_numpy_state_dict(tm, {k: v.copy() for k, v in mmdit_state_dict(params).items()})
    return tm


def _mesh(dp, sp, tp):
    return create_mesh(MeshConfig(dp, sp, tp), [CPU] * (dp * sp * tp))


def _jax_spec_by_torch_name(params, fsdp):
    """JAX's spec of each parameter, carried to the port's name and torch
    dims: every leaf is filled with its own id, carried by the weight map,
    and its (.., in, out) kernel spec read as (out, in)."""
    leaves, treedef = jax.tree_util.tree_flatten(params)
    ids = jax.tree_util.tree_unflatten(treedef, [np.full(x.shape, i, np.float32) for i, x in enumerate(leaves)])
    specs = jax.tree_util.tree_leaves(j_specs(params, fsdp=fsdp),
                                      is_leaf=lambda s: isinstance(s, jax.sharding.PartitionSpec))
    out = {}
    for name, arr in mmdit_state_dict(ids).items():
        i = int(np.asarray(arr).flat[0])
        spec = tuple(specs[i]) + (None,) * (leaves[i].ndim - len(specs[i]))
        tail = spec[leaves[i].ndim - arr.ndim:]
        out[name] = tuple(reversed(tail)) if arr.ndim == 2 else tail
    return out


@pytest.mark.parametrize("fused_qkv", [True, False])
@pytest.mark.parametrize("fsdp", [True, False])
def test_rule_table_matches_jax(fused_qkv, fsdp):
    _, params = _jax(fused_qkv)
    want = _jax_spec_by_torch_name(params, fsdp)
    got = tsh.mmdit_param_specs(_port(params, fused_qkv), fsdp)
    assert sorted(got) == sorted(want)
    assert got == want
    on = {n for n, s in got.items() if any(s)}
    assert any("qkv" in n or "q_proj" in n for n in on) and (fsdp == any("data" in s for s in got.values()))


@pytest.mark.parametrize("sizes", [(1, 1, 2), (1, 1, 4), (2, 1, 2), (4, 1, 1), (2, 2, 2)])
@pytest.mark.parametrize("fused_qkv", [True, False])
def test_shard_gather_round_trip_is_exact(sizes, fused_qkv):
    """Every parameter's leaves gather back to it bitwise; each leaf has its
    shard's shape, and on one device every shard is held once."""
    _, params = _jax(fused_qkv, seed=2)
    tm = _port(params, fused_qkv)
    want = {k: v.clone() for k, v in tm.state_dict().items()}
    mesh = _mesh(*sizes)
    tsh.shard_params(mesh, tm, fsdp=True)
    got = {n: pl.gather([p.detach() for p in pl.leaves], CPU) for n, pl in tm.sharding.placements.items()}
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        assert torch.equal(got[k], v), k
    dp, _, tp = sizes
    for name, pl in tm.sharding.placements.items():
        n = (dp if pl.data_dim is not None else 1) * (tp if pl.tp_dim is not None else 1)
        assert len(pl.leaves) == n, name
        assert sum(p.numel() for p in pl.leaves) == want[name].numel(), name
    assert not tm.sharding.replicas() and not tm.sharding.non_canonical()


def test_segments_cut_each_fused_axis_by_heads():
    """Rank r's rows of a fused qkv weight are rows r of q, of k and of v."""
    _, params = _jax(True, seed=3)
    tm = _port(params)
    full = tm.double_blocks[0].img_attn.qkv.weight.detach().clone()
    tsh.shard_params(_mesh(1, 1, 2), tm, fsdp=False)
    leaves = tm.sharding.placements["double_blocks.0.img_attn.qkv.weight"].leaves
    h = GEOM["hidden_size"]
    for r in range(2):
        want = torch.cat([full[s * h + r * h // 2: s * h + (r + 1) * h // 2] for s in range(3)])
        assert torch.equal(leaves[r], want)


def _jax_forward_on_mesh(jm, params, tp, x):
    jmesh = j_create_mesh(JMeshConfig(dp_size=1, sp_size=1, tp_size=tp), jax.devices()[:tp])
    jcontext.set_mesh(jmesh)
    try:
        placed = jax.device_put(params, make_shardings(jmesh, j_specs(params, fsdp=False)))
        return np.asarray(jax.jit(jm.apply)({"params": placed}, **{k: jnp.asarray(v) for k, v in x.items()}))
    finally:
        jcontext.set_mesh(None)


def _contiguous(name, shape, config):
    return None


def _bias_on_every_rank(linear, partials, group):
    bias = linear._placements.get("bias")
    return comm.all_reduce([p + bias.local(group.data, t, p.dtype) for t, p in enumerate(partials)])


@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("fused_qkv", [True, False])
def test_tp_forward_matches_jax_and_known_wrong_variants_fail(tp, fused_qkv, monkeypatch):
    jm, params = _jax(fused_qkv, seed=4)
    x = _inputs()
    ref = _jax_forward_on_mesh(jm, params, tp, x)
    tx = {k: torch.from_numpy(v) for k, v in x.items()}
    base = _port(params, fused_qkv)
    with torch.no_grad():
        assert max_rel_err(base(**tx).numpy(), ref) <= TOL
    variants = {"right": None, "contiguous": ("tp_segments", _contiguous),
                "bias_on_every_rank": ("row_parallel", _bias_on_every_rank)}
    errs = {}
    for name, patch in variants.items():
        with monkeypatch.context() as m:
            if patch is not None:
                m.setattr(tsh, *patch)
            tm = tsh.shard_params(_mesh(1, 1, tp), copy.deepcopy(base), fsdp=False)
            with torch.no_grad():
                errs[name] = max_rel_err(tm(**tx).numpy(), ref)
    assert errs["right"] <= TOL, errs
    assert errs["bias_on_every_rank"] > 100 * TOL, errs
    # the unfused layout cuts one fused axis per block ([v | mlp] and linear2's input)
    assert errs["contiguous"] > 100 * TOL, errs


def test_tp_must_divide_the_heads_and_int8_under_tp_raises():
    """tp 3 over 4 heads raises; a quantized model (int8 under TP is
    ported: tests/test_torch_int8_tp.py) shards, its int8 weights and fp32
    scales kept in their dtypes, cut as the float weights and biases are,
    and gathers back bitwise."""
    _, params = _jax(True, seed=5)
    with pytest.raises(ValueError, match=r"tp 3 must divide the heads \(4\)"):
        tsh.shard_params(_mesh(1, 1, 3), _port(params), fsdp=False)
    q = quantize_model_(_port(params), "w8a8")
    q.compute_dtype = torch.bfloat16  # a bf16 model's: its float leaves are read in bf16
    want = {k: v.clone() for k, v in q.state_dict().items()}
    tsh.shard_params(_mesh(1, 1, 2), q, fsdp=False)
    placements = q.sharding.placements
    assert sorted(placements) == sorted(want)
    for name, pl in placements.items():
        assert all(p.dtype == want[name].dtype for p in pl.leaves), name
        assert torch.equal(pl.gather([p.detach() for p in pl.leaves], CPU), want[name]), name
    with rank_scope(0, 1, 0):
        qkv = q.double_blocks[0].img_attn.qkv
        assert (qkv.weight_q.dtype, qkv.weight_scale.dtype, qkv.bias.dtype) == (torch.int8, torch.float32,
                                                                                torch.bfloat16)
        assert torch.equal(qkv.weight_q, placements["double_blocks.0.img_attn.qkv.weight_q"].leaves[1])
    assert placements["double_blocks.0.img_attn.qkv.weight_q"].spec == ("tp", None)
    assert placements["single_blocks.0.linear2.weight_q"].spec == (None, "tp")
    assert placements["single_blocks.0.linear1.weight_scale"].spec == ("tp",)
    assert placements["single_blocks.0.linear2.weight_scale"].spec == (None,)


def test_constrain_degrades_axes_that_do_not_divide():
    mesh = _mesh(2, 2, 1)
    assert tsh.constrain((4, 6, 3), ("data", "sp", None), mesh) == ("data", "sp", None)
    assert tsh.constrain((4, 7, 3), ("data", "sp", None), mesh) == ("data", None, None)
    assert tsh.constrain((3, 6), ("data", "sp"), mesh) == (None, "sp")
    assert tsh.constrain((4, 6), ("data", "pp"), mesh) == ("data", None)
    assert tsh.constrain((4,), ("data",), None) == (None,)


def test_collectives_sum_in_fp32_and_carry_gradients():
    """all_reduce rounds once (a bf16 sum of the same parts drifts),
    all_gather's gradient is the reduce-scatter of the gradients, and
    reduce_scatter gives each rank its piece of the sum."""
    rng = np.random.default_rng(0)
    parts = [torch.tensor(rng.standard_normal((64,)), dtype=torch.float32) for _ in range(4)]
    exact = sum(p.double() for p in parts)
    bf = [p.bfloat16() for p in parts]
    got = comm.all_reduce(bf)
    assert all(g is got[0] for g in got) and got[0].dtype == torch.bfloat16
    assert torch.equal(got[0], sum(p.float() for p in bf).bfloat16())
    assert float((got[0].double() - exact).abs().max()) <= float((exact.bfloat16().double() - exact).abs().max()) + 0.05
    leaves = [torch.randn(2, 3, requires_grad=True) for _ in range(2)]
    full = comm.all_gather(leaves, 0)
    (full[0] * torch.arange(12.0).reshape(4, 3)).sum().backward()
    assert torch.equal(leaves[1].grad, torch.arange(6.0, 12.0).reshape(2, 3))
    rs = comm.reduce_scatter([torch.ones(4, 2), 2 * torch.ones(4, 2)], 0)
    assert [tuple(r.shape) for r in rs] == [(2, 2)] * 2 and all(torch.equal(r, 3 * torch.ones(2, 2)) for r in rs)
