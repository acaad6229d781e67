"""Int8 serving under tensor parallelism (ROADMAP Queue 1 item 1 (f)):
``prepare_api(mesh=...)`` over two logical CPU ranks with a quantized MMDiT
(the int8 weights and fp32 scales cut per rank in their own dtypes,
``parallel/sharding.py``; the row-parallel products' activation scale the
whole row's, ``ops/quant.QuantLinear.tp_row_partials``) against the JAX
package's ``prepare_api(mesh=...)`` on two of its virtual CPU devices,
which leaves ``kernel_q`` / ``kernel_scale`` replicated and lets GSPMD
split the products.

Tolerances, fp32: "w8" (no activation quantization, continuous) to 2e-4
of the video's scale, as tests/test_torch_tp_api.py holds the float TP
slice. The dynamic modes quantize each activation row: a value an fp32
ulp from a rounding edge steps to the next int8 level and the step
cascades (tests/test_torch_quant.py), so the video is held in relative L2
to ``DYNAMIC_TOL`` = 1.5e-2, the limit the unsharded W8A8 MMDiT meets
against JAX; and the sharded MMDiT is held to the port's unsharded one on
the same inputs to ``TP_TOL`` = 1e-5 of the output's scale (the ranks'
fp32 partials summed in another order than one product: the int8 sums
are exact, each rank quantizes its slice with the whole row's scale).
Known-wrong: each rank quantizing against its own slice's abs-max fails
``TP_TOL`` by orders of magnitude. int8_qk8 attention engages only at head
dim 128 (tiny_dev.py's heads are 32 wide), so it is held at the model
level on a geometry with two heads of 128, against JAX's sharded forward.
"""

import copy
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opensora_tpu.models.mmdit.model import MMDiTConfig as JMMDiTConfig
from opensora_tpu.models.mmdit.model import MMDiTModel as JMMDiT
from opensora_tpu.ops.quant import quantize_params as j_quantize_params
from opensora_tpu.parallel import context as jcontext
from opensora_tpu.parallel.mesh import MeshConfig as JMeshConfig
from opensora_tpu.parallel.mesh import create_mesh as j_create_mesh
from opensora_tpu.parallel.sharding import make_shardings, mmdit_param_specs as j_specs
from opensora_tpu.utils import sampling as JS
from opensora_tpu.utils.api import ModelBundle
from opensora_tpu.utils.api import prepare_api as jprepare_api

from opensora_torch.models.mmdit.model import MMDiTConfig, MMDiTModel
from opensora_torch.ops.quant import QuantLinear, quantize_model_
from opensora_torch.parallel import comm
from opensora_torch.parallel import sharding as tsh
from opensora_torch.parallel.context import set_mesh
from opensora_torch.parallel.mesh import MeshConfig, create_mesh
from opensora_torch.utils import sampling as S
from opensora_torch.utils.api import prepare_api
from opensora_torch.utils.weights import load_numpy_state_dict, mmdit_state_dict
from test_torch_pipeline import tiny_models  # noqa: F401  (module fixture)
from test_torch_quant import _inputs
from test_torch_tp_api import _jax_bundles, tp_cfg  # noqa: F401  (module fixture)
from torch_parity_utils import max_rel_err, one_torch_thread, t, to_numpy

W8_TOL = 2e-4
DYNAMIC_TOL = 1.5e-2
TP_TOL = 1e-5
CPU = torch.device("cpu")
# two heads of 128 and 128 image tokens: int8 attention engages
QK8_GEOM = dict(in_channels=16, vec_in_dim=32, context_in_dim=64, hidden_size=256, mlp_ratio=2.0, num_heads=2,
                depth=1, depth_single_blocks=1, axes_dim=[32, 48, 48], qkv_bias=True, guidance_embed=False,
                cond_embed=False)

_thread = pytest.fixture(autouse=True)(one_torch_thread)


@pytest.fixture(autouse=True)
def _no_mesh():
    yield
    set_mesh(None)
    jcontext.set_mesh(None)


def _rel_l2(a, b) -> float:
    return float(np.linalg.norm(np.asarray(a, np.float64) - b) / np.linalg.norm(np.asarray(b, np.float64)))


def _per_rank_max(parts, group=None):
    """Known-wrong: each rank keeps its own slice's activation scale."""
    return list(parts)


@pytest.mark.parametrize("mode", ["w8", "w8a8", "w8a8_fq"])
def test_prepare_api_int8_under_tp_matches_jax(tp_cfg, tiny_models, monkeypatch, mode):  # noqa: F811
    """tiny_dev.py + plugins/tp.py, quantized, through both packages'
    prepare_api(mesh=...) at tp 2: the video against JAX's; the int8
    weights cut per rank, their dtypes kept."""
    _, js, models = tiny_models
    jmodel, jae = _jax_bundles(tp_cfg)
    mkw = {k: v for k, v in tp_cfg.model.items() if k != "type"}
    jq = ModelBundle(JMMDiT(JMMDiTConfig(**mkw, quantized=mode)),
                     {"params": to_numpy(j_quantize_params(jmodel.variables["params"]))})
    jmesh = j_create_mesh(JMeshConfig(**tp_cfg.mesh), jax.devices()[:2])
    japi = jprepare_api(jq, jae, js["t5"], js["clip"], mesh=jmesh)
    seed, prompts, opt = 3, ["a cat playing piano"], dict(tp_cfg.sampling_option)
    ref = np.asarray(japi(JS.sanitize_sampling_option(JS.SamplingOption(**opt)), "t2v", seed, text=prompts))
    jcontext.set_mesh(None)

    z = JS.get_noise(jax.random.split(jax.random.PRNGKey(seed))[0], 1, opt["height"], opt["width"], 2,
                     dtype=jnp.float32, patch_size=2, channel=4)
    monkeypatch.setattr(S, "get_noise", lambda *a, **k: t(z))
    model = quantize_model_(copy.deepcopy(models["model"]), mode)
    api = prepare_api(model, models["model_ae"], models["model_t5"], models["model_clip"],
                      mesh=create_mesh(MeshConfig(**tp_cfg.mesh), [CPU] * 2))
    qkv = model.sharding.placements["double_blocks.0.img_attn.qkv.weight_q"]
    assert [(tuple(p.shape), p.dtype) for p in qkv.leaves] == [((96, 64), torch.int8)] * 2
    scale = model.sharding.placements["double_blocks.0.img_attn.qkv.weight_scale"]
    assert [(tuple(p.shape), p.dtype) for p in scale.leaves] == [((96,), torch.float32)] * 2
    out = api(S.sanitize_sampling_option(S.SamplingOption(**opt), 16), "t2v", seed, text=prompts).numpy()
    assert out.shape == ref.shape
    if mode == "w8":
        assert max_rel_err(out, ref) <= W8_TOL, max_rel_err(out, ref)
    else:
        assert _rel_l2(out, ref) <= DYNAMIC_TOL, _rel_l2(out, ref)


def _qk8_jax(params, qparams, x, tp):
    jm = JMMDiT(JMMDiTConfig(**QK8_GEOM, dtype="fp32", quantized="w8a8", attn_backend="int8_qk8"))
    jx = {k: (None if v is None else jnp.asarray(v)) for k, v in x.items()}
    jmesh = j_create_mesh(JMeshConfig(dp_size=1, sp_size=1, tp_size=tp), jax.devices()[:tp])
    jcontext.set_mesh(jmesh)
    try:
        placed = jax.device_put(qparams, make_shardings(jmesh, j_specs(qparams, fsdp=False)))
        return np.asarray(jax.jit(jm.apply)({"params": placed}, **jx))
    finally:
        jcontext.set_mesh(None)


def test_w8a8_int8_qk8_under_tp_matches_jax_and_the_unsharded_model(monkeypatch):
    """W8A8 products with int8_qk8 attention (two heads of 128, 128 image
    tokens: one head per rank, int8 attention engaged) at tp 2: against
    JAX's sharded forward within DYNAMIC_TOL, against the port's unsharded
    model within TP_TOL (a head split leaves int8 attention's per-head
    smoothing and scales unchanged); each rank quantizing with its own
    slice's abs-max fails TP_TOL."""
    x = _inputs(QK8_GEOM, B=2, Li=128, Lt=16, seed=4)
    jfp = JMMDiT(JMMDiTConfig(**QK8_GEOM, dtype="fp32", attn_backend="xla"))
    params = to_numpy(jfp.init(jax.random.PRNGKey(1), **{k: (None if v is None else jnp.asarray(v))
                                                         for k, v in x.items()})["params"])
    qparams = to_numpy(j_quantize_params(params))
    ref = _qk8_jax(params, qparams, x, 2)

    base = MMDiTModel(MMDiTConfig(**QK8_GEOM, dtype="fp32", quantized="w8a8", attn_backend="int8_qk8"),
                      device="meta", dtype=torch.float32).eval()
    load_numpy_state_dict(base, mmdit_state_dict(qparams))
    tx = {k: (None if v is None else t(v)) for k, v in x.items()}
    with torch.no_grad():
        whole = base(**tx).numpy()
    outs = {}
    for name in ("right", "per_rank_max"):
        with monkeypatch.context() as m:
            if name != "right":
                m.setattr(comm, "all_reduce_max", _per_rank_max)
            tm = tsh.shard_params(create_mesh(MeshConfig(1, 1, 2), [CPU] * 2), copy.deepcopy(base), fsdp=False)
            with torch.no_grad():
                outs[name] = tm(**tx).numpy()
    assert _rel_l2(outs["right"], ref) <= DYNAMIC_TOL, _rel_l2(outs["right"], ref)
    assert max_rel_err(outs["right"], whole) <= TP_TOL, max_rel_err(outs["right"], whole)
    assert max_rel_err(outs["per_rank_max"], whole) > 100 * TP_TOL, max_rel_err(outs["per_rank_max"], whole)


@pytest.mark.parametrize("mode", ["w8", "w8a8", "w8a8_fq"])
def test_row_parallel_quant_linear_equals_the_whole_product(monkeypatch, mode):
    """A row-parallel QuantLinear (``proj``) over tp 2 at 1024 rows and an
    input width of 1024, where "w8a8_fq" takes the fused-quant wrapper with
    the whole row's scale passed in: each rank's fp32 partial summed once
    equals the whole layer's output within TP_TOL; the per-rank abs-max
    variant fails it in the dynamic modes."""
    rng = np.random.default_rng(5)
    w = rng.standard_normal((64, 1024)).astype(np.float32) * 0.2
    x = torch.from_numpy(rng.standard_normal((1, 1024, 1024)).astype(np.float32))
    x[..., :512] *= 4  # the two ranks' slices have different abs-maxima

    class Block(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.proj = QuantLinear.from_linear(_linear(w), mode)

    block = Block()
    with torch.no_grad():
        whole = block.proj(x).numpy()
    outs = {}
    for name in ("right", "per_rank_max"):
        with monkeypatch.context() as m:
            if name != "right":
                m.setattr(comm, "all_reduce_max", _per_rank_max)
            b = tsh.shard_params(create_mesh(MeshConfig(1, 1, 2), [CPU] * 2), copy.deepcopy(block), fsdp=False)
            pl = b.sharding.placements["proj.weight_q"]
            assert pl.tp_dim == 1 and [tuple(p.shape) for p in pl.leaves] == [(64, 512)] * 2
            g = tsh.RankGroup(b.sharding, 0)
            with torch.no_grad():
                outs[name] = g.row(b.proj, list(x.chunk(2, -1)))[0].numpy()
    assert max_rel_err(outs["right"], whole) <= TP_TOL, max_rel_err(outs["right"], whole)
    if mode != "w8":
        assert max_rel_err(outs["per_rank_max"], whole) > 100 * TP_TOL


def _linear(w: np.ndarray) -> torch.nn.Linear:
    lin = torch.nn.Linear(w.shape[1], w.shape[0], dtype=torch.float32)
    with torch.no_grad():
        lin.weight.copy_(torch.from_numpy(w))
    return lin


def test_int8_configs_compose_with_the_tp_plugin(tmp_path):
    """256px_int8.py / 256px_w8a8.py / 256px_int8attn.py composed with
    plugins/tp.py keep the quantized mode and take the tp mesh."""
    from opensora_torch.utils.config import parse_configs

    root = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "configs", "diffusion",
                        "inference")
    for name, mode in (("256px_int8.py", True), ("256px_w8a8.py", "w8a8"), ("256px_int8attn.py", "w8a8")):
        path = tmp_path / f"tp_{name}"
        path.write_text(f"_base_ = [{os.path.join(root, name)!r}, {os.path.join(root, 'plugins', 'tp.py')!r}]\n")
        cfg = parse_configs([str(path)])
        assert dict(cfg.mesh) == dict(dp_size=1, sp_size=1, tp_size=-1) and cfg.model["quantized"] == mode
