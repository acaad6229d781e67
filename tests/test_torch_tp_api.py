"""Tensor-parallel generation through the port's entry point: ``prepare_api
(mesh=...)`` with plugins/tp.py's mesh (``tp_size=-1``) over two logical
CPU ranks, against the JAX package's ``prepare_api(mesh=...)`` on two of its
virtual CPU devices, at the tiny_dev.py geometry, fp32, the port handed the
JAX noise.

Tolerance: 2e-4 of the output's scale, as tests/test_torch_pipeline.py
holds the unsharded slice (two fp32 sampling steps through MMDiT and VAE;
the tp ranks' partial products and their fp32 sum add sums in another
order).
"""

import copy
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opensora_tpu.models.hunyuan_vae.model import AutoEncoder3DConfig as JVAEConfig
from opensora_tpu.models.hunyuan_vae.model import AutoencoderKLCausal3D as JVAE
from opensora_tpu.models.mmdit.model import MMDiTConfig as JMMDiTConfig
from opensora_tpu.models.mmdit.model import MMDiTModel as JMMDiT
from opensora_tpu.parallel import context as jcontext
from opensora_tpu.parallel.mesh import MeshConfig as JMeshConfig
from opensora_tpu.parallel.mesh import create_mesh as j_create_mesh
from opensora_tpu.utils import sampling as JS
from opensora_tpu.utils.api import ModelBundle
from opensora_tpu.utils.api import prepare_api as jprepare_api

from opensora_torch.parallel.context import get_mesh, set_mesh
from opensora_torch.parallel.mesh import MeshConfig, create_mesh
from opensora_torch.utils import sampling as S
from opensora_torch.utils.api import prepare_api
from opensora_torch.utils.config import parse_configs
from test_torch_pipeline import CONFIG_DIR, TINY_DEV, tiny_models  # noqa: F401  (module fixture)
from torch_parity_utils import max_rel_err, randomize, t, to_numpy

TOL = 2e-4
CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def _no_mesh():
    yield
    set_mesh(None)
    jcontext.set_mesh(None)


@pytest.fixture(scope="module")
def tp_cfg(tmp_path_factory):
    """tiny_dev.py composed with plugins/tp.py, as 256px_tp.py composes 256px.py."""
    path = tmp_path_factory.mktemp("cfg") / "tiny_tp.py"
    path.write_text(f"_base_ = [{TINY_DEV!r}, {os.path.join(CONFIG_DIR, 'plugins', 'tp.py')!r}]\n")
    return parse_configs([str(path)])


def _jax_bundles(cfg):
    """tiny_models' JAX MMDiT and VAE weights (the same seeded draws) as
    ModelBundles."""
    mkw = {k: v for k, v in cfg.model.items() if k != "type"}
    akw = {k: v for k, v in cfg.ae.items() if k != "type"}
    jm = JMMDiT(JMMDiTConfig(**mkw))
    z = lambda *s: jnp.zeros(s)  # noqa: E731
    m_shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0), z(1, 8, 16), z(1, 8, 3), z(1, 4, 64), z(1, 4, 3),
                              z(1), z(1, 32), z(1, 8, 20), z(1))
    jvae = JVAE(JVAEConfig(**akw))
    v_shapes = jax.eval_shape(jvae.init, {"params": jax.random.PRNGKey(0), "gaussian": jax.random.PRNGKey(1)},
                              z(1, 3, 5, 32, 32))
    return (ModelBundle(jm, {"params": randomize(to_numpy(m_shapes["params"]), 0, 0.05)}),
            ModelBundle(jvae, {"params": randomize(to_numpy(v_shapes["params"]), 1, 0.1)}))


def test_tp_plugin_mesh_resolves_like_jax(tp_cfg):
    assert dict(tp_cfg.mesh) == dict(dp_size=1, sp_size=1, tp_size=-1)
    for n in (2, 4):
        assert MeshConfig(**tp_cfg.mesh).resolve(n) == JMeshConfig(**tp_cfg.mesh).resolve(n) == (1, 1, n)
    assert parse_configs([os.path.join(CONFIG_DIR, "256px_tp.py")]).mesh == tp_cfg.mesh


@pytest.mark.parametrize("neg", [None, ["blurry, low quality"]])
def test_prepare_api_with_the_tp_mesh_matches_jax(tp_cfg, tiny_models, monkeypatch, neg):  # noqa: F811
    _, js, models = tiny_models
    jmodel, jae = _jax_bundles(tp_cfg)
    jmesh = j_create_mesh(JMeshConfig(**tp_cfg.mesh), jax.devices()[:2])
    japi = jprepare_api(jmodel, jae, js["t5"], js["clip"], mesh=jmesh)
    seed, prompts = 3, ["a cat playing piano"]
    opt = dict(tp_cfg.sampling_option)
    ref = np.asarray(japi(JS.sanitize_sampling_option(JS.SamplingOption(**opt)), "t2v", seed, text=prompts, neg=neg))
    jcontext.set_mesh(None)

    model = copy.deepcopy(models["model"])
    mesh = create_mesh(MeshConfig(**tp_cfg.mesh), [CPU] * 2)
    api = prepare_api(model, models["model_ae"], models["model_t5"], models["model_clip"], mesh=mesh)
    assert get_mesh() is mesh and model.sharding is not None and model.sharding.tp == 2
    names = [n for n, _ in model.named_parameters()]
    assert names and all("_shards." in n for n in names)  # every weight moved into its shards
    qkv = model.sharding.placements["double_blocks.0.img_attn.qkv.weight"]
    assert [tuple(p.shape) for p in qkv.leaves] == [(96, 64)] * 2

    z = JS.get_noise(jax.random.split(jax.random.PRNGKey(seed))[0], 1, opt["height"], opt["width"], 2,
                     dtype=jnp.float32, patch_size=2, channel=4)
    monkeypatch.setattr(S, "get_noise", lambda *a, **k: t(z))
    out = api(S.sanitize_sampling_option(S.SamplingOption(**opt), 16), "t2v", seed, text=prompts, neg=neg).numpy()
    assert out.shape == ref.shape
    assert max_rel_err(out, ref) <= TOL, max_rel_err(out, ref)


def test_prepare_api_without_a_tp_axis_keeps_the_model_whole(tiny_models):  # noqa: F811
    """A mesh with no 'tp' axis (sequence parallelism) cuts no weight: the
    MMDiT is placed replicated over 'sp' (its sp ranks each run their chunk
    of the tokens), one whole leaf per parameter on the one device, the
    parameter's own tensor; a sharded model is not cut again."""
    _, _, models = tiny_models
    model = copy.deepcopy(models["model"])
    whole = {n: p.data_ptr() for n, p in model.named_parameters()}
    prepare_api(model, models["model_ae"], models["model_t5"], models["model_clip"],
                mesh=create_mesh(MeshConfig(1, 2, 1), [CPU] * 2))
    placements = model.sharding.placements
    assert sorted(placements) == sorted(whole)
    for name, pl in placements.items():
        assert len(pl.leaves) == 1 and pl.leaves[0].data_ptr() == whole[name], name
    tp = create_mesh(MeshConfig(1, 1, 2), [CPU] * 2)
    prepare_api(model, models["model_ae"], models["model_t5"], models["model_clip"], mesh=tp)
    sharding = model.sharding
    prepare_api(model, models["model_ae"], models["model_t5"], models["model_clip"], mesh=tp)
    assert model.sharding is sharding
