"""Sequence parallelism of the port over logical ranks on the CPU, against
the JAX package on its 8 virtual CPU devices (tests/test_sp.py,
tests/test_model_sp.py): the mesh (opensora_torch/parallel/mesh.py),
Ulysses and ring attention (opensora_torch/ops/sp.py) forward and
backward, a tiny MMDiT with each sequence-parallel backend, and the entry
points that set the mesh (prepare_api, Trainer, the inference CLI). Inputs
are seeded numpy arrays fed to both packages; everything runs in fp32."""

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JMesh
from jax.sharding import NamedSharding, PartitionSpec as P

from opensora_tpu.ops.sp import ring_attention as j_ring_attention
from opensora_tpu.ops.sp import ulysses_attention as j_ulysses_attention
from opensora_tpu.parallel.mesh import MeshConfig as JMeshConfig
from opensora_tpu.parallel.mesh import create_mesh as j_create_mesh

from opensora_torch.ops import sp as tsp
from opensora_torch.parallel import comm
from opensora_torch.parallel.context import get_mesh, set_mesh, sp_enabled, sp_size
from opensora_torch.parallel.mesh import MeshConfig, create_mesh, pad_to_multiple, round_up

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), os.pardir))
CPU = torch.device("cpu")
# ring and Ulysses against JAX: the JAX file holds Ulysses to 1e-5 and ring
# to 1e-4 (LSE-rescaled partials) against dense attention
TOL = 1e-4


@pytest.fixture(autouse=True)
def _no_torch_mesh():
    yield
    set_mesh(None)


@pytest.mark.parametrize("sizes,n", [
    ((-1, 1, 1), 8), ((1, -1, 1), 4), ((2, 4, 1), 8), ((-1, 2, 2), 8), ((1, 4, 2), 8),
    ((-1, -1, 1), 8), ((3, 1, 1), 8), ((-1, 3, 1), 8),
])
def test_mesh_config_resolve_matches_jax(sizes, n):
    """The same sizes, and the same configurations refused."""
    try:
        want = JMeshConfig(*sizes).resolve(n)
    except AssertionError:
        with pytest.raises(ValueError):
            MeshConfig(*sizes).resolve(n)
        return
    assert MeshConfig(*sizes).resolve(n) == want


def test_mesh_groups_follow_jax_device_order():
    """Ranks are row-major over (data, sp, tp) as JAX's logical ids: the sp
    group through each rank keeps its data and tp coordinates."""
    devs = jax.devices()[:8]
    jm = JMesh(np.asarray(devs).reshape(2, 2, 2), ("data", "sp", "tp"))
    tm = create_mesh(MeshConfig(2, 2, 2), [CPU] * 8)
    assert tm.shape == dict(jm.shape)
    ids = np.vectorize(lambda d: d.id)(jm.devices)
    for r in range(8):
        d, s, t = tm.coords(r)
        assert ids[d, s, t] == devs[r].id
        assert tm.group("sp", r) == [int(i) - devs[0].id for i in ids[d, :, t]]
    assert round_up(10, 4) == pad_to_multiple(10, 4) == 12


def test_context_and_collectives_on_logical_ranks():
    m = create_mesh(MeshConfig(1, 4, 1), [CPU] * 4)
    assert not sp_enabled() and sp_size() == 1
    set_mesh(m)
    assert get_mesh() is m and sp_enabled() and sp_size() == 4
    x = torch.arange(2 * 8 * 4, dtype=torch.float32).reshape(2, 8, 4)
    parts = comm.shard(x, 1, m.devices)
    assert [tuple(p.shape) for p in parts] == [(2, 2, 4)] * 4
    assert torch.equal(comm.gather(parts, 1, CPU), x)
    # all_to_all: rank j gets head slice j of every rank's tokens, and back
    heads = comm.all_to_all(parts, split_dim=2, concat_dim=1)
    assert torch.equal(heads[1], x[:, :, 1:2])
    assert torch.equal(comm.gather(comm.all_to_all(heads, split_dim=1, concat_dim=2), 1, CPU), x)
    assert [torch.equal(a, b) for a, b in zip(comm.ppermute(parts), parts[-1:] + parts[:-1])] == [True] * 4


def _sp_inputs(B=2, L=64, H=4, D=32):
    rng = np.random.default_rng(0)
    return [rng.standard_normal((B, L, H, D)).astype(np.float32) for _ in range(3)]


@functools.lru_cache(maxsize=None)
def _jax_sp(name):
    """JAX's output and gradients of sum(out ** 2) on a (data 2, sp 4) mesh
    (computed once for both of the port's backends)."""
    jmesh = j_create_mesh(JMeshConfig(dp_size=2, sp_size=4, tp_size=1))
    sharding = NamedSharding(jmesh, P("data", "sp", None, None))
    jx = [jax.device_put(jnp.asarray(x), sharding) for x in _sp_inputs()]
    jfn = {"ulysses": j_ulysses_attention, "ring": j_ring_attention}[name]
    ref = jfn(*jx, jmesh, backend="xla")
    grads = jax.grad(lambda a, b, c: (jfn(a, b, c, jmesh, backend="xla") ** 2).sum(), argnums=(0, 1, 2))(*jx)
    return np.asarray(ref), [np.asarray(g) for g in grads]


@pytest.mark.parametrize("name", ["ulysses", "ring"])
@pytest.mark.parametrize("backend", ["xla", None])
def test_sp_attention_matches_jax(name, backend):
    """Forward and the gradients of sum(out ** 2) on a (data 2, sp 4) mesh.
    The port's default backend runs the flash attention (its plain version
    on the CPU); JAX's runs the einsum reference (``xla``) here."""
    tmesh = create_mesh(MeshConfig(dp_size=2, sp_size=4, tp_size=1), [CPU] * 8)
    ref, j_grads = _jax_sp(name)
    tfn = {"ulysses": tsp.ulysses_attention, "ring": tsp.ring_attention}[name]
    tx = [torch.from_numpy(x).requires_grad_() for x in _sp_inputs()]
    out = tfn(*tx, tmesh, backend=backend)
    grads = torch.autograd.grad((out ** 2).sum(), tx)
    np.testing.assert_allclose(out.detach().numpy(), ref, atol=TOL, rtol=0)
    for got, want in zip(grads, j_grads):
        np.testing.assert_allclose(got.numpy(), want, atol=TOL * max(1.0, float(np.abs(want).max())), rtol=0)


def test_ulysses_needs_heads_divisible_by_sp():
    tmesh = create_mesh(MeshConfig(dp_size=1, sp_size=4, tp_size=1), [CPU] * 4)
    x = torch.zeros((1, 8, 2, 16))
    with pytest.raises(ValueError, match="divide heads"):
        tsp.ulysses_attention(x, x, x, tmesh)


@functools.lru_cache(maxsize=None)
def _jax_tiny_mmdit():
    """The JAX tiny MMDiT (``xla`` backend): its seeded params, inputs and
    output (computed once for every backend)."""
    from test_torch_mmdit import TINY, _inputs as model_inputs, _jax_model

    jm, params = _jax_model(TINY)
    x = model_inputs(TINY)
    return params, x, np.asarray(jax.jit(jm.apply)({"params": params}, **{k: jnp.asarray(v) for k, v in x.items()}))


@pytest.mark.parametrize("backend,sp", [("ring_rdma", 4), ("ring", 4), ("ring:xla", 4), ("ulysses", 2),
                                        ("ulysses:xla", 2)])
def test_tiny_mmdit_sequence_parallel_matches_jax(backend, sp):
    """The tiny MMDiT (tiny_dev.py geometry, 12 image + 8 text tokens: 5 or
    10 a rank) with a sequence-parallel backend over logical CPU ranks,
    against the JAX MMDiT with the ``xla`` backend on the same weights."""
    from test_torch_mmdit import TINY, TOL as MODEL_TOL

    from opensora_torch.models.mmdit.model import MMDiTConfig, MMDiTModel
    from opensora_torch.utils.weights import load_numpy_state_dict, mmdit_state_dict
    from torch_parity_utils import max_rel_err

    params, x, ref = _jax_tiny_mmdit()
    tm = MMDiTModel(MMDiTConfig(**TINY, dtype="fp32", attn_backend=backend), device="meta",
                    dtype=torch.float32).eval()
    load_numpy_state_dict(tm, mmdit_state_dict(params))
    set_mesh(create_mesh(MeshConfig(dp_size=1, sp_size=sp, tp_size=1), [CPU] * sp))
    with torch.no_grad():
        out = tm(**{k: torch.from_numpy(np.asarray(v)) for k, v in x.items()})
    assert max_rel_err(out.numpy(), ref) <= MODEL_TOL, max_rel_err(out.numpy(), ref)


def test_trainer_with_a_mesh_runs_the_ring_step_like_the_dense_step():
    """Trainer(mesh=...) sets the mesh; a step whose MMDiT attends with
    ring_rdma over 4 logical ranks equals the dense step (the same draws
    from the same seed): loss, gradient norm and the updated weights."""
    from opensora_torch.train import Trainer
    from opensora_torch.utils.config import parse_configs

    rng = np.random.default_rng(0)
    batch = {"video_latents": rng.standard_normal((2, 4, 2, 4, 4)).astype(np.float32),
             "text_t5": rng.standard_normal((2, 8, 64)).astype(np.float32),  # 8 image + 8 text tokens
             "text_clip": rng.standard_normal((2, 32)).astype(np.float32)}
    demo = os.path.join(REPO, "configs", "diffusion", "train", "demo.py")
    runs = []
    for backend in ("xla", "ring_rdma"):
        cfg = parse_configs([demo, "--cached_video", "True", "--model.attn_backend", backend])
        mesh = create_mesh(MeshConfig(dp_size=1, sp_size=4, tp_size=1), [CPU] * 4) if backend != "xla" else None
        trainer = Trainer(cfg, "cpu", mesh=mesh)
        assert get_mesh() is mesh
        metrics = trainer.run_batch(batch)
        runs.append((float(metrics["loss"]), float(metrics["grad_norm"]),
                     torch.cat([p.detach().flatten() for p in trainer.model.parameters()])))
        set_mesh(None)
    (l0, g0, w0), (l1, g1, w1) = runs
    assert abs(l1 - l0) <= 1e-5 * abs(l0) and abs(g1 - g0) <= 1e-4 * abs(g0)
    assert float((w1 - w0).abs().max()) <= 1e-6


def test_prepare_api_sets_the_mesh_and_the_cli_builds_none_on_one_device(tmp_path):
    """prepare_api(mesh=...) makes the mesh the process's; the inference CLI
    builds a mesh from the config's ``mesh`` only over more than one
    device, so on the CPU it runs without one."""
    from opensora_torch.inference import main
    from opensora_torch.utils.api import prepare_api

    m = create_mesh(MeshConfig(dp_size=1, sp_size=2, tp_size=1), [CPU] * 2)
    prepare_api(torch.nn.Linear(1, 1), None, None, None, mesh=m)
    assert get_mesh() is m
    set_mesh(None)
    cfg = tmp_path / "tiny_mesh.py"
    cfg.write_text(f"_base_ = [{os.path.join(REPO, 'configs', 'diffusion', 'inference', 'tiny_dev.py')!r}]\n"
                   "mesh = dict(dp_size=1, sp_size=-1, tp_size=1)\n")
    paths = main([str(cfg), "--prompt", "a cat", "--device", "cpu", "--save_dir", str(tmp_path / "out")])
    assert get_mesh() is None and len(paths) == 1 and paths[0].endswith(".mp4")
