"""The pieces of 768px generation on the CPU, against the JAX package where
it has them: the 768px.py shape arithmetic (576 x 1024, a 33 x 72 x 128
latent, 76032 image tokens), the HunyuanVAE's tiled decode over a latent
whose tile grid has 768px's form (3 rows x 6 columns, the last row and
column ragged), the parking of a model in host memory and back, the t2i2v
CLI with its image models parked (the same bytes as with them resident),
and the mesh rule of a config that asks for ``sp_size=-1`` on one device.

Tolerance: the decode within 1e-4 of the output's scale (as
tests/test_torch_vae.py: fp32 convolutions summed in another order); the
rest exact.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opensora_tpu.datasets.aspect import get_image_size as jget_image_size
from opensora_tpu.models.hunyuan_vae.model import AutoencoderKLCausal3D as JVAE
from opensora_tpu.utils import sampling as JS
from opensora_tpu.utils.config import parse_configs as jparse_configs

import opensora_torch.inference as cli
from opensora_torch.datasets.aspect import get_image_size
from opensora_torch.models.mmdit.model import MMDiTConfig, MMDiTModel
from opensora_torch.utils import api
from opensora_torch.utils import sampling as S
from opensora_torch.utils.config import ae_spatial_compression, parse_configs
from test_torch_t2i2v_cli import TINY_T2I2V
from test_torch_vae import TOL, _jax_vae, _port_vae
from torch_parity_utils import max_rel_err, read_frames, t

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG_768 = os.path.join(REPO, "configs", "diffusion", "inference", "768px.py")


def test_768px_shape_arithmetic_equals_jax():
    ours, theirs = parse_configs([CFG_768]), jparse_configs([CFG_768])
    assert ours.to_dict() == theirs.to_dict()
    opt = S.sanitize_sampling_option(S.SamplingOption(**ours.sampling_option), ae_spatial_compression(ours))
    jopt = JS.sanitize_sampling_option(JS.SamplingOption(**theirs.sampling_option))
    assert (opt.height, opt.width) == (jopt.height, jopt.width) == get_image_size("768px", "16:9") \
        == jget_image_size("768px", "16:9") == (576, 1024)
    lt = (opt.num_frames - 1) // opt.temporal_reduction + 1
    z = S.get_noise(1, opt.height, opt.width, lt, generator=torch.Generator().manual_seed(0), channel=16)
    jz = jax.eval_shape(lambda k: JS.get_noise(k, 1, jopt.height, jopt.width, lt, channel=16), jax.random.PRNGKey(0))
    assert tuple(z.shape) == jz.shape == (1, 16, 33, 72, 128)
    img, ids = S.pack(z), S.build_img_ids(lt, 72, 128)
    assert tuple(img.shape) == jax.eval_shape(JS.pack, jz).shape == (1, 76032, 64)
    assert tuple(ids.shape) == JS.build_img_ids(lt, 72, 128).shape == (1, 76032, 3)


def test_tiled_decode_in_the_768px_grid_matches_jax():
    """Tile 4, stride 3 over a 9 x 16 latent: rows of 4, 4, 3 and columns of
    4 x 5, 1 -- 768px's 3 x 6 grid (tile 32, stride 24 over 72 x 128) with
    its ragged last row and column -- decoded tile by tile and blended."""
    tiling = dict(use_spatial_tiling=True, sample_size=32)
    vae, params = _jax_vae(**tiling)
    z = np.random.default_rng(2).standard_normal((1, 4, 2, 9, 16)).astype(np.float32)
    ref = np.asarray(jax.jit(lambda p, x: vae.apply({"params": p}, x, method=JVAE.decode))(params, jnp.asarray(z)))
    ae = _port_vae(params, **tiling)
    core, tiles = ae._decode_core, []
    ae._decode_core = lambda x: tiles.append(tuple(x.shape[3:])) or core(x)
    with torch.no_grad():
        out = ae.decode(t(z)).numpy()
    assert sorted(set(tiles)) == [(3, 1), (3, 4), (4, 1), (4, 4)]
    assert [tiles.count(s) for s in ((4, 4), (3, 4), (4, 1), (3, 1))] == [10, 5, 2, 1]
    assert out.shape == ref.shape == (1, 3, 5, 72, 128)
    assert max_rel_err(out, ref) <= TOL, max_rel_err(out, ref)


def test_offload_to_host_and_back_is_bitwise():
    cfg = MMDiTConfig(in_channels=16, vec_in_dim=32, context_in_dim=64, hidden_size=64, mlp_ratio=2.0, num_heads=2,
                      depth=1, depth_single_blocks=1, axes_dim=[8, 12, 12], qkv_bias=True)
    torch.manual_seed(0)
    model = MMDiTModel(cfg).eval().requires_grad_(False)
    model.register_buffer("extra", torch.arange(5.0))
    before = {k: v.clone() for k, v in model.state_dict().items()}
    ptrs = {k: v.data_ptr() for k, v in model.state_dict().items()}
    n = sum(v.numel() * v.element_size() for v in before.values())
    assert api.offload_to_host(model) == n
    parked = model.state_dict()
    assert all(parked[k].data_ptr() != ptrs[k] for k in ptrs)  # copies of their own
    assert api.load_to_device(model, "cpu") == n
    after = model.state_dict()
    assert after.keys() == before.keys() and all(torch.equal(after[k], before[k]) for k in before)
    assert all(after[k].dtype == before[k].dtype for k in before)
    assert all(isinstance(p, torch.nn.Parameter) and not p.requires_grad for p in model.parameters())


def test_t2i2v_cli_with_the_image_models_parked_writes_the_resident_bytes(tmp_path, monkeypatch):
    """Two prompts, one batch each: parked, the image models go to the host
    after each image stage and come back before the next (park, load,
    park); the images and videos equal those of a run that keeps them
    resident."""
    cfg = tmp_path / "tiny_t2i2v.py"
    cfg.write_text(TINY_T2I2V)
    prompts = tmp_path / "prompts.csv"
    prompts.write_text("text\na red panda\na blue whale\n")
    calls = []
    for name in ("offload_to_host", "load_to_device"):
        fn = getattr(api, name)
        monkeypatch.setattr(api, name, lambda m, *a, fn=fn, name=name: calls.append((name, type(m).__name__))
                            or fn(m, *a))
    runs = {}
    for parked in (True, False):
        monkeypatch.setattr(cli, "parks_image_stage", lambda device, parked=parked: parked)
        out = tmp_path / f"parked_{parked}"
        paths = cli.main([str(cfg), "--dataset.data_path", str(prompts), "--device", "cpu", "--save_dir", str(out)])
        runs[parked] = [read_frames(str(out / f"t2i_{i:04d}.png")) for i in range(2)] + [read_frames(p) for p in paths]
    park = [("offload_to_host", "MMDiTModel"), ("offload_to_host", "AutoEncoder2D")]
    load = [("load_to_device", "MMDiTModel"), ("load_to_device", "AutoEncoder2D")]
    assert calls == park + load + park
    assert len(runs[True]) == 4
    for a, b in zip(runs[True], runs[False]):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("device,cards,meshed", [("cuda", 1, False), ("cpu", 4, False), ("cuda", 4, True)])
def test_sp_size_minus_one_builds_a_mesh_only_over_several_cards(monkeypatch, device, cards, meshed):
    """768px.py's ``mesh = dict(sp_size=-1)``: no mesh where one device is
    seen (one card, or the CPU), as the JAX script builds none; over 4
    cards the mesh the config asks for."""
    import opensora_torch.parallel.mesh as mesh_mod

    made = []
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    monkeypatch.setattr(mesh_mod, "create_mesh", lambda config: made.append(config) or "mesh")
    got = cli.inference_mesh(parse_configs([CFG_768]), torch.device(device))
    assert (got == "mesh") == meshed and len(made) == int(meshed)
    if meshed:
        assert made[0].resolve(cards) == mesh_mod.MeshConfig(dp_size=1, sp_size=4, tp_size=1).resolve(cards)
