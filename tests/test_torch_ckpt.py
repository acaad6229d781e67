"""The port's checkpoint loader (``opensora_torch.utils.ckpt.load_checkpoint``
through the model builders) against the JAX package on the CPU, fp32:

- the MMDiT (the geometry of tests/test_ckpt_interop.py) from a file the
  JAX ``export_mmdit_state_dict`` writes, loaded by the JAX
  ``load_checkpoint`` and by the port, for {fused, unfused} source x
  {fused, unfused} target x {split, interleaved} source pairing: outputs
  within 2e-4 of their scale (fp32 sums in another order); a bf16 file
  loads as the fp32 one rounded to bf16, exactly; quantize-at-load equals
  the JAX ``quantize_params`` bitwise;
- the HunyuanVAE from the JAX exporter's file, the 2D Flux AE and the DC-AE
  from upstream-named files (which the JAX loader cannot read, ROADMAP
  Queue 3 R8), held against the JAX modules with the same parameters:
  1e-4 of the output's scale (1e-5 for the 2D AE), as the AEs' own tests;
- failures: a missing, mis-shaped or unexpected key raises and names the
  key.
The text encoders' loading is in tests/test_torch_ckpt_text.py.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from opensora_tpu.models.mmdit.model import MMDiTConfig as JConfig
from opensora_tpu.models.mmdit.model import MMDiTModel as JModel
from opensora_tpu.ops.quant import quantize_params
from opensora_tpu.utils.ckpt import export_hunyuan_vae_state_dict, export_mmdit_state_dict, load_checkpoint

from opensora_torch.models.mmdit.model import Flux
from opensora_torch.utils.ckpt import export_mmdit_state_dict as port_export
from opensora_torch.utils.safetensors_io import save_file
from opensora_torch.utils.weights import autoencoder_2d_state_dict, dc_ae_state_dict, mmdit_state_dict
from torch_parity_utils import max_rel_err, randomize, t, to_numpy

TOL = 2e-4
H, HEADS, DEPTH, DEPTH_S = 32, 2, 2, 2
HEAD_DIM = H // HEADS
GEOM = dict(in_channels=8, vec_in_dim=8, context_in_dim=16, hidden_size=H, mlp_ratio=2.0, num_heads=HEADS,
            depth=DEPTH, depth_single_blocks=DEPTH_S, axes_dim=[8, 4, 4], qkv_bias=True, guidance_embed=True,
            cond_embed=True)


def _save_numpy(sd, path, dtype=None):
    save_file({k: torch.from_numpy(np.ascontiguousarray(v)).to(dtype or torch.float32) for k, v in sd.items()}, path)
    return path


def _inputs(seed=0, b=2, li=16, lt=4):
    rng = np.random.default_rng(seed)
    ids = np.stack(np.meshgrid(np.arange(4.0), np.arange(2.0), np.arange(2.0), indexing="ij"), -1).reshape(1, li, 3)
    return dict(img=rng.standard_normal((b, li, 8)).astype(np.float32),
                img_ids=np.broadcast_to(ids, (b, li, 3)).astype(np.float32),
                txt=rng.standard_normal((b, lt, 16)).astype(np.float32), txt_ids=np.zeros((b, lt, 3), np.float32),
                timesteps=rng.uniform(0, 1, b).astype(np.float32), y_vec=rng.standard_normal((b, 8)).astype(np.float32),
                cond=rng.standard_normal((b, li, 12)).astype(np.float32), guidance=np.full((b,), 4.0, np.float32))


@pytest.fixture(scope="module")
def mmdit_params():
    jm = JModel(JConfig(**GEOM, attn_backend="xla", dtype="fp32"))
    x = {k: jnp.asarray(v) for k, v in _inputs(b=1).items()}
    return randomize(to_numpy(jax.eval_shape(jm.init, jax.random.PRNGKey(0), **x)["params"]), 1, 0.05)


def _mmdit_file(params, tmp_path, src_fused, src_rope, dtype=None):
    sd = export_mmdit_state_dict(params, HEADS, HEAD_DIM, rope_convention="split", dst_fused=src_fused,
                                 dst_rope_convention=src_rope)
    return _save_numpy(sd, str(tmp_path / f"mmdit_{src_fused}_{src_rope}.safetensors"), dtype)


def _port_out(model, x):
    with torch.no_grad():
        return model(**{k: t(v) for k, v in x.items()}).numpy()


@pytest.mark.parametrize("src_rope", ["split", "interleaved"])
@pytest.mark.parametrize("tgt_fused", [True, False], ids=["to_fused", "to_unfused"])
@pytest.mark.parametrize("src_fused", [True, False], ids=["from_fused", "from_unfused"])
def test_mmdit_loads_every_layout_as_the_jax_loader(mmdit_params, tmp_path, src_fused, tgt_fused, src_rope):
    path = _mmdit_file(mmdit_params, tmp_path, src_fused, src_rope)
    jm = JModel(JConfig(**GEOM, fused_qkv=tgt_fused, ckpt_rope_convention=src_rope, attn_backend="xla",
                        dtype="fp32"))
    x = _inputs()
    ref = np.asarray(jax.jit(lambda v, a: jm.apply(v, **a))(load_checkpoint(jm, path, kind="mmdit"),
                                                            {k: jnp.asarray(v) for k, v in x.items()}))
    model = Flux(from_pretrained=path, **GEOM, fused_qkv=tgt_fused, ckpt_rope_convention=src_rope,
                 attn_backend="xla", dtype="fp32", device="cpu")
    assert {p.device.type for p in model.parameters()} == {"cpu"}
    out = _port_out(model, x)
    assert max_rel_err(out, ref) <= TOL, max_rel_err(out, ref)
    # the load is exact: exported back in the file's layout, the tensors are the file's
    from opensora_torch.utils.ckpt import load_torch_state_dict

    back = port_export(model, fused=src_fused, rope_convention=src_rope)
    want = load_torch_state_dict(path)
    assert back.keys() == want.keys() and all(torch.equal(back[k], want[k]) for k in want)


def test_mmdit_bf16_file_is_the_fp32_file_rounded(mmdit_params, tmp_path):
    """A bf16 file into an fp32 model: every tensor is the fp32 file's
    rounded to bf16 (exactly), and the output stays within bf16 rounding of
    the fp32 model's (3e-2 of its scale: weights rounded to 2^-9 relative,
    compounded over 4 blocks)."""
    f32 = Flux(from_pretrained=_mmdit_file(mmdit_params, tmp_path, False, "split"), **GEOM, attn_backend="xla",
               dtype="fp32", device="cpu")
    b16 = Flux(from_pretrained=_mmdit_file(mmdit_params, tmp_path, False, "split", torch.bfloat16), **GEOM,
               attn_backend="xla", dtype="fp32", device="cpu")
    s32, s16 = f32.state_dict(), b16.state_dict()
    assert all(s16[k].dtype == torch.float32 and torch.equal(s16[k], s32[k].bfloat16().float()) for k in s32)
    x = _inputs(seed=3)
    out32, out16 = _port_out(f32, x), _port_out(b16, x)
    assert 0 < max_rel_err(out16, out32) <= 3e-2, max_rel_err(out16, out32)


@pytest.mark.parametrize("src_fused,src_rope", [(False, "split"), (True, "interleaved")],
                         ids=["published_unfused_split", "flux1_dev_fused_interleaved"])
def test_quantize_at_load_equals_jax_quantize_params(mmdit_params, tmp_path, src_fused, src_rope):
    """The int8 weights and fp32 scales of a ``quantized`` model loaded from
    a float file equal the JAX package's ``quantize_params`` of the JAX
    loader's float tree, bitwise; every other tensor equals too."""
    path = _mmdit_file(mmdit_params, tmp_path, src_fused, src_rope)
    jm = JModel(JConfig(**GEOM, ckpt_rope_convention=src_rope, attn_backend="xla", dtype="fp32"))
    want = mmdit_state_dict(to_numpy(quantize_params(load_checkpoint(jm, path, kind="mmdit")["params"])))
    model = Flux(from_pretrained=path, **GEOM, ckpt_rope_convention=src_rope, quantized="w8a8", attn_backend="xla",
                 dtype="fp32", device="cpu")
    got = model.state_dict()
    assert sorted(got) == sorted(want)
    assert sum(k.endswith(".weight_q") for k in got) == 10 * DEPTH + 3 * DEPTH_S
    for k, v in want.items():
        np.testing.assert_array_equal(got[k].numpy(), v, err_msg=k)
        assert got[k].dtype == (torch.int8 if k.endswith(".weight_q") else torch.float32), k


def test_mmdit_missing_misshaped_and_unexpected_keys_raise_naming_them(mmdit_params, tmp_path):
    sd = export_mmdit_state_dict(mmdit_params, HEADS, HEAD_DIM)
    kw = dict(**GEOM, attn_backend="xla", dtype="fp32", device="cpu")
    gone = {k: v for k, v in sd.items() if k != "single_blocks.1.linear2.weight"}
    with pytest.raises(ValueError, match=r"single_blocks\.1\.linear2\.weight is missing"):
        Flux(from_pretrained=_save_numpy(gone, str(tmp_path / "gone.safetensors")), **kw)
    bent = dict(sd, **{"txt_in.weight": sd["txt_in.weight"][:, :-1]})
    with pytest.raises(ValueError, match=r"txt_in\.weight is \(32, 15\) in the checkpoint, \(32, 16\) in the model"):
        Flux(from_pretrained=_save_numpy(bent, str(tmp_path / "bent.safetensors")), **kw)
    extra = dict(sd, **{"double_blocks.9.img_mod.lin.weight": sd["img_in.weight"]})
    with pytest.raises(ValueError, match=r"unexpected keys .*double_blocks\.9\.img_mod\.lin\.weight"):
        Flux(from_pretrained=_save_numpy(extra, str(tmp_path / "extra.safetensors")), **kw)
    # guidance_in / cond_in of the file are taken only where the model has them
    model = Flux(from_pretrained=_save_numpy(sd, str(tmp_path / "ok.safetensors")),
                 **dict(kw, guidance_embed=False, cond_embed=False))
    assert not hasattr(model, "guidance_in") and not hasattr(model, "cond_in")


# ----------------------------------------------------------------------
# the autoencoders
# ----------------------------------------------------------------------


def test_hunyuan_vae_from_the_jax_exporters_file(tmp_path):
    from opensora_tpu.models.hunyuan_vae.model import AutoEncoder3DConfig as JVConfig
    from opensora_tpu.models.hunyuan_vae.model import AutoencoderKLCausal3D as JVAE

    from opensora_torch.models.hunyuan_vae.model import CausalVAE3D_HUNYUAN

    tiny = dict(block_out_channels=(8, 16, 16, 16), latent_channels=4, norm_num_groups=4, layers_per_block=1)
    jv = JVAE(JVConfig(**tiny, dtype="fp32"))
    shapes = jax.eval_shape(jv.init, {"params": jax.random.PRNGKey(0), "gaussian": jax.random.PRNGKey(1)},
                            jnp.zeros((1, 3, 5, 16, 16)))
    params = randomize(to_numpy(shapes["params"]), 0, 0.1)
    path = _save_numpy(export_hunyuan_vae_state_dict(params), str(tmp_path / "hunyuan_vae.safetensors"))
    ae = CausalVAE3D_HUNYUAN(from_pretrained=path, **tiny, dtype="fp32", device="cpu").eval()
    x = np.random.default_rng(2).uniform(-1, 1, (1, 3, 5, 16, 16)).astype(np.float32)
    z_ref = jax.jit(lambda p, v: jv.apply({"params": p}, v, sample_posterior=False, method=JVAE.encode))(
        params, jnp.asarray(x))
    rec_ref = jax.jit(lambda p, z: jv.apply({"params": p}, z, method=JVAE.decode))(params, z_ref)
    # the JAX loader reads its own exporter's file into the same tree
    loaded = load_checkpoint(jv, path, kind="hunyuan_vae")["params"]
    assert jax.tree.structure(loaded) == jax.tree.structure(params)
    with torch.no_grad():
        z = ae.encode(t(x), sample_posterior=False)
        rec = ae.decode(z)
    assert max_rel_err(z.numpy(), np.asarray(z_ref)) <= 1e-4
    assert max_rel_err(rec.numpy(), np.asarray(rec_ref)) <= 1e-4


def test_flux_ae_2d_from_upstream_names(tmp_path):
    """Upstream Flux names (``encoder.down.0.block.0``, ``decoder.mid.attn_1``)
    load into the port; the JAX loader maps them to a tree its module does not
    hold (R8), so the reference is the JAX module holding the same
    parameters."""
    from opensora_tpu.models.vae2d.autoencoder_2d import AutoEncoder2D as JAE
    from opensora_tpu.models.vae2d.autoencoder_2d import AutoEncoderFlux as JFlux

    from opensora_torch.models.vae2d.autoencoder_2d import AutoEncoderFlux

    tiny = dict(ch=32, ch_mult=[1, 2], num_res_blocks=1, z_channels=4)
    jm = JFlux(**tiny, dtype="fp32")
    shapes = jax.eval_shape(jm.init, {"params": jax.random.PRNGKey(0), "gaussian": jax.random.PRNGKey(1)},
                            jnp.zeros((1, 3, 16, 16)))
    params = randomize(to_numpy(shapes["params"]), 0, 0.1)
    path = _save_numpy(autoencoder_2d_state_dict(params), str(tmp_path / "ae.safetensors"))
    assert jax.tree.structure(load_checkpoint(jm, path, kind="vae2d")["params"]) != jax.tree.structure(params)
    ae = AutoEncoderFlux(from_pretrained=path, **tiny, dtype="fp32", device="cpu").eval()
    x = np.random.default_rng(1).uniform(-1, 1, (2, 3, 16, 24)).astype(np.float32)
    mode_ref = jax.jit(lambda p, v: jm.apply({"params": p}, v, sample_posterior=False, method=JAE.encode))(
        params, jnp.asarray(x))
    dec_ref = jax.jit(lambda p, z: jm.apply({"params": p}, z, method=JAE.decode))(params, mode_ref)
    with torch.no_grad():
        mode = ae.encode(t(x), sample_posterior=False)
        dec = ae.decode(mode)
    assert max_rel_err(mode.numpy(), np.asarray(mode_ref)) <= 1e-5
    assert max_rel_err(dec.numpy(), np.asarray(dec_ref)) <= 1e-5


def test_dc_ae_from_upstream_names(tmp_path):
    from opensora_tpu.models.dc_ae.model import DCAE as JDCAE
    from opensora_tpu.models.dc_ae.model import DCAEConfig as JDConfig

    from opensora_torch.models.dc_ae.model import DC_AE

    tiny = dict(width_list=(8, 16, 16, 16, 32, 32), encoder_depth_list=(1, 1, 1, 1, 1, 1),
                decoder_depth_list=(1, 1, 1, 1, 1, 1), latent_channels=8)
    jm = JDCAE(JDConfig(**tiny, dtype="fp32"))
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0), jnp.zeros((1, 3, 4, 32, 32)))
    params = randomize(to_numpy(shapes["params"]), 2, 0.1)
    sd = dc_ae_state_dict(params)
    path = _save_numpy(sd, str(tmp_path / "dc_ae.safetensors"))
    jax_tree = load_checkpoint(jm, path, kind="dc_ae")["params"]
    assert jax.tree.structure(jax_tree) != jax.tree.structure(params)  # R8
    ae = DC_AE(from_pretrained=path, **tiny, dtype="fp32", device="cpu").eval()
    assert set(ae.state_dict()) == set(sd)
    x = np.random.default_rng(3).uniform(-1, 1, (1, 3, 4, 32, 32)).astype(np.float32)
    x_rec_ref, _, z_ref = jax.jit(lambda p, v: jm.apply({"params": p}, v))(params, jnp.asarray(x))
    with torch.no_grad():
        x_rec, _, z = ae(t(x))
    assert max_rel_err(z.numpy(), np.asarray(z_ref)) <= 1e-4
    assert max_rel_err(x_rec.numpy(), np.asarray(x_rec_ref)) <= 1e-4


# ----------------------------------------------------------------------
# training from a checkpoint
# ----------------------------------------------------------------------


def test_trainers_start_from_a_checkpoint(tmp_path):
    """``Trainer`` (demo.py + LoRA) and ``VAETrainer`` (a tiny DC-AE) with
    ``from_pretrained``: the MMDiT and VAE the trainer holds are the files'
    tensors exactly (in the model's dtype), the LoRA factors sit on the
    loaded base, and the VAE trainer's fp32 master weights are the file's
    bf16 values upcast."""
    import os

    from opensora_torch.train import Trainer
    from opensora_torch.train_vae import VAETrainer
    from opensora_torch.utils.api import prepare_models
    from opensora_torch.utils.ckpt import init_ae
    from opensora_torch.utils.config import parse_configs
    from opensora_torch.utils.logger import close_logger

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    demo = os.path.join(repo, "configs", "diffusion", "train", "demo.py")
    model, ae, _, _, _ = prepare_models(parse_configs([demo]), device="cpu", seed=7)
    mm, vae = str(tmp_path / "mmdit.safetensors"), str(tmp_path / "vae.safetensors")
    save_file(port_export(model, fused=False), mm)
    save_file(ae.state_dict(), vae)
    cfg = tmp_path / "lora.py"
    cfg.write_text(f"_base_ = [{demo!r}]\nlora_config = dict(r=4, lora_alpha=4)\n"
                   f"model = dict(from_pretrained={mm!r})\nae = dict(from_pretrained={vae!r})\n")
    try:
        trainer = Trainer(parse_configs([str(cfg)]), "cpu")
    finally:
        close_logger()
    base = {k: v for k, v in trainer.model.state_dict().items() if "lora_" not in k}
    assert base.keys() == model.state_dict().keys()
    assert all(torch.equal(base[k], v) for k, v in model.state_dict().items())
    assert any("lora_A" in k for k in trainer.model.state_dict())
    assert all(torch.equal(trainer.ae.state_dict()[k], v) for k, v in ae.state_dict().items())

    tiny = dict(type="dc_ae", width_list=(8, 16, 16, 16, 32, 32), encoder_depth_list=(1, 1, 1, 1, 1, 1),
                decoder_depth_list=(1, 1, 1, 1, 1, 1), latent_channels=8, dtype="bf16")
    dcae = init_ae(tiny, "cpu", seed=3)
    assert {p.dtype for p in dcae.parameters()} == {torch.bfloat16}
    save_file(dcae.state_dict(), str(tmp_path / "dc_ae.safetensors"))
    vcfg = tmp_path / "vae.py"
    vcfg.write_text(f"_base_ = [{os.path.join(repo, 'configs', 'vae', 'train', 'video_dc_ae_disc.py')!r}]\n"
                    f"model = dict(**{tiny!r}, from_pretrained={str(tmp_path / 'dc_ae.safetensors')!r})\n")
    try:
        vtrainer = VAETrainer(parse_configs([str(vcfg)]), "cpu")
    finally:
        close_logger()
    got = vtrainer.ae.state_dict()
    assert all(got[k].dtype == torch.float32 and torch.equal(got[k], v.float()) for k, v in dcae.state_dict().items())


def test_prepare_models_loads_every_model_and_quantizes_at_load(tmp_path):
    """A tiny t2i2v config with ``from_pretrained`` on the MMDiT, the VAE, the
    image model (flux1-dev's fused, interleaved layout) and its 2D AE:
    ``prepare_models`` returns exactly the written tensors; with
    ``model.quantized`` the loaded MMDiT equals ``quantize_model_`` of the
    float one, tensor for tensor."""
    import os

    from opensora_torch.ops.quant import quantize_model_
    from opensora_torch.utils.api import prepare_models
    from opensora_torch.utils.config import parse_configs

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    tiny_dev = os.path.join(repo, "configs", "diffusion", "inference", "tiny_dev.py")
    cfg = tmp_path / "t2i2v.py"
    cfg.write_text(f"_base_ = [{tiny_dev!r}]\n"
                   "img_flux = dict(type='flux', in_channels=16, vec_in_dim=32, context_in_dim=64, hidden_size=64,\n"
                   "                mlp_ratio=2.0, num_heads=2, depth=1, depth_single_blocks=1, axes_dim=[8, 12, 12],\n"
                   "                qkv_bias=True, guidance_embed=True, ckpt_rope_convention='interleaved',\n"
                   "                attn_backend='xla', dtype='fp32')\n"
                   "img_flux_ae = dict(type='autoencoder_2d', ch=8, ch_mult=[1, 1, 2, 2], num_res_blocks=1,\n"
                   "                   z_channels=4, dtype='fp32')\n")
    model, ae, _, _, optional = prepare_models(parse_configs([str(cfg)]), device="cpu", seed=5)
    files = {"model": (port_export(model, fused=False), "mmdit"), "ae": (ae.state_dict(), "vae"),
             "img_flux": (port_export(optional["img_flux"], fused=True, rope_convention="interleaved"), "flux"),
             "img_flux_ae": (optional["img_flux_ae"].state_dict(), "ae2d")}
    overrides = []
    for key, (sd, name) in files.items():
        save_file(sd, str(tmp_path / f"{name}.safetensors"))
        overrides += [f"--{key}.from_pretrained", str(tmp_path / f"{name}.safetensors")]
    l_model, l_ae, _, _, l_opt = prepare_models(parse_configs([str(cfg), *overrides]), device="cpu", seed=0)
    for want, got in ((model, l_model), (ae, l_ae), (optional["img_flux"], l_opt["img_flux"]),
                      (optional["img_flux_ae"], l_opt["img_flux_ae"])):
        w, g = want.state_dict(), got.state_dict()
        assert w.keys() == g.keys() and all(torch.equal(w[k], g[k]) for k in w)
    q_model = prepare_models(parse_configs([str(cfg), *overrides[:2], "--model.quantized", "w8a8"]), device="cpu",
                             seed=0)[0]
    want = quantize_model_(model, "w8a8").state_dict()
    got = q_model.state_dict()
    assert want.keys() == got.keys() and all(torch.equal(want[k], got[k]) for k in want)
    assert q_model.config.quantized == "w8a8"
