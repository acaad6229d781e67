"""The whole text-to-video slice of the PyTorch port against the JAX package
on the CPU, fp32, at the tiny_dev.py geometry: given the same numpy noise,
prompts and carried weights, JAX prepare -> I2VDenoiser.denoise -> unpack ->
decode equals the port's ``generate``. Also the pieces around it (config
parsing, image sizes, schedule, packing, the denoiser's guidance logic), the
CLI's output shape and determinism, and the no-GPU rule of the entry points.

Tolerance: 2e-4 of the output's scale (two fp32 sampling steps through
MMDiT and VAE, sums taken in another order).
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from opensora_tpu.datasets.aspect import get_image_size as jget_image_size
from opensora_tpu.models.hunyuan_vae.model import AutoEncoder3DConfig as JVAEConfig
from opensora_tpu.models.hunyuan_vae.model import AutoencoderKLCausal3D as JVAE
from opensora_tpu.models.mmdit.model import MMDiTConfig as JMMDiTConfig
from opensora_tpu.models.mmdit.model import MMDiTModel as JMMDiT
from opensora_tpu.models.text import clip as jclip
from opensora_tpu.models.text import t5 as jt5
from opensora_tpu.models.text.conditioner import HFEmbedder as JEmbedder
from opensora_tpu.utils import sampling as JS
from opensora_tpu.utils.config import parse_configs as jparse_configs
from opensora_tpu.utils.inference import prepare_inference_condition as jprepare_condition

from opensora_torch.datasets.aspect import get_image_size
from opensora_torch.models.hunyuan_vae.model import AutoEncoder3DConfig, AutoencoderKLCausal3D
from opensora_torch.models.mmdit.model import MMDiTConfig, MMDiTModel
from opensora_torch.models.text import clip as tclip
from opensora_torch.models.text import t5 as tt5
from opensora_torch.models.text.conditioner import HFEmbedder
from opensora_torch.utils import sampling as S
from opensora_torch.utils.api import prepare_api, prepare_models
from opensora_torch.utils.config import ae_spatial_compression, parse_configs
from opensora_torch.utils.weights import (
    clip_text_state_dict,
    hunyuan_vae_state_dict,
    load_numpy_state_dict,
    mmdit_state_dict,
    t5_state_dict,
)
from torch_parity_utils import max_rel_err, randomize, read_frames, t, to_numpy

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG_DIR = os.path.join(REPO, "configs", "diffusion", "inference")
TINY_DEV = os.path.join(CONFIG_DIR, "tiny_dev.py")
TOL = 2e-4


def _meta(cls, *args):
    return cls(*args, device="meta", dtype=torch.float32).eval()


@pytest.fixture(scope="module")
def tiny_models():
    """The tiny_dev.py models in both packages, fp32, same seeded weights:
    (cfg, the JAX side's callables, the port's models by name)."""
    cfg = parse_configs([TINY_DEV])
    mkw = {k: v for k, v in cfg.model.items() if k != "type"}
    akw = {k: v for k, v in cfg.ae.items() if k != "type"}
    jm = JMMDiT(JMMDiTConfig(**mkw))
    B, Li, Lt = 1, 8, 4
    z = lambda *s: jnp.zeros(s)  # noqa: E731
    m_shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0), z(B, Li, 16), z(B, Li, 3), z(B, Lt, 64), z(B, Lt, 3),
                              z(B), z(B, 32), z(B, Li, 20), z(B))
    m_params = randomize(to_numpy(m_shapes["params"]), 0, 0.05)
    jvae = JVAE(JVAEConfig(**akw))
    v_shapes = jax.eval_shape(jvae.init, {"params": jax.random.PRNGKey(0), "gaussian": jax.random.PRNGKey(1)},
                              z(1, 3, 5, 32, 32))
    v_params = randomize(to_numpy(v_shapes["params"]), 1, 0.1)

    t5_cfg, clip_cfg = jt5.t5_small_test_config(), jclip.clip_small_test_config()
    t5_cfg.dtype = clip_cfg.dtype = "fp32"
    ids = jnp.zeros((1, 8), jnp.int32)
    t5_params = randomize(to_numpy(jax.eval_shape(jt5.T5Encoder(t5_cfg).init, jax.random.PRNGKey(0), ids)["params"]),
                          2, 0.2)
    clip_params = randomize(
        to_numpy(jax.eval_shape(jclip.CLIPTextModel(clip_cfg).init, jax.random.PRNGKey(0), ids)["params"]), 3, 0.2)
    jax_side = dict(
        model=lambda **kw: jm.apply({"params": m_params}, **kw),
        vae=jax.jit(lambda x: jvae.apply({"params": v_params}, x, method=JVAE.decode)),
        t5=JEmbedder("", max_length=16, t5_config=t5_cfg, params={"params": t5_params}),
        clip=JEmbedder("clip-tiny", max_length=16, clip_config=clip_cfg, params={"params": clip_params}),
    )

    model = _meta(MMDiTModel, MMDiTConfig(**mkw))
    load_numpy_state_dict(model, mmdit_state_dict(m_params))
    ae = _meta(AutoencoderKLCausal3D, AutoEncoder3DConfig(**akw))
    load_numpy_state_dict(ae, hunyuan_vae_state_dict(v_params))
    t5 = HFEmbedder("", max_length=16, t5_config=tt5.t5_small_test_config(), device="meta", dtype=torch.float32)
    load_numpy_state_dict(t5.module, t5_state_dict(t5_params))
    clip = HFEmbedder("clip-tiny", max_length=16, clip_config=tclip.clip_small_test_config(), device="meta",
                      dtype=torch.float32)
    load_numpy_state_dict(clip.module, clip_text_state_dict(clip_params))
    return cfg, jax_side, dict(model=model, model_ae=ae, model_t5=t5.eval(), model_clip=clip.eval())


@pytest.fixture(scope="module")
def tiny_pair(tiny_models):
    """(cfg, the JAX side, the port's api_fn) over tiny_models."""
    cfg, jax_side, models = tiny_models
    return cfg, jax_side, prepare_api(**models)


def _jax_generate(js, z, prompts, opt, neg=None):
    """The JAX package's api_fn body for t2v, given the noise."""
    num_frames = z.shape[2]
    denoiser = JS.SamplingMethodDict[opt.method]
    timesteps = JS.get_schedule(opt.num_steps, (z.shape[-1] * z.shape[-2]) // 4, num_frames,
                                shift=opt.shift, shift_alpha=opt.flow_shift)
    text, additional = denoiser.prepare_guidance(text=prompts, neg=neg, guidance_img=opt.guidance_img)
    zj = jnp.asarray(z)
    inp = JS.prepare(js["t5"], js["clip"], zj, prompt=text, patch_size=2)
    img = inp.pop("img")
    masks, masked_ref = jprepare_condition(zj, "t2v", ref_list=None, causal=opt.is_causal_vae)
    x = denoiser.denoise(
        js["model"], img=img, timesteps=timesteps, guidance=opt.guidance,
        guidance_img=additional.get("guidance_img") or 1.0, masks=masks, masked_ref=masked_ref,
        text_osci=opt.text_osci, image_osci=opt.image_osci, scale_temporal_osci=False, patch_size=2,
        cfg_batched=True, **{k: inp[k] for k in ("img_ids", "txt", "txt_ids", "y_vec")},
    )
    x = JS.unpack(x.astype(jnp.float32), opt.height, opt.width, num_frames, patch_size=2)
    return np.asarray(js["vae"](x))[:, :, : opt.num_frames]


@pytest.mark.parametrize("variant", [
    {},
    # image guidance on, 3 steps; the port runs its CFG as three sequential
    # passes while the JAX side batches them
    dict(num_steps=3, guidance_img=2.0, text_osci=True, image_osci=True, cfg_batched=False),
])
def test_t2v_slice_matches_jax(tiny_pair, variant):
    cfg, js, api_fn = tiny_pair
    opt = dict(cfg.sampling_option, **variant)
    jopt = JS.sanitize_sampling_option(JS.SamplingOption(**{k: v for k, v in opt.items() if k != "cfg_batched"}))
    popt = S.sanitize_sampling_option(S.SamplingOption(**opt), ae_spatial_compression(cfg))
    prompts = ["a cat playing piano", "raining, sea"]
    z = np.random.default_rng(5).standard_normal((2, 4, 2, 4, 4)).astype(np.float32)
    ref = _jax_generate(js, z, prompts, jopt)
    out = api_fn.generate(t(z), prompts, popt).numpy()
    assert out.shape == ref.shape == (2, 3, 5, 32, 32)
    assert max_rel_err(out, ref) <= TOL, max_rel_err(out, ref)


def test_denoiser_guidance_logic_matches_jax():
    """Oscillation and the temporal image-guidance ramp (the i2v-only path
    generate cannot reach for t2v), with a stand-in linear model run by
    both denoisers."""
    rng = np.random.default_rng(6)
    b, C, T, H, W = 1, 4, 3, 4, 4
    img3 = np.repeat(rng.standard_normal((b, T * H * W // 4, C * 4)).astype(np.float32), 3, axis=0)
    masks = (rng.uniform(size=(b, 1, T, H, W)) > 0.5).astype(np.float32)
    ref_lat = rng.standard_normal((b, C, T, H, W)).astype(np.float32)
    ts = np.linspace(1.0, 0.0, 14).astype(np.float32)  # 13 steps: oscillation starts at step 10
    w = rng.standard_normal((C * 4 + 4 + C * 4, C * 4)).astype(np.float32) * 0.3

    def model_j(img, cond, timesteps, guidance, **_):
        return jnp.concatenate([img, cond], -1) @ w * (1 + timesteps[:, None, None])

    def model_t(img, cond, timesteps, guidance, **_):
        return torch.cat([img, cond], -1) @ torch.from_numpy(w) * (1 + timesteps[:, None, None])

    kw = dict(guidance=5.0, guidance_img=3.0, text_osci=True, image_osci=True, scale_temporal_osci=True,
              patch_size=2)
    ref = JS.I2VDenoiser().denoise(model_j, img=jnp.asarray(img3), timesteps=jnp.asarray(ts),
                                   masks=jnp.asarray(masks), masked_ref=jnp.asarray(ref_lat), **kw)
    out = S.I2VDenoiser().denoise(model_t, img=t(img3), timesteps=t(ts), masks=t(masks), masked_ref=t(ref_lat), **kw)
    assert max_rel_err(out.numpy(), ref) <= 1e-5


def test_configs_parse_like_jax():
    """The port's parser reads the same config files (exec, _base_ merge,
    dotted and alias overrides) into the same values."""
    for name in sorted(os.listdir(CONFIG_DIR)):
        if not name.endswith(".py"):
            continue
        argv = [os.path.join(CONFIG_DIR, name), "--sampling_option.num_steps", "7", "--num-frames", "33"]
        ours = parse_configs(list(argv)).to_dict()
        theirs = jparse_configs(list(argv)).to_dict()
        assert ours == theirs, name


def test_image_sizes_and_sampling_helpers_match_jax():
    for res in ("256px", "768px", "360p"):
        for ar in ("16:9", "9:16", "1:1", "4:3", "2.39:1"):
            assert get_image_size(res, ar, training=False) == jget_image_size(res, ar, training=False)
    assert get_image_size("256px", "16:9", training=False) == (192, 336)
    for steps, seq, frames, shift in ((50, 2079, 33, True), (2, 4, 2, False), (10, 100, 1, True)):
        np.testing.assert_allclose(S.get_schedule(steps, seq, frames, shift=shift).numpy(),
                                   np.asarray(JS.get_schedule(steps, seq, frames, shift=shift)), atol=1e-6)
    x = np.random.default_rng(7).standard_normal((2, 4, 3, 8, 6)).astype(np.float32)
    packed = S.pack(t(x)).numpy()
    np.testing.assert_array_equal(packed, np.asarray(JS.pack(jnp.asarray(x))))
    np.testing.assert_array_equal(S.unpack(t(packed), 64, 48, 3).numpy(), x)
    np.testing.assert_array_equal(S.build_img_ids(3, 8, 6, bs=2).numpy(), np.asarray(JS.build_img_ids(3, 8, 6, bs=2)))
    assert S.get_oscillation_gs(7.5, 11) == JS.get_oscillation_gs(7.5, 11) == 1.0


def test_cli_tiny_dev_shape_and_determinism(tmp_path):
    from opensora_torch.inference import main

    runs = []
    for r in range(2):
        save_dir = str(tmp_path / f"run{r}")
        paths = main([TINY_DEV, "--prompt", "raining, sea", "--motion-score", "4", "--num-sample", "2",
                      "--device", "cpu", "--save_dir", save_dir])
        assert [os.path.basename(p) for p in paths] == ["sample_0000.mp4", "sample_0001.mp4"]
        runs.append([read_frames(p) for p in paths])
        with open(os.path.join(save_dir, "sample_0000.txt")) as f:
            assert f.read() == "raining, sea 4 motion score."
    for a, b in zip(*runs):
        assert a.shape == (5, 32, 32, 3) and a.dtype == np.uint8
        np.testing.assert_array_equal(a, b)  # same seed, same video
    assert np.abs(runs[0][0].astype(int) - runs[0][1]).max() > 0  # seeds differ per sample


def test_entry_points_need_a_gpu_unless_asked_for_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = parse_configs([TINY_DEV])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        prepare_models(cfg)
    model, *_ = prepare_models(cfg, device="cpu")
    assert next(model.parameters()).device.type == "cpu"


def test_sampling_option_fields_match_jax():
    ours = [f.name for f in dataclasses.fields(S.SamplingOption)]
    assert ours == [f.name for f in dataclasses.fields(JS.SamplingOption)]


def test_cli_reads_prompts_from_csv_with_dataset_suffixes(tmp_path):
    """Prompts from dataset.data_path (stdlib csv, quoted commas kept) get the
    dataset's fps and motion-score suffixes, as the JAX text dataset adds."""
    import csv

    from opensora_torch.inference import text_dataset

    path = tmp_path / "prompts.csv"
    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["text"])
        w.writerows([["raining, sea"], ["a cat."]])
    cfg = parse_configs([os.path.join(CONFIG_DIR, "256px.py"), "--dataset.data_path", str(path)])
    assert text_dataset(cfg, None).texts == ["raining, sea. 16 FPS. 4 motion score.",
                                             "a cat. 16 FPS. 4 motion score."]
    assert text_dataset(cfg, "x").texts == ["x. 16 FPS. 4 motion score."]


def test_cli_tiny_dev_w8a8_writes_a_finite_sample(tmp_path):
    """The int8 serving path through the CLI on the CPU: tiny_dev.py with
    --model.quantized w8a8 quantizes the drawn MMDiT's blocks at build and
    writes a sample; the quantized model's weights are those of the float
    model drawn from the same seed, quantized."""
    from opensora_torch.inference import main
    from opensora_torch.ops.quant import QuantLinear, quantize_weight

    paths = main([TINY_DEV, "--prompt", "raining, sea", "--model.quantized", "w8a8", "--device", "cpu",
                  "--save_dir", str(tmp_path)])
    sample = read_frames(paths[0])
    assert sample.shape == (5, 32, 32, 3) and sample.dtype == np.uint8 and sample.std() > 0

    cfg = parse_configs([TINY_DEV, "--model.quantized", "w8a8"])
    model, *_ = prepare_models(cfg, device="cpu", seed=3)
    float_model, *_ = prepare_models(parse_configs([TINY_DEV]), device="cpu", seed=3)
    assert model.config.quantized == "w8a8"
    quant = {n: m for n, m in model.named_modules() if isinstance(m, QuantLinear)}
    assert len(quant) == 13 and not isinstance(model.img_in, QuantLinear)
    for name, m in quant.items():
        q, s = quantize_weight(float_model.get_submodule(name).weight)
        assert torch.equal(m.weight_q, q) and torch.equal(m.weight_scale, s), name
    x = float_model.double_blocks[0].img_attn.qkv
    assert torch.equal(quant["double_blocks.0.img_attn.qkv"].bias, x.bias)


def test_prepare_models_quantizes_each_block_as_it_is_built():
    """With model.quantized, the float MMDiT never exists whole: when a block
    is registered in the model, the float linears of every earlier block are
    already freed (swapped for int8), so at most one block's float weights
    live at a time; and the mode is recorded in the model's config."""
    import weakref

    from opensora_torch.models.mmdit.layers import DoubleStreamBlock, SingleStreamBlock

    refs, most_alive = [], []

    def hook(parent, name, sub):  # runs before prepare_models' own hook
        if isinstance(sub, (DoubleStreamBlock, SingleStreamBlock)):
            refs.extend(weakref.ref(m) for m in sub.modules() if isinstance(m, torch.nn.Linear))
            most_alive.append(sum(r() is not None for r in refs))

    handle = torch.nn.modules.module.register_module_module_registration_hook(hook)
    try:
        model, *_ = prepare_models(parse_configs([TINY_DEV, "--model.quantized", "w8a8_fq"]), device="cpu", seed=3)
    finally:
        handle.remove()
    assert most_alive == [10, 3]  # one double block's linears, then one single block's
    assert all(r() is None for r in refs) and model.config.quantized == "w8a8_fq"
    assert all(not isinstance(m, torch.nn.Linear) for m in model.double_blocks.modules())
