"""Image- and video-conditioned generation (i2v, v2v) and the distilled
image stage of t2i2v in the PyTorch port, against the JAX package on the
CPU with the same numpy inputs:

- ``DistilledDenoiser`` over a tiny guidance-embedded MMDiT;
- ``prepare_inference_condition`` for every cond type, causal or not
  (exactly equal), and ``add_noise_to_ref`` given the same noise;
- ``read_from_path`` (png, mp4, and the port's own ``.npy`` sample) and
  ``collect_references_batch`` with a deterministic stand-in encoder;
- the conditioned slice: ``tiny_dev.py`` with i2v_head, i2v_tail, i2v_loop
  and v2v_head_easy, the port's ``generate`` against the JAX package's
  api_fn body given the same noise and encoded references (the latent-frame
  replacement included), and the non-causal trim on a tiny DC-AE.

Tolerances: exact for the masks and masked latents; 1e-6 for the noised
reference (one fp32 multiply-add); 1e-3 after normalization for the media
read (the port resizes with torch's bilinear, the JAX package with
cv2.INTER_LINEAR: they differ by at most 0.018 of 255 on a downscale,
1.4e-4 after normalization; 0 at an integer ratio); 2e-4 of the output's
scale for the denoiser and the slices (fp32 sampling steps through MMDiT
and AE, sums in another order), as the text-to-video slice test holds.
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from opensora_tpu.datasets.utils import read_from_path as jread_from_path
from opensora_tpu.models.dc_ae.model import DCAE as JDCAE
from opensora_tpu.models.dc_ae.model import DCAEConfig as JDCAEConfig
from opensora_tpu.models.mmdit.model import MMDiTConfig as JMMDiTConfig
from opensora_tpu.models.mmdit.model import MMDiTModel as JMMDiT
from opensora_tpu.utils import sampling as JS
from opensora_tpu.utils.inference import add_noise_to_ref as jadd_noise_to_ref
from opensora_tpu.utils.inference import collect_references_batch as jcollect
from opensora_tpu.utils.inference import prepare_inference_condition as jprepare_condition

from opensora_torch.datasets.utils import read_from_path
from opensora_torch.models.dc_ae.model import DCAE, DCAEConfig
from opensora_torch.models.mmdit.model import MMDiTConfig, MMDiTModel
from opensora_torch.utils import sampling as S
from opensora_torch.utils.api import prepare_api
from opensora_torch.utils.config import ae_spatial_compression, parse_configs
from opensora_torch.utils.inference import add_noise_to_ref, collect_references_batch, prepare_inference_condition
from opensora_torch.utils.weights import dc_ae_state_dict, load_numpy_state_dict, mmdit_state_dict
from test_torch_pipeline import CONFIG_DIR, TOL, tiny_models, tiny_pair  # noqa: F401  (module fixtures)
from torch_parity_utils import max_rel_err, randomize, t, to_numpy

COND_TYPES = ["t2v", "i2v_head", "i2v_tail", "i2v_loop", "v2v_head", "v2v_tail", "v2v_head_easy", "v2v_tail_easy"]
READ_TOL = 1e-3


def _rng(seed):
    return np.random.default_rng(seed)


def _tiny_mmdit_pair(**overrides):
    """tiny_dev.py's MMDiT in both packages with the same seeded weights."""
    cfg = parse_configs([os.path.join(CONFIG_DIR, "tiny_dev.py")])
    mkw = dict({k: v for k, v in cfg.model.items() if k != "type"}, **overrides)
    jm = JMMDiT(JMMDiTConfig(**mkw))
    B, Li, Lt, ps = 1, 8, 4, mkw.get("patch_size", 2)
    z = lambda *s: jnp.zeros(s)  # noqa: E731
    c = mkw["in_channels"]
    cond = z(B, Li, c + ps**2) if mkw["cond_embed"] else None
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0), z(B, Li, c), z(B, Li, 3), z(B, Lt, 64), z(B, Lt, 3),
                            z(B), z(B, 32), cond, z(B))
    params = randomize(to_numpy(shapes["params"]), 4, 0.05)
    model = MMDiTModel(MMDiTConfig(**mkw), device="meta", dtype=torch.float32).eval()
    load_numpy_state_dict(model, mmdit_state_dict(params))
    return (lambda **kw: jm.apply({"params": params}, **kw)), model


def test_distilled_denoiser_matches_jax():
    """The Euler loop with the guidance vector, the I2V-only arguments
    dropped, over a guidance-embedded MMDiT without cond_embed (the Flux
    image stage's kind)."""
    model_j, model_t = _tiny_mmdit_pair(cond_embed=False)
    rng = _rng(0)
    b, L, Lt = 2, 8, 4
    inputs = dict(img=rng.standard_normal((b, L, 16)), img_ids=S.build_img_ids(1, 4, 8, bs=b).numpy(),
                  txt=rng.standard_normal((b, Lt, 64)), txt_ids=np.zeros((b, Lt, 3)),
                  y_vec=rng.standard_normal((b, 32)))
    inputs = {k: np.asarray(v, np.float32) for k, v in inputs.items()}
    ts = np.asarray(S.get_schedule(3, L, 1).numpy())
    dropped = dict(masks=None, masked_ref=None, text_osci=True, image_osci=True, scale_temporal_osci=False,
                   patch_size=2, guidance_img=3.0, cfg_batched=True)
    ref = JS.DistilledDenoiser().denoise(model_j, timesteps=jnp.asarray(ts), guidance=4.0,
                                         **{k: jnp.asarray(v) for k, v in inputs.items()}, **dropped)
    steps = []
    with torch.no_grad():
        out = S.SamplingMethodDict[S.SamplingMethod.DISTILLED].denoise(
            model_t, timesteps=t(ts), guidance=4.0, step_seconds=steps, **{k: t(v) for k, v in inputs.items()},
            **dropped)
    assert len(steps) == 3 and out.shape == ref.shape
    assert max_rel_err(out.numpy(), ref) <= TOL, max_rel_err(out.numpy(), ref)
    assert S.DistilledDenoiser().prepare_guidance(["a", "b"], neg=["c", "d"]) == (["a", "b"], {})


def _ref_latents(cond_type, C, T, H, W, seed):
    """One sample's encoded references: a latent clip for v2v, one frame
    (two for i2v_loop) for i2v."""
    rng = _rng(seed)
    if cond_type.startswith("v2v"):
        return [rng.standard_normal((C, T, H, W)).astype(np.float32)]
    n = 2 if cond_type == "i2v_loop" else 1
    return [rng.standard_normal((C, 1, H, W)).astype(np.float32) for _ in range(n)]


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("cond_type", COND_TYPES)
def test_prepare_inference_condition_equals_jax(cond_type, causal):
    B, C, T, H, W = 3, 4, 20, 2, 3
    z = _rng(1).standard_normal((B, C, T, H, W)).astype(np.float32)
    if cond_type == "t2v":
        refs = None
    else:  # the middle sample has no reference
        refs = [_ref_latents(cond_type, C, T, H, W, 2), None, _ref_latents(cond_type, C, T, H, W, 3)]
    jm, jz = jprepare_condition(jnp.asarray(z), cond_type, ref_list=refs, causal=causal)
    tm, tz = prepare_inference_condition(
        t(z), cond_type, ref_list=None if refs is None else [r and [t(x) for x in r] for r in refs], causal=causal)
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    np.testing.assert_array_equal(tz.numpy(), np.asarray(jz))
    assert tm.shape == (B, 1, T, H, W) and tz.dtype == torch.float32
    if cond_type.startswith("v2v"):
        k = (16 if "easy" in cond_type else 8) + int(causal)
        assert int(tm[0, 0, :, 0, 0].sum()) == k and int(tm[1].sum()) == 0


def test_prepare_inference_condition_needs_references():
    z = torch.zeros(1, 4, 3, 2, 2)
    with pytest.raises(ValueError, match="reference is required"):
        prepare_inference_condition(z, "i2v_head")
    with pytest.raises(ValueError, match="Unknown mask condition"):
        prepare_inference_condition(z, "i2v_middle", ref_list=[[torch.zeros(4, 1, 2, 2)]])


def test_add_noise_to_ref_given_the_same_noise():
    rng = _rng(4)
    masked_ref = rng.standard_normal((2, 4, 3, 2, 2)).astype(np.float32)
    masks = (rng.uniform(size=(2, 1, 3, 2, 2)) > 0.5).astype(np.float32)
    key = jax.random.PRNGKey(5)
    ref = jadd_noise_to_ref(jnp.asarray(masked_ref), jnp.asarray(masks), 0.7, key)
    noise = np.asarray(jax.random.normal(key, masked_ref.shape, jnp.float32))
    out = add_noise_to_ref(t(masked_ref), t(masks), 0.7, noise=t(noise))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-6)
    drawn = add_noise_to_ref(t(masked_ref), t(masks), 0.7, generator=torch.Generator().manual_seed(0))
    assert (drawn[t(masks).expand_as(drawn) == 0] == 0).all() and drawn.abs().sum() > 0


@pytest.fixture(scope="module")
def media(tmp_path_factory):
    """A png (40 x 48), a 70-frame mp4 (40 x 48) written with cv2, and the
    png's frame as the port's ``.npy`` sample."""
    import cv2

    root = tmp_path_factory.mktemp("media")
    rng = _rng(6)
    img = rng.integers(0, 256, (40, 48, 3), dtype=np.uint8)
    png = str(root / "ref.png")
    cv2.imwrite(png, cv2.cvtColor(img, cv2.COLOR_RGB2BGR))
    npy = str(root / "ref.npy")
    np.save(npy, img[None])
    mp4 = str(root / "ref.mp4")
    writer = cv2.VideoWriter(mp4, cv2.VideoWriter_fourcc(*"mp4v"), 16, (48, 40))
    base = rng.integers(0, 256, (40, 48, 3), dtype=np.uint8)
    for i in range(70):
        writer.write(np.roll(base, i, axis=1))
    writer.release()
    return dict(png=png, mp4=mp4, npy=npy)


@pytest.mark.parametrize("size", [(32, 32), (40, 48), (20, 24), (64, 80)], ids=["down", "same", "half", "up"])
@pytest.mark.parametrize("kind", ["png", "mp4"])
def test_read_from_path_matches_jax(media, kind, size):
    ours = read_from_path(media[kind], size)
    ref = np.asarray(jread_from_path(media[kind], size))
    assert ours.shape == ref.shape and ours.shape[2:] == size and ours.dtype == np.float32
    assert np.abs(ours - ref).max() <= READ_TOL, np.abs(ours - ref).max()
    if size in ((40, 48), (20, 24)):  # identity and an integer ratio: the same values
        np.testing.assert_allclose(ours, ref, atol=1e-6)


def test_npy_sample_reads_as_the_png_of_the_same_bytes(media):
    for size in ((40, 48), (32, 32)):
        np.testing.assert_array_equal(read_from_path(media["npy"], size), read_from_path(media["png"], size))
    with pytest.raises(ValueError, match="uint8 frames"):
        bad = media["npy"].replace(".npy", "_f32.npy")
        np.save(bad, np.zeros((1, 4, 4, 3), np.float32))
        read_from_path(bad, (4, 4))


def _stand_in_encode(x):
    """A deterministic 'encoder': every other channel, 4x4 pooled."""
    x = np.asarray(x, np.float32)
    b, c, tt, h, w = x.shape
    return x[:, ::2].reshape(b, 2, tt, h // 4, 4, w // 4, 4).mean(axis=(4, 6))


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("cond_type", ["i2v_head", "i2v_tail", "i2v_loop", "v2v_head", "v2v_tail_easy"])
def test_collect_references_batch_matches_jax(media, cond_type, causal):
    if cond_type.startswith("v2v"):
        paths = [media["mp4"], ""]
    else:
        paths = [media["png"], f"{media['png']};{media['mp4']}"]
    ours = collect_references_batch(paths, cond_type, _stand_in_encode, (32, 32), is_causal=causal)
    ref = jcollect(paths, cond_type, _stand_in_encode, (32, 32), is_causal=causal)
    assert len(ours) == len(ref) == 2
    for o, r in zip(ours, ref):
        assert (o is None) == (r is None)
        if o is None:
            continue
        assert len(o) == len(r) == (2 if cond_type == "i2v_loop" else 1)
        for a, b in zip(o, r):
            assert a.shape == np.asarray(b).shape
            assert np.abs(a - np.asarray(b)).max() <= READ_TOL
    if cond_type.startswith("v2v"):
        want = (64 if "easy" in cond_type else 32) + int(causal)
        assert ours[0][0].shape[1] == want
    with pytest.raises(ValueError, match="v2v needs"):
        collect_references_batch([media["png"]], "v2v_head", _stand_in_encode, (32, 32))


def _jax_conditioned(js, decode, z, prompts, opt, cond_type, refs, unpack):
    """The JAX package's api_fn body (opensora_tpu/utils/api.py:264-328)
    from the noise and the encoded references on."""
    num_frames = z.shape[2]
    denoiser = JS.SamplingMethodDict[opt.method]
    timesteps = JS.get_schedule(opt.num_steps, (z.shape[-1] * z.shape[-2]) // unpack["patch_size"]**2, num_frames,
                                shift=opt.shift, shift_alpha=opt.flow_shift)
    text, additional = denoiser.prepare_guidance(text=prompts, neg=None, guidance_img=opt.guidance_img)
    zj = jnp.asarray(z)
    inp = JS.prepare(js["t5"], js["clip"], zj, prompt=text, patch_size=unpack["patch_size"])
    img = inp.pop("img")
    masks, masked_ref = jprepare_condition(zj, cond_type, ref_list=refs, causal=opt.is_causal_vae)
    x = denoiser.denoise(
        js["model"], img=img, timesteps=timesteps, guidance=opt.guidance,
        guidance_img=additional.get("guidance_img") or 1.0, masks=masks, masked_ref=masked_ref,
        text_osci=opt.text_osci, image_osci=opt.image_osci,
        scale_temporal_osci=opt.scale_temporal_osci and "i2v" in cond_type, patch_size=unpack["patch_size"],
        cfg_batched=True, **{k: inp[k] for k in ("img_ids", "txt", "txt_ids", "y_vec")},
    )
    x = JS.unpack(x.astype(jnp.float32), opt.height, opt.width, num_frames, patch_size=unpack["patch_size"])
    if cond_type == "i2v_head":
        x = x.at[0, :, :1].set(refs[0][0])
    elif cond_type == "i2v_tail":
        x = x.at[0, :, -1:].set(refs[0][0])
    elif cond_type == "i2v_loop":
        x = x.at[0, :, :1].set(refs[0][0])
        x = x.at[0, :, -1:].set(refs[0][1])
    x = np.asarray(decode(x))[:, :, : opt.num_frames]
    if not opt.is_causal_vae:
        pad = unpack["pad_len"]
        x = {"i2v_head": x[:, :, pad:], "i2v_tail": x[:, :, :-pad], "i2v_loop": x[:, :, pad:-pad]}.get(cond_type, x)
    return x


@pytest.mark.parametrize("cond_type,variant", [
    ("i2v_head", dict(guidance_img=2.0, image_osci=True, scale_temporal_osci=True)),
    ("i2v_tail", {}),
    ("i2v_loop", dict(num_steps=3, guidance_img=2.0)),
    ("v2v_head_easy", dict(num_frames=73)),  # 19 latent frames, 17 of them conditioned
])
def test_conditioned_slice_matches_jax(tiny_pair, cond_type, variant):  # noqa: F811
    cfg, js, api_fn = tiny_pair
    opt = dict(cfg.sampling_option, **variant)
    jopt = JS.sanitize_sampling_option(JS.SamplingOption(**opt))
    popt = S.sanitize_sampling_option(S.SamplingOption(**opt), ae_spatial_compression(cfg))
    prompts = ["a cat playing piano", "raining, sea"]
    T = (popt.num_frames - 1) // popt.temporal_reduction + 1
    z = _rng(7).standard_normal((2, 4, T, 4, 4)).astype(np.float32)
    refs = [_ref_latents(cond_type, 4, 17, 4, 4, 8),
            None if cond_type == "i2v_tail" else _ref_latents(cond_type, 4, 17, 4, 4, 9)]
    ref = _jax_conditioned(js, js["vae"], z, prompts, jopt, cond_type, refs, dict(patch_size=2))
    out = api_fn.generate(t(z), prompts, popt, cond_type, [r and [t(x) for x in r] for r in refs]).numpy()
    assert out.shape == ref.shape == (2, 3, popt.num_frames, 32, 32)
    assert max_rel_err(out, ref) <= TOL, max_rel_err(out, ref)


def test_references_change_the_video(tiny_pair):  # noqa: F811
    """An i2v video differs from the t2v video of the same noise, and the
    api_fn without ``ref`` falls back to t2v as the JAX package does."""
    cfg, _, api_fn = tiny_pair
    opt = S.sanitize_sampling_option(S.SamplingOption(**cfg.sampling_option), ae_spatial_compression(cfg))
    z = t(_rng(10).standard_normal((1, 4, 2, 4, 4)).astype(np.float32))
    refs = [[t(x) for x in _ref_latents("i2v_head", 4, 1, 4, 4, 11)]]
    t2v = api_fn.generate(z, ["a cat"], opt, "t2v")
    i2v = api_fn.generate(z, ["a cat"], opt, "i2v_head", refs)
    assert (t2v - i2v).abs().max() > 1e-3
    np.testing.assert_array_equal(api_fn(opt, "i2v_head", seed=3, text=["a cat"]).numpy(),
                                  api_fn(opt, "t2v", seed=3, text=["a cat"]).numpy())


DCAE_TINY = dict(width_list=(8, 16, 16, 16, 32, 32), encoder_depth_list=(1,) * 6, decoder_depth_list=(1,) * 6,
                 latent_channels=8)


@pytest.fixture(scope="module")
def dcae_pair(tiny_models):  # noqa: F811
    """tiny_dev.py's text encoders with a patch-1 MMDiT over a tiny DC-AE's
    8-channel latents (non-causal, 4x in time, 32x in space)."""
    _, js, models = tiny_models
    model_j, model_t = _tiny_mmdit_pair(in_channels=8, patch_size=1)
    jm = JDCAE(JDCAEConfig(**DCAE_TINY, dtype="fp32"))
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0), jnp.zeros((1, 3, 8, 64, 64)))
    params = randomize(to_numpy(shapes["params"]), 12, 0.1)
    ae = DCAE(DCAEConfig(**DCAE_TINY, dtype="fp32"), device="meta", dtype=torch.float32).eval()
    load_numpy_state_dict(ae, dc_ae_state_dict(params))
    decode = jax.jit(lambda x: jm.apply({"params": params}, x, method=JDCAE.decode))
    api_fn = prepare_api(model_t, ae, models["model_t5"], models["model_clip"], spatial_compression=32)
    return dict(js, model=model_j), decode, api_fn


@pytest.mark.parametrize("cond_type", ["i2v_head", "i2v_tail", "i2v_loop", "t2v"])
def test_noncausal_trim_on_dc_ae_matches_jax(dcae_pair, monkeypatch, cond_type):
    """A non-causal AE (DC-AE, 4x in time) decodes time_compression_ratio - 1
    padding frames beside a fixed head or tail frame; both packages trim
    them."""
    js, decode, api_fn = dcae_pair
    monkeypatch.setenv("AE_SPATIAL_COMPRESSION", "32")  # the JAX package's unpack reads it
    opt = dict(height=64, width=64, num_frames=8, num_steps=2, guidance=4.0, guidance_img=1.0,
               is_causal_vae=False, temporal_reduction=4, method="i2v", seed=0)
    jopt = JS.sanitize_sampling_option(JS.SamplingOption(**opt))
    popt = S.sanitize_sampling_option(S.SamplingOption(**opt), 32)
    z = _rng(13).standard_normal((1, 8, 2, 2, 2)).astype(np.float32)
    refs = None if cond_type == "t2v" else [_ref_latents(cond_type, 8, 1, 2, 2, 14)]
    ref = _jax_conditioned(js, decode, z, ["a cat"], jopt, cond_type, refs, dict(patch_size=1, pad_len=3))
    out = api_fn.generate(t(z), ["a cat"], popt, cond_type, refs and [[t(x) for x in refs[0]]],
                          patch_size=1).numpy()
    frames = {"i2v_head": 5, "i2v_tail": 5, "i2v_loop": 2, "t2v": 8}[cond_type]
    assert out.shape == ref.shape == (1, 3, frames, 64, 64)
    assert max_rel_err(out, ref) <= TOL, max_rel_err(out, ref)


def test_image_stage_config_keeps_ckpt_rope_convention():
    """t2i2v_256px.py's img_flux (original-Flux weights, interleaved RoPE
    pairing) builds with the field set; the video model keeps "split"."""
    from opensora_torch.registry import MODELS, build_module
    from opensora_torch.utils.api import prepare_models  # noqa: F401  (registers the models)

    cfg = parse_configs([os.path.join(CONFIG_DIR, "t2i2v_256px.py")])
    img_flux = build_module(dict(cfg.img_flux), MODELS, device="meta")
    assert img_flux.config.ckpt_rope_convention == "interleaved" and img_flux.config.guidance_embed
    assert img_flux.config.rope_convention == "split" and not img_flux.config.cond_embed
    assert MMDiTConfig().ckpt_rope_convention == JMMDiTConfig().ckpt_rope_convention == "split"
    ae = build_module(dict(cfg.img_flux_ae), MODELS, device="meta")
    assert ae.spatial_compression_ratio == 8 and cfg.cond_type == "i2v_head"
