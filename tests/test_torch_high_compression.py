"""The high-compression path of the port -- ``configs/diffusion/{inference,
train}/high_compression.py``: Video DC-AE latents (128 channels, 32x in
space, 4x in time, non-causal, tiled in time and space) under an MMDiT at
patch_size 1 -- against the JAX package on the CPU, at a tiny width with
the configs' structure and the same seeded numpy weights:

- the configs' geometry (cond_in takes 129 channels; 129 frames at 192 x
  320, the 256px 16:9 size at 32 px a token, make 32 x 6 x 10 latent
  tokens);
- ``api_fn`` t2v at a width that is no multiple of 32 (the 336 -> 11
  columns -> 352 case) and ``i2v_head`` from a png reference, against the
  JAX package's ``api_fn`` given the same noise (the reference encoded by
  each package's DC-AE, tiled in time and space; the non-causal trim);
- what the DC-AE cannot encode: a tile of 4k + 1 frames or a width that is
  no multiple of 32 fails in both packages alike (the 4k + 1-frame buckets
  of the training config, and 336 px, the 256px 16:9 width at 16 px a
  token);
- ``Trainer.run_batch`` on the training config against the JAX step (the
  DC-AE encode, the i2v_head conditions, patch-1 packing, shift, masked
  loss, clip + AdamW, EMA), and the causal condition layout that both
  trainers give a non-causal AE (the JAX trainer never passes ``causal``);
- the training CLI over small mp4 files.

Tolerances: ``TOL`` = 2e-4 of the output's scale for videos and latents
(fp32 through DC-AE and MMDiT, sums in another order), as the text-to-video
slice holds; 1e-4 relative for the loss and gradient norm and 1e-3 of each
parameter change's own scale after one step, plus one fp32 spacing of the
parameter that the change is rounded into (fp32, the train step's); masks
exact.
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from opensora_tpu.models.dc_ae.model import DCAE as JDCAE
from opensora_tpu.models.dc_ae.model import DCAEConfig as JDCAEConfig
from opensora_tpu.models.mmdit.model import MMDiTConfig as JMMDiTConfig
from opensora_tpu.models.mmdit.model import MMDiTModel as JMMDiT
from opensora_tpu.training import diffusion as jdiff
from opensora_tpu.utils import optimizer as jopt
from opensora_tpu.utils import sampling as JS
from opensora_tpu.utils import train as jtrain
from opensora_tpu.utils.api import ModelBundle
from opensora_tpu.utils.api import prepare_api as jprepare_api
from opensora_tpu.utils.config import parse_configs as jparse_configs

from opensora_torch.models.dc_ae.model import DCAE, DCAEConfig
from opensora_torch.models.mmdit.model import Flux, MMDiTConfig, MMDiTModel
from opensora_torch.utils import sampling as S
from opensora_torch.utils import train as ttrain
from opensora_torch.utils.api import prepare_api
from opensora_torch.utils.config import ae_spatial_compression, parse_configs
from opensora_torch.utils.logger import close_logger
from opensora_torch.utils.weights import dc_ae_state_dict, load_numpy_state_dict, mmdit_state_dict
from test_torch_pipeline import tiny_models  # noqa: F401  (module fixture: the tiny T5 / CLIP pair)
from test_torch_training import _jax_draws
from torch_parity_utils import max_rel_err, randomize, t, to_numpy

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), os.pardir))
INF_CFG = os.path.join(REPO, "configs", "diffusion", "inference", "high_compression.py")
TRAIN_CFG = os.path.join(REPO, "configs", "diffusion", "train", "high_compression.py")
TOL = 2e-4
STEP_TOL = 1e-4
UPDATE_TOL = 1e-3
# the configs' DC-AE narrowed; its tiles shrunk (256 px -> 128 px, 32 frames
# -> 16) so that a small clip is tiled in time and space as a 129-frame
# video is at full size
DCAE_TINY = dict(width_list=(8, 16, 16, 16, 32, 32), encoder_depth_list=(1,) * 6, decoder_depth_list=(1,) * 6,
                 latent_channels=8)
TILES = dict(use_spatial_tiling=True, use_temporal_tiling=True, spatial_tile_size=128, temporal_tile_size=16)
MMDIT_TINY = dict(in_channels=8, vec_in_dim=32, context_in_dim=64, hidden_size=64, mlp_ratio=2.0, num_heads=2,
                  depth=1, depth_single_blocks=1, axes_dim=[8, 12, 12], attn_backend="xla", dtype="fp32")


def _dcae_pair(seed=12, **cfg):
    """A tiny DC-AE in both packages with the same seeded weights."""
    jm = JDCAE(JDCAEConfig(**DCAE_TINY, dtype="fp32", **cfg))
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0), jnp.zeros((1, 3, 8, 64, 64)))
    params = randomize(to_numpy(shapes["params"]), seed, 0.1)
    ae = DCAE(DCAEConfig(**DCAE_TINY, dtype="fp32", **cfg), device="meta", dtype=torch.float32).eval()
    load_numpy_state_dict(ae, {k: v.copy() for k, v in dc_ae_state_dict(params).items()})
    return jm, params, ae


def _mmdit_pair(model_cfg: dict, seed=4):
    """The config's MMDiT at the tiny width in both packages, same weights."""
    mkw = dict({k: v for k, v in model_cfg.items() if k not in ("type", "from_pretrained")}, **MMDIT_TINY)
    jm = JMMDiT(JMMDiTConfig(**mkw))
    z = lambda *s: jnp.zeros(s)  # noqa: E731
    c = mkw["in_channels"]
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0), z(1, 8, c), z(1, 8, 3), z(1, 4, 64), z(1, 4, 3), z(1),
                            z(1, 32), z(1, 8, c + 1), None)
    params = randomize(to_numpy(shapes["params"]), seed, 0.05)
    model = MMDiTModel(MMDiTConfig(**mkw), device="meta", dtype=torch.float32).eval()
    load_numpy_state_dict(model, {k: v.copy() for k, v in mmdit_state_dict(params).items()})
    return jm, params, model


def test_configs_have_the_high_compression_geometry(monkeypatch):
    """cond_in takes the 128 latent channels + 1 mask channel (patch 1); 129
    frames at 192 x 320 (256px 16:9 snapped to 32 px, as the JAX package
    sizes it) make 32 x 6 x 10 latent tokens, as the JAX package's
    get_noise makes them; both configs name a non-causal DC-AE at 32x."""
    inf, train = parse_configs([INF_CFG]), parse_configs([TRAIN_CFG])
    for cfg in (inf, train):
        assert cfg.ae["type"] == "dc_ae" and ae_spatial_compression(cfg) == 32 and cfg.patch_size == 1
        model = Flux(**{k: v for k, v in cfg.model.items() if k != "type"}, device="meta")
        assert model.cond_in.in_features == 129 and model.img_in.in_features == 128
        assert model.final_layer.linear.out_features == 128
    # the training config's condition_config merges into stage1.py's, in
    # both packages' parsers: v2v_head, i2v_tail and i2v_loop stay in it
    assert train.is_causal_vae is False and dict(train.condition_config) == dict(
        t2v=1, i2v_head=7, i2v_tail=0.05, i2v_loop=0.05, v2v_head=0.05)
    assert train.to_dict() == jparse_configs([TRAIN_CFG]).to_dict()
    assert train.model["remat_policy"] == "dots" and train.ae["use_temporal_tiling"]
    opt = S.sanitize_sampling_option(S.SamplingOption(**inf.sampling_option), ae_spatial_compression(inf))
    assert (opt.height, opt.width, opt.is_causal_vae, opt.temporal_reduction) == (192, 320, False, 4)
    frames = opt.num_frames // opt.temporal_reduction  # non-causal: 129 // 4
    z = S.get_noise(1, opt.height, opt.width, frames, generator=torch.Generator().manual_seed(0), patch_size=1,
                    channel=128, spatial_compression=32)
    monkeypatch.setenv("AE_SPATIAL_COMPRESSION", "32")  # the JAX package's get_noise reads it
    jz = JS.get_noise(jax.random.PRNGKey(0), 1, opt.height, opt.width, frames, patch_size=1, channel=128)
    assert z.shape == jz.shape == (1, 128, 32, 6, 10) and S.pack(z, 1).shape == (1, 1920, 128)


@pytest.fixture(scope="module")
def hc_pair(tiny_models):  # noqa: F811
    """The inference config's MMDiT and DC-AE at a tiny width with tiny_dev's
    text encoders: (the JAX package's api_fn, the port's api_fn)."""
    _, js, models = tiny_models
    cfg = parse_configs([INF_CFG])
    jm, mparams, model = _mmdit_pair(cfg.model)
    jae, aparams, ae = _dcae_pair(**TILES)
    japi = jprepare_api(ModelBundle(jm, {"params": mparams}), ModelBundle(jae, {"params": aparams}),
                        js["t5"], js["clip"])
    api = prepare_api(model, ae, models["model_t5"], models["model_clip"], spatial_compression=32)
    return cfg, japi, api


@pytest.mark.parametrize("cond_type,height,width,frames", [
    ("t2v", 64, 144, 33),  # 144 -> 5 latent columns -> 160 decoded, as 336 -> 11 -> 352
    ("i2v_head", 64, 160, 33),  # a reference the DC-AE can encode: 160 = 128 + 32 in tiles
])
def test_api_fn_matches_jax(hc_pair, tmp_path, monkeypatch, cond_type, height, width, frames):
    """The inference config's sampling options (guidance 7.5 / 3.0,
    oscillation, the temporal image-guidance ramp, non-causal, 4x in time)
    at a small size, 2 steps: the port's api_fn against the JAX package's,
    the port handed the JAX noise. 33 frames make 8 latent frames, decoded
    by 3 temporal tiles of 4 and 2 spatial tiles (128 + 32 px) into 32
    frames; i2v_head trims the 3 padding frames of the fixed head."""
    import cv2

    cfg, japi, api = hc_pair
    seed, prompts = 5, ["a cat playing piano"]
    opt = dict(cfg.sampling_option, resolution=None, aspect_ratio=None, height=height, width=width,
               num_frames=frames, num_steps=2)
    kw = dict(patch_size=1, channel=8)
    if cond_type != "t2v":
        img = np.random.default_rng(6).integers(0, 256, (height, width, 3), dtype=np.uint8)
        path = str(tmp_path / "ref.png")
        cv2.imwrite(path, cv2.cvtColor(img, cv2.COLOR_RGB2BGR))
        kw["ref"] = [path]
    monkeypatch.setenv("AE_SPATIAL_COMPRESSION", "32")  # the JAX package's noise and unpack read it
    jopt = JS.sanitize_sampling_option(JS.SamplingOption(**opt))
    ref = np.asarray(japi(jopt, cond_type, seed, text=prompts, **kw))

    latent_t = frames // 4
    z = JS.get_noise(jax.random.split(jax.random.PRNGKey(seed))[0], 1, height, width, latent_t, dtype=jnp.float32,
                     patch_size=1, channel=8)

    def jax_noise(*args, **kwargs):
        assert args[3] == latent_t and kwargs["spatial_compression"] == 32 and kwargs["patch_size"] == 1
        return t(z)

    monkeypatch.setattr(S, "get_noise", jax_noise)
    popt = S.sanitize_sampling_option(S.SamplingOption(**opt), ae_spatial_compression(cfg))
    out = api(popt, cond_type, seed, text=prompts, **kw).numpy()
    want = (1, 3, 32 - (3 if cond_type == "i2v_head" else 0), height, 32 * -(-width // 32))
    assert out.shape == ref.shape == want
    assert max_rel_err(out, ref) <= TOL, max_rel_err(out, ref)


@pytest.mark.parametrize("shape,encodes", [
    ((1, 3, 33, 64, 64), False),  # the 33-frame bucket: tiles of 32 every 24 frames leave one of 9
    ((1, 3, 1, 192, 336), False),  # 256px 16:9 at 16 px a token: tiles of 256 every 192 px leave one of 144
    ((1, 3, 40, 64, 64), True),  # tiles of 32 and 16 frames
    ((1, 3, 1, 64, 320), True),  # tiles of 256 and 128 px
])
def test_dc_ae_encodes_only_what_its_tiles_divide(shape, encodes):
    """The DC-AE with the configs' own tiling (256 px, 32 frames, overlap
    1/4) halves each tile 5 times in space and twice in time. The training
    config's 4k + 1-frame buckets and a 336-px side (256px 16:9 at 16 px a
    token; at the configs' 32 it is 320) are not encodable: both packages
    fail there alike, and agree where the tiles divide."""
    tiling = dict(use_spatial_tiling=True, use_temporal_tiling=True)
    jm, params, ae = _dcae_pair(seed=3, **tiling)
    x = np.random.default_rng(7).uniform(-1, 1, shape).astype(np.float32)
    encode = jax.jit(lambda v: jm.apply({"params": params}, v, method=JDCAE.encode))
    if not encodes:
        with pytest.raises(TypeError, match="reshape"):
            encode(jnp.asarray(x))
        with torch.no_grad(), pytest.raises(RuntimeError, match="shape"):
            ae.encode(t(x))
        return
    ref = np.asarray(encode(jnp.asarray(x)))
    with torch.no_grad():
        out = ae.encode(t(x)).numpy()
    assert out.shape == ref.shape == (1, 8, max(1, shape[2] // 4), shape[3] // 32, shape[4] // 32)
    assert max_rel_err(out, ref) <= TOL


def _tiny_train_cfg(tmp_path, **extra) -> str:
    """The training config at the tiny width, its structure kept."""
    lines = [f"_base_ = [{TRAIN_CFG!r}]",
             f"model = dict(**{MMDIT_TINY!r})",
             f"ae = dict(**{dict(DCAE_TINY, **TILES, dtype='fp32')!r})",
             "t5 = dict(type='text_embedder', from_pretrained='', max_length=16, _tiny=True)",
             "clip = dict(type='text_embedder', from_pretrained='clip-tiny', max_length=16, _tiny=True)",
             *(f"{k} = {v!r}" for k, v in extra.items())]
    path = tmp_path / "hc_tiny.py"
    path.write_text("\n".join(lines) + "\n")
    return str(path)


def _set_weights(trainer, models, mparams, aparams):
    """The JAX pair's weights and tiny_models' text encoders into a built
    Trainer, in place (the optimizer holds the parameters), EMA restarted."""
    with torch.no_grad():
        for n, p in trainer.model.named_parameters():
            p.copy_(torch.from_numpy(mmdit_state_dict(mparams)[n]))
        for n, p in trainer.ae.state_dict().items():
            p.copy_(torch.from_numpy(dc_ae_state_dict(aparams)[n]))
    trainer.state.ema = {n: p.detach().float().clone() for n, p in trainer.state.params.items()}
    trainer.t5, trainer.clip = models["model_t5"], models["model_clip"]
    with torch.no_grad():
        trainer.null_txt, trainer.null_vec = trainer.t5([""]), trainer.clip([""])


def test_trainer_run_batch_matches_jax_step(tmp_path, tiny_models):  # noqa: F811
    """One iteration of the training config (warmup 0, lr 1e-2 and Adam's
    eps 1e-2, so that the first update is visible and not the sign of
    rounding): the
    port's Trainer.run_batch against the JAX train script's body -- DC-AE
    encode of a 32-frame 64 x 160 clip (tiled in time and space), the
    host's mask-type draw, the i2v_head frame encoded alone, patch-1
    packing, the shift over the DC-AE latents, the train step with the JAX
    draws -- from the same weights and text encoders."""
    from opensora_torch.train import Trainer

    _, js, models = tiny_models
    cfg = parse_configs([_tiny_train_cfg(tmp_path, warmup_steps=0, lr=1e-2, adam_eps=1e-2)])
    trainer = Trainer(cfg, "cpu")
    assert trainer.cfg.model["param_dtype"] == "fp32" and trainer.patch_size == 1
    jm, mparams, _ = _mmdit_pair(cfg.model, seed=8)
    jae, aparams, _ = _dcae_pair(seed=9, **TILES)
    _set_weights(trainer, models, mparams, aparams)

    video = np.random.default_rng(10).uniform(-1, 1, (2, 3, 32, 64, 160)).astype(np.float32)
    texts = ["a red panda", "waves at sunset"]
    prob, rng = cfg.dropout_ratio["t5"], jax.random.PRNGKey(3)
    captured = {}
    orig = trainer.train_step

    def step_with_jax_draws(state, tb, generator=None):
        captured["tb"] = tb
        draws = _jax_draws({k: tb[k].numpy() for k in ("x0", "shift_alpha")}, rng, 0, prob)
        return orig(state, tb, draws=draws)

    trainer.train_step = step_with_jax_draws
    p0 = {n: p.detach().clone() for n, p in trainer.state.params.items()}
    metrics = trainer.run_batch({"video": t(video), "text": texts})

    # the JAX train script's body (scripts/diffusion/train.py:306-350)
    encode = jax.jit(lambda x: jae.apply({"params": aparams}, x, method=JDCAE.encode))
    xj = jnp.asarray(video)
    latent = encode(xj)
    assert latent.shape == (2, 8, 8, 2, 5)
    mask_conds = jtrain.choose_mask_conditions(dict(cfg.condition_config), 2, latent.shape[2], 4,
                                               np.random.default_rng(cfg.seed))
    assert mask_conds == trainer.mask_conds and "i2v_head" in mask_conds
    masks, cond = jtrain.build_visual_condition(xj, mask_conds, encode, latent, 4)
    inp = JS.prepare(js["t5"], js["clip"], latent, prompt=texts, seq_align=cfg.seq_align, patch_size=1)
    null_txt, null_vec = np.asarray(js["t5"]([""])), np.asarray(js["clip"]([""]))
    jtb = dict(x0=inp["img"], img_ids=inp["img_ids"], txt=inp["txt"], txt_ids=inp["txt_ids"], y_vec=inp["y_vec"],
               cond=JS.pack(cond, patch_size=1), masks=masks,
               guidance=jnp.full((2,), cfg.guidance, jnp.float32),
               shift_alpha=jnp.full((2,), jdiff.compute_shift_alpha(2, 5, 8), jnp.float32),
               null_txt=jnp.broadcast_to(jnp.asarray(null_txt[:, :inp["txt"].shape[1]]), inp["txt"].shape),
               null_vec=jnp.broadcast_to(jnp.asarray(null_vec), inp["y_vec"].shape))
    tb = captured["tb"]
    np.testing.assert_array_equal(tb["masks"].numpy(), np.asarray(masks))
    for k in ("x0", "cond", "txt", "y_vec", "img_ids", "shift_alpha"):
        assert tb[k].shape == jtb[k].shape and max_rel_err(tb[k].numpy(), jtb[k]) <= TOL, k

    tx = jopt.create_optimizer(lr=cfg.lr, weight_decay=cfg.weight_decay, eps=cfg.adam_eps,
                               warmup_steps=cfg.warmup_steps, grad_clip=cfg.grad_clip)
    jmodel = JMMDiT(JMMDiTConfig(**{k: v for k, v in trainer.cfg.model.items() if k not in ("type",)}))
    jstate = jdiff.TrainState.create(jax.tree.map(jnp.asarray, mparams), tx, ema=True)
    jstep = jax.jit(jdiff.make_train_step(jmodel, tx, ema_decay=cfg.ema_decay, text_dropout_prob=prob,
                                          use_masked_loss=True, patch_size=1))
    jstate, jmetrics = jstep(jstate, jtb, rng)
    assert float(metrics["loss"]) == pytest.approx(float(jmetrics["loss"]), rel=STEP_TOL)
    assert float(metrics["grad_norm"]) == pytest.approx(float(jmetrics["grad_norm"]), rel=STEP_TOL)
    want_p, want_e = mmdit_state_dict(to_numpy(jstate.params)), mmdit_state_dict(to_numpy(jstate.ema_params))
    for n, p in trainer.state.params.items():
        d = want_p[n] - p0[n].numpy()
        assert p.dtype == torch.float32 and np.abs(d).max() > 0, n
        limit = UPDATE_TOL * np.abs(d).max() + np.spacing(np.abs(p0[n].numpy())).max()
        assert np.abs(p.detach().numpy() - p0[n].numpy() - d).max() <= limit, n
        assert max_rel_err(trainer.state.ema[n].numpy(), want_e[n]) <= STEP_TOL, n


def test_trainer_keeps_the_jax_trainers_causal_condition_layout(tmp_path):
    """The JAX trainer never passes ``causal`` to the visual condition
    (scripts/diffusion/train.py:313-321), so a non-causal AE gets the causal
    layout; the port's Trainer does the same. It shows with v2v_head, which
    the training config keeps from stage1.py: a 48-frame clip (12 latent
    frames) conditions 9 latent frames, (33 - 1) // 4 + 1, where a
    non-causal layout would take 32 // 4 = 8. t2v and i2v_head take the
    same frames either way."""
    from opensora_torch.train import Trainer

    cfg = parse_configs([_tiny_train_cfg(tmp_path)])
    cfg["condition_config"] = {"v2v_head": 1.0}
    trainer = Trainer(cfg, "cpu")
    captured = {}
    orig = trainer.train_step
    trainer.train_step = lambda state, tb, gen=None: (captured.update(tb=tb), orig(state, tb, gen))[1]
    video = torch.rand((1, 3, 48, 64, 64), generator=torch.Generator().manual_seed(0)) * 2 - 1
    trainer.run_batch({"video": video, "text": ["a cat"]})
    masks = captured["tb"]["masks"]
    assert trainer.mask_conds == ["v2v_head"] and masks.shape == (1, 1, 12, 2, 2)
    assert masks[0, 0, :, 0, 0].tolist() == [1.0] * 9 + [0.0] * 3
    latent = trainer.ae.encode(video).detach()
    jmasks, _ = jtrain.build_visual_condition(jnp.asarray(video.numpy()), ["v2v_head"], None,
                                              jnp.asarray(latent.numpy()), 4)
    np.testing.assert_array_equal(masks.numpy(), np.asarray(jmasks))
    noncausal, _ = ttrain.build_visual_condition(video, ["v2v_head"], None, latent, 4, causal=False)
    assert int(noncausal[0, 0, :, 0, 0].sum()) == 8
    for mc in ("t2v", "i2v_head"):
        both = [ttrain.build_visual_condition(video, [mc], lambda x: trainer.ae.encode(x), latent, 4, causal=c)[0]
                for c in (True, False)]
        assert torch.equal(*both)


def test_train_cli_high_compression_runs_a_full_finetune(tmp_path):
    """``python -m opensora_torch.train`` on the training config (tiny width,
    one 8-frame 64 x 64 bucket of batch 2 the DC-AE can encode) trains the
    fp32 masters of a bf16-computing MMDiT for two steps and writes its
    checkpoint with the masters and the EMA."""
    from opensora_torch import train as train_cli
    from test_torch_train_cli import _losses, _write_videos

    csv = _write_videos(str(tmp_path / "videos"), n=4, frames=16, size=96)
    cfg = _tiny_train_cfg(tmp_path, bucket_config={"_delete_": True, "64px": {8: (1.0, 2)}}, warmup_steps=0)
    out = str(tmp_path / "out")
    try:
        trainer = train_cli.main([cfg, "--device", "cpu", "--outputs", out, "--dataset.data_path", csv,
                                  "--exp_name", "hc", "--epochs", "1", "--model.dtype", "bf16", "--log_every", "1"])
    finally:
        close_logger()
    losses, log = _losses(os.path.join(out, "hc"))
    assert len(losses) == 2 and np.isfinite(losses).all(), log
    assert trainer.model.dtype == torch.bfloat16
    state = torch.load(os.path.join(out, "hc", "epoch0-global_step2", "state.pt"), weights_only=False)
    assert {v.dtype for v in state["params"].values()} == {torch.float32}
    assert {v.dtype for v in state["ema"].values()} == {torch.float32} and state["step"] == 2
