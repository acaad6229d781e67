"""The port's dataset and checkpoint tools (``opensora_torch.cnv``) against
their JAX counterparts in ``scripts/cnv`` on the CPU, at a small size:

- ``meta``: over a folder of 3 mp4s, 2 pngs and an unreadable file, given
  as a directory and as a CSV, the table equals the JAX script's, column by
  column through pandas, and reads back through ``read_data_file`` as
  pandas reads the JAX script's (same columns, types and values);
- ``export``: a port train state holding a small MMDiT's JAX parameters
  (``params``) and a perturbed copy (``ema``), saved by ``CheckpointIO``:
  for each of the 3 layouts x 2 sources the file equals the JAX
  ``export_mmdit_state_dict`` of the same tree exactly (a permutation of
  fp32 rows); the JAX loader reads the published file back into that tree
  exactly; the HunyuanVAE export of a VAE train state equals the JAX
  ``export_hunyuan_vae_state_dict`` exactly;
- the finetune loop on the demo config: a table made by ``meta``, 2
  training steps, the EMA exported in the published layout; the inference
  API from the export gives the same sample, bitwise, as from the
  in-memory EMA (both fp32; the layout only reorders rows), and a LoRA
  finetune starts from the export, whose state the exporter refuses,
  naming its missing weights;
- ``cache``: with JAX weights carried across, the posterior's moments, and
  the latents under the JAX draw's noise, equal the JAX AE's encode within
  1e-4 of their scale (fp32 convolutions summed in another order, as
  tests/test_torch_vae.py); the cached latents are the port's encode under
  the generator seeded with ``seed`` exactly; the T5 and CLIP rows equal
  the JAX embedders' within 1e-4 (tests/test_torch_text.py);
  ``CachedVideoTextDataset`` reads the table;
- ``verify_pretrained``: on small random files that the JAX exporters
  write (the published layout: unfused, "split" pairing; and flux's: fused,
  "interleaved"; so both fusions and both source pairings) the report
  equals the JAX tool's: geometry fields and ``n_tensors`` exactly, forward statistics
  within 1e-5 relative (fp32 on both sides); ``--ref-npz`` holding the JAX
  forward passes and a perturbed one fails; the VAE report at a small
  geometry given the JAX draw's noise, within 1e-5 relative too.
"""

import importlib.util
import json
import math
import os
import sys

import numpy as np
import pandas as pd
import pytest
import torch

import jax
import jax.numpy as jnp

from opensora_tpu.models.hunyuan_vae import model as jvae_module
from opensora_tpu.models.hunyuan_vae.model import AutoEncoder3DConfig as JVAEConfig
from opensora_tpu.models.hunyuan_vae.model import AutoencoderKLCausal3D as JVAE
from opensora_tpu.models.mmdit.model import MMDiTConfig as JConfig
from opensora_tpu.models.mmdit.model import MMDiTModel as JModel
from opensora_tpu.models.text import clip as jclip
from opensora_tpu.models.text import t5 as jt5
from opensora_tpu.models.text import conditioner as jconditioner
from opensora_tpu.models.text.conditioner import HFEmbedder as JEmbedder
from opensora_tpu.utils.ckpt import export_hunyuan_vae_state_dict, export_mmdit_state_dict
from opensora_tpu.utils.ckpt import load_checkpoint as jax_load_checkpoint

from opensora_torch.cnv import cache, export, meta, verify_pretrained
from opensora_torch.datasets.datasets import CachedVideoTextDataset, read_data_file
from opensora_torch.models.hunyuan_vae import model as tvae_module
from opensora_torch.utils.ckpt import CheckpointIO, load_torch_state_dict
from opensora_torch.utils.logger import close_logger
from opensora_torch.utils.safetensors_io import save_file
from opensora_torch.utils.weights import clip_text_state_dict, hunyuan_vae_state_dict, load_numpy_state_dict
from opensora_torch.utils.weights import mmdit_state_dict, t5_state_dict
from torch_parity_utils import max_rel_err, randomize, t, to_numpy

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), os.pardir))
DEMO = os.path.join(REPO, "configs", "diffusion", "train", "demo.py")
TINY_DEV = os.path.join(REPO, "configs", "diffusion", "inference", "tiny_dev.py")
TOL = 1e-4  # the AE's and the text encoders' outputs, of their scale (fp32 sums in another order)
STATS_RTOL = 1e-5  # verify_pretrained's forward statistics, relative (fp32 on both sides)
H, HEADS = 32, 2
HEAD_DIM = H // HEADS
GEOM = dict(in_channels=8, vec_in_dim=8, context_in_dim=16, hidden_size=H, mlp_ratio=2.0, num_heads=HEADS, depth=2,
            depth_single_blocks=2, axes_dim=[4, 6, 6], qkv_bias=True, guidance_embed=True, cond_embed=True)
TINY_VAE = dict(block_out_channels=(8, 16, 16, 16), latent_channels=4, norm_num_groups=4, layers_per_block=1)
DEMO_VAE = dict(TINY_VAE, block_out_channels=(8, 8, 8, 8))  # demo.py's AE
VERIFY_GEOM = dict(GEOM, depth=1, depth_single_blocks=1)  # the JAX tool runs its forwards op by op


def _jax_script(name):
    """``scripts/cnv/<name>.py`` as a module of its own name."""
    spec = importlib.util.spec_from_file_location(f"jax_cnv_{name}", os.path.join(REPO, "scripts", "cnv",
                                                                                  f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _write_media(root):
    """3 mp4s (sizes, lengths and rates of their own), 2 pngs (one in a
    subdirectory) and a file named .mp4 that is no video."""
    import cv2

    os.makedirs(os.path.join(root, "stills"), exist_ok=True)
    rng = np.random.default_rng(0)
    for i, (frames, h, w, fps) in enumerate([(8, 64, 64, 8.0), (6, 64, 64, 12.0), (9, 48, 64, 24.0)]):
        writer = cv2.VideoWriter(os.path.join(root, f"clip{i}.mp4"), cv2.VideoWriter_fourcc(*"mp4v"), fps, (w, h))
        base = rng.integers(0, 255, (h, w, 3), np.uint8)
        for k in range(frames):
            writer.write(np.roll(base, 3 * k, axis=1))
        writer.release()
    cv2.imwrite(os.path.join(root, "still0.png"), rng.integers(0, 255, (64, 64, 3), np.uint8))
    cv2.imwrite(os.path.join(root, "stills", "still1.png"), rng.integers(0, 255, (40, 56, 3), np.uint8))
    with open(os.path.join(root, "broken.mp4"), "wb") as f:
        f.write(b"no video here")
    names = ["clip0.mp4", "clip1.mp4", "clip2.mp4", "still0.png", os.path.join("stills", "still1.png"), "broken.mp4"]
    return [os.path.join(root, n) for n in names]


def _write_table(paths, path):
    texts = ['a clip, with a comma', 'a "quoted" clip', "plain", "a still", "still", "broken"]
    pd.DataFrame({"path": paths, "text": texts, "aesthetic": [5.5, 4, 6.25, None, 7, 1]}).to_csv(path, index=False)
    return path


@pytest.fixture(scope="module")
def media(tmp_path_factory):
    root = tmp_path_factory.mktemp("media")
    paths = _write_media(str(root / "files"))
    return dict(root=str(root / "files"), paths=paths, csv=_write_table(paths, str(root / "in.csv")))


# ----------------------------------------------------------------------
# meta
# ----------------------------------------------------------------------


@pytest.mark.parametrize("given", ["directory", "csv"])
def test_meta_table_equals_the_jax_script(media, tmp_path, monkeypatch, given):
    src = media["root"] if given == "directory" else media["csv"]
    ours, theirs = str(tmp_path / "port.csv"), str(tmp_path / "jax.csv")
    table = meta.main([src, ours])
    monkeypatch.setattr(sys, "argv", ["meta.py", src, theirs])
    _jax_script("meta").main()
    port_df, jax_df = pd.read_csv(ours), pd.read_csv(theirs)
    assert list(port_df.columns) == list(jax_df.columns) and len(jax_df) == 5
    for col in jax_df.columns:
        pd.testing.assert_series_equal(port_df[col], jax_df[col])
    # read back by the port's reader as pandas reads the JAX script's file
    back = read_data_file(ours)
    assert back.columns == list(jax_df.columns) == table.columns
    for row, ref in zip(back, jax_df.to_dict("records")):
        for k, v in ref.items():
            v = v.item() if hasattr(v, "item") else v
            if isinstance(v, float) and math.isnan(v):
                assert math.isnan(row[k]), k
            else:
                assert row[k] == v and type(row[k]) is type(v), (k, row[k], v)
    heights = dict(zip(jax_df["path"].map(os.path.basename), jax_df["height"]))
    assert heights == {"clip0.mp4": 64, "clip1.mp4": 64, "clip2.mp4": 48, "still0.png": 64, "still1.png": 40}


# ----------------------------------------------------------------------
# export
# ----------------------------------------------------------------------


def _jax_mmdit_params(seed, geom=GEOM):
    jm = JModel(JConfig(**geom, attn_backend="xla", dtype="fp32"))
    ins = verify_pretrained.mmdit_fixture_inputs(8, 16, 8, True, True)
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0), *[jnp.asarray(a) for a in ins])["params"]
    return randomize(to_numpy(shapes), seed, 0.05)


def _perturbed(tree, seed):
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda v: (v + 0.01 * rng.standard_normal(v.shape)).astype(v.dtype), tree)


def _write_config(path, **dicts):
    with open(path, "w") as f:
        f.write("".join(f"{k} = {v!r}\n" for k, v in dicts.items()))
    return path


@pytest.fixture(scope="module")
def mmdit_ckpt(tmp_path_factory):
    """A port train state of the small MMDiT: the JAX parameters in
    ``params``, a perturbed copy in ``ema``, saved by CheckpointIO."""
    from opensora_torch.models.mmdit.model import Flux
    from opensora_torch.training.diffusion import TrainState
    from opensora_torch.utils.optimizer import create_optimizer

    root = tmp_path_factory.mktemp("mmdit_ckpt")
    params = _jax_mmdit_params(1)
    ema = _perturbed(params, 2)
    model = Flux(**GEOM, attn_backend="xla", dtype="fp32", device="meta")
    load_numpy_state_dict(model, mmdit_state_dict(params))
    state = TrainState.create(model, create_optimizer(model.parameters(), lr=1e-4), ema=True)
    state.ema = {n: torch.from_numpy(np.ascontiguousarray(v)) for n, v in mmdit_state_dict(ema).items()}
    state.step = 3
    ckpt = CheckpointIO().save(str(root), state, 0, 3, 3)
    cfg = _write_config(str(root / "cfg.py"), model=dict(type="flux", **GEOM, dtype="fp32"))
    return dict(ckpt=ckpt, cfg=cfg, params=params, ema=ema, root=root)


@pytest.mark.parametrize("source", ["ema", "params"])
@pytest.mark.parametrize("layout", ["published", "flux", "native"])
def test_export_equals_the_jax_exporter(mmdit_ckpt, tmp_path, layout, source):
    out = str(tmp_path / "out.safetensors")
    res = export.main([mmdit_ckpt["ckpt"], out, "--config", mmdit_ckpt["cfg"], "--source", source, "--layout", layout])
    dst_fused, dst_rope = {"published": (False, "split"), "flux": (True, "interleaved"), "native": (None, "split")}[
        layout]
    want = export_mmdit_state_dict(mmdit_ckpt[source], num_heads=HEADS, head_dim=HEAD_DIM, rope_convention="split",
                                   dst_fused=dst_fused, dst_rope_convention=dst_rope)
    got = load_torch_state_dict(out)
    assert res["n_tensors"] == len(got) and got.keys() == want.keys() and res["step"] == 3
    for k, v in want.items():
        assert got[k].dtype == torch.float32 and np.array_equal(got[k].numpy(), np.asarray(v, np.float32)), k
    if layout == "published":
        assert any(".q_proj." in k for k in got) and any(".v_mlp." in k for k in got)
        assert not any(".qkv." in k or ".linear1." in k for k in got)
        # the JAX loader reads the port's published file back into the tree
        jm = JModel(JConfig(**GEOM, attn_backend="xla", dtype="fp32"))
        loaded = jax_load_checkpoint(jm, out, kind="mmdit")["params"]
        flat_got = jax.tree_util.tree_flatten_with_path(to_numpy(loaded))[0]
        flat_want = dict(jax.tree_util.tree_flatten_with_path(mmdit_ckpt[source])[0])
        assert len(flat_got) == len(flat_want)
        for p, v in flat_got:
            assert np.array_equal(v, flat_want[p]), jax.tree_util.keystr(p)


def test_export_hunyuan_vae_equals_the_jax_exporter(tmp_path):
    """A VAE training CLI's state (AE + ``loss_logvar``, its EMA, a
    discriminator) through ``--kind hunyuan_vae``: the EMA's AE, nothing
    else."""
    from opensora_torch.models.hunyuan_vae.model import AutoEncoder3DConfig, AutoencoderKLCausal3D
    from opensora_torch.models.vae2d.discriminator import NLayerDiscriminator3D
    from opensora_torch.training.vae import LOGVAR, VAETrainState, ae_parameters
    from opensora_torch.utils.optimizer import create_optimizer

    vae = JVAE(JVAEConfig(**TINY_VAE, dtype="fp32"))
    shapes = jax.eval_shape(vae.init, {"params": jax.random.PRNGKey(0), "gaussian": jax.random.PRNGKey(1)},
                            jnp.zeros((1, 3, 5, 32, 32)))
    params = randomize(to_numpy(shapes["params"]), 3, 0.1)
    ema = _perturbed(params, 4)
    ae = AutoencoderKLCausal3D(AutoEncoder3DConfig(**TINY_VAE, dtype="fp32"), device="meta", dtype=torch.float32)
    load_numpy_state_dict(ae, hunyuan_vae_state_dict(params))
    disc = NLayerDiscriminator3D(input_nc=3, ndf=8, n_layers=3)
    trained = ae_parameters(ae, torch.nn.Parameter(torch.zeros(())))
    state = VAETrainState.create(trained, create_optimizer(trained.values(), lr=1e-4), disc,
                                 create_optimizer(disc.parameters(), lr=1e-4), ema=True)
    state.ema = {**{n: torch.from_numpy(np.ascontiguousarray(v)) for n, v in hunyuan_vae_state_dict(ema).items()},
                 LOGVAR: torch.zeros(())}
    ckpt = CheckpointIO().save(str(tmp_path), state, 0, 1, 1)
    cfg = _write_config(str(tmp_path / "vae.py"), model=dict(type="hunyuan_vae", **TINY_VAE, dtype="fp32"))
    out = str(tmp_path / "vae.safetensors")
    export.main([ckpt, out, "--config", cfg, "--kind", "hunyuan_vae"])
    got, want = load_torch_state_dict(out), export_hunyuan_vae_state_dict(ema)
    assert got.keys() == want.keys()
    for k, v in want.items():
        assert np.array_equal(got[k].numpy(), np.asarray(v, np.float32)), k


# ----------------------------------------------------------------------
# the finetune loop on the demo config
# ----------------------------------------------------------------------


def _train(argv):
    from opensora_torch import train

    try:
        return train.main(argv)
    finally:
        close_logger()


def _sample(model, cfg, seed=0):
    from opensora_torch.utils.api import prepare_api, prepare_models
    from opensora_torch.utils.config import ae_spatial_compression
    from opensora_torch.utils.sampling import SamplingOption, sanitize_sampling_option

    _, ae, t5, clip, _ = prepare_models(cfg, device="cpu", seed=cfg.seed)
    api_fn = prepare_api(model.eval(), ae, t5, clip, spatial_compression=ae_spatial_compression(cfg))
    opt = sanitize_sampling_option(SamplingOption(**cfg.sampling_option), ae_spatial_compression(cfg))
    return api_fn(opt, cond_type="t2v", seed=seed, text=["a clip"], channel=cfg.model["in_channels"])


def test_finetune_loop_from_a_folder_of_clips(media, tmp_path):
    from opensora_torch.models.mmdit.model import Flux
    from opensora_torch.utils.config import parse_configs

    table = str(tmp_path / "meta.csv")
    meta.main([media["csv"], table])
    cfg = str(tmp_path / "demo_5f.py")
    with open(cfg, "w") as f:  # the 5-frame bucket: the two square clips make a batch, one step an epoch
        f.write(f"_base_ = [{DEMO!r}]\nbucket_config = {{'_delete_': True, '64px': {{5: (1.0, 2)}}}}\n")
    out = str(tmp_path / "out")
    common = ["--device", "cpu", "--outputs", out, "--dataset.data_path", table, "--warmup_steps", "0", "--lr",
              "1e-2", "--ema_decay", "0.5"]
    trainer = _train([cfg, *common, "--exp_name", "full", "--epochs", "2"])
    assert trainer.state.step == 2
    ckpt = os.path.join(out, "full", "epoch1-global_step2")
    exported = str(tmp_path / "finetuned.safetensors")
    export.main([ckpt, exported, "--config", cfg, "--source", "ema", "--layout", "published"])
    ema = trainer.state.ema
    assert not all(torch.equal(ema[n], p) for n, p in trainer.state.params.items())

    # the inference API from the export against the in-memory EMA, one seed
    inf = [TINY_DEV, "--model.guidance_embed", "False", "--model.cond_embed", "False"]
    loaded = Flux(**dict(parse_configs(inf).model, from_pretrained=exported), device="cpu")
    in_memory = Flux(**parse_configs(inf).model, device="meta")
    in_memory.load_state_dict(ema, strict=True, assign=True)
    for n, p in in_memory.state_dict().items():
        assert torch.equal(loaded.state_dict()[n], p), n
    a, b = _sample(loaded, parse_configs(inf)), _sample(in_memory, parse_configs(inf))
    assert a.shape == (1, 3, 5, 32, 32) and torch.isfinite(a).all() and torch.equal(a, b)

    # a LoRA finetune from the export; its state holds only the factors
    with open(str(tmp_path / "lora.py"), "w") as f:
        f.write(f"_base_ = [{cfg!r}]\nlora_config = dict(r=4, lora_alpha=4)\n")
    lora = _train([str(tmp_path / "lora.py"), *common, "--exp_name", "lora", "--epochs", "1",
                   "--model.from_pretrained", exported])
    assert lora.state.step == 1 and all("lora" in n for n in lora.state.params)
    with open(os.path.join(out, "lora", "log.txt")) as f:
        assert "LoRA enabled" in f.read()
    with pytest.raises(ValueError, match=r"lacks \d+ of the model's \d+ weights: \['img_in.weight'"):
        export.main([os.path.join(out, "lora", "epoch0-global_step1"), str(tmp_path / "lora.safetensors"),
                     "--config", cfg])


# ----------------------------------------------------------------------
# cache
# ----------------------------------------------------------------------


def _jax_text(kind, seed):
    """The JAX embedder (byte-fallback tokenizer) of the tiny T5 / CLIP with
    seeded weights, and those weights in the port's names."""
    cfg = (jt5 if kind == "t5" else jclip).__dict__[f"{kind}_small_test_config"]()
    cfg.dtype = "fp32"
    module = jt5.T5Encoder(cfg) if kind == "t5" else jclip.CLIPTextModel(cfg)
    shapes = jax.eval_shape(module.init, jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))["params"]
    params = randomize(to_numpy(shapes), seed, 0.2)
    name = "" if kind == "t5" else "clip-fallback"
    emb = JEmbedder(name, max_length=16, **{f"{kind}_config": cfg}, params={"params": params})
    return emb, (t5_state_dict if kind == "t5" else clip_text_state_dict)(params)


def test_cache_equals_the_jax_encoders(media, tmp_path, monkeypatch):
    from opensora_torch.datasets.dataloader import prepare_dataloader
    from opensora_torch.registry import DATASETS, build_module
    from opensora_torch.utils.config import ae_spatial_compression, parse_configs

    # the demo geometry's AE, T5 and CLIP with JAX weights, carried into files
    vae = JVAE(JVAEConfig(**DEMO_VAE, dtype="fp32"))
    shapes = jax.eval_shape(vae.init, {"params": jax.random.PRNGKey(0), "gaussian": jax.random.PRNGKey(1)},
                            jnp.zeros((1, 3, 5, 32, 32)))
    vae_params = randomize(to_numpy(shapes["params"]), 5, 0.1)
    files = {"ae": str(tmp_path / "vae.safetensors"), "t5": str(tmp_path / "t5"),
             "clip": str(tmp_path / "clip_tiny")}
    save_file({k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in hunyuan_vae_state_dict(vae_params).items()},
              files["ae"])
    # no tokenizer files: the JAX embedder's fallback, without its attempt through transformers (slow to import)
    monkeypatch.setattr(jconditioner, "_load_hf_tokenizer", lambda *args: None)
    jemb = {}
    for kind, seed in (("t5", 6), ("clip", 7)):
        jemb[kind], sd = _jax_text(kind, seed)
        os.makedirs(files[kind])
        save_file({k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in sd.items()},
                  os.path.join(files[kind], "model.safetensors"))
    table = str(tmp_path / "meta.csv")
    meta.main([media["csv"], table])
    argv = [DEMO, "--dataset.data_path", table, "--out_dir", str(tmp_path / "cache"), "--dtype", "fp32",
            *[a for k, f in files.items() for a in (f"--{k}.from_pretrained", f)]]
    meta_csv = cache.main([*argv, "--device", "cpu"])

    rows = read_data_file(meta_csv)
    assert rows.columns == list(cache.META_COLUMNS)
    cfg = parse_configs(argv)
    loader, _ = prepare_dataloader(build_module(dict(cfg.dataset), DATASETS), bucket_config=cfg.bucket_config,
                                   shuffle=False, seed=cfg.seed, spatial_compression=ae_spatial_compression(cfg))
    ae = cache.build_encoders(cfg, torch.device("cpu"), cfg.seed)[0]
    gen = torch.Generator().manual_seed(cfg.seed)
    n = 0
    for batch in loader:
        x, texts = np.asarray(batch["video"], np.float32), list(batch["text"])
        with torch.no_grad():
            replay = ae.encode(t(x), generator=gen)
        if n == 0:  # the JAX AE on the first clip: its moments, and its sample under its noise
            rng, x0 = jax.random.PRNGKey(0), x[:1]
            z, posterior = vae.apply({"params": vae_params}, jnp.asarray(x0), rng, return_posterior=True,
                                     method=JVAE.encode)
            noise = np.moveaxis(np.asarray(jax.random.normal(rng, posterior.mean.shape, jnp.float32)), -1, 1)
            with torch.no_grad():
                moments, z_port = ae.encode_moments(t(x0)), ae.encode(t(x0), noise=t(noise))
            c = moments.shape[1] // 2
            for got, want in ((moments[:, :c], posterior.mean), (moments[:, c:], posterior.logvar)):
                want = np.moveaxis(np.asarray(want), -1, 1)
                assert got.shape == want.shape and max_rel_err(got.numpy(), want) <= TOL, max_rel_err(got.numpy(),
                                                                                                      want)
            assert z_port.shape == z.shape and max_rel_err(z_port.numpy(), z) <= TOL, max_rel_err(z_port.numpy(), z)
        embedded = {kind: np.asarray(jemb[kind](texts)) for kind in ("t5", "clip")}
        for i in range(x.shape[0]):
            row = rows[n]
            assert row["text"] == texts[i]
            lat = np.load(row["latent_path"])
            assert lat.dtype == np.float32 and np.array_equal(lat, replay[i].numpy())
            assert row["shape"] == "x".join(str(d) for d in lat.shape)
            for kind, want in embedded.items():
                got = np.load(row[f"{kind}_path"])
                assert got.shape == want[i].shape and max_rel_err(got, want[i]) <= TOL, (kind, max_rel_err(got, want[i]))
            n += 1
    assert n == len(rows) >= 4  # the bucket sampler's batches, as the training CLI reads them
    item = CachedVideoTextDataset(meta_csv)[0]
    assert item["video_latents"].shape == tuple(int(d) for d in rows[0]["shape"].split("x"))
    assert item["text_t5"].shape == (16, 64) and item["text_clip"].shape == (32,)


# ----------------------------------------------------------------------
# verify_pretrained
# ----------------------------------------------------------------------


def _close(got, want, path=""):
    """Reports equal: exact but for floats, within STATS_RTOL relative."""
    if isinstance(want, dict):
        assert got.keys() == want.keys(), (path, got.keys(), want.keys())
        for k in want:
            _close(got[k], want[k], f"{path}.{k}")
    elif isinstance(want, float) and not isinstance(want, bool):
        assert abs(got - want) <= STATS_RTOL * max(abs(want), 1e-6), (path, got, want)
    else:
        assert got == want, (path, got, want)


@pytest.fixture(scope="module")
def jax_verify():
    return _jax_script("verify_pretrained")


@pytest.mark.parametrize("src_fused,src_rope", [(False, "split"), (True, "interleaved")],
                         ids=["published_unfused_split", "flux_fused_interleaved"])
def test_verify_mmdit_report_equals_the_jax_tool(jax_verify, tmp_path, src_fused, src_rope):
    params = _jax_mmdit_params(8, VERIFY_GEOM)
    sd = export_mmdit_state_dict(params, HEADS, HEAD_DIM, rope_convention="split", dst_fused=src_fused,
                                 dst_rope_convention=src_rope)
    path = str(tmp_path / "mmdit.safetensors")
    save_file({k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in sd.items()}, path)
    want = jax_verify.verify_mmdit(path, None, src_rope=src_rope)
    got = verify_pretrained.main(["mmdit", path, "--src-rope", src_rope, "--device", "cpu"])
    delta_got, delta_want = got.pop("rope_convention_max_delta"), want.pop("rope_convention_max_delta")
    assert delta_got < verify_pretrained.ROPE_TOL and delta_want < verify_pretrained.ROPE_TOL
    _close(got, json.loads(json.dumps(want)))
    assert got["fused_qkv_src"] == src_fused and got["n_tensors"] == len(sd)
    if not src_fused:  # --ref-npz: the JAX forward passes, a perturbed one fails
        jm = JModel(JConfig(**VERIFY_GEOM, rope_convention="interleaved", attn_backend="xla", dtype="fp32"))
        ins = [None if a is None else jnp.asarray(a) for a in jax_verify.mmdit_fixture_inputs(8, 16, 8, True, True)]
        expected = np.asarray(jm.apply(jax_load_checkpoint(jm, path, kind="mmdit"), *ins))
        ref = str(tmp_path / "ref.npz")
        np.savez(ref, expected=expected)
        assert verify_pretrained.verify_mmdit(path, ref, device="cpu")["ref_parity"] == "PASS"
        np.savez(ref, expected=expected + 1e-2)
        with pytest.raises(AssertionError):
            verify_pretrained.verify_mmdit(path, ref, device="cpu")


def test_verify_vae_report_equals_the_jax_tool(jax_verify, tmp_path, monkeypatch):
    """Both tools build the default geometry; here both build a small one,
    and the port's sample takes the noise of the JAX tool's draw."""
    port_config = tvae_module.AutoEncoder3DConfig
    monkeypatch.setattr(jvae_module, "AutoEncoder3DConfig", lambda **kw: JVAEConfig(**{**DEMO_VAE, **kw}))
    monkeypatch.setattr(tvae_module, "AutoEncoder3DConfig", lambda **kw: port_config(**{**DEMO_VAE, **kw}))
    vae = JVAE(JVAEConfig(**DEMO_VAE, dtype="fp32"))
    shapes = jax.eval_shape(vae.init, {"params": jax.random.PRNGKey(0), "gaussian": jax.random.PRNGKey(1)},
                            jnp.zeros((1, 3, 5, 32, 32)))
    params = randomize(to_numpy(shapes["params"]), 9, 0.1)
    path = str(tmp_path / "vae.safetensors")
    sd = export_hunyuan_vae_state_dict(params)
    save_file({k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in sd.items()}, path)
    want = jax_verify.verify_vae(path, None)
    # the tool's encode draws with make_rng("gaussian") under PRNGKey(1): (B, T', H', W', C)
    key = vae.apply({"params": params}, rngs={"gaussian": jax.random.PRNGKey(1)},
                    method=lambda m: m.make_rng("gaussian"))
    b, c, *thw = want["latent"]["shape"]
    noise = np.moveaxis(np.asarray(jax.random.normal(key, (b, *thw, c), jnp.float32)), -1, 1)
    got = verify_pretrained.verify_vae(path, device="cpu", noise=noise)
    assert got["n_tensors"] == len(sd)
    _close(got, json.loads(json.dumps(want)))
