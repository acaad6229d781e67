"""The VAE inference and statistics CLIs of the port (``python -m
opensora_torch.vae_inference`` / ``vae_stats``) on the CPU, on a tiny
HunyuanVAE (from the JAX exporter's file) and a tiny DC-AE (from an
upstream-named file), over 3 seeded 9 x 64 x 64 mp4 clips:

- their latent mean and std equal, exactly, the port's own encode of the
  same batches with a generator seeded as the CLIs seed theirs, and the
  inference CLI's per-batch PSNR equals the port's forward with that
  generator;
- against the JAX package with the same weights: the DC-AE has no
  posterior, so the JAX module's reconstructions and latents of the same
  batches give the CLI's numbers within 1e-4 (relative) and its PSNR
  within 1e-3 dB. The HunyuanVAE's JAX CLI samples its posterior with
  ``jax.random`` noise, which no torch generator reproduces, so its
  numbers differ: only the deterministic parts are compared -- the
  posterior's mode of every batch and the decode of the port's sampled
  latents, within 1e-4 of their scale (the VAE tests' tolerance), and the
  PSNR function on the same arrays.
"""

import importlib.util
import math
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from opensora_tpu.models.dc_ae.model import DCAE as JDCAE
from opensora_tpu.models.dc_ae.model import DCAEConfig as JDConfig
from opensora_tpu.models.hunyuan_vae.model import AutoEncoder3DConfig as JVConfig
from opensora_tpu.models.hunyuan_vae.model import AutoencoderKLCausal3D as JVAE
from opensora_tpu.utils.ckpt import export_hunyuan_vae_state_dict

from opensora_torch import vae_inference, vae_stats
from opensora_torch.utils.logger import close_logger
from opensora_torch.utils.safetensors_io import save_file
from opensora_torch.utils.weights import dc_ae_state_dict
from torch_parity_utils import max_rel_err, randomize, t, to_numpy

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HUNYUAN = dict(block_out_channels=(8, 16, 16, 16), latent_channels=4, norm_num_groups=4, layers_per_block=1)
DCAE = dict(width_list=(8, 16, 16, 16, 32, 32), encoder_depth_list=(1, 1, 1, 1, 1, 1),
            decoder_depth_list=(1, 1, 1, 1, 1, 1), latent_channels=8)


@pytest.fixture(scope="module")
def clips(tmp_path_factory):
    cv2 = pytest.importorskip("cv2")
    root = str(tmp_path_factory.mktemp("clips"))
    rng = np.random.default_rng(0)
    rows = []
    for i in range(3):
        path = os.path.join(root, f"v{i}.mp4")
        writer = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), 8.0, (64, 64))
        base = rng.integers(0, 255, (64, 64, 3), np.uint8)
        for k in range(9):
            writer.write(np.roll(base, 3 * k, axis=1))
        writer.release()
        rows.append(f"{path},clip {i},64,64,9,8.0")
    csv = os.path.join(root, "meta.csv")
    with open(csv, "w") as f:
        f.write("path,text,height,width,num_frames,fps\n" + "\n".join(rows) + "\n")
    return csv


def _tensors(sd):
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in sd.items()}


def _config(tmp_path, base, model, ckpt, eval_setting):
    cfg = tmp_path / "cfg.py"
    cfg.write_text(f"_base_ = [{os.path.join(REPO, 'configs', 'vae', 'inference', base)!r}]\n"
                   f"model = dict(**{model!r}, dtype='fp32', from_pretrained={ckpt!r})\n"
                   f"eval_setting = {eval_setting!r}\nnum_save = 2\nsave_dir = {str(tmp_path / 'recon')!r}\n")
    return str(cfg)


def _run_clis(argv):
    try:
        return vae_inference.main(list(argv)), vae_stats.main(list(argv))
    finally:
        close_logger()


def _own_pass(argv):
    """The port's encode and forward of the CLIs' batches, each with a
    generator seeded as the CLIs seed theirs: (batches, latent stats,
    per-batch PSNR, sampled latents)."""
    _, dataloader, ae, device, gen, _ = vae_inference.prepare_vae_eval(list(argv), lambda cfg: True)
    stats = vae_inference.LatentStats()
    batches = [torch.as_tensor(b["video"]).float() for b in dataloader]
    fwd_gen = torch.Generator(device=device).manual_seed(gen.initial_seed())
    psnrs, zs = [], []
    with torch.no_grad():
        for x in batches:
            stats.add(ae.encode(x, generator=gen))
            rec, _, z = ae(x, generator=fwd_gen)
            psnrs.append(vae_inference.psnr(x, rec))
            zs.append(z)
    return ae, batches, stats.result(), psnrs, zs


def test_hunyuan_vae_clis(tmp_path, clips):
    jv = JVAE(JVConfig(**HUNYUAN, use_spatial_tiling=True, dtype="fp32"))
    shapes = jax.eval_shape(jv.init, {"params": jax.random.PRNGKey(0), "gaussian": jax.random.PRNGKey(1)},
                            jnp.zeros((1, 3, 5, 16, 16)))
    params = randomize(to_numpy(shapes["params"]), 0, 0.1)
    ckpt = str(tmp_path / "hunyuan_vae.safetensors")
    save_file(_tensors(export_hunyuan_vae_state_dict(params)), ckpt)
    argv = [_config(tmp_path, "hunyuan_vae.py", HUNYUAN, ckpt, "9x64"), "--device", "cpu",
            "--dataset.data_path", clips]
    inf, st = _run_clis(argv)
    ae, batches, own, psnrs, zs = _own_pass(argv)
    assert len(batches) == 3 and inf["n_batches"] == st["n_batches"] == 3
    for k in ("latent_mean", "latent_std", "latent_count"):
        assert inf[k] == own[k] and st[k] == own[k], k
    assert inf["psnr"] == psnrs and all(math.isfinite(p) for p in psnrs)
    assert inf["scale_factor"] == 1 / own["latent_std"] and inf["shift_factor"] == own["latent_mean"]
    assert sorted(os.listdir(tmp_path / "recon")) == ["0000_orig.mp4", "0000_recn.mp4", "0001_orig.mp4",
                                                      "0001_recn.mp4"]
    # the deterministic parts against JAX: the posterior's mode, the decode
    encode = jax.jit(lambda p, v: jv.apply({"params": p}, v, sample_posterior=False, method=JVAE.encode))
    decode = jax.jit(lambda p, z: jv.apply({"params": p}, z, method=JVAE.decode))
    spec = importlib.util.spec_from_file_location("jax_vae_inference", os.path.join(REPO, "scripts", "vae",
                                                                                     "inference.py"))
    jax_cli = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jax_cli)
    with torch.no_grad():
        for x, z in zip(batches, zs):
            mode = ae.encode(x, sample_posterior=False)
            assert max_rel_err(mode.numpy(), np.asarray(encode(params, jnp.asarray(x.numpy())))) <= 1e-4
            rec = ae.decode(z)
            assert max_rel_err(rec.numpy(), np.asarray(decode(params, jnp.asarray(z.numpy())))) <= 1e-4
            ref_psnr = jax_cli.psnr(x.numpy(), np.clip(rec.numpy(), -1, 1))
            assert abs(vae_inference.psnr(x, rec) - ref_psnr) <= 1e-9


def test_dc_ae_clis_match_jax(tmp_path, clips):
    jm = JDCAE(JDConfig(**DCAE, use_spatial_tiling=True, use_temporal_tiling=True, dtype="fp32"))
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0), jnp.zeros((1, 3, 4, 32, 32)))
    params = randomize(to_numpy(shapes["params"]), 2, 0.1)
    ckpt = str(tmp_path / "dc_ae.safetensors")
    save_file(_tensors(dc_ae_state_dict(params)), ckpt)
    argv = [_config(tmp_path, "video_dc_ae.py", DCAE, ckpt, "8x64"), "--device", "cpu",
            "--dataset.data_path", clips]
    inf, st = _run_clis(argv)
    _, batches, own, psnrs, _ = _own_pass(argv)
    for k in ("latent_mean", "latent_std", "latent_count"):
        assert inf[k] == own[k] and st[k] == own[k], k
    assert inf["psnr"] == psnrs and [tuple(x.shape) for x in batches] == [(1, 3, 8, 64, 64)] * 3
    # no posterior: the JAX module's numbers of the same batches
    fwd = jax.jit(lambda p, v: jm.apply({"params": p}, v))
    z_sum = z_sq = 0.0
    n, ref_psnrs = 0, []
    for x in batches:
        x_rec, _, z = fwd(params, jnp.asarray(x.numpy()))
        zf = np.asarray(z, np.float64)
        z_sum, z_sq, n = z_sum + zf.sum(), z_sq + (zf ** 2).sum(), n + zf.size
        mse = float(np.mean((x.numpy().astype(np.float64) - np.clip(np.asarray(x_rec), -1, 1)) ** 2))
        ref_psnrs.append(10 * np.log10(4.0 / mse))
    mean = z_sum / n
    std = math.sqrt(z_sq / n - mean**2)
    assert n == own["latent_count"]
    assert abs(inf["latent_mean"] - mean) <= 1e-4 * std and abs(inf["latent_std"] - std) <= 1e-4 * std
    np.testing.assert_allclose(inf["psnr"], ref_psnrs, atol=1e-3, rtol=0)
