"""The port's HunyuanVideo VAE against the JAX package's on the CPU, fp32,
with the same carried weights: a tiny config decoded and encoded whole,
with spatial tiling (full and partial tiles, blended), and with temporal
plus spatial tiling; the posterior's sample given the same noise. Also the
weight carry against the JAX package's exporter.

Tolerance: 1e-4 of the output's scale (fp32 convolutions summed in
another order).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from opensora_tpu.models.hunyuan_vae.model import AutoEncoder3DConfig as JConfig
from opensora_tpu.models.hunyuan_vae.model import AutoencoderKLCausal3D as JVAE
from opensora_tpu.utils.ckpt import export_hunyuan_vae_state_dict

from opensora_torch.models.hunyuan_vae.model import AutoEncoder3DConfig, AutoencoderKLCausal3D, blend_tiles
from opensora_torch.utils.weights import (
    hunyuan_vae_state_dict,
    load_numpy_state_dict,
)
from torch_parity_utils import max_rel_err, randomize, t, to_numpy

TOL = 1e-4
TINY = dict(block_out_channels=(8, 16, 16, 16), latent_channels=4, norm_num_groups=4, layers_per_block=1)


def _jax_vae(**kw):
    vae = JVAE(JConfig(**TINY, dtype="fp32", **kw))
    shapes = jax.eval_shape(
        vae.init, {"params": jax.random.PRNGKey(0), "gaussian": jax.random.PRNGKey(1)}, jnp.zeros((1, 3, 9, 32, 32)))
    return vae, randomize(to_numpy(shapes["params"]), 0, 0.1)


def _port_vae(params, **kw):
    ae = AutoencoderKLCausal3D(AutoEncoder3DConfig(**TINY, dtype="fp32", **kw), device="meta",
                               dtype=torch.float32).eval()
    load_numpy_state_dict(ae, hunyuan_vae_state_dict(params))
    return ae


@pytest.mark.parametrize("latent_thw,tiling", [
    ((3, 4, 4), {}),
    ((2, 5, 6), dict(use_spatial_tiling=True, sample_size=32)),  # 2 x 2 tiles, partial ones blended
    ((5, 3, 3), dict(use_temporal_tiling=True, sample_tsize=12)),  # 3 causal temporal tiles
])
def test_decode_matches_jax(latent_thw, tiling):
    vae, params = _jax_vae(**tiling)
    z = np.random.default_rng(1).standard_normal((1, 4, *latent_thw)).astype(np.float32)
    decode = jax.jit(lambda p, x: vae.apply({"params": p}, x, method=JVAE.decode))
    ref = np.asarray(decode(params, jnp.asarray(z)))
    with torch.no_grad():
        out = _port_vae(params, **tiling).decode(t(z)).numpy()
    assert out.shape == ref.shape
    assert max_rel_err(out, ref) <= TOL, max_rel_err(out, ref)


def test_blend_tiles_matches_jax():
    from opensora_tpu.models.hunyuan_vae.model import blend_tiles as jblend

    rng = np.random.default_rng(2)
    a, b = rng.standard_normal((1, 2, 3, 8, 9)).astype(np.float32), rng.standard_normal((1, 2, 3, 8, 7)).astype(np.float32)
    ref = np.asarray(jblend(jnp.asarray(a), jnp.asarray(b), 4, 4))
    np.testing.assert_allclose(blend_tiles(t(a), t(b), 4, 4).numpy(), ref, atol=1e-6, rtol=0)


def test_vae_weight_carry_equals_jax_exporter():
    _, params = _jax_vae()
    ours, theirs = hunyuan_vae_state_dict(params), export_hunyuan_vae_state_dict(params)
    assert sorted(ours) == sorted(theirs)
    for k in ours:
        np.testing.assert_array_equal(ours[k], theirs[k], err_msg=k)
    ae = _port_vae(params)  # strict load of encoder and decoder
    assert set(ae.state_dict()) == set(ours)


@pytest.mark.parametrize("video_thw,tiling", [
    ((9, 32, 32), {}),
    ((5, 48, 40), dict(use_spatial_tiling=True, sample_size=32)),  # 2 x 2 tiles, partial ones blended
    ((17, 16, 16), dict(use_temporal_tiling=True, sample_tsize=8)),  # causal temporal tiles
])
def test_encode_moments_match_jax(video_thw, tiling):
    """The posterior's moments (mean and clipped log-variance), and the
    scaled latent's mode, through each tiling path."""
    vae, params = _jax_vae(**tiling)
    x = np.random.default_rng(3).uniform(-1, 1, (2, 3, *video_thw)).astype(np.float32)
    def encode(p, v):
        z, post = vae.apply({"params": p}, v, sample_posterior=False, return_posterior=True, method=JVAE.encode)
        return z, post.mean, post.logvar

    z_ref, mean, logvar = jax.jit(encode)(params, jnp.asarray(x))
    ae = _port_vae(params, **tiling)
    with torch.no_grad():
        z, tpost = ae.encode(t(x), sample_posterior=False, return_posterior=True)
    to_ncthw = lambda a: np.moveaxis(np.asarray(a), -1, 1)  # noqa: E731  (JAX keeps moments channels-last)
    assert z.shape == z_ref.shape
    assert max_rel_err(z.numpy(), z_ref) <= TOL
    assert max_rel_err(tpost.mean.numpy(), to_ncthw(mean)) <= TOL
    assert max_rel_err(tpost.logvar.numpy(), to_ncthw(logvar)) <= TOL


def test_encode_sample_matches_jax_given_the_noise():
    vae, params = _jax_vae()
    x = np.random.default_rng(4).uniform(-1, 1, (1, 3, 5, 16, 16)).astype(np.float32)
    rng = jax.random.PRNGKey(5)
    z_ref = jax.jit(lambda p, v: vae.apply({"params": p}, v, rng=rng, method=JVAE.encode))(params, jnp.asarray(x))
    # the JAX posterior draws its noise channels-last: (B, T, H, W, C)
    b, c, lt, lh, lw = z_ref.shape
    noise = np.moveaxis(np.asarray(jax.random.normal(rng, (b, lt, lh, lw, c), jnp.float32)), -1, 1)
    with torch.no_grad():
        z = _port_vae(params).encode(t(x), noise=t(noise))
    assert max_rel_err(z.numpy(), z_ref) <= TOL
