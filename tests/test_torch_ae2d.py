"""The port's Flux 2D AE (the t2i2v image stage's autoencoder) against the
JAX package's on the CPU, with the same carried weights
(``autoencoder_2d_state_dict``): encode (the posterior's mode, and a sample
from shared noise) and decode, for a 4-D image batch and a 5-D clip; the
builder.

Tolerance: fp32, 1e-5 of the output's scale (convolutions and the fp32
attention summed in another order). The bf16 compute path (the config's
dtype, fp32 master weights) is held to the fp32 result: its relative L2
distance at most 1.5x the JAX package's own bf16 path's distance from the
same fp32 result (bf16 roundings differ between the two packages, so the
two bf16 outputs are not compared with each other).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from opensora_tpu.models.vae2d.autoencoder_2d import AutoEncoder2D as JAE
from opensora_tpu.models.vae2d.autoencoder_2d import AutoEncoderFlux as JAutoEncoderFlux

from opensora_torch.models.vae2d.autoencoder_2d import AutoEncoder2D, AutoEncoderFlux
from opensora_torch.registry import MODELS, build_module
from opensora_torch.utils.weights import autoencoder_2d_state_dict, load_numpy_state_dict
from torch_parity_utils import max_rel_err, randomize, t, to_numpy

TINY = dict(ch=32, ch_mult=[1, 2], num_res_blocks=1, z_channels=4)
TOL = 1e-5


@pytest.fixture(scope="module")
def params():
    jm = JAutoEncoderFlux(**TINY, dtype="fp32")
    x0 = jnp.zeros((1, 3, 16, 16))
    shapes = jax.eval_shape(jm.init, {"params": jax.random.PRNGKey(0), "gaussian": jax.random.PRNGKey(1)}, x0)
    return randomize(to_numpy(shapes["params"]), 0, 0.1)


def _pair(params, dtype):
    jm = JAutoEncoderFlux(**TINY, dtype=dtype)
    tm = AutoEncoderFlux(**TINY, dtype=dtype, device="meta")
    load_numpy_state_dict(tm, autoencoder_2d_state_dict(params))
    return jm, tm.eval()


def _np(x):
    return np.asarray(jnp.asarray(x, jnp.float32))


@pytest.mark.parametrize("shape", [(2, 3, 16, 24), (1, 3, 2, 16, 16)], ids=["image", "clip"])
def test_encode_decode_match_jax(params, shape):
    jm, tm = _pair(params, "fp32")
    x = np.random.default_rng(1).uniform(-1, 1, shape).astype(np.float32)
    xj = jnp.asarray(x)
    rng = jax.random.PRNGKey(3)
    mode_j = jm.apply({"params": params}, xj, sample_posterior=False, method=JAE.encode)
    z_j, post = jm.apply({"params": params}, xj, rng=rng, return_posterior=True, method=JAE.encode)
    # the JAX posterior's noise, channels-last (B*T, h, w, C), as the port's
    # latent layout (B, C, [T,] h, w)
    noise = np.asarray(jax.random.normal(rng, post.mean.shape, jnp.float32))
    noise = np.moveaxis(noise, -1, 1)
    if len(shape) == 5:
        bt, c, h, w = noise.shape
        noise = noise.reshape(shape[0], shape[2], c, h, w).transpose(0, 2, 1, 3, 4)
    dec_j = jm.apply({"params": params}, z_j, method=JAE.decode)
    with torch.no_grad():
        mode_t = tm.encode(t(x), sample_posterior=False)
        z_t = tm.encode(t(x), noise=t(noise))
        dec_t = tm.decode(torch.tensor(_np(z_j)))
    assert tuple(mode_t.shape) == tuple(z_t.shape) == mode_j.shape == z_j.shape
    assert tuple(dec_t.shape) == dec_j.shape == shape
    for ours, ref in ((mode_t, mode_j), (z_t, z_j), (dec_t, dec_j)):
        assert max_rel_err(ours.numpy(), _np(ref)) <= TOL, max_rel_err(ours.numpy(), _np(ref))


def test_bf16_compute_is_as_close_to_fp32_as_jax_bf16(params):
    x = np.random.default_rng(2).uniform(-1, 1, (2, 3, 16, 24)).astype(np.float32)

    def run_jax(dtype, z=None):
        jm = JAutoEncoderFlux(**TINY, dtype=dtype)
        xj = jnp.asarray(x, jnp.bfloat16 if dtype == "bf16" else jnp.float32)
        if z is None:
            return _np(jm.apply({"params": params}, xj, sample_posterior=False, method=JAE.encode))
        return _np(jm.apply({"params": params}, jnp.asarray(z), method=JAE.decode))

    def rel_l2(a, b):
        return float(np.linalg.norm(a - b) / np.linalg.norm(b))

    ref_z, jax_z = run_jax("fp32"), run_jax("bf16")
    ref_dec, jax_dec = run_jax("fp32", ref_z), run_jax("bf16", ref_z)
    _, tm = _pair(params, "bf16")
    assert tm.encoder.conv_in.weight.dtype == torch.float32
    with torch.no_grad():
        z = tm.encode(t(x), sample_posterior=False)
        dec = tm.decode(t(ref_z))
    assert z.dtype == dec.dtype == torch.bfloat16
    assert rel_l2(z.float().numpy(), ref_z) <= 1.5 * rel_l2(jax_z, ref_z)
    assert rel_l2(dec.float().numpy(), ref_dec) <= 1.5 * rel_l2(jax_dec, ref_dec)


def test_builder_ignores_unknown_keys_and_keeps_fp32_masters():
    ae = build_module(dict(type="autoencoder_2d", **TINY, resolution=512, not_a_field=1), MODELS, device="meta")
    assert isinstance(ae, AutoEncoder2D) and ae.config.resolution == 512
    assert ae.decoder.conv_in.weight.dtype == torch.float32 and ae.dtype == torch.bfloat16
    assert ae.spatial_compression_ratio == 2
    full = build_module(dict(type="autoencoder_2d"), MODELS, device="meta")
    assert full.spatial_compression_ratio == 8
    # upstream Flux ae.safetensors names
    names = set(full.state_dict())
    for key in ("encoder.down.0.block.1.norm1.weight", "encoder.down.2.downsample.conv.weight",
                "encoder.mid.attn_1.proj_out.bias", "decoder.up.3.upsample.conv.weight",
                "decoder.up.1.block.0.nin_shortcut.weight", "encoder.conv_out.weight"):
        assert key in names, key
    shapes = jax.eval_shape(JAutoEncoderFlux().init, {"params": jax.random.PRNGKey(0),
                                                      "gaussian": jax.random.PRNGKey(1)}, jnp.zeros((1, 3, 32, 32)))
    assert sum(p.numel() for p in full.parameters()) == sum(x.size for x in jax.tree.leaves(shapes["params"]))
