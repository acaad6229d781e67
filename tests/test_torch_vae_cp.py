"""HunyuanVAE context parallelism over height in the port
(opensora_torch/parallel/vae_sharding.py, the blocks' ``forward_strips``)
against the JAX package's ``make_sharded_vae_fn`` on its 8 virtual CPU
devices, at tests/test_vae_parallel.py's config (channels 8, x of (2, 3, 5,
64, 64), a (data 2, sp 4) mesh), with the same weights, input and
posterior noise; and against the port's unsharded VAE.

Tolerance: 1e-4 of the output's scale (``max_rel_err``), fp32 on both
sides; JAX's own test holds its sharded encode to 1e-4 of the local one.
The input varies down the height (a vertical ramp under the noise), so
that a strip's group-norm statistics differ from the whole height's:
known-wrong variants -- interior strip edges replicate-padded instead of
taking the neighbour's rows, per-strip group-norm statistics -- fail the
limit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opensora_tpu.models.hunyuan_vae.model import AutoEncoder3DConfig as JConfig
from opensora_tpu.models.hunyuan_vae.model import AutoencoderKLCausal3D as JVAE
from opensora_tpu.parallel.mesh import MeshConfig as JMeshConfig
from opensora_tpu.parallel.mesh import create_mesh as j_create_mesh
from opensora_tpu.parallel.vae_sharding import make_sharded_vae_fn as j_make_sharded_vae_fn

from opensora_torch.models.hunyuan_vae.model import AutoEncoder3DConfig, AutoencoderKLCausal3D
from opensora_torch.parallel import vae_sharding
from opensora_torch.parallel.mesh import MeshConfig, create_mesh
from opensora_torch.parallel.vae_sharding import ONE_STRIP, HeightStrips, check_height, make_sharded_vae_fn
from opensora_torch.utils.weights import hunyuan_vae_state_dict, load_numpy_state_dict
from torch_parity_utils import max_rel_err, one_torch_thread, randomize, t, to_numpy

TOL = 1e-4
CFG = dict(block_out_channels=(8, 8, 8, 8), latent_channels=4, norm_num_groups=4, layers_per_block=1)
CPU = torch.device("cpu")

_thread = pytest.fixture(autouse=True)(one_torch_thread)


@pytest.fixture(scope="module")
def weights():
    vae = JVAE(JConfig(**CFG, dtype="fp32"))
    shapes = jax.eval_shape(vae.init, {"params": jax.random.PRNGKey(0), "gaussian": jax.random.PRNGKey(1)},
                            jnp.zeros((1, 3, 5, 64, 64)))
    return vae, randomize(to_numpy(shapes["params"]), 0, 0.1)


def _port_vae(params, **kw):
    ae = AutoencoderKLCausal3D(AutoEncoder3DConfig(**CFG, dtype="fp32", **kw), device="meta",
                               dtype=torch.float32).eval()
    load_numpy_state_dict(ae, hunyuan_vae_state_dict(params))
    return ae


def _video(h, w=64, seed=0):
    """(2, 3, 5, h, w): seeded noise on a vertical ramp from -1 to 1."""
    rng = np.random.default_rng(seed)
    ramp = np.linspace(-1.0, 1.0, h, dtype=np.float32)[:, None]
    return (0.5 * rng.standard_normal((2, 3, 5, h, w)).astype(np.float32) + ramp).astype(np.float32)


def _mesh(sp, dp=2):
    return create_mesh(MeshConfig(dp, sp, 1), [CPU] * (dp * sp))


@pytest.mark.parametrize("height", [64, 32])  # latent strips of 2 rows, and of 1 row (the halo is a whole strip)
def test_sharded_encode_and_decode_match_jax(weights, height):
    """Encode (the posterior's sample, given JAX's noise) and decode over
    (data 2, sp 4): the port's against JAX's ``make_sharded_vae_fn`` and
    against the port's unsharded VAE."""
    jvae, params = weights
    x = _video(height)
    jmesh = j_create_mesh(JMeshConfig(dp_size=2, sp_size=4, tp_size=1), jax.devices()[:8])
    rng = jax.random.PRNGKey(7)
    j_enc = j_make_sharded_vae_fn(jvae, {"params": params}, jmesh, method=lambda m, v: m.encode(v, rng=rng),
                                  rngs_name=None)
    z_ref = np.asarray(j_enc(jnp.asarray(x)))
    b, c, lt, lh, lw = z_ref.shape
    assert lh == height // 8  # over sp 4: latent strips of height / 32 rows
    # the JAX posterior draws its noise channels-last: (B, T, H, W, C)
    noise = np.moveaxis(np.asarray(jax.random.normal(rng, (b, lt, lh, lw, c), jnp.float32)), -1, 1)
    j_dec = j_make_sharded_vae_fn(jvae, {"params": params}, jmesh, method=JVAE.decode, rngs_name=None)
    y_ref = np.asarray(j_dec(jnp.asarray(z_ref)))

    vae = _port_vae(params)
    mesh = _mesh(4)
    with torch.no_grad():
        z = make_sharded_vae_fn(vae, mesh, "encode")(t(x), noise=t(noise))
        z_local = vae.encode(t(x), noise=t(noise))
        y = make_sharded_vae_fn(vae, mesh, AutoencoderKLCausal3D.decode)(t(z_ref))
        y_local = vae.decode(t(z_ref))
    assert z.shape == z_ref.shape and y.shape == y_ref.shape == x.shape
    assert max_rel_err(z.numpy(), z_ref) <= TOL
    assert max_rel_err(z.numpy(), z_local.numpy()) <= TOL
    assert max_rel_err(y.numpy(), y_ref) <= TOL
    assert max_rel_err(y.numpy(), y_local.numpy()) <= TOL


def test_sharded_encode_draws_the_unsharded_noise(weights):
    """Without given noise the posterior's noise comes from the generator
    as the unsharded encode draws it: the same latent from the same seed."""
    vae = _port_vae(weights[1])
    x = t(_video(64))
    with torch.no_grad():
        z = make_sharded_vae_fn(vae, _mesh(4), "encode", generator=torch.Generator().manual_seed(3))(x)
        z_local = vae.encode(x, generator=torch.Generator().manual_seed(3))
    assert max_rel_err(z.numpy(), z_local.numpy()) <= TOL


def test_sharded_tiled_passes_equal_the_unsharded_ones(weights):
    """The tile loops and the blend stay the unsharded ones: a spatially
    tiled decode (latent tiles of 4, 4 and 2 rows over sp 2) and a
    temporally tiled encode equal the unsharded tiled passes."""
    params = weights[1]
    mesh = _mesh(2)
    z = t(np.random.default_rng(1).standard_normal((2, 4, 2, 8, 8)).astype(np.float32))
    x = t(_video(64, seed=2))
    with torch.no_grad():
        vae = _port_vae(params, use_spatial_tiling=True, sample_size=32)
        y, y_local = make_sharded_vae_fn(vae, mesh, "decode")(z), vae.decode(z)
        vae = _port_vae(params, use_temporal_tiling=True, sample_tsize=4)
        noise = torch.randn(2, 4, 2, 8, 8, generator=torch.Generator().manual_seed(5))
        e, e_local = make_sharded_vae_fn(vae, mesh, "encode")(x, noise=noise), vae.encode(x, noise=noise)
    assert y.shape == (2, 3, 5, 64, 64) and max_rel_err(y.numpy(), y_local.numpy()) <= TOL
    assert max_rel_err(e.numpy(), e_local.numpy()) <= TOL


_HALO = HeightStrips.halo


def _own_edges(self, xs, top, bottom):
    """Known-wrong: every strip replicate-pads its own edges."""
    return [_HALO(ONE_STRIP, [x], top, bottom)[0] for x in xs]


def _per_strip_moments(self, xs, num_groups):
    """Known-wrong: each strip's own group-norm statistics."""
    flat = [x.float().reshape(x.shape[0], num_groups, -1) for x in xs]
    return [f.mean(-1, keepdim=True) for f in flat], [f.var(-1, unbiased=False, keepdim=True) for f in flat]


@pytest.mark.parametrize("name,fault", [("halo", _own_edges), ("group_moments", _per_strip_moments)])
def test_known_wrong_strips_fail_the_limit(weights, monkeypatch, name, fault):
    vae = _port_vae(weights[1])
    x = t(_video(64))
    noise = torch.zeros(2, 4, 2, 8, 8)
    with torch.no_grad():
        ref = vae.encode(x, noise=noise)
        monkeypatch.setattr(HeightStrips, name, fault)
        z = make_sharded_vae_fn(vae, _mesh(4), "encode")(x, noise=noise)
    assert max_rel_err(z.numpy(), ref.numpy()) > 10 * TOL


def test_heights_that_do_not_split_raise(weights):
    """The encoder's input height must divide by sp * 8 (three stride-2
    levels), the latent's by sp; the batch by 'data'. A rank on another
    device than the VAE's runs on a replica there: such a mesh encodes as
    the unsharded VAE does."""
    vae = _port_vae(weights[1])
    assert vae_sharding.encoder_levels(vae) == 3
    for sp, good, bad in ((4, (32, 64, 96), (16, 40, 48, 56)), (2, (16, 32, 48), (8, 24, 36))):
        for h in good:
            check_height(vae, h, sp, decode=False)
        for h in bad:
            with pytest.raises(ValueError, match=f"height {h} does not split over sp={sp}"):
                check_height(vae, h, sp, decode=False)
    check_height(vae, 4, 4, decode=True)
    with pytest.raises(ValueError, match="latent height 6 does not split over sp=4"):
        check_height(vae, 6, 4, decode=True)
    mesh = _mesh(4)
    with torch.no_grad():
        with pytest.raises(ValueError, match="height 48 does not split over sp=4"):
            make_sharded_vae_fn(vae, mesh, "encode")(t(_video(48)))
        with pytest.raises(ValueError, match="latent height 6 does not split"):
            make_sharded_vae_fn(vae, mesh, "decode")(torch.zeros(2, 4, 2, 6, 8))
        with pytest.raises(ValueError, match="batch 3 does not split over the mesh 'data' axis"):
            make_sharded_vae_fn(vae, mesh, "decode")(torch.zeros(3, 4, 2, 8, 8))
    x, noise = t(_video(64)), torch.zeros(2, 4, 2, 8, 8)
    with torch.no_grad():
        z = make_sharded_vae_fn(vae, create_mesh(MeshConfig(1, 2, 1), [CPU, torch.device("cpu", 1)]), "encode")(
            x, noise=noise)
        assert max_rel_err(z.numpy(), vae.encode(x, noise=noise).numpy()) <= TOL
