"""The port's Video DC-AE against the JAX package's on the CPU, fp32, with
the same carried weights: the pixel (un)shuffles, the norms, each layer and
block (LiteMLA's fp32 linear attention included) and the whole DC-AE at a
tiny width list, whole and tiled; the weight carry's names; the builder.

Tolerances: the pixel shuffles are exact (pure data movement); layers,
blocks and the whole AE 1e-4 of the output's scale (fp32 convolutions
summed in another order).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from opensora_tpu.models.dc_ae import ops as jops
from opensora_tpu.models.dc_ae.model import DCAE as JDCAE
from opensora_tpu.models.dc_ae.model import DCAEConfig as JConfig

from opensora_torch.models.dc_ae import ops as tops
from opensora_torch.models.dc_ae.model import DC_AE, DCAE, DCAEConfig
from opensora_torch.utils.weights import dc_ae_module_state_dict, dc_ae_state_dict, load_numpy_state_dict
from torch_parity_utils import max_rel_err, randomize, t, to_numpy

TOL = 1e-4
TINY = dict(width_list=(8, 16, 16, 16, 32, 32), encoder_depth_list=(1, 1, 1, 1, 1, 1),
            decoder_depth_list=(1, 1, 1, 1, 1, 1), latent_channels=8)


def _x(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _cl(x):
    """channels-first -> the JAX package's channels-last."""
    return np.moveaxis(x, 1, -1)


@pytest.mark.parametrize("name,shape,r", [
    ("pixel_unshuffle_2d", (2, 3, 4, 6), 2),
    ("pixel_unshuffle_2d", (1, 3, 2, 4, 6), 2),
    ("pixel_shuffle_2d", (1, 12, 2, 3, 2), 2),
    ("pixel_unshuffle_3d", (1, 3, 4, 4, 6), 2),
    ("pixel_shuffle_3d", (1, 16, 2, 3, 2), 2),
])
def test_pixel_shuffles_equal_jax(name, shape, r):
    x = _x(shape)
    want = np.moveaxis(np.asarray(getattr(jops, name)(jnp.asarray(_cl(x)), r)), -1, 1)
    np.testing.assert_array_equal(getattr(tops, name)(t(x), r).numpy(), want)


def _layer_parity(jmod, tmod, x, seed=1):
    """Init the JAX module on x (channels-last), randomize its params, carry
    them into the port module and compare the outputs."""
    xl = jnp.asarray(_cl(x))
    shapes = jax.eval_shape(jmod.init, jax.random.PRNGKey(0), xl)
    params = randomize(to_numpy(shapes.get("params", {})), seed, 0.2)
    want = np.moveaxis(np.asarray(jmod.apply({"params": params}, xl)), -1, 1)
    if params:
        load_numpy_state_dict(tmod, dc_ae_module_state_dict(params))
    with torch.no_grad():
        got = tmod(t(x)).numpy()
    assert got.shape == want.shape
    assert max_rel_err(got, want) <= TOL, max_rel_err(got, want)


F32 = dict(dtype=jnp.float32)
V = (1, 8, 4, 8, 8)  # a video batch (B, C, T, H, W)


@pytest.mark.parametrize("case", [
    "conv_stride2_video", "conv_stride122_grouped", "conv_stride2_image", "conv_unshuffle_down",
    "averaging_down_3d", "averaging_down_2d", "conv_shuffle_up", "duplicating_up_3d", "duplicating_up_2d",
    "duplicating_up_one_frame", "interpolate_up_video", "norm_rms3d", "norm_ln2d",
])
def test_layer_matches_jax(case):
    x = _x(V)
    if case == "conv_stride2_video":
        jm = jops.ConvLayer(12, 3, 2, use_bias=True, norm="rms3d", act_func="silu", is_video=True, **F32)
        tm = tops.ConvLayer(8, 12, 3, 2, use_bias=True, norm="rms3d", act_func="silu", is_video=True)
    elif case == "conv_stride122_grouped":
        jm = jops.ConvLayer(16, 3, (1, 2, 2), groups=2, norm="ln2d", act_func="gelu", is_video=True, **F32)
        tm = tops.ConvLayer(8, 16, 3, (1, 2, 2), groups=2, norm="ln2d", act_func="gelu", is_video=True)
    elif case == "conv_stride2_image":
        x = _x((2, 8, 6, 10))
        jm = jops.ConvLayer(4, 3, 2, use_bias=True, act_func="relu6", **F32)
        tm = tops.ConvLayer(8, 4, 3, 2, use_bias=True, act_func="relu6")
    elif case == "conv_unshuffle_down":
        x = _x((2, 8, 6, 10))
        jm = jops.ConvPixelUnshuffleDownSampleLayer(16, 3, 2, **F32)
        tm = tops.ConvPixelUnshuffleDownSampleLayer(8, 16, 3, 2)
    elif case == "averaging_down_3d":
        jm = jops.PixelUnshuffleChannelAveragingDownSampleLayer(8, 16, 2, temporal_downsample=True)
        tm = tops.PixelUnshuffleChannelAveragingDownSampleLayer(8, 16, 2, temporal_downsample=True)
    elif case == "averaging_down_2d":
        jm = jops.PixelUnshuffleChannelAveragingDownSampleLayer(8, 16, 2)
        tm = tops.PixelUnshuffleChannelAveragingDownSampleLayer(8, 16, 2)
    elif case == "conv_shuffle_up":
        x = _x((2, 8, 3, 5))
        jm = jops.ConvPixelShuffleUpSampleLayer(4, 3, 2, **F32)
        tm = tops.ConvPixelShuffleUpSampleLayer(8, 4, 3, 2)
    elif case == "duplicating_up_3d":
        jm = jops.ChannelDuplicatingPixelShuffleUpSampleLayer(8, 4, 2, temporal_upsample=True)
        tm = tops.ChannelDuplicatingPixelShuffleUpSampleLayer(8, 4, 2, temporal_upsample=True)
    elif case == "duplicating_up_2d":
        jm = jops.ChannelDuplicatingPixelShuffleUpSampleLayer(8, 4, 2)
        tm = tops.ChannelDuplicatingPixelShuffleUpSampleLayer(8, 4, 2)
    elif case == "duplicating_up_one_frame":
        x = _x((1, 8, 1, 4, 4))
        jm = jops.ChannelDuplicatingPixelShuffleUpSampleLayer(8, 4, 2, temporal_upsample=True)
        tm = tops.ChannelDuplicatingPixelShuffleUpSampleLayer(8, 4, 2, temporal_upsample=True)
    elif case == "interpolate_up_video":
        jm = jops.InterpolateConvUpSampleLayer(4, 3, 2, is_video=True, temporal_upsample=True, **F32)
        tm = tops.InterpolateConvUpSampleLayer(8, 4, 3, 2, is_video=True, temporal_upsample=True)
    elif case == "norm_rms3d":
        jm, tm = jops.RMSNormND(), tops.RMSNormND(8)
    else:
        jm, tm = jops.LayerNormND(), tops.LayerNormND(8)
    _layer_parity(jm, tm, x)


@pytest.mark.parametrize("case", ["resblock", "glumbconv", "litemla_video", "litemla_image", "litemla_one_frame",
                                  "evit_video"])
def test_block_matches_jax(case):
    x = _x((1, 16, 4, 6, 6))
    if case == "resblock":
        jm = jops.ResBlock(16, is_video=True, **F32)
        tm = tops.ResBlock(16, 16, is_video=True)
    elif case == "glumbconv":
        jm = jops.GLUMBConv(16, expand_ratio=2, norm=(None, None, "rms3d"), is_video=True, **F32)
        tm = tops.GLUMBConv(16, 16, expand_ratio=2, norm=(None, None, "rms3d"), is_video=True)
    elif case == "litemla_video":
        jm = jops.LiteMLA(16, scales=(5,), is_video=True, **F32)
        tm = tops.LiteMLA(16, 16, scales=(5,), is_video=True)
    elif case == "litemla_image":
        x = _x((2, 16, 6, 5))
        jm = jops.LiteMLA(8, scales=(3, 5), norm=(None, "ln2d"), **F32)
        tm = tops.LiteMLA(16, 8, scales=(3, 5), norm=(None, "ln2d"))
    elif case == "litemla_one_frame":
        x = _x((1, 16, 1, 6, 6))
        jm = jops.LiteMLA(16, scales=(5,), is_video=True, **F32)
        tm = tops.LiteMLA(16, 16, scales=(5,), is_video=True)
    else:
        jm = jops.EfficientViTBlock(16, scales=(5,), is_video=True, **F32)
        tm = tops.EfficientViTBlock(16, scales=(5,), is_video=True)
    _layer_parity(jm, tm, x)


def _jax_dcae(**kw):
    jm = JDCAE(JConfig(**TINY, dtype="fp32", **kw))
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0), jnp.zeros((1, 3, 8, 64, 64)))
    return jm, randomize(to_numpy(shapes["params"]), 2, 0.1)


def _port_dcae(params, **kw):
    m = DCAE(DCAEConfig(**TINY, dtype="fp32", **kw), device="meta", dtype=torch.float32).eval()
    load_numpy_state_dict(m, dc_ae_state_dict(params))
    return m


@pytest.mark.parametrize("shape,tiling", [
    ((1, 3, 8, 64, 64), {}),
    ((2, 3, 1, 64, 96), {}),  # image batch: no temporal down/up-sampling
    ((1, 3, 16, 64, 64), dict(use_temporal_tiling=True, temporal_tile_size=8)),
    # overlapping 64px tiles every 32px, blended; the last ones partial (32px)
    ((1, 3, 4, 64, 96), dict(use_spatial_tiling=True, spatial_tile_size=64, tile_overlap_factor=0.5)),
])
def test_dc_ae_matches_jax(shape, tiling):
    """The whole DC-AE: (x_rec, None, z) from __call__, and decode alone."""
    jm, params = _jax_dcae(**tiling)
    x = _x(shape, 3)
    x_rec, post, z = jax.jit(lambda p, v: jm.apply({"params": p}, v))(params, jnp.asarray(x))
    assert post is None
    ae = _port_dcae(params, **tiling)
    with torch.no_grad():
        t_rec, t_post, tz = ae(t(x))
    assert t_post is None and tz.shape == z.shape and t_rec.shape == x_rec.shape
    assert max_rel_err(tz.numpy(), np.asarray(z)) <= TOL
    assert max_rel_err(t_rec.numpy(), np.asarray(x_rec)) <= TOL


def test_dc_ae_weight_carry_names_and_strict_load():
    """Upstream's layout: the downsample after a stage's blocks, the
    upsample before them, the project_out norm and conv at op_list 0 and 2."""
    _, params = _jax_dcae()
    sd = dc_ae_state_dict(params)
    ae = _port_dcae(params)  # strict
    assert set(sd) == set(ae.state_dict())
    for name in ("encoder.project_in.conv.weight", "encoder.stages.0.op_list.0.main.conv1.conv.weight",
                 "encoder.stages.0.op_list.1.main.conv.bias",
                 "encoder.stages.3.op_list.0.context_module.main.aggreg.0.1.weight",
                 "encoder.stages.3.op_list.0.local_module.main.point_conv.norm.weight",
                 "encoder.project_out.main.op_list.0.weight", "encoder.project_out.main.op_list.2.conv.weight",
                 "decoder.project_in.main.conv.weight", "decoder.stages.4.op_list.0.main.conv.conv.weight",
                 "decoder.stages.4.op_list.1.context_module.main.qkv.conv.weight",
                 "decoder.stages.5.op_list.0.context_module.main.proj.conv.weight",
                 "decoder.project_out.op_list.0.bias", "decoder.project_out.op_list.2.conv.weight"):
        assert name in sd, name
    n_jax = sum(np.asarray(v).size for v in jax.tree.leaves(params))
    assert sum(v.numel() for v in ae.parameters()) == n_jax


def test_dc_ae_builder_keeps_fp32_master_weights_under_bf16_compute():
    ae = DC_AE(model_name="dc-ae-f32t4c128", is_training=True, dtype="bf16", param_dtype="fp32", device="meta",
               **TINY)
    assert {p.dtype for p in ae.parameters()} == {torch.float32} and ae.dtype == torch.bfloat16
    full = DC_AE(device="meta")  # dc-ae-f32t4c128 at full width: the JAX model's parameter count
    jm = JDCAE(JConfig())
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0), jnp.zeros((1, 3, 4, 32, 32)))
    assert sum(p.numel() for p in full.parameters()) == sum(x.size for x in jax.tree.leaves(shapes["params"]))
    with pytest.raises(FileNotFoundError, match="ckpt.safetensors"):  # the builder loads from_pretrained
        DC_AE(from_pretrained="ckpt.safetensors", device="meta")
    with pytest.raises(NotImplementedError):
        DC_AE(model_name="dc-ae-f64", device="meta")
