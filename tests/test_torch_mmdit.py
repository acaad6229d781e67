"""The port's MMDiT against the JAX package's on the CPU, fp32, with the
same (seeded, carried) weights: the tiny_dev.py geometry in every qkv
layout and RoPE pairing, and the 11B model's full width (hidden 3072, 24
heads of 128, mlp 4.0) at depth 1+1 on a short sequence. Also the weight
carry: its keys and values equal the JAX package's own exporter, and it
loads with load_state_dict(strict=True).

Tolerance: 2e-4 of the output's scale (fp32 sums over up to 12288-wide
products taken in another order).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from opensora_tpu.models.mmdit.model import MMDiTConfig as JConfig
from opensora_tpu.models.mmdit.model import MMDiTModel as JModel
from opensora_tpu.utils.ckpt import export_mmdit_state_dict

from opensora_torch.models.mmdit.model import MMDiTConfig, MMDiTModel
from opensora_torch.utils.weights import load_numpy_state_dict, mmdit_state_dict
from torch_parity_utils import max_rel_err, randomize, t, to_numpy

TOL = 2e-4

TINY = dict(in_channels=16, vec_in_dim=32, context_in_dim=64, hidden_size=64, mlp_ratio=2.0,
            num_heads=2, depth=1, depth_single_blocks=1, axes_dim=[8, 12, 12], qkv_bias=True,
            guidance_embed=True, cond_embed=True)
FLAGSHIP = dict(in_channels=64, vec_in_dim=768, context_in_dim=4096, hidden_size=3072, mlp_ratio=4.0,
                num_heads=24, depth=1, depth_single_blocks=1, axes_dim=[16, 56, 56], qkv_bias=True,
                guidance_embed=False, cond_embed=True)


def _inputs(geom, B=2, Li=12, Lt=8, seed=0):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    ids = np.stack(np.meshgrid(np.arange(1), np.arange(3), np.arange(4), indexing="ij"), -1)
    img_ids = np.broadcast_to(ids.reshape(1, Li, 3), (B, Li, 3)).astype(np.float32)
    return dict(
        img=f(B, Li, geom["in_channels"]), img_ids=img_ids,
        txt=f(B, Lt, geom["context_in_dim"]), txt_ids=np.zeros((B, Lt, 3), np.float32),
        timesteps=rng.uniform(0, 1, B).astype(np.float32), y_vec=f(B, geom["vec_in_dim"]),
        cond=f(B, Li, geom["in_channels"] + 4) if geom["cond_embed"] else None,
        guidance=np.full((B,), 4.0, np.float32) if geom["guidance_embed"] else None,
    )


def _jax_model(geom, seed=1, **kw):
    """The JAX module and seeded params of its tree (shapes from eval_shape:
    no init pass, which takes long at full width)."""
    jm = JModel(JConfig(**geom, attn_backend="xla", dtype="fp32", **kw))
    x = _inputs(geom, B=1, Li=12, Lt=8)
    shapes = jax.eval_shape(
        jm.init, jax.random.PRNGKey(0), **{k: (None if v is None else jnp.asarray(v)) for k, v in x.items()})
    return jm, randomize(to_numpy(shapes["params"]), seed, scale=0.02)


def _run_both(geom, jm, params, **kw):
    x = _inputs(geom)
    # one compiled program: op-by-op dispatch compiles every op of the
    # full-width model on its own and takes several times longer
    ref = jax.jit(jm.apply)({"params": params}, **{k: (None if v is None else jnp.asarray(v)) for k, v in x.items()})
    tm = MMDiTModel(MMDiTConfig(**geom, dtype="fp32", **kw), device="meta", dtype=torch.float32).eval()
    load_numpy_state_dict(tm, mmdit_state_dict(params))
    with torch.no_grad():
        out = tm(**{k: (None if v is None else t(v)) for k, v in x.items()})
    return out.numpy(), np.asarray(ref)


@pytest.mark.parametrize("fused_qkv", [True, False])
@pytest.mark.parametrize("rope_convention", ["split", "interleaved"])
def test_mmdit_tiny_forward_matches_jax(fused_qkv, rope_convention):
    kw = dict(fused_qkv=fused_qkv, rope_convention=rope_convention)
    jm, params = _jax_model(TINY, **kw)
    out, ref = _run_both(TINY, jm, params, **kw)
    assert out.shape == ref.shape == (2, 12, 16)
    assert max_rel_err(out, ref) <= TOL, max_rel_err(out, ref)


def test_mmdit_full_width_depth_1_1_matches_jax():
    jm, params = _jax_model(FLAGSHIP, seed=2)
    out, ref = _run_both(FLAGSHIP, jm, params)
    assert out.shape == (2, 12, 64)
    assert np.isfinite(out).all()
    assert max_rel_err(out, ref) <= TOL, max_rel_err(out, ref)


@pytest.mark.parametrize("fused_qkv", [True, False])
def test_mmdit_weight_carry_equals_jax_exporter(fused_qkv):
    jm, params = _jax_model(TINY, seed=3, fused_qkv=fused_qkv)
    cfg = jm.config
    ours = mmdit_state_dict(params)
    theirs = export_mmdit_state_dict(params, cfg.num_heads, cfg.hidden_size // cfg.num_heads)
    assert sorted(ours) == sorted(theirs)
    for k in ours:
        np.testing.assert_array_equal(ours[k], theirs[k], err_msg=k)
    tm = MMDiTModel(MMDiTConfig(**TINY, fused_qkv=fused_qkv, dtype="fp32"), device="cpu", dtype=torch.float32)
    load_numpy_state_dict(tm, ours)  # strict
    assert set(tm.state_dict()) == set(ours)
