"""The PyTorch port's ops against the JAX package's on the CPU: norms, RoPE,
the flash-attention plain version (vs the Pallas kernels in interpret mode
and vs xla_attention), and the attention entry point.

Inputs are made with numpy from a seed and handed to both sides in fp32.
Tolerances: 1e-5 absolute for elementwise ops (same fp32 formulas), 1e-4
for attention (sums taken in another order over up to 320 keys).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from opensora_tpu.ops import norms as jnorms
from opensora_tpu.ops import rope as jrope
from opensora_tpu.ops.attention import attention as jattention
from opensora_tpu.ops.attention import xla_attention
from opensora_tpu.ops.flash_attention import flash_attention_with_lse as jflash_with_lse

from opensora_torch.ops import attention as tattn
from opensora_torch.ops import flash_attention as tflash
from opensora_torch.ops import norms as tnorms
from opensora_torch.ops import rope as trope

ELEMENTWISE_TOL = 1e-5
ATTN_TOL = 1e-4


def _np(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def test_rms_norm_matches_jax():
    x, s = _np((2, 5, 32), 0), _np((32,), 1)
    ref = np.asarray(jnorms.rms_norm(jnp.asarray(x), jnp.asarray(s)))
    out = tnorms.rms_norm(torch.from_numpy(x), torch.from_numpy(s)).numpy()
    np.testing.assert_allclose(out, ref, atol=ELEMENTWISE_TOL, rtol=0)


def test_layer_norm_matches_jax():
    x = _np((2, 5, 48), 2, scale=3.0) + 1.5
    ref = np.asarray(jnorms.layer_norm(jnp.asarray(x)))
    out = tnorms.layer_norm(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(out, ref, atol=ELEMENTWISE_TOL, rtol=0)


def test_group_norm_matches_jax_channels_last():
    """The JAX group_norm is channels-last, the port's channels-first."""
    x = _np((2, 3, 4, 5, 16), 3, scale=2.0)  # (B, T, H, W, C)
    s, b = _np((16,), 4), _np((16,), 5)
    ref = np.asarray(jnorms.group_norm(jnp.asarray(x), 4, jnp.asarray(s), jnp.asarray(b)))
    out = tnorms.group_norm(torch.from_numpy(x).permute(0, 4, 1, 2, 3), 4,
                            torch.from_numpy(s), torch.from_numpy(b))
    np.testing.assert_allclose(out.permute(0, 2, 3, 4, 1).numpy(), ref, atol=ELEMENTWISE_TOL, rtol=0)


def test_embed_nd_matches_jax():
    ids = np.random.default_rng(6).integers(0, 20, (2, 10, 3)).astype(np.float32)
    axes = [8, 12, 12]
    jc, js = jrope.embed_nd(jnp.asarray(ids), axes, 10_000)
    tc, ts = trope.embed_nd(torch.from_numpy(ids), axes, 10_000)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=ELEMENTWISE_TOL, rtol=0)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=ELEMENTWISE_TOL, rtol=0)


@pytest.mark.parametrize("convention", ["split", "interleaved"])
def test_apply_rope_matches_jax(convention):
    x = _np((2, 10, 3, 32), 7)
    ids = np.random.default_rng(8).integers(0, 20, (2, 10, 3)).astype(np.float32)
    cos, sin = jrope.embed_nd(jnp.asarray(ids), [8, 12, 12], 10_000)
    jfn = getattr(jrope, f"apply_rope_{convention}")
    tfn = getattr(trope, f"apply_rope_{convention}")
    ref = np.asarray(jfn(jnp.asarray(x), cos, sin))
    out = tfn(torch.from_numpy(x), torch.tensor(np.asarray(cos)), torch.tensor(np.asarray(sin)))
    np.testing.assert_allclose(out.numpy(), ref, atol=ELEMENTWISE_TOL, rtol=0)


# (L, causal_block, q scale): anchored branch, tail tile, frame-causal mask
# with a partial last frame, and q scaled so the logit bound A >= 40 sends the
# TPU kernel down its running-max branch.
FLASH_CASES = [(256, None, 1.0), (320, None, 1.0), (320, 64, 1.0), (300, 96, 1.0), (256, None, 4.0)]


@pytest.mark.parametrize("L,causal_block,qscale", FLASH_CASES)
def test_flash_plain_matches_pallas_interpret(L, causal_block, qscale):
    B, H, D = 1, 2, 128
    q, k, v = _np((B, H, L, D), 10, qscale), _np((B, H, L, D), 11), _np((B, H, L, D), 12)
    a2 = tflash.anchor_log2(torch.from_numpy(q), torch.from_numpy(k), D**-0.5)
    if causal_block is None:
        # the case list covers both sides of the TPU's dispatch
        assert bool((a2 < 40).all()) == (qscale == 1.0)
    jout, jlse = jflash_with_lse(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), block_q=128,
                                 block_k=128, causal_block=causal_block, interpret=True)
    out, lse = tflash.flash_attention_with_lse(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), causal_block=causal_block)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), atol=ATTN_TOL, rtol=0)
    np.testing.assert_allclose(lse.numpy(), np.asarray(jlse), atol=ATTN_TOL, rtol=0)
    ref = np.asarray(xla_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal_block=causal_block))
    np.testing.assert_allclose(out.numpy(), ref, atol=ATTN_TOL, rtol=0)


@pytest.mark.parametrize("convention", ["split", "interleaved"])
def test_attention_entry_matches_jax(convention):
    B, L, H, D = 2, 24, 2, 32
    q, k, v = _np((B, L, H, D), 14), _np((B, L, H, D), 15), _np((B, L, H, D), 16)
    ids = np.random.default_rng(17).integers(0, 9, (B, L, 3)).astype(np.float32)
    cos, sin = jrope.embed_nd(jnp.asarray(ids), [8, 12, 12], 10_000)
    ref = np.asarray(jattention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), pe=(cos, sin),
                                rope_convention=convention, backend="xla"))
    pe = (torch.tensor(np.asarray(cos)), torch.tensor(np.asarray(sin)))
    for backend in (None, "xla"):
        out = tattn.attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), pe=pe,
                              rope_convention=convention, backend=backend)
        np.testing.assert_allclose(out.numpy(), ref, atol=ATTN_TOL, rtol=0)
