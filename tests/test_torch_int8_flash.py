"""The port's int8 attention (plain version, as the CPU runs it) against the
JAX package's ``int8_flash_attention`` in interpret mode, on the cases of
opensora_tpu tests/test_int8_flash.py, with the same ``block_k``; and the
port's own quality bounds against fp32 attention, the JAX file's
``FULL_TOL`` and ``QK8_TOL``.

Tolerances against the JAX kernel, fp32, relative to max|ref|: the two
quantize the same inputs the same way and sum in another order, and where
no quantized value sits at a rounding boundary they agree to ~1e-6 (most
cases here, in every row). But a value within an ulp of k + 1/2 can round
the other way and move its rows by one int8 step: K8, when the centred K
comes out of a mean summed in another order (most of all with a large
common mode, the outlier channel: +30 leaves ~30 * 2^-24 of absolute
error), and P8 = round(p * 127 / p_scale) in the anchored int8 loop, where
p = exp2(s - a2) with exp2 and the norm behind a2 from another library can
differ in its last bit. Measured over these cases: at most 2.5e-3 in a row
and 5.4e-4 relative L2; held to 3e-3 and 1e-3. Below 128 tokens both
packages take the plain fp32 attention: 1e-5.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from opensora_tpu.ops.attention import attention as jattention
from opensora_tpu.ops.attention import xla_attention
from opensora_tpu.ops.int8_flash import int8_flash_attention as jint8

from opensora_torch.ops.attention import attention
from opensora_torch.ops.int8_flash import int8_flash_attention, int8_flash_attention_ref, quantize_inputs

FULL_TOL = 0.026  # the JAX file's bounds against fp32 attention
QK8_TOL = 0.016
TIGHT = 1e-5
FLIP = 3e-3
FLIP_L2 = 1e-3


def _rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / (np.linalg.norm(b) + 1e-12)


def _qkv(shape, seed, scale=1.0, mutate=None):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal(shape).astype(np.float32) for _ in range(3))
    if mutate is not None:
        q, k, v = mutate(q, k, v)
    return q * scale, k * scale, v


def _outlier_channel(q, k, v):
    k[..., 7] += 30.0
    return q, k, v


def _peaked(q, k, v):
    k[:, :, 5, :] = q.mean(axis=2) * 8.0
    return q, k, v


CASES = {  # (shape, seed, q/k scale, mutation, block_k)
    "random": ((2, 3, 256, 128), 0, 1.0, None, 128),
    "tail": ((1, 2, 300, 128), 1, 1.0, None, 128),
    "outlier_key_channel": ((1, 2, 256, 128), 2, 1.0, _outlier_channel, 128),
    "peaked_softmax": ((1, 1, 384, 128), 3, 1.0, _peaked, 128),
    "running_max_tail": ((1, 2, 300, 128), 6, 4.0, None, 128),
    "default_block_k": ((2, 2, 300, 128), 7, 1.0, None, None),
}


@pytest.mark.parametrize("pv_int8", [False, True], ids=["qk8", "int8"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_int8_attention_matches_jax_interpret(case, pv_int8):
    shape, seed, scale, mutate, block_k = CASES[case]
    q, k, v = _qkv(shape, seed, scale, mutate)
    ref = np.asarray(jint8(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), block_q=128, block_k=block_k,
                           pv_int8=pv_int8, interpret=True))
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    out = int8_flash_attention(tq, tk, tv, block_k=block_k, pv_int8=pv_int8).numpy()
    assert out.shape == ref.shape and np.isfinite(out).all()
    rows = np.abs(out - ref).max(axis=-1) / np.abs(ref).max()
    anchored = bool((quantize_inputs(tq, tk, tv, shape[-1] ** -0.5, block_k or 300, pv_int8)["a2"] < 40).all())
    assert anchored == (scale == 1.0)
    assert rows.max() <= FLIP and _rel_l2(out, ref) <= FLIP_L2, (rows.max(), _rel_l2(out, ref))
    # the port's own quality against fp32 attention (the JAX file's bounds;
    # the running-max case has 16x the logits and its own looser bound there)
    exact = np.asarray(xla_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)))
    bound = 0.07 if scale != 1.0 else (FULL_TOL if pv_int8 else QK8_TOL)
    assert _rel_l2(out, exact) < bound


def test_qk8_is_tighter_than_int8():
    q, k, v = (torch.from_numpy(a) for a in _qkv((2, 3, 256, 128), 0))
    exact = torch.softmax(q @ k.transpose(-1, -2) / 128 ** 0.5, -1) @ v
    e_full = _rel_l2(int8_flash_attention_ref(q, k, v, block_k=128), exact)
    e_qk8 = _rel_l2(int8_flash_attention_ref(q, k, v, block_k=128, pv_int8=False), exact)
    assert e_qk8 < e_full < FULL_TOL


def test_bf16_in_bf16_out():
    q, k, v = (torch.from_numpy(a).to(torch.bfloat16) for a in _qkv((1, 2, 256, 128), 4))
    out = int8_flash_attention(q, k, v, block_k=128)
    assert out.dtype == torch.bfloat16
    exact = torch.softmax(q.float() @ k.float().transpose(-1, -2) / 128 ** 0.5, -1) @ v.float()
    assert _rel_l2(out.float(), exact) < FULL_TOL


@pytest.mark.parametrize("backend", ["int8", "int8_qk8"])
def test_attention_dispatch_matches_jax(backend):
    """The model-facing entry point: (B, L, H, D) in, (B, L, H * D) out, the
    int8 kernel's function at L >= 128 and head dim 128, plain attention
    below 128 tokens (the JAX package's rule)."""
    rng = np.random.default_rng(5)
    for length in (256, 100):
        q, k, v = (rng.standard_normal((1, length, 2, 128)).astype(np.float32) for _ in range(3))
        ref = np.asarray(jattention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), backend=backend))
        out = attention(*(torch.from_numpy(a) for a in (q, k, v)), backend=backend).numpy()
        assert out.shape == ref.shape == (1, length, 256)
        err = np.abs(out - ref).max() / np.abs(ref).max()
        if length >= 128:
            assert err <= FLIP and _rel_l2(out, ref) <= FLIP_L2
        else:
            assert err <= TIGHT, err
