"""The flash-attention wrapper of the PyTorch port: CPU tensors take the
plain version, the kernel's input checks raise before any launch, and, on
a machine with an NVIDIA GPU, the CUDA kernel against its plain version.

This file imports neither JAX nor the JAX package, so it also runs where
only PyTorch is installed (``tests/conftest.py`` imports JAX, hence):
``python -m pytest --noconftest tests/test_torch_kernels.py``.
"""

import numpy as np
import pytest
import torch

from opensora_torch.ops import _build
from opensora_torch.ops import flash_attention as tflash


def _np(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def test_flash_on_cpu_takes_plain_version_without_launching():
    q = torch.from_numpy(_np((1, 1, 40, 64), 13))
    before = _build.LAUNCHES["flash_attention_fwd"]
    out = tflash.flash_attention(q, q, q, causal_block=8)
    assert out.dtype == q.dtype and out.shape == q.shape
    assert _build.LAUNCHES["flash_attention_fwd"] == before


@pytest.mark.parametrize("bad,match", [
    (dict(dtype=torch.float32), "bf16"),
    (dict(shape=(1, 2, 64, 96)), "head dims"),
    (dict(causal_block=0), "causal_block"),
])
def test_flash_kernel_input_checks(bad, match):
    """What the kernel does not take raises before any launch."""
    shape = bad.get("shape", (1, 2, 64, 128))
    q = torch.zeros(shape, dtype=bad.get("dtype", torch.bfloat16))
    with pytest.raises((TypeError, ValueError), match=match):
        tflash._check(q, q, q, bad.get("causal_block"))


# (shape, causal_block, q scale): the anchored loop, the running-max loop
# (q scaled so the logit bound A >= 40), and the frame-causal D=512 kernel;
# L = 1000 fills no tile exactly.
@pytest.mark.cuda
@pytest.mark.parametrize("shape,causal_block,qscale", [
    ((2, 3, 1000, 128), None, 1.0),
    ((2, 3, 1000, 128), None, 4.0),
    ((1, 2, 1000, 512), 96, 1.0),
])
def test_flash_kernel_matches_plain_on_cuda(shape, causal_block, qscale):
    """bf16 kernel vs the fp32 plain version on the card: bf16 output
    rounding (2^-8 relative) bounds the difference; the limit is twice
    that, of the output's scale (as in chip_smoke.py)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    gen = torch.Generator(device="cuda").manual_seed(0)
    q, k, v = (torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16) for _ in range(3))
    q = (q.float() * qscale).to(torch.bfloat16)
    if causal_block is None:
        anchor_max = tflash.anchor_log2(q, k, shape[-1] ** -0.5).max().item()
        assert (anchor_max < 40) == (qscale == 1.0)
    out, lse = tflash.flash_attention_with_lse(q, k, v, causal_block=causal_block)
    ref_out, ref_lse = tflash.flash_attention_ref(q, k, v, None, causal_block)
    assert (out.float() - ref_out).abs().max().item() <= 8e-3 * ref_out.abs().max().item()
    assert (lse - ref_lse).abs().max().item() <= 1e-3
