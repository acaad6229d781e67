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
    before = dict(_build.LAUNCHES)
    for d in (64, 128):
        q = torch.from_numpy(_np((1, 1, 40, d), 13))
        out = tflash.flash_attention(q, q, q, causal_block=8)
        assert out.dtype == q.dtype and out.shape == q.shape
    assert _build.LAUNCHES == before


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


def _fwd_kernel(head_dim):
    """The forward's kernel at a head dim: the Hopper wgmma/TMA kernel at
    128, the mma.sync kernel at 512."""
    return tflash.KERNEL_FWD_SM90 if head_dim == tflash.FWD_SM90_HEAD_DIM else tflash.KERNEL


def test_fwd_sm90_input_checks():
    """The D = 128 forward's TMA tensor maps need 16-byte aligned inputs:
    a misaligned one raises before a launch, naming it."""
    q = torch.zeros((1, 1, 64, 128), dtype=torch.bfloat16)
    tflash._check_aligned(tflash.KERNEL_FWD_SM90, (("q", q), ("k", q), ("v", q)))
    shifted = torch.zeros(64 * 128 + 1, dtype=torch.bfloat16)[1:].view(1, 1, 64, 128)
    with pytest.raises(ValueError, match="k must be 16-byte aligned"):
        tflash._check_aligned(tflash.KERNEL_FWD_SM90, (("q", q), ("k", shifted), ("v", q)))


# (shape, causal_block, q scale, Lk): the anchored loop, the running-max
# loop (q scaled so the logit bound A >= 40), the MMDiT's length over 4
# heads in both loops, frame-causal at D = 128 and at D = 512, Lq != Lk
# both ways, L below one 128-row tile; L = 1000 fills no tile exactly.
@pytest.mark.cuda
@pytest.mark.parametrize("shape,causal_block,qscale,lk", [
    ((2, 3, 1000, 128), None, 1.0, None),
    ((2, 3, 1000, 128), None, 4.0, None),
    ((1, 4, 8828, 128), None, 1.0, None),
    ((1, 4, 8828, 128), None, 3.0, None),
    ((1, 2, 1000, 128), 96, 1.0, None),
    ((1, 2, 300, 128), None, 1.0, 500),
    ((1, 2, 500, 128), 64, 1.0, 300),
    ((2, 2, 50, 128), None, 4.0, None),
    ((1, 2, 1000, 512), 96, 1.0, None),
])
def test_flash_kernel_matches_plain_on_cuda(shape, causal_block, qscale, lk):
    """bf16 kernel vs the fp32 plain version on the card: bf16 output
    rounding (2^-8 relative) bounds the difference; the limit is twice
    that, of the output's scale (as in chip_smoke.py)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    gen = torch.Generator(device="cuda").manual_seed(0)
    kshape = shape[:2] + (lk or shape[2], shape[3])
    q, k, v = (torch.randn(s, generator=gen, device="cuda").to(torch.bfloat16) for s in (shape, kshape, kshape))
    q = (q.float() * qscale).to(torch.bfloat16)
    if causal_block is None:
        anchor_max = tflash.anchor_log2(q, k, shape[-1] ** -0.5).max().item()
        assert (anchor_max < 40) == (qscale == 1.0)
    before = dict(_build.LAUNCHES)
    out, lse = tflash.flash_attention_with_lse(q, k, v, causal_block=causal_block)
    launched = {n: c - before.get(n, 0) for n, c in _build.LAUNCHES.items() if c != before.get(n, 0)}
    assert launched == {_fwd_kernel(shape[-1]): 1}
    ref_out, ref_lse = tflash.flash_attention_ref(q, k, v, None, causal_block)
    assert (out.float() - ref_out).abs().max().item() <= 8e-3 * ref_out.abs().max().item()
    assert (lse - ref_lse).abs().max().item() <= 1e-3


# ----------------------------------------------------------------------
# backward
# ----------------------------------------------------------------------

# The bf16 backward kernels vs the fp32 plain backward on the same q, k, v,
# dO, LSE and delta: P (for dV) and dS (for dK, dQ) are rounded to bf16
# (2^-9 relative) before their products and the outputs once more; over
# many keys the rounding errors of random sign stay well under 1e-2 of each
# gradient's scale, the limit chip_smoke.py also holds them to.
BWD_RTOL = 1e-2


def _bwd_inputs(shape, causal_block, device, seed=0, lk=None):
    gen = torch.Generator(device=device).manual_seed(seed)
    kshape = shape[:2] + (lk or shape[2], shape[3])
    q, k, v, do = (torch.randn(s, generator=gen, device=device).to(torch.bfloat16)
                   for s in (shape, kshape, kshape, shape))
    out, lse = tflash.flash_attention_ref(q, k, v, None, causal_block)
    delta = (do.float() * out).sum(-1)
    return q, k, v, do, lse, delta


def _bwd_kernels(head_dim):
    """The backward's kernels at a head dim: the fused kernel and its dQ
    epilogue at 128, the split dkv / dq pair at 512."""
    if head_dim == tflash.FUSED_HEAD_DIM:
        return (tflash.KERNEL_FUSED, tflash.KERNEL_DQ_CONVERT)
    return (tflash.KERNEL_DKV, tflash.KERNEL_DQ)


def test_flash_function_on_cpu_matches_autograd_of_plain_attention():
    """On the CPU the Function takes the plain forward and the plain
    backward; its gradients equal autograd through the plain attention."""
    shape, cb = (1, 2, 40, 16), 8
    base = [torch.from_numpy(_np(shape, s)) for s in (1, 2, 3)]
    do = torch.from_numpy(_np(shape, 4))
    q, k, v = (x.clone().requires_grad_() for x in base)
    before = dict(_build.LAUNCHES)
    out = tflash.flash_attention(q, k, v, causal_block=cb)
    grads = torch.autograd.grad(out, (q, k, v), do)
    q2, k2, v2 = (x.clone().requires_grad_() for x in base)
    ref = tflash.flash_attention_ref(q2, k2, v2, None, cb)[0]
    ref_grads = torch.autograd.grad(ref, (q2, k2, v2), do)
    assert out.grad_fn is not None
    for got, want in zip(grads, ref_grads):
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
    assert _build.LAUNCHES == before


def test_flash_bwd_kernel_input_checks():
    """A head dim the backward kernels were not built for (they take 128 and
    512) and inputs they do not take raise before a launch, naming what is
    wrong; D = 512 passes the checks."""
    assert tflash.BWD_HEAD_DIMS == (128, 512)
    lse = torch.zeros((1, 1, 64))
    q = torch.zeros((1, 1, 64, 512), dtype=torch.bfloat16)
    tflash._check_bwd(q, q, q, q, lse, lse, 16)
    q = torch.zeros((1, 1, 64, 256), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="head dims"):
        tflash._check_bwd(q, q, q, q, lse, lse, None)
    q = torch.zeros((1, 1, 64, 128), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="delta"):
        tflash._check_bwd(q, q, q, q, lse, lse[..., :32], None)


@pytest.mark.cuda
@pytest.mark.parametrize("shape,causal_block", [
    ((2, 3, 1000, 128), None),
    ((1, 2, 1000, 128), 96),
    ((1, 2, 256, 128), 64),
    # D = 512 (the VAE mid-block: the gradient's D split over 4 blocks):
    # tails of 1000 % 64 and 1000 % 16 rows, several frames, bidirectional
    ((1, 2, 1000, 512), 96),
    ((1, 1, 2048, 512), 256),
    ((2, 1, 300, 512), None),
])
def test_flash_bwd_kernels_match_plain_on_cuda(shape, causal_block):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    q, k, v, do, lse, delta = _bwd_inputs(shape, causal_block, "cuda")
    before = dict(_build.LAUNCHES)
    got = tflash.partial_flash_backward(q, k, v, do, lse, delta, causal_block=causal_block)
    want = tflash.flash_attention_bwd_ref(q, k, v, do, lse, delta, None, causal_block)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        err = (g.float() - w).abs().max().item()
        assert err <= BWD_RTOL * w.abs().max().item(), (name, err, w.abs().max().item())
    for name in _bwd_kernels(shape[-1]):
        assert _build.LAUNCHES[name] == before.get(name, 0) + 1


@pytest.mark.cuda
@pytest.mark.parametrize("shape,causal_block", [((1, 2, 300, 128), None), ((1, 1, 300, 512), 64)])
def test_flash_function_backward_on_cuda_goes_through_the_kernels(shape, causal_block):
    """A backward through the Function on the card launches both backward
    kernels (no gradient is dropped) and agrees with autograd through the
    plain fp32 attention on the same bf16 inputs."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    gen = torch.Generator(device="cuda").manual_seed(1)
    base = [torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16) for _ in range(3)]
    do = torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)
    q, k, v = (x.clone().requires_grad_() for x in base)
    before = dict(_build.LAUNCHES)
    grads = torch.autograd.grad(tflash.flash_attention(q, k, v, causal_block=causal_block), (q, k, v), do)
    launched = {n: c - before.get(n, 0) for n, c in _build.LAUNCHES.items() if c != before.get(n, 0)}
    assert launched == {_fwd_kernel(shape[-1]): 1, **{n: 1 for n in _bwd_kernels(shape[-1])}}
    q2, k2, v2 = (x.float().requires_grad_() for x in base)
    ref = tflash.flash_attention_ref(q2, k2, v2, None, causal_block)[0]
    ref_grads = torch.autograd.grad(ref, (q2, k2, v2), do.float())
    for g, w in zip(grads, ref_grads):
        # the bf16 forward output feeds delta here, adding its rounding
        assert (g.float() - w).abs().max().item() <= 2 * BWD_RTOL * w.abs().max().item()


# ----------------------------------------------------------------------
# the fused D = 128 backward (csrc/flash_attention_bwd_sm90.cu)
# ----------------------------------------------------------------------


def test_dq_accum_layout_is_the_wgmma_fragment_order():
    """dq_accum's layout: float 2 i + e of thread t = 32 w + 4 g + q in
    float4 j of consumer c of query tile T is row 64 T + 16 w + g + 8 i,
    column 64 c + 8 j + 2 q + e; the two maps are each other's inverse."""
    acc = torch.zeros((1, 1, 128, 128))
    for tile, c, j, w, g, q, i, e in ((1, 1, 3, 2, 5, 3, 1, 0), (0, 0, 7, 3, 7, 0, 0, 1)):
        acc.zero_()
        acc.view(-1)[tile * 8192 + c * 4096 + (j * 128 + 32 * w + 4 * g + q) * 4 + 2 * i + e] = 1.0
        rows = tflash.dq_accum_to_rows(acc, 128)
        assert rows.nonzero().tolist() == [[0, 0, 64 * tile + 16 * w + g + 8 * i, 64 * c + 8 * j + 2 * q + e]]
    x = torch.from_numpy(_np((2, 3, 100, 128), 5))
    acc = tflash.dq_rows_to_accum(x)
    assert acc.shape == (2, 3, 128, 128)
    assert torch.equal(tflash.dq_accum_to_rows(acc, 100), x)
    assert int((acc != 0).sum()) == int((x != 0).sum())  # the padding rows hold zeros only


@pytest.mark.parametrize("d", [32, 24, 20])
def test_dq_accum_layout_round_trips_at_narrow_head_dims(d):
    """The plain ring backward keeps its dQ sum in the dq_accum layout at the
    small models' head dims too: the two maps stay each other's inverse and
    move only rows within their 64-row tile."""
    x = torch.from_numpy(_np((1, 2, 100, d), 6))
    acc = tflash.dq_rows_to_accum(x)
    assert acc.shape == (1, 2, 128, d)
    assert torch.equal(tflash.dq_accum_to_rows(acc, 100), x)
    assert torch.equal(acc[:, :, :64].flatten().sort().values, x[:, :, :64].flatten().sort().values)


def test_fused_backward_on_cpu_takes_plain_versions_without_launching():
    """CPU tensors: the fused wrapper pair gives the plain backward (dq
    through dq_accum and the plain epilogue), with no launch."""
    q, k, v, do, lse, delta = _bwd_inputs((1, 2, 100, 128), 48, "cpu")
    before = dict(_build.LAUNCHES)
    dq, dk, dv = tflash.flash_attention_bwd_fused(q, k, v, do, lse, delta, sm_scale=0.125, causal_block=48)
    ref = tflash.flash_attention_bwd_ref(q, k, v, do, lse, delta, 0.125, 48)
    assert dq.dtype == dk.dtype == dv.dtype == torch.bfloat16
    for got, want in zip((dq, dk, dv), ref):
        assert torch.equal(got, want.to(torch.bfloat16))
    assert _build.LAUNCHES == before


def test_fused_backward_input_checks():
    """What the fused kernel and its epilogue do not take raises before a
    launch: another head dim, a misaligned tensor (the TMA's 16 bytes), a
    dq_accum of the wrong shape or dtype."""
    lse = torch.zeros((1, 1, 64))
    q = torch.zeros((1, 1, 64, 128), dtype=torch.bfloat16)
    tflash._check_fused(q, q, q, q, lse, lse, None)
    q512 = torch.zeros((1, 1, 64, 512), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="head dim 128"):
        tflash._check_fused(q512, q512, q512, q512, lse, lse, None)
    shifted = torch.zeros(64 * 128 + 1, dtype=torch.bfloat16)[1:].view(1, 1, 64, 128)
    with pytest.raises(ValueError, match="16-byte aligned"):
        tflash._check_fused(q, shifted, q, q, lse, lse, None)
    tflash._check_dq_accum(torch.zeros((1, 1, 64, 128)), 50)
    for bad in (torch.zeros((1, 1, 50, 128)), torch.zeros((1, 1, 64, 128), dtype=torch.bfloat16)):
        with pytest.raises(ValueError, match="dq_accum"):
            tflash._check_dq_accum(bad, 50)


# (B, H, Lq, D), causal_block, Lk: a tail of 64-row tiles and 128-key
# blocks, several frames, L < 64, Lq != Lk both ways
FUSED_CASES = [
    ((2, 3, 1000, 128), None, None),
    ((1, 2, 1000, 128), 96, None),
    ((1, 2, 50, 128), None, None),
    ((1, 2, 300, 128), None, 500),
    ((1, 2, 500, 128), 64, 300),
]


@pytest.mark.cuda
@pytest.mark.parametrize("shape,causal_block,lk", FUSED_CASES)
def test_fused_backward_kernels_match_plain_on_cuda(shape, causal_block, lk):
    """The fused kernel's dk, dv and dq_accum against the plain backward
    (BWD_RTOL of each gradient's scale; dq_accum read through its layout),
    and the epilogue kernel equal to its plain version on the same
    dq_accum (the same fp32 multiply and bf16 rounding)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    q, k, v, do, lse, delta = _bwd_inputs(shape, causal_block, "cuda", lk=lk)
    sm_scale = shape[-1] ** -0.5
    before = dict(_build.LAUNCHES)
    acc, dk, dv = tflash.flash_attention_bwd_fused_accum(q, k, v, do, lse, delta, sm_scale=sm_scale,
                                                         causal_block=causal_block)
    dq = tflash.flash_attention_bwd_dq_convert(acc, shape[2], sm_scale=sm_scale)
    torch.cuda.synchronize()
    assert _build.LAUNCHES[tflash.KERNEL_FUSED] == before.get(tflash.KERNEL_FUSED, 0) + 1
    assert _build.LAUNCHES[tflash.KERNEL_DQ_CONVERT] == before.get(tflash.KERNEL_DQ_CONVERT, 0) + 1
    want = tflash.flash_attention_bwd_ref(q, k, v, do, lse, delta, sm_scale, causal_block)
    got = (tflash.dq_accum_to_rows(acc, shape[2]) * sm_scale, dk, dv)
    for name, g, w in zip(("dq_accum", "dk", "dv"), got, want):
        err = (g.float() - w).abs().max().item()
        assert err <= BWD_RTOL * w.abs().max().item(), (name, err, w.abs().max().item())
    assert torch.equal(dq, tflash.flash_attention_bwd_dq_convert_ref(acc, shape[2], sm_scale))


@pytest.mark.cuda
def test_fused_backward_run_to_run_spread_on_cuda():
    """dQ's fp32 sum is added in an order that changes from run to run. Two
    runs' dq_accum differ by fp32 rounding alone: 8 key blocks' partials
    summed in another order, a few fp32 ulps of the partials, held to 1e-5
    of max|dq_accum|. So their bf16 dq differ by at most that (times
    sm_scale) plus one bf16 ulp of the element (2^-7 of it). dk and dv are
    summed in registers in a fixed order and agree bitwise."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    q, k, v, do, lse, delta = _bwd_inputs((2, 3, 1000, 128), None, "cuda", seed=3)
    sm_scale = 128 ** -0.5
    acc0, dk0, dv0 = tflash.flash_attention_bwd_fused_accum(q, k, v, do, lse, delta, sm_scale=sm_scale)
    dq0 = tflash.flash_attention_bwd_dq_convert(acc0, 1000, sm_scale=sm_scale).float()
    scale = acc0.abs().max().item()
    for _ in range(3):
        acc, dk, dv = tflash.flash_attention_bwd_fused_accum(q, k, v, do, lse, delta, sm_scale=sm_scale)
        spread = (acc - acc0).abs().max().item()
        assert spread <= 1e-5 * scale, (spread, scale)
        dq = tflash.flash_attention_bwd_dq_convert(acc, 1000, sm_scale=sm_scale).float()
        bound = 2.0 ** -7 * torch.maximum(dq.abs(), dq0.abs()) + 1e-5 * scale * sm_scale
        assert bool(((dq - dq0).abs() <= bound).all())
        assert torch.equal(dk, dk0) and torch.equal(dv, dv0)


@pytest.mark.cuda
def test_fused_backward_raises_on_cuda_inputs_it_does_not_take():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    q, k, v, do, lse, delta = _bwd_inputs((1, 1, 64, 64), None, "cuda")
    with pytest.raises(ValueError, match="head dim"):
        tflash.flash_attention_bwd_fused(q, k, v, do, lse, delta, sm_scale=0.125)
    q, k, v, do, lse, delta = _bwd_inputs((1, 1, 64, 128), None, "cuda")
    with pytest.raises(TypeError, match="bf16"):
        tflash.flash_attention_bwd_fused(q.float(), k, v, do, lse, delta, sm_scale=0.125)
    with pytest.raises(ValueError, match="dq_accum"):
        tflash.flash_attention_bwd_dq_convert(torch.zeros((1, 1, 64, 128), device="cuda"), 65, sm_scale=0.125)


# ----------------------------------------------------------------------
# W8A8 GEMM (csrc/int8_matmul_sm90.cu)
# ----------------------------------------------------------------------

from opensora_torch.ops import int8_flash as tint8  # noqa: E402
from opensora_torch.ops import int8_matmul as tgemm  # noqa: E402


def _gemm_inputs(m, n, k, seed, device="cpu"):
    rng = np.random.default_rng(seed)
    x8 = torch.from_numpy(rng.integers(-127, 128, (m, k)).astype(np.int8)).to(device)
    w = torch.from_numpy(rng.integers(-127, 128, (n, k)).astype(np.int8)).to(device)
    sa = torch.from_numpy((rng.random((m, 1)) * 0.01 + 1e-3).astype(np.float32)).to(device)
    sw = torch.from_numpy((rng.random(n) * 0.01 + 1e-3).astype(np.float32)).to(device)
    x = torch.from_numpy((rng.standard_normal((m, k)) * 0.3).astype(np.float32)).to(device, torch.bfloat16)
    return x8, w, sa, sw, x


def test_w8a8_on_cpu_takes_plain_versions_without_launching():
    x8, w, sa, sw, x = _gemm_inputs(5, 24, 64, 0)
    before = dict(_build.LAUNCHES)
    out = tgemm.w8a8_matmul(x8, w, sa, sw)
    assert out.dtype == torch.bfloat16 and out.shape == (5, 24)
    torch.testing.assert_close(out, tgemm.w8a8_matmul_ref(x8, w, sa, sw), rtol=0, atol=0)
    out = tgemm.w8a8_fusedquant_matmul(x, w, sw, out_dtype=torch.float32)
    torch.testing.assert_close(out, tgemm.w8a8_fusedquant_matmul_ref(x, w, sw, torch.float32), rtol=0, atol=0)
    assert _build.LAUNCHES == before


@pytest.mark.parametrize("bad,match", [
    (dict(x_dtype=torch.float32), "activations"),
    (dict(w_dtype=torch.int16), "int8"),
    (dict(k=96), "K tile"),
    (dict(out_dtype=torch.float16), "out_dtype"),
])
def test_w8a8_kernel_input_checks(bad, match):
    """What the kernel does not take raises before any launch."""
    k = bad.get("k", 128)
    x = torch.zeros((4, k), dtype=bad.get("x_dtype", torch.int8))
    w = torch.zeros((8, k), dtype=bad.get("w_dtype", torch.int8))
    with pytest.raises((TypeError, ValueError), match=match):
        tgemm._check(x, w, torch.ones(8), torch.int8, bad.get("out_dtype", torch.bfloat16))


# The kernel's integer sums are exact and its fp32 epilogue runs in the
# plain version's order: at fp32 output the two agree in every element.
# (1000, 200, 3072) and (3, 18432, 3072) are chip_smoke.py's m_and_n_tails
# and modulation shapes; (520, 300, 448) has an N no multiple of 8 and a K
# loop of 7 steps, more than the int8 instantiation's 6 stages.
GEMM_CASES = [(300, 512, 1024), (3, 384, 3072), (1000, 200, 640), (1000, 200, 3072), (3, 18432, 3072),
              (520, 300, 448)]


@pytest.mark.cuda
@pytest.mark.parametrize("m,n,k", GEMM_CASES)
def test_w8a8_kernels_equal_plain_on_cuda(m, n, k):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    x8, w, sa, sw, x = _gemm_inputs(m, n, k, 1, "cuda")
    before = dict(_build.LAUNCHES)
    got = tgemm.w8a8_matmul(x8, w, sa, sw, out_dtype=torch.float32)
    assert torch.equal(got, tgemm.w8a8_matmul_ref(x8, w, sa, sw, torch.float32))
    got = tgemm.w8a8_fusedquant_matmul(x, w, sw, out_dtype=torch.float32)
    assert torch.equal(got, tgemm.w8a8_fusedquant_matmul_ref(x, w, sw, torch.float32))
    got = tgemm.w8a8_matmul(x8, w, sa, sw)  # bf16 output: the same values, rounded once
    assert torch.equal(got, tgemm.w8a8_matmul_ref(x8, w, sa, sw))
    assert _build.LAUNCHES[tgemm.KERNEL] == before.get(tgemm.KERNEL, 0) + 2
    assert _build.LAUNCHES[tgemm.KERNEL_FQ] == before.get(tgemm.KERNEL_FQ, 0) + 1


@pytest.mark.cuda
@pytest.mark.parametrize("m,n,k", [(1000, 512, 1024), (130, 264, 64)])
def test_w8a8_fq_kernel_rounds_ties_half_to_even_on_cuda(m, n, k):
    """Rows of abs-max 127 (s_a = inv = 1) holding half-integers put x * inv
    on ties: the fused-quant kernel (csrc/int8_matmul_sm90.cu, the magic-
    number rounding) equals the plain version, which rounds half to even, in
    every element at fp32 and bf16 output; an N no multiple of 8 takes the
    element-wise bf16 stores."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    rng = np.random.default_rng(5)
    x = (rng.integers(-127, 127, (m, k)) + 0.5).astype(np.float32)
    x[:, 0] = 127.0
    x = torch.from_numpy(x).to("cuda", torch.bfloat16)
    w = torch.from_numpy(rng.integers(-127, 128, (n, k)).astype(np.int8)).to("cuda")
    sw = torch.from_numpy((rng.random(n) * 0.01 + 1e-3).astype(np.float32)).to("cuda")
    s_a, inv = tgemm.fq_inputs(x)
    assert bool((s_a == 1).all()) and bool((inv == 1).all())
    for dt in (torch.float32, torch.bfloat16):
        got = tgemm.w8a8_fusedquant_matmul(x, w, sw, out_dtype=dt)
        assert torch.equal(got, tgemm.w8a8_fusedquant_matmul_ref(x, w, sw, dt)), dt


# ----------------------------------------------------------------------
# int8 attention (csrc/int8_flash_attention.cu)
# ----------------------------------------------------------------------


def test_int8_attention_on_cpu_takes_plain_version_without_launching():
    q = torch.from_numpy(_np((1, 2, 130, 128), 21))
    before = dict(_build.LAUNCHES)
    for pv_int8 in (False, True):
        out = tint8.int8_flash_attention(q, q * 0.5, q, block_k=64, pv_int8=pv_int8)
        assert out.dtype == q.dtype and out.shape == q.shape
    assert _build.LAUNCHES == before


@pytest.mark.parametrize("bad,match", [
    (dict(dtype=torch.float32), "bf16"),
    (dict(shape=(1, 2, 256, 64)), "head dim"),
    (dict(block_k=100), "block_k"),
])
def test_int8_attention_kernel_input_checks(bad, match):
    shape = bad.get("shape", (1, 2, 256, 128))
    q = torch.zeros(shape, dtype=bad.get("dtype", torch.bfloat16))
    with pytest.raises((TypeError, ValueError), match=match):
        tint8._check(q, q, q, bad.get("block_k", 128))


def test_int8_attention_refuses_causal_block():
    from opensora_torch.ops.attention import scaled_dot_product_attention

    q = torch.zeros((1, 1, 256, 128))
    with pytest.raises(ValueError, match="bidirectional"):
        scaled_dot_product_attention(q, q, q, causal_block=16, backend="int8_qk8")


def test_v8_permutation_matches_the_score_fragment():
    """Logical key 4t + j of a 16-key group is the key a lane with column
    pair t holds in its score fragment: 2t, 2t + 1 of the group's first
    8-key tile (j = 0, 1), then of its second (j = 2, 3)."""
    for t in range(4):
        assert [tint8.PERM_16[4 * t + j] for j in range(4)] == [2 * t, 2 * t + 1, 8 + 2 * t, 9 + 2 * t]
    v8 = torch.arange(40, dtype=torch.int8).reshape(1, 1, 40, 1)
    vt = tint8._v8_transposed(v8)
    assert vt.shape == (1, 1, 1, 64)
    want = [16 * grp + p if 16 * grp + p < 40 else 0 for grp in range(4) for p in tint8.PERM_16]
    assert vt[0, 0, 0].tolist() == want  # padded keys are zero


# Each mode in each loop: the anchored loop (N(0,1) inputs, a2 < 40) and
# the running-max loop (q and k scaled by 4, a2 >= 40); L = 1000 fills no
# 64-key tile and, with block_k 512, no quantization tile. The kernel sums
# in another order and rounds P (bf16 in qk8 mode) against other anchors than
# the plain version's fp32 row softmax; the output is bf16: it is held to
# 8e-3 of the output's scale, as the bf16 forward (chip_smoke.py OUT_RTOL).
INT8_ATTN_RTOL = 8e-3


@pytest.mark.cuda
@pytest.mark.parametrize("pv_int8", [False, True])
@pytest.mark.parametrize("shape,scale,block_k", [
    ((2, 3, 1000, 128), 1.0, 512),
    ((2, 3, 1000, 128), 4.0, 512),
    ((1, 2, 300, 128), 1.0, None),
    ((2, 3, 1000, 128), 1.0, 64),
    ((2, 3, 1000, 128), 4.0, 192),
    ((1, 2, 4000, 128), 1.0, 1536),
])
def test_int8_attention_kernel_matches_plain_on_cuda(pv_int8, shape, scale, block_k):
    """block_k 512, 1536 and a whole L = 300 run 128-key compute tiles; 64
    and 192 (no multiple of 128) run 64-key ones."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    gen = torch.Generator(device="cuda").manual_seed(3)
    q, k, v = (torch.randn(shape, generator=gen, device="cuda") for _ in range(3))
    q, k, v = (q * scale).to(torch.bfloat16), (k * scale).to(torch.bfloat16), v.to(torch.bfloat16)
    pre = tint8.quantize_inputs(q, k, v, shape[-1] ** -0.5, block_k or tint8.default_block_k(shape[2]), pv_int8)
    assert bool((pre["a2"] < 40).all()) == (scale == 1.0)
    name = tint8.KERNEL_PV8 if pv_int8 else tint8.KERNEL
    before = _build.LAUNCHES[name]
    out = tint8.int8_flash_attention(q, k, v, block_k=block_k, pv_int8=pv_int8)
    assert _build.LAUNCHES[name] == before + 1
    ref = tint8.int8_flash_attention_ref(q, k, v, block_k=block_k, pv_int8=pv_int8)
    err = (out.float() - ref).abs().max().item()
    assert torch.isfinite(out).all() and err <= INT8_ATTN_RTOL * ref.abs().max().item(), err


# ----------------------------------------------------------------------
# ring flash attention (csrc/ring_flash_attention.cu)
# ----------------------------------------------------------------------

from opensora_torch.ops import ring_flash as tring  # noqa: E402
from opensora_torch.parallel.mesh import MeshConfig, create_mesh  # noqa: E402

RING_KERNELS = (tring.KERNEL_FWD, tring.KERNEL_BWD)


def _ring_mesh(device, sp=4):
    return create_mesh(MeshConfig(dp_size=1, sp_size=sp, tp_size=1), [torch.device(device)] * sp)


def test_ring_on_cpu_takes_plain_hops_without_launching():
    """CPU tensors go through the plain hops (over 4 logical CPU ranks) and
    launch nothing; the result is the dense attention's, causal at global
    offsets, at a local length that fills no tile."""
    shape, cb = (1, 2, 4 * 37, 32), 24
    q, k, v = (torch.from_numpy(_np(shape, s)) for s in (5, 6, 7))
    before = dict(_build.LAUNCHES)
    out, lse = tring.ring_flash_attention(q, k, v, _ring_mesh("cpu"), causal_block=cb)
    ref, ref_lse = tflash.flash_attention_ref(q, k, v, None, cb)
    torch.testing.assert_close(out, ref, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(lse, ref_lse, rtol=1e-5, atol=1e-5)
    assert _build.LAUNCHES == before


def test_ring_kernel_input_checks():
    """What the hop kernels do not take raises before any launch, naming it."""
    q = torch.zeros((1, 2, 64, 128), dtype=torch.bfloat16)
    f = torch.zeros((1, 2, 64), dtype=torch.float32)
    tring._check(bf16=(("q", q), ("k", q)), fp32=(("lse", f),), like=q)
    with pytest.raises(TypeError, match="bf16"):
        tring._check(bf16=(("k", q.float()),), like=q)
    with pytest.raises(ValueError, match="128"):
        tring._check(bf16=(("k", torch.zeros((1, 2, 64, 64), dtype=torch.bfloat16)),), like=q)
    with pytest.raises(TypeError, match="fp32"):
        tring._check(fp32=(("acc", q),), like=q)
    with pytest.raises(ValueError, match="contiguous"):
        tring._check(bf16=(("k", q.transpose(2, 3).contiguous().transpose(2, 3)),), like=q)
    with pytest.raises(ValueError, match="split"):
        tring.ring_flash_attention(q[:, :, :62], q[:, :, :62], q[:, :, :62], _ring_mesh("cpu"))
    with pytest.raises(ValueError, match="cuda or cpu"):
        tring._route(q.to("meta"))


def _hop_inputs(lq, lk, causal_block, q_off, device, seed=6):
    """One backward hop's inputs: q, dO of a rank's lq rows at global
    offset q_off, the k, v it holds, and the LSE and delta of its rows
    over every key of the ring (here: these keys and a second, unseen set)."""
    gen = torch.Generator(device=device).manual_seed(seed)
    b, h, d = 1, 2, 128
    q, do = (torch.randn((b, h, lq, d), generator=gen, device=device).to(torch.bfloat16) for _ in range(2))
    k, v = (torch.randn((b, h, lk, d), generator=gen, device=device).to(torch.bfloat16) for _ in range(2))
    lse = torch.logsumexp(torch.randn((b, h, lq, 4), generator=gen, device=device) * 2 + 8, -1)
    delta = torch.randn((b, h, lq), generator=gen, device=device) * 0.1
    return q, k, v, do, lse.contiguous(), delta


def _hop_accs(q, k, seed=7):
    """Nonzero travelling dK/dV accumulators and a dq_accum (the fused
    kernel's layout, its padding rows 0), as a hop finds them after earlier
    hops."""
    gen = torch.Generator(device=q.device).manual_seed(seed)
    dk, dv, dq = (torch.randn(x.shape, generator=gen, device=q.device) for x in (k, k, q))
    return dk, dv, tflash.dq_rows_to_accum(dq)


def test_ring_bwd_hop_on_cpu_takes_plain_version_and_checks_its_inputs():
    """CPU tensors: the fused hop's wrapper runs the plain hop (no launch);
    what the kernel does not take raises: a dq_accum that is not the fused
    kernel's, one 64-row tile per 64 rows."""
    q, k, v, do, lse, delta = _hop_inputs(100, 70, 48, 100, "cpu")
    kw = dict(sm_scale=128 ** -0.5, causal_block=48, q_off=100, k_off=30)
    accs = _hop_accs(q, k)
    want = [x.clone() for x in accs]
    before = dict(_build.LAUNCHES)
    tring.ring_bwd_hop(q, k, v, do, lse, delta, *accs, **kw)
    tring.ring_bwd_hop_ref(q, k, v, do, lse, delta, *want, **kw)
    assert _build.LAUNCHES == before
    for got, w in zip(accs, want):
        assert torch.equal(got, w)
    assert accs[2].shape == (1, 2, 128, 128)
    with pytest.raises(ValueError, match="dq_accum"):
        tflash._check_dq_accum(torch.zeros((1, 2, 100, 128)), 100)


def test_ring_dq_finish_reads_the_dq_accum_layout_on_cpu():
    """One dq_accum layout on every device: on the CPU, dq_finish of the
    dq_accum that dq_rows_to_accum builds gives back its rows, scaled."""
    x = torch.randn((1, 2, 100, 128), generator=torch.Generator().manual_seed(3))
    got = tring.dq_finish(tflash.dq_rows_to_accum(x), 100, sm_scale=0.5, dtype=torch.float32)
    assert torch.equal(got, x * 0.5)


# (Lq, Lk, causal_block, q_off, k_off): one hop at global offsets; local
# lengths that fill no 64-row tile or 128-key block; a causal hop whose
# keys come from a later rank (all but the 16 of the frame the shard edge
# cuts unseen: 7 of 8 key blocks add nothing), and one from an earlier rank.
HOP_CASES = [
    (250, 250, None, 250, 0),
    (1000, 1000, 96, 1000, 2000),
    (1000, 1000, 96, 2000, 1000),
    (300, 500, 64, 0, 300),
]


@pytest.mark.cuda
@pytest.mark.parametrize("lq,lk,causal_block,q_off,k_off", HOP_CASES)
def test_ring_bwd_fused_hop_matches_plain_hop_on_cuda(lq, lk, causal_block, q_off, k_off):
    """The fused hop kernel adds into the travelling dK/dV and the rank's
    dq_accum what the plain hop adds: each sum held to 1e-2 of the scale of
    what the hop adds (P and dS rounded to bf16, as in the dense backward);
    where no query sees the keys the accumulators keep their values."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    q, k, v, do, lse, delta = _hop_inputs(lq, lk, causal_block, q_off, "cuda")
    kw = dict(sm_scale=128 ** -0.5, causal_block=causal_block, q_off=q_off, k_off=k_off)
    start = _hop_accs(q, k)
    accs = [x.clone() for x in start]
    want = [x.clone() for x in start]
    before = dict(_build.LAUNCHES)
    tring.ring_bwd_hop(q, k, v, do, lse, delta, *accs, **kw)
    torch.cuda.synchronize()
    assert _build.LAUNCHES[tring.KERNEL_BWD] == before.get(tring.KERNEL_BWD, 0) + 1
    tring.ring_bwd_hop_ref(q, k, v, do, lse, delta, *want, **kw)
    rows = lambda x: tflash.dq_accum_to_rows(x, lq)  # noqa: E731  (the padding rows hold no dq)
    accs[2], want[2], s0_dq = rows(accs[2]), rows(want[2]), rows(start[2])
    for name, got, w, s0 in zip(("dk", "dv", "dq"), accs, want, (*start[:2], s0_dq)):
        added = (w - s0).abs().max().item()
        err = (got - w).abs().max().item()
        assert err <= BWD_RTOL * added + 1e-6 * s0.abs().max().item(), (name, err, added)
    seen = tring.visible(lq, lk, q_off, k_off, causal_block, q.device)
    if seen is not None:  # keys no query sees (whole 128-key blocks return at once) keep their sums bitwise
        unseen = ~seen.any(0)
        assert bool(unseen.any()) == (k_off > q_off)
        for got, s0 in zip(accs[:2], start[:2]):
            assert torch.equal(got[:, :, unseen], s0[:, :, unseen])


# (Lq, Lk, causal_block, q_off, k_off, first, last): forward hops at global
# offsets from a loaded state: a middle hop at the slice's local length
# (2207 rows: 17 full CTAs and a 31-row tail); a last hop whose frames of
# 96 the shard edges cut; and a 159-row shard (a full CTA, a 31-row tail)
# holding keys that its first CTA does not see, on a middle, the first and
# the last hop; a last hop with no keys at all (out and LSE from the loaded
# state, as chip_smoke's skipped-last-hop control runs it).
FWD_HOP_CASES = [
    (2207, 2207, None, 2207, 0, False, False),
    (250, 250, 96, 500, 250, False, True),
    (159, 159, 64, 0, 128, False, False),
    (159, 159, 64, 0, 128, True, False),
    (159, 159, 64, 0, 128, False, True),
    (159, 0, None, 0, 0, False, True),
]


@pytest.mark.cuda
@pytest.mark.parametrize("lq,lk,causal_block,q_off,k_off,first,last", FWD_HOP_CASES)
def test_ring_fwd_hop_matches_plain_hop_on_cuda(lq, lk, causal_block, q_off, k_off, first, last):
    """The forward hop kernel (the D = 128 forward's main loop from and to
    the rank's state) against the plain hop from the same loaded state: m
    to 1e-3 and l to 1e-3 of its scale (fp32 sums), acc to 1e-2 of its
    scale (P rounded to bf16 for the PV product), out to 8e-3 of its scale
    and the LSE to 1e-3, as the dense forward; a CTA with no key tile keeps
    its rows' state bitwise on a middle hop."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    gen = torch.Generator(device="cuda").manual_seed(8)
    q = torch.randn((1, 2, lq, 128), generator=gen, device="cuda").to(torch.bfloat16)
    k, v = (torch.randn((1, 2, lk, 128), generator=gen, device="cuda").to(torch.bfloat16) for _ in range(2))
    start = (torch.randn((1, 2, lq), generator=gen, device="cuda") * 3,
             torch.rand((1, 2, lq), generator=gen, device="cuda") * 50 + 1,
             torch.randn((1, 2, lq, 128), generator=gen, device="cuda") * 10)
    state, want = [x.clone() for x in start], [x.clone() for x in start]
    out, lse = torch.zeros_like(q), torch.zeros((1, 2, lq), device="cuda")
    ref_out, ref_lse = torch.zeros_like(q), torch.zeros_like(lse)
    kw = dict(sm_scale=128 ** -0.5, causal_block=causal_block, q_off=q_off, k_off=k_off, first=first, last=last)
    before = dict(_build.LAUNCHES)
    tring.ring_fwd_hop(q, k, v, state, out, lse, **kw)
    torch.cuda.synchronize()
    assert _build.LAUNCHES[tring.KERNEL_FWD] == before.get(tring.KERNEL_FWD, 0) + 1
    tring.ring_fwd_hop_ref(q, k, v, want, ref_out, ref_lse, **kw)
    if last:
        assert (out.float() - ref_out.float()).abs().max().item() <= 8e-3 * ref_out.float().abs().max().item()
        assert (lse - ref_lse).abs().max().item() <= 1e-3
        return
    for name, got, w, tol in zip("mla", state, want, (1e-3, 1e-3, 1e-2)):
        err = (got - w).abs().max().item()
        assert err <= tol * max(1.0, w.abs().max().item()), (name, err)
    if causal_block is not None and not first:  # the first CTA sees no key: it returned, its rows as loaded
        for got, s0 in zip(state, start):
            assert torch.equal(got[:, :, :128], s0[:, :, :128])


# (global shape, causal_block) over 4 logical ranks on one card: local
# lengths 250 and 1000 fill no 64-row tile; frames of 96 cut by the shard
# edges. Forward to 8e-3 of the output's scale and the LSE to 1e-3, the
# gradients to 1e-2 of their scales, as the flash kernels.
@pytest.mark.cuda
@pytest.mark.parametrize("shape,causal_block", [((2, 3, 1000, 128), None), ((1, 2, 4000, 128), 96)])
def test_ring_kernels_match_plain_ring_on_cuda(shape, causal_block):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from opensora_torch.parallel.comm import gather, shard

    mesh = _ring_mesh("cuda")
    devices = tring.ring_devices(mesh, "sp")
    gen = torch.Generator(device="cuda").manual_seed(4)
    q, k, v, do = (torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16) for _ in range(4))
    qg, kg, vg = (x.clone().requires_grad_() for x in (q, k, v))
    before = dict(_build.LAUNCHES)
    out, lse = tring.ring_flash_attention(qg, kg, vg, mesh, causal_block=causal_block)
    grads = torch.autograd.grad(out, (qg, kg, vg), do)
    torch.cuda.synchronize()
    for name in RING_KERNELS:  # 16 (rank, hop) launches a call
        assert _build.LAUNCHES[name] == before.get(name, 0) + 16, name
    # one dQ epilogue per rank, after the last hop
    assert _build.LAUNCHES[tflash.KERNEL_DQ_CONVERT] == before.get(tflash.KERNEL_DQ_CONVERT, 0) + 4
    sm = shape[-1] ** -0.5
    parts = [shard(x, 2, devices) for x in (q, k, v)]
    outs, lses = tring.ring_forward_shards(*parts, sm_scale=sm, causal_block=causal_block, plain=True)
    ref, ref_lse = gather(outs, 2, q.device).float(), gather(lses, 2, q.device)
    assert (out.float() - ref).abs().max().item() <= 8e-3 * ref.abs().max().item()
    assert (lse - ref_lse).abs().max().item() <= 1e-3
    ref_g = tring.ring_backward_shards(*parts, shard(out.detach(), 2, devices), shard(lse, 2, devices),
                                       shard(do, 2, devices), sm_scale=sm, causal_block=causal_block, plain=True)
    for name, g, w in zip("qkv", grads, ref_g):
        w = gather(w, 2, q.device).float()
        assert (g.float() - w).abs().max().item() <= BWD_RTOL * w.abs().max().item(), name


@pytest.mark.cuda
def test_ring_on_cuda_raises_where_the_kernel_cannot_run():
    """A CUDA call never takes the plain hops: a head dim the kernels were
    not built for raises."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    q = torch.zeros((1, 2, 256, 64), dtype=torch.bfloat16, device="cuda")
    with pytest.raises(ValueError, match="128"):
        tring.ring_flash_attention(q, q, q, _ring_mesh("cuda"))
