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


# ----------------------------------------------------------------------
# backward
# ----------------------------------------------------------------------

# The bf16 backward kernels vs the fp32 plain backward on the same q, k, v,
# dO, LSE and delta: P (for dV) and dS (for dK, dQ) are rounded to bf16
# (2^-9 relative) before their products and the outputs once more; over
# many keys the rounding errors of random sign stay well under 1e-2 of each
# gradient's scale, the limit chip_smoke.py also holds them to.
BWD_RTOL = 1e-2


def _bwd_inputs(shape, causal_block, device, seed=0):
    gen = torch.Generator(device=device).manual_seed(seed)
    q, k, v, do = (torch.randn(shape, generator=gen, device=device).to(torch.bfloat16) for _ in range(4))
    out, lse = tflash.flash_attention_ref(q, k, v, None, causal_block)
    delta = (do.float() * out).sum(-1)
    return q, k, v, do, lse, delta


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
    for name in (tflash.KERNEL_DKV, tflash.KERNEL_DQ):
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
    assert _build.LAUNCHES[tflash.KERNEL_DKV] == before.get(tflash.KERNEL_DKV, 0) + 1
    assert _build.LAUNCHES[tflash.KERNEL_DQ] == before.get(tflash.KERNEL_DQ, 0) + 1
    q2, k2, v2 = (x.float().requires_grad_() for x in base)
    ref = tflash.flash_attention_ref(q2, k2, v2, None, causal_block)[0]
    ref_grads = torch.autograd.grad(ref, (q2, k2, v2), do.float())
    for g, w in zip(grads, ref_grads):
        # the bf16 forward output feeds delta here, adding its rounding
        assert (g.float() - w).abs().max().item() <= 2 * BWD_RTOL * w.abs().max().item()


# ----------------------------------------------------------------------
# W8A8 GEMM (csrc/int8_matmul.cu)
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
GEMM_CASES = [(300, 512, 1024), (3, 384, 3072), (1000, 200, 640)]


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
])
def test_int8_attention_kernel_matches_plain_on_cuda(pv_int8, shape, scale, block_k):
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

RING_KERNELS = (tring.KERNEL_FWD, tring.KERNEL_DKV, tring.KERNEL_DQ)


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
