"""The port's ring flash attention (opensora_torch/ops/ring_flash.py) against
the JAX package's (opensora_tpu/ops/ring_flash.py) on the CPU: the port's
plain hops over 4 logical CPU ranks against the Pallas ring kernels in
interpret mode on a 4-virtual-device ("sp",) mesh, on the same numpy
inputs, as tests/test_ring_flash.py runs them (L = 512, H = 2, D = 128,
blocks of 128: the JAX kernel needs local lengths that tile evenly). Both
sides compute in fp32; their sums differ in order and in the exp domain
(the port keeps the running max in log2), hence the stated tolerances."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from opensora_tpu.ops.attention import attention as j_attention
from opensora_tpu.ops.ring_flash import ring_flash_attention as j_ring
from opensora_tpu.parallel.context import set_mesh as j_set_mesh

from opensora_torch.ops import _build
from opensora_torch.ops import flash_attention as tflash
from opensora_torch.ops import ring_flash as tring
from opensora_torch.ops.attention import attention as t_attention
from opensora_torch.parallel.context import set_mesh
from opensora_torch.parallel.mesh import MeshConfig, create_mesh

OUT_TOL = 5e-5  # of max(1, max|ref|), as the JAX file holds its ring against dense attention
LSE_TOL = 2e-5
GRAD_TOL = 2e-4  # of max(1, max|ref|), the JAX file's backward limit


@pytest.fixture(scope="module")
def jmesh():
    devs = jax.devices()
    if len(devs) < 4:
        pytest.skip("needs 4 virtual devices")
    return Mesh(np.asarray(devs[:4]), ("sp",))


@pytest.fixture(scope="module")
def tmesh():
    return create_mesh(MeshConfig(dp_size=1, sp_size=4, tp_size=1), [torch.device("cpu")] * 4)


@pytest.fixture(autouse=True)
def _no_torch_mesh():
    yield
    set_mesh(None)


def _qkv(L=512, B=1, H=2, D=128, seed=0, n=3):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((B, H, L, D)).astype(np.float32) for _ in range(n)]


def _close(got, want, tol):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    err = np.abs(got - want).max()
    assert err <= tol * max(1.0, np.abs(want).max()), (err, np.abs(want).max())


@pytest.mark.parametrize("causal_block", [None, 128])
def test_ring_forward_matches_jax(jmesh, tmesh, causal_block):
    """Output and LSE; causal at GLOBAL offsets (each hop's shard comes from
    another rank, so a local mask would differ)."""
    q, k, v = _qkv()
    j_out, j_lse = j_ring(*(jnp.asarray(x) for x in (q, k, v)), jmesh, block_q=128, block_k=128,
                          causal_block=causal_block, interpret=True)
    before = dict(_build.LAUNCHES)
    out, lse = tring.ring_flash_attention(*(torch.from_numpy(x) for x in (q, k, v)), tmesh,
                                          causal_block=causal_block)
    assert _build.LAUNCHES == before  # CPU tensors: the plain hops
    _close(out.numpy(), j_out, OUT_TOL)
    _close(lse.numpy(), np.asarray(j_lse)[..., 0], LSE_TOL)


@pytest.mark.parametrize("causal_block", [None, 128])
def test_ring_backward_matches_jax(jmesh, tmesh, causal_block):
    """dq, dk, dv of sum(out * w): the rotating dK/dV accumulators land
    home, dq comes from the global LSE."""
    q, k, v, w = _qkv(seed=1, n=4)

    def loss(a, b, c):
        out, _ = j_ring(a, b, c, jmesh, block_q=128, block_k=128, causal_block=causal_block, interpret=True)
        return jnp.sum(out * jnp.asarray(w))

    j_grads = jax.grad(loss, argnums=(0, 1, 2))(*(jnp.asarray(x) for x in (q, k, v)))
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    out, _ = tring.ring_flash_attention(tq, tk, tv, tmesh, causal_block=causal_block)
    grads = torch.autograd.grad(out, (tq, tk, tv), torch.from_numpy(w))
    for got, want in zip(grads, j_grads):
        _close(got.numpy(), want, GRAD_TOL)


@pytest.mark.parametrize("causal_block", [None, 128])
def test_fused_hop_plain_version_through_the_dq_accum_layout_matches_jax(jmesh, tmesh, causal_block):
    """The fused hop's plain version, hop by hop as the kernel runs it: each
    (rank, hop) adds into the travelling dK/dV of the shard it holds, and
    its dQ partial goes into the rank's dq_accum in the kernel's fragment
    order (dq_rows_to_accum), finished once by the dQ epilogue's plain
    version (bf16); the layout's round trip is exact. dk and dv to the JAX file's limit; dq to 8e-3 of its
    scale (the epilogue rounds to bf16: 2^-8 relative, twice that)."""
    from opensora_torch.parallel.comm import shard

    q, k, v, w = _qkv(seed=1, n=4)

    def loss(a, b, c):
        out, _ = j_ring(a, b, c, jmesh, block_q=128, block_k=128, causal_block=causal_block, interpret=True)
        return jnp.sum(out * jnp.asarray(w))

    j_grads = jax.grad(loss, argnums=(0, 1, 2))(*(jnp.asarray(x) for x in (q, k, v)))
    devices = tring.ring_devices(tmesh, "sp")
    sp, sm = len(devices), 128 ** -0.5
    qs, ks, vs, dos = (shard(torch.from_numpy(x), 2, devices) for x in (q, k, v, w))
    outs, lses = tring.ring_forward_shards(qs, ks, vs, sm_scale=sm, causal_block=causal_block, plain=True)
    lq = qs[0].shape[2]
    dk = [torch.zeros_like(x) for x in ks]
    dv = [torch.zeros_like(x) for x in vs]
    dq = []
    for r in range(sp):
        delta = (dos[r] * outs[r]).sum(-1)
        accum = tflash.dq_rows_to_accum(torch.zeros_like(qs[r]))
        for hop in range(sp):
            src = (r - hop) % sp
            tring.ring_bwd_hop_ref(qs[r], ks[src], vs[src], dos[r], lses[r], delta, dk[src], dv[src], accum,
                                   sm_scale=sm, causal_block=causal_block, q_off=r * lq, k_off=src * lq)
        assert torch.equal(tflash.dq_rows_to_accum(tflash.dq_accum_to_rows(accum, lq)), accum)  # the round trip
        dq.append(tflash.flash_attention_bwd_dq_convert_ref(accum, lq, sm).float())
    for got, want, tol in ((dq, j_grads[0], 8e-3), (dk, j_grads[1], GRAD_TOL), (dv, j_grads[2], GRAD_TOL)):
        _close(torch.cat(got, 2).numpy(), want, tol)


@pytest.mark.parametrize("L,causal_block", [(4 * 75, None), (4 * 75, 32), (4 * 70, 48)])
def test_ring_at_ragged_lengths_matches_dense(tmesh, L, causal_block):
    """Local lengths that fill no 64-row tile (75, 70; the JAX kernel cannot
    run them) and frames that the shard edges cut: the plain ring equals the
    port's plain dense attention, forward and backward."""
    q, k, v, w = (torch.from_numpy(x) for x in _qkv(L=L, H=3, D=32, seed=2, n=4))
    q, k, v = (x.requires_grad_() for x in (q, k, v))
    out, lse = tring.ring_flash_attention(q, k, v, tmesh, causal_block=causal_block)
    grads = torch.autograd.grad(out, (q, k, v), w)
    ref, ref_lse = tflash.flash_attention_ref(q, k, v, None, causal_block)
    ref_grads = torch.autograd.grad(ref, (q, k, v), w)
    _close(out.detach().numpy(), ref.detach().numpy(), OUT_TOL)
    _close(lse.numpy(), ref_lse.detach().numpy(), LSE_TOL)
    for got, want in zip(grads, ref_grads):
        _close(got.numpy(), want.numpy(), GRAD_TOL)


def test_known_wrong_rings_are_caught(tmesh):
    """The faults chip_smoke.py's limits must reject differ from the sound
    ring by far more than the tolerances here: the last hop skipped, dK/dV
    read home from the other slot."""
    from opensora_torch.parallel.comm import shard

    q, k, v, do = (torch.from_numpy(x) for x in _qkv(L=256, H=2, D=32, seed=3, n=4))
    devices = tring.ring_devices(tmesh, "sp")
    parts = [shard(x, 2, devices) for x in (q, k, v)]
    sm = 32 ** -0.5
    outs, lses = tring.ring_forward_shards(*parts, sm_scale=sm, plain=True)
    orig_hop, orig_home = tring.ring_fwd_hop_ref, tring.home_slot

    def skip_last(q_, k_, v_, *a, **kw):
        if kw["last"]:
            k_, v_ = k_[:, :, :0], v_[:, :, :0]
        return orig_hop(q_, k_, v_, *a, **kw)

    tring.ring_fwd_hop_ref = skip_last
    try:
        wrong, _ = tring.ring_forward_shards(*parts, sm_scale=sm, plain=True)
    finally:
        tring.ring_fwd_hop_ref = orig_hop
    assert max(float((a - b).abs().max()) for a, b in zip(wrong, outs)) > 0.1
    grads = tring.ring_backward_shards(*parts, outs, lses, shard(do, 2, devices), sm_scale=sm, plain=True)
    tring.home_slot = lambda sp: 1 - orig_home(sp)
    try:
        wrong = tring.ring_backward_shards(*parts, outs, lses, shard(do, 2, devices), sm_scale=sm, plain=True)
    finally:
        tring.home_slot = orig_home
    for good, bad in zip(grads[1:], wrong[1:]):
        assert max(float((a - b).abs().max()) for a, b in zip(good, bad)) > 0.1


def test_attention_dispatcher_ring_rdma_matches_jax(jmesh, tmesh):
    """attention(..., backend="ring_rdma") over the mesh of the context, on
    (B, L, H, D) with RoPE off, against the JAX dispatcher's; without a mesh
    it raises, as the JAX package asserts."""
    rng = np.random.default_rng(4)
    q, k, v = (rng.standard_normal((1, 512, 2, 128)).astype(np.float32) for _ in range(3))
    j_set_mesh(jmesh)
    try:
        ref = j_attention(*(jnp.asarray(x) for x in (q, k, v)), backend="ring_rdma")
    finally:
        j_set_mesh(None)
    with pytest.raises(ValueError, match="mesh"):
        t_attention(*(torch.from_numpy(x) for x in (q, k, v)), backend="ring_rdma")
    set_mesh(tmesh)
    out = t_attention(*(torch.from_numpy(x) for x in (q, k, v)), backend="ring_rdma")
    assert out.shape == (1, 512, 256)
    _close(out.numpy(), ref, OUT_TOL)
