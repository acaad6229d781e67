"""Int8 serving of the PyTorch port against the JAX package on the CPU:
weight quantization, ``QuantLinear`` in every mode against ``QuantDense``,
the plain versions of the two W8A8 kernels against the interpret-mode
Pallas kernels, the quantized MMDiT (W8A8 + int8 attention) with weights
carried from a ``quantize_params`` tree, and the quantize-at-build of
``prepare_models``.

Tolerances, fp32: the W8A8 plain versions equal the Pallas kernels in every
element (exact integer sums, the same fp32 epilogue order). ``QuantLinear``
in the W8A8 modes agrees with ``QuantDense`` to 1e-5 of the output's scale:
both quantize the same fp32 activations the same way; "w8" is a float
product summed in another order (1e-5 too).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from opensora_tpu.models.mmdit.model import MMDiTConfig as JConfig
from opensora_tpu.models.mmdit.model import MMDiTModel as JModel
from opensora_tpu.ops.flash_attention import pick_blocks
from opensora_tpu.ops.int8_matmul import w8a8_fusedquant_matmul as j_fq_matmul
from opensora_tpu.ops.int8_matmul import w8a8_matmul as j_matmul
from opensora_tpu.ops.quant import QuantDense
from opensora_tpu.ops.quant import quantize_kernel as j_quantize_kernel
from opensora_tpu.ops.quant import quantize_params as j_quantize_params

from opensora_torch.models.mmdit.model import Flux, MMDiTConfig, MMDiTModel
from opensora_torch.ops.int8_flash import default_block_k
from opensora_torch.ops.int8_matmul import w8a8_fusedquant_matmul_ref, w8a8_matmul_ref
from opensora_torch.ops.quant import QuantLinear, quantize_kernel, quantize_model_, quantize_params
from opensora_torch.utils.weights import load_numpy_state_dict, mmdit_state_dict
from torch_parity_utils import max_rel_err, randomize, t, to_numpy

TINY = dict(in_channels=16, vec_in_dim=32, context_in_dim=64, hidden_size=64, mlp_ratio=2.0, num_heads=2,
            depth=1, depth_single_blocks=1, axes_dim=[8, 12, 12], qkv_bias=True, guidance_embed=True,
            cond_embed=True)
# head dim 128 and L >= 128, so that the int8 attention kernel engages
# (opensora_tpu tests/test_quant.py:245-264)
WIDE = dict(in_channels=16, vec_in_dim=32, context_in_dim=64, hidden_size=512, mlp_ratio=4.0, num_heads=4,
            depth=2, depth_single_blocks=2, axes_dim=[32, 48, 48], qkv_bias=True, guidance_embed=False,
            cond_embed=False)


def test_flux_builds_quantized_layers_and_rejects_bad_modes():
    """A quantized config builds int8 layers in every block linear, the
    modulation's included, and nowhere else; an unknown mode raises."""
    for mode, want in ((True, "w8"), ("w8", "w8"), ("w8a8", "w8a8"), ("w8a8_pallas", "w8a8_pallas"),
                       ("w8a8_fq", "w8a8_fq")):
        m = Flux(**TINY, quantized=mode, dtype="fp32", device="meta")
        quant = {n: mod for n, mod in m.named_modules() if isinstance(mod, QuantLinear)}
        assert len(quant) == 10 + 3, sorted(quant)  # per double and per single block
        assert {mod.mode for mod in quant.values()} == {want}
        assert "double_blocks.0.img_mod.lin" in quant and "single_blocks.0.modulation.lin" in quant
        assert all(n.startswith(("double_blocks", "single_blocks")) for n in quant)
        assert isinstance(m.final_layer.linear, torch.nn.Linear) and isinstance(m.img_in, torch.nn.Linear)
    plain = Flux(**TINY, dtype="fp32", device="meta")
    assert not any(isinstance(mod, QuantLinear) for mod in plain.modules())
    with pytest.raises(ValueError, match="quantized mode"):
        Flux(**TINY, quantized="w4a8", dtype="fp32", device="meta")


def test_quantize_kernel_and_params_equal_jax():
    rng = np.random.default_rng(0)
    for shape in ((64, 48), (3, 32, 16)):
        k = rng.standard_normal(shape).astype(np.float32) * 0.3
        k[..., 5] = 0.0  # an all-zero output channel takes scale 1
        q, s = quantize_kernel(k)
        jq, js = j_quantize_kernel(k)
        np.testing.assert_array_equal(q, jq)
        np.testing.assert_array_equal(s, js)
    tree = {"img_in": {"kernel": rng.standard_normal((8, 4)).astype(np.float32)},
            "double_blocks": {"lin": {"kernel": rng.standard_normal((2, 8, 6)).astype(np.float32),
                                      "bias": np.zeros((2, 6), np.float32)}}}
    ours, theirs = quantize_params(tree), to_numpy(j_quantize_params(tree))
    assert "kernel" in ours["img_in"] and "kernel_q" in ours["double_blocks"]["lin"]
    for a, b in ((ours["double_blocks"]["lin"], theirs["double_blocks"]["lin"]),):
        for key in ("kernel_q", "kernel_scale", "bias"):
            np.testing.assert_array_equal(a[key], b[key])


def _jax_model(geom, seed, **kw):
    x = _inputs(geom, B=1, Li=8, Lt=4)
    jm = JModel(JConfig(**geom, dtype="fp32", **kw))
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0),
                            **{k: (None if v is None else jnp.asarray(v)) for k, v in x.items()})
    return jm, randomize(to_numpy(shapes["params"]), seed, scale=0.05)


def _inputs(geom, B, Li, Lt, seed=0):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    w = 8 if Li % 8 == 0 else Li
    ids = np.stack(np.meshgrid(np.arange(1), np.arange(Li // w), np.arange(w), indexing="ij"), -1)
    img_ids = np.broadcast_to(ids.reshape(1, Li, 3), (B, Li, 3)).astype(np.float32)
    return dict(img=f(B, Li, geom["in_channels"]), img_ids=img_ids, txt=f(B, Lt, geom["context_in_dim"]),
                txt_ids=np.zeros((B, Lt, 3), np.float32), timesteps=np.full((B,), 0.5, np.float32),
                y_vec=f(B, geom["vec_in_dim"]),
                cond=f(B, Li, geom["in_channels"] + 4) if geom["cond_embed"] else None,
                guidance=np.full((B,), 4.0, np.float32) if geom["guidance_embed"] else None)


def test_quantize_model_equals_jax_quantize_params():
    """quantize_model_ on the port's float model holds, tensor for tensor,
    what the JAX package's quantize_params tree carries to the port."""
    _, params = _jax_model(TINY, seed=1)
    tm = MMDiTModel(MMDiTConfig(**TINY, dtype="fp32"), device="meta", dtype=torch.float32)
    load_numpy_state_dict(tm, mmdit_state_dict(params))
    quantize_model_(tm, "w8a8")
    assert tm.config.quantized == "w8a8"
    want = mmdit_state_dict(to_numpy(j_quantize_params(params)))
    got = tm.state_dict()
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        assert got[k].dtype == (torch.int8 if k.endswith("weight_q") else torch.float32), k
        np.testing.assert_array_equal(got[k].numpy(), v, err_msg=k)
    # and the quantized tree loads strictly into a model built quantized
    qm = MMDiTModel(MMDiTConfig(**TINY, dtype="fp32", quantized="w8a8"), device="meta", dtype=torch.float32)
    load_numpy_state_dict(qm, want)
    assert qm.double_blocks[0].img_attn.qkv.weight_q.dtype == torch.int8


@pytest.mark.parametrize("mode", ["w8", "w8a8", "w8a8_pallas", "w8a8_fq"])
@pytest.mark.parametrize("rows", [7, 1024])
def test_quant_linear_matches_quant_dense(mode, rows):
    """Every mode, below and above the fused kernels' 1024-row threshold,
    with and without col_slice, on the same int8 params."""
    rng = np.random.default_rng(3)
    w = rng.standard_normal((512, 256)).astype(np.float32) * 0.2
    bias = rng.standard_normal(256).astype(np.float32) * 0.1
    x = rng.standard_normal((1, rows, 512)).astype(np.float32)
    q, s = quantize_kernel(w)
    params = {"params": {"kernel_q": jnp.asarray(q), "kernel_scale": jnp.asarray(s), "bias": jnp.asarray(bias)}}
    jd = QuantDense(256, dtype=jnp.float32, mode=mode)
    ql = QuantLinear(512, 256, mode=mode, dtype=torch.float32)
    load_numpy_state_dict(ql, {"weight_q": q.T.copy(), "weight_scale": s, "bias": bias})
    with torch.no_grad():
        for cs in (None, (128, 256)):
            ref = np.asarray(jd.apply(params, jnp.asarray(x), col_slice=cs))
            out = ql(t(x), col_slice=cs).numpy()
            assert out.shape == ref.shape == (1, rows, 128 if cs else 256)
            assert max_rel_err(out, ref) <= 1e-5, (cs, max_rel_err(out, ref))
    # the quantized product stays close to the float one
    assert max_rel_err(ql(t(x)).detach().numpy(), x @ w + bias) < 0.03


def test_w8a8_plain_versions_equal_interpret_pallas_kernels():
    """opensora_tpu tests/test_quant.py:89-105 and 274-296 shapes, M tail
    included: every element equal at fp32 output."""
    rng = np.random.default_rng(2)
    M, K, N = 300, 1024, 512
    x8 = rng.integers(-127, 128, (M, K)).astype(np.int8)
    w8 = rng.integers(-127, 128, (K, N)).astype(np.int8)
    sa = (rng.random((M, 1)) * 0.01 + 0.001).astype(np.float32)
    sw = (rng.random((N,)) * 0.01 + 0.001).astype(np.float32)
    ref = np.asarray(j_matmul(jnp.asarray(x8), jnp.asarray(w8), jnp.asarray(sa), jnp.asarray(sw), block_m=256,
                              block_n=256, block_k=512, out_dtype=jnp.float32, interpret=True))
    out = w8a8_matmul_ref(t(x8), t(w8.T.copy()), t(sa), t(sw), out_dtype=torch.float32).numpy()
    np.testing.assert_array_equal(out, ref)
    out_bf16 = w8a8_matmul_ref(t(x8), t(w8.T.copy()), t(sa), t(sw))
    assert out_bf16.dtype == torch.bfloat16
    np.testing.assert_array_equal(out_bf16.float().numpy(), t(ref).to(torch.bfloat16).float().numpy())

    # The fused-quant function: XLA compiles the jitted ``xf_max / 127.0``
    # of w8a8_fusedquant_matmul as a product with the reciprocal of 127, so
    # its s_a is one ulp off the true quotient (the port's) in a few rows;
    # there, and only there, the output differs, by at most a few ulp.
    x = (rng.standard_normal((M, K)) * 0.3).astype(np.float32)
    ref = np.asarray(j_fq_matmul(jnp.asarray(x), jnp.asarray(w8), jnp.asarray(sw), block_m=256, block_n=256,
                                 block_k=512, out_dtype=jnp.float32, interpret=True))
    out = w8a8_fusedquant_matmul_ref(t(x), t(w8.T.copy()), t(sw), out_dtype=torch.float32).numpy()
    xmax = np.abs(x).max(axis=-1)
    one_ulp_off = xmax / np.float32(127.0) != xmax * np.float32(1.0 / 127.0)
    np.testing.assert_array_equal(out[~one_ulp_off], ref[~one_ulp_off])
    assert one_ulp_off.mean() < 0.1
    assert (np.abs(out - ref) <= 2.0 ** -21 * np.abs(ref)).all()


@pytest.mark.parametrize("length", [300, 2100, 8828, 76544])
def test_default_block_k_is_the_jax_rule(length):
    assert default_block_k(length) == pick_blocks(length, length, 128)[1]


@pytest.fixture(scope="module")
def wide_w8a8_pair():
    """The WIDE geometry, fp32 params from a seed: the JAX model at fp32 and
    with W8A8 + int8_qk8 attention on its quantize_params tree, and the
    port's twins."""
    x = _inputs(WIDE, B=2, Li=128, Lt=16, seed=4)
    jfp = JModel(JConfig(**WIDE, dtype="fp32", attn_backend="xla"))
    jq = JModel(JConfig(**WIDE, dtype="fp32", quantized="w8a8", attn_backend="int8_qk8"))
    jx = {k: (None if v is None else jnp.asarray(v)) for k, v in x.items()}
    params = to_numpy(jfp.init(jax.random.PRNGKey(1), **jx)["params"])  # flax-init statistics
    qparams = to_numpy(j_quantize_params(params))
    ref_fp = np.asarray(jax.jit(jfp.apply)({"params": params}, **jx))
    ref_q = np.asarray(jax.jit(jq.apply)({"params": qparams}, **jx))
    return x, params, qparams, ref_fp, ref_q


def _port_model(state, **kw):
    tm = MMDiTModel(MMDiTConfig(**WIDE, dtype="fp32", **kw), device="meta", dtype=torch.float32).eval()
    load_numpy_state_dict(tm, state)
    return tm


def test_w8a8_int8_attention_mmdit_matches_jax(wide_w8a8_pair):
    """Depth 2+2, head dim 128, 144 tokens: the port's W8A8 + int8_qk8 MMDiT
    with the JAX quantize_params tree carried by mmdit_state_dict (strict).

    Every quantized layer, fed the input it got in the port's run, equals
    ``QuantDense`` on the same params in every element. The whole model is
    held looser: dynamic activation quantization is discontinuous, so an
    activation one ulp apart (a layer norm or softmax summed in another
    order) can round to the next int8 step, and that step cascades through
    the later quantizations; a 1e-7 relative change of the input moves the
    port's own output by ~2e-3 of its scale. Measured against the JAX model:
    7.2e-3 relative L2, below the 1.3e-2 that the quantization itself costs
    against fp32; the limit is 1.5e-2. The same model in "w8" (no activation
    quantization, so continuous) matches to 1e-5."""
    x, _, qparams, ref_fp, ref_q = wide_w8a8_pair
    tm = _port_model(mmdit_state_dict(qparams), quantized="w8a8", attn_backend="int8_qk8")
    seen = []
    for name, mod in tm.named_modules():
        if isinstance(mod, QuantLinear):
            mod.register_forward_hook(lambda m, i, o, n=name: seen.append((n, m, i[0].numpy(), o.numpy())))
    with torch.no_grad():
        out = tm(**{k: (None if v is None else t(v)) for k, v in x.items()}).numpy()
    assert len(seen) == 2 * 10 + 2 * 3
    for name, mod, xin, got in seen:
        stack, i, *path = name.split(".")
        node = jax.tree_util.tree_map(lambda a: a[int(i)], qparams[stack])
        for part in path:
            node = node[part]
        dense = QuantDense(mod.out_features, use_bias=mod.bias is not None, dtype=jnp.float32, mode="w8a8")
        np.testing.assert_array_equal(got, np.asarray(dense.apply({"params": node}, jnp.asarray(xin))), err_msg=name)
    assert out.shape == ref_q.shape == (2, 128, 16)
    rel = float(np.linalg.norm(out - ref_q) / np.linalg.norm(ref_q))
    assert rel < 1.5e-2, rel

    jw8 = JModel(JConfig(**WIDE, dtype="fp32", quantized="w8", attn_backend="xla"))
    ref_w8 = np.asarray(jax.jit(jw8.apply)({"params": qparams},
                                           **{k: (None if v is None else jnp.asarray(v)) for k, v in x.items()}))
    with torch.no_grad():
        out_w8 = _port_model(mmdit_state_dict(qparams), quantized="w8", attn_backend="xla")(
            **{k: (None if v is None else t(v)) for k, v in x.items()}).numpy()
    assert max_rel_err(out_w8, ref_w8) <= 1e-5, max_rel_err(out_w8, ref_w8)


def test_w8a8_int8_attention_quality_bound(wide_w8a8_pair):
    """The port's version of opensora_tpu tests/test_quant.py:239-271: the
    W8A8 + int8_qk8 model, quantized from the float model by
    quantize_model_, within 2.5 % relative L2 of the fp32 model."""
    x, params, _, ref_fp, _ = wide_w8a8_pair
    tm = _port_model(mmdit_state_dict(params), attn_backend="int8_qk8")
    quantize_model_(tm, "w8a8")
    fp = _port_model(mmdit_state_dict(params), attn_backend="xla")
    with torch.no_grad():
        args = {k: (None if v is None else t(v)) for k, v in x.items()}
        out, out_fp = tm(**args).numpy(), fp(**args).numpy()
    assert max_rel_err(out_fp, ref_fp) <= 1e-4
    rel = float(np.linalg.norm(out - out_fp) / np.linalg.norm(out_fp))
    assert rel < 0.025, rel
