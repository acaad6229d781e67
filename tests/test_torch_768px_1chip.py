"""The one-card 768px serving configs, ``configs/diffusion/inference/
768px_1chip.py`` and ``768px_1chip_int8attn.py``, on the CPU against the
JAX package:

- both parse as the JAX package's do: 576 x 1024 at 129 frames,
  ``w8a8_pallas`` products, ``cfg_batched=False``, the int8-qk8 attention
  in the second; ``seq_chunks`` is carried and not used by the port (it
  only chunks the JAX package's tokenwise work to save memory);
- the I2V denoiser with ``cfg_batched=False`` (three B = 1 passes a step)
  over a small MMDiT with the configs' ``w8a8_pallas`` and ``int8_qk8``
  (head dim 128, 144 tokens, so that the int8 attention engages), from a
  ``quantize_params`` tree: the port against the JAX package's denoiser
  (its int8 attention in interpret mode), and the port's three passes
  against its one batched pass.

Tolerances: dynamic activation quantization is discontinuous (an
activation an ulp apart can round to the next int8 step, and the step
cascades: tests/test_torch_quant.py), so the denoised latents are held in
relative L2: ``JAX_TOL`` = 1.5e-2 against the JAX package (the whole-model
W8A8 limit of tests/test_torch_quant.py; measured: 4.0e-3), ``BATCHED_TOL`` = 1e-2 between
the port's sequential and batched CFG. There each token and each (b, h)
quantizes alone, but the fp32 products' sums take another order with the
batch, and an ulp that crosses an int8 rounding step cascades as above
(measured: 2.9e-3).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opensora_tpu.models.mmdit.model import MMDiTConfig as JConfig
from opensora_tpu.models.mmdit.model import MMDiTModel as JModel
from opensora_tpu.ops.quant import quantize_params as j_quantize_params
from opensora_tpu.utils import sampling as JS
from opensora_tpu.utils.config import parse_configs as jparse_configs

from opensora_torch.models.mmdit.model import Flux, MMDiTConfig, MMDiTModel
from opensora_torch.ops.quant import QuantLinear
from opensora_torch.utils import sampling as S
from opensora_torch.utils.config import ae_spatial_compression, parse_configs
from opensora_torch.utils.weights import load_numpy_state_dict, mmdit_state_dict
from torch_parity_utils import one_torch_thread, t, to_numpy

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), os.pardir))
CFGS = {name: os.path.join(REPO, "configs", "diffusion", "inference", f"{name}.py")
        for name in ("768px_1chip", "768px_1chip_int8attn")}
JAX_TOL = 1.5e-2
BATCHED_TOL = 1e-2
# head dim 128 (two heads) and 128 + 16 tokens: the int8 attention engages
GEOM = dict(in_channels=16, vec_in_dim=32, context_in_dim=64, hidden_size=256, mlp_ratio=2.0, num_heads=2,
            depth=1, depth_single_blocks=1, axes_dim=[32, 48, 48], qkv_bias=True, guidance_embed=False,
            cond_embed=True)
LATENT = (1, 4, 2, 16, 16)  # (b, C, T, H, W): 2 x 8 x 8 = 128 image tokens at patch 2
LT = 16
STEPS = 2

_one_thread = pytest.fixture(autouse=True)(one_torch_thread)


@pytest.mark.parametrize("name", sorted(CFGS))
def test_configs_parse_as_jax(monkeypatch, name):
    monkeypatch.delenv("AE_SPATIAL_COMPRESSION", raising=False)
    ours, theirs = parse_configs([CFGS[name]]), jparse_configs([CFGS[name]])
    assert ours.to_dict() == theirs.to_dict()
    assert ours.model["quantized"] == "w8a8_pallas" and ours.model["seq_chunks"] == 16
    assert ours.model.get("attn_backend") == ("int8_qk8" if name.endswith("int8attn") else None)
    assert ours.mesh is None
    opt = S.sanitize_sampling_option(S.SamplingOption(**ours.sampling_option), ae_spatial_compression(ours))
    jopt = JS.sanitize_sampling_option(JS.SamplingOption(**theirs.sampling_option))
    assert (opt.height, opt.width, opt.num_frames) == (jopt.height, jopt.width, jopt.num_frames) == (576, 1024, 129)
    assert opt.cfg_batched is False and jopt.cfg_batched is False
    model = Flux(**{k: v for k, v in ours.model.items() if k != "type"}, device="meta")  # seq_chunks ignored
    quant = [m for m in model.modules() if isinstance(m, QuantLinear)]
    assert quant and all(m.mode == "w8a8_pallas" for m in quant)


@pytest.fixture(scope="module")
def denoise_inputs():
    """A quantize_params tree of the small MMDiT and the denoiser's inputs
    for one prompt (cond, neg, neg), t2v (zero masks and reference)."""
    rng = np.random.default_rng(3)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    b, c, lt, h, w = LATENT
    li = lt * (h // 2) * (w // 2)
    ids = np.stack(np.meshgrid(np.arange(lt), np.arange(h // 2), np.arange(w // 2), indexing="ij"), -1)
    x = dict(img=np.repeat(f(1, li, 4 * c), 3, 0), img_ids=np.broadcast_to(ids.reshape(1, li, 3), (3, li, 3)).copy()
             .astype(np.float32), txt=f(3, LT, GEOM["context_in_dim"]), txt_ids=np.zeros((3, LT, 3), np.float32),
             y_vec=f(3, GEOM["vec_in_dim"]), masks=np.zeros((b, 1, lt, h, w), np.float32),
             masked_ref=np.zeros(LATENT, np.float32))
    jfp = JModel(JConfig(**GEOM, dtype="fp32", attn_backend="xla"))
    init = dict(img=x["img"], img_ids=x["img_ids"], txt=x["txt"], txt_ids=x["txt_ids"],
                timesteps=np.full((3,), 0.5, np.float32), y_vec=x["y_vec"], cond=f(3, li, 4 * (c + 1)))
    params = to_numpy(jfp.init(jax.random.PRNGKey(1), **{k: jnp.asarray(v) for k, v in init.items()})["params"])
    qparams = to_numpy(j_quantize_params(params))
    timesteps = S.get_schedule(STEPS, li, lt, shift=True)
    return x, qparams, np.asarray(timesteps, np.float32)


def _options():
    opt = S.SamplingOption(**dict(parse_configs([CFGS["768px_1chip_int8attn"]]).sampling_option))
    return dict(guidance=opt.guidance, guidance_img=opt.guidance_img, text_osci=opt.text_osci,
                image_osci=opt.image_osci, scale_temporal_osci=False, patch_size=2)


def test_sequential_cfg_int8_denoise_matches_jax_and_the_batched_pass(denoise_inputs):
    x, qparams, timesteps = denoise_inputs
    kw = _options()
    jm = JModel(JConfig(**GEOM, dtype="fp32", quantized="w8a8_pallas", attn_backend="int8_qk8"))
    ref = np.asarray(JS.I2VDenoiser().denoise(
        lambda **a: jm.apply({"params": qparams}, **a), timesteps=jnp.asarray(timesteps), cfg_batched=False,
        **kw, **{k: jnp.asarray(v) for k, v in x.items()}))

    tm = MMDiTModel(MMDiTConfig(**GEOM, dtype="fp32", quantized="w8a8_pallas", attn_backend="int8_qk8"),
                    device="meta", dtype=torch.float32).eval()
    load_numpy_state_dict(tm, mmdit_state_dict(qparams))
    calls = []
    tm.register_forward_hook(lambda m, i, o: calls.append(o.shape[0]))
    outs = {}
    with torch.no_grad():
        for batched in (False, True):
            outs[batched] = S.I2VDenoiser().denoise(tm, timesteps=t(timesteps), cfg_batched=batched, **kw,
                                                    **{k: t(v) for k, v in x.items()}).numpy()
    # three B = 1 passes a step, then one B = 3 pass a step
    assert calls == [1] * (3 * STEPS) + [3] * STEPS
    rel = lambda a, b: float(np.linalg.norm(a - b) / np.linalg.norm(b))  # noqa: E731
    assert outs[False].shape == ref.shape == (1, 128, 16) and np.isfinite(outs[False]).all()
    assert rel(outs[False], ref) <= JAX_TOL, rel(outs[False], ref)
    assert rel(outs[False], outs[True]) <= BATCHED_TOL, rel(outs[False], outs[True])
