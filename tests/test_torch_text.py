"""The port's text encoders against the JAX package's on the CPU, fp32,
with the same carried weights: T5 and CLIP at t5_small_test_config /
clip_small_test_config, the HFEmbedder wrappers (byte-fallback tokenizer,
seq_align padding, pooled CLIP output), and the weight carry. The port's
HF-style parameter names are also checked against HuggingFace's own torch
models, whose state dicts load into the port as they are.

Tolerance: 1e-4 of the output's scale (fp32, sums in another order).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from opensora_tpu.models.text import clip as jclip
from opensora_tpu.models.text import t5 as jt5
from opensora_tpu.models.text.conditioner import HFEmbedder as JEmbedder

from opensora_torch.models.text import clip as tclip
from opensora_torch.models.text import t5 as tt5
from opensora_torch.models.text.conditioner import HFEmbedder
from opensora_torch.utils.weights import clip_text_state_dict, load_numpy_state_dict, t5_state_dict
from torch_parity_utils import max_rel_err, randomize, to_numpy

TOL = 1e-4
IDS = np.array([[3, 7, 1, 0, 0, 0], [5, 2, 9, 4, 11, 1]], np.int32)


def _param_shapes(module):
    """The module's params tree from eval_shape (no init pass to compile)."""
    return to_numpy(jax.eval_shape(module.init, jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))["params"])


def _jax_t5():
    cfg = jt5.t5_small_test_config()
    cfg.dtype = "fp32"
    module = jt5.T5Encoder(cfg)
    params = randomize(_param_shapes(module), 0, 0.2)
    return cfg, module, params


def _jax_clip():
    cfg = jclip.clip_small_test_config()
    cfg.dtype = "fp32"
    module = jclip.CLIPTextModel(cfg)
    params = randomize(_param_shapes(module), 1, 0.2)
    return cfg, module, params


def _port(module_cls, config, sd):
    m = module_cls(config, device="meta", dtype=torch.float32).eval()
    load_numpy_state_dict(m, sd)  # strict
    return m


def test_t5_matches_jax():
    _, module, params = _jax_t5()
    ref = np.asarray(module.apply({"params": params}, jnp.asarray(IDS)))
    port = _port(tt5.T5Encoder, tt5.t5_small_test_config(), t5_state_dict(params))
    with torch.no_grad():
        out = port(torch.from_numpy(IDS).long()).numpy()
    assert max_rel_err(out, ref) <= TOL, max_rel_err(out, ref)


def test_clip_matches_jax():
    _, module, params = _jax_clip()
    ids = IDS.copy()
    ids[:, -1] = 127  # eos of clip_small_test_config
    ref_h, ref_p = module.apply({"params": params}, jnp.asarray(ids))
    port = _port(tclip.CLIPTextModel, tclip.clip_small_test_config(), clip_text_state_dict(params))
    with torch.no_grad():
        h, p = port(torch.from_numpy(ids).long())
    assert max_rel_err(h.numpy(), ref_h) <= TOL
    assert max_rel_err(p.numpy(), ref_p) <= TOL


def test_relative_position_bucket_matches_jax():
    rel = np.arange(-300, 300).reshape(20, 30)
    ref = np.asarray(jt5.relative_position_bucket(jnp.asarray(rel), 32, 128))
    out = tt5.relative_position_bucket(torch.from_numpy(rel), 32, 128).numpy()
    np.testing.assert_array_equal(out, ref)


@pytest.mark.parametrize("kind", ["t5", "clip"])
def test_embedder_matches_jax(kind):
    """Tokenize -> pad to seq_align -> encode, the path prepare() drives."""
    prompts = ["a cat playing piano", "raining, sea", ""]
    if kind == "t5":
        jcfg, _, params = _jax_t5()
        jemb = JEmbedder("", max_length=16, t5_config=jcfg, params={"params": params})
        emb = HFEmbedder("", max_length=16, t5_config=tt5.t5_small_test_config(), device="meta",
                         dtype=torch.float32)
        load_numpy_state_dict(emb.module, t5_state_dict(params))
        kw = dict(added_tokens=5, seq_align=7)  # 5 + 16 -> pad to 21
    else:
        jcfg, _, params = _jax_clip()
        jemb = JEmbedder("clip-fallback", max_length=16, clip_config=jcfg, params={"params": params})
        emb = HFEmbedder("clip-fallback", max_length=16, clip_config=tclip.clip_small_test_config(),
                         device="meta", dtype=torch.float32)
        load_numpy_state_dict(emb.module, clip_text_state_dict(params))
        kw = {}
    ref = np.asarray(jemb(prompts, **kw))
    with torch.no_grad():
        out = emb.eval()(prompts, **kw).numpy()
    assert out.shape == ref.shape
    assert max_rel_err(out, ref) <= TOL


def test_t5_loads_hf_state_dict_and_matches_hf():
    transformers = pytest.importorskip("transformers")
    hf_cfg = transformers.T5Config(
        vocab_size=128, d_model=32, d_kv=8, d_ff=64, num_layers=2, num_heads=4,
        relative_attention_num_buckets=8, relative_attention_max_distance=16, dropout_rate=0.0,
        feed_forward_proj="gated-gelu", is_encoder_decoder=False,
    )
    torch.manual_seed(0)
    hf = transformers.T5EncoderModel(hf_cfg).eval()
    port = tt5.T5Encoder(tt5.T5Config(vocab_size=128, d_model=32, d_kv=8, d_ff=64, num_layers=2, num_heads=4,
                                      relative_attention_num_buckets=8, relative_attention_max_distance=16))
    sd = {k: v for k, v in hf.state_dict().items() if k != "encoder.embed_tokens.weight"}
    port.load_state_dict(sd, strict=True)
    ids = torch.from_numpy(IDS).long()
    with torch.no_grad():
        ref = hf(input_ids=ids).last_hidden_state
        out = port.eval()(ids)
    assert max_rel_err(out, ref) <= TOL


def test_clip_loads_hf_state_dict_and_matches_hf():
    transformers = pytest.importorskip("transformers")
    hf_cfg = transformers.CLIPTextConfig(
        vocab_size=99, hidden_size=32, intermediate_size=64, num_hidden_layers=2,
        num_attention_heads=2, max_position_embeddings=16, eos_token_id=98,
    )
    torch.manual_seed(0)
    hf = transformers.CLIPTextModel(hf_cfg).eval()
    port = tclip.CLIPTextModel(tclip.CLIPTextConfig(vocab_size=99, hidden_size=32, intermediate_size=64,
                                                    num_layers=2, num_heads=2, max_position_embeddings=16,
                                                    eos_token_id=98))
    own = port.state_dict()
    port.load_state_dict({k: v for k, v in hf.state_dict().items() if k in own}, strict=True)
    ids = torch.tensor([[5, 7, 9, 98, 0, 0], [4, 3, 2, 11, 13, 98]])
    with torch.no_grad():
        ref = hf(input_ids=ids)
        h, p = port.eval()(ids)
    assert max_rel_err(h, ref.last_hidden_state) <= TOL
    assert max_rel_err(p, ref.pooler_output) <= TOL
