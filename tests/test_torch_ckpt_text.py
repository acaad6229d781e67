"""The port's text-encoder loading (``HFEmbedder`` with a local
``from_pretrained``, through ``opensora_torch.utils.ckpt``, without
``transformers``) against the JAX package on the CPU, fp32: T5 and CLIP from
tiny directories that ``transformers`` writes (sharded safetensors with
their index, ``pytorch_model.bin`` of a ``T5ForConditionalGeneration``, a
``CLIPModel`` with its vision tower), against the JAX ``HFEmbedder``
loading the same directory through ``transformers``: 1e-4 of the output's
scale (fp32, sums in another order). Failures: a local directory that
fails to load raises and names the key (the JAX embedder falls back to
random weights there); a name that is no local path keeps the seeded
random weights and logs so.
"""

import logging
import os

import numpy as np
import pytest
import torch

from opensora_torch.utils.safetensors_io import save_file
from torch_parity_utils import max_rel_err

TEXTS = ["a red panda eating bamboo", "", "x" * 40]


def _t5_configs():
    from opensora_tpu.models.text.t5 import T5Config as JT5Config

    from opensora_torch.models.text.t5 import t5_small_test_config

    port = t5_small_test_config()
    jax_cfg = JT5Config(**{k: getattr(port, k) for k in port.__dataclass_fields__}, dtype="fp32")
    return port, jax_cfg


def _hf_t5(encoder_only: bool):
    transformers = pytest.importorskip("transformers")
    port, _ = _t5_configs()
    cfg = transformers.T5Config(vocab_size=port.vocab_size, d_model=port.d_model, d_kv=port.d_kv, d_ff=port.d_ff,
                                num_layers=port.num_layers, num_heads=port.num_heads,
                                relative_attention_num_buckets=port.relative_attention_num_buckets,
                                relative_attention_max_distance=port.relative_attention_max_distance,
                                dropout_rate=0.0, feed_forward_proj="gated-gelu")
    torch.manual_seed(0)
    cls = transformers.T5EncoderModel if encoder_only else transformers.T5ForConditionalGeneration
    return cls(cfg).eval()


def _port_embedder(path, **kw):
    from opensora_torch.models.text.conditioner import HFEmbedder

    return HFEmbedder(from_pretrained=path, max_length=16, _tiny=True, device="cpu", dtype=torch.float32, **kw)


def _embed(embedder, texts=TEXTS):
    with torch.no_grad():
        return embedder(texts).numpy()


@pytest.mark.parametrize("layout", ["sharded_safetensors", "pytorch_model_bin_with_decoder"])
def test_t5_from_an_hf_directory_matches_the_jax_embedder(tmp_path, layout):
    from opensora_tpu.models.text.conditioner import HFEmbedder as JEmbedder

    hf = _hf_t5(encoder_only=layout == "sharded_safetensors")
    d = str(tmp_path / "t5_dir")
    if layout == "sharded_safetensors":
        hf.save_pretrained(d, max_shard_size="40KB")
        assert "model.safetensors.index.json" in os.listdir(d)
    else:
        hf.save_pretrained(d, safe_serialization=False)
    port_cfg, jax_cfg = _t5_configs()
    ref = np.asarray(JEmbedder(from_pretrained=d, max_length=16, t5_config=jax_cfg)(TEXTS))
    ours = _port_embedder(d, t5_config=port_cfg)
    np.testing.assert_array_equal(ours.module.shared.weight.detach().numpy(), hf.shared.weight.detach().numpy())
    assert max_rel_err(_embed(ours), ref) <= 1e-4


def test_clip_from_a_clipmodel_directory_matches_the_jax_embedder(tmp_path):
    """A CLIPModel's file carries ``vision_model.*``, ``visual_projection``,
    ``text_projection`` and ``logit_scale``: the text tower loads, the rest
    is skipped."""
    transformers = pytest.importorskip("transformers")
    from opensora_tpu.models.text.clip import CLIPTextConfig as JCLIPConfig
    from opensora_tpu.models.text.conditioner import HFEmbedder as JEmbedder

    from opensora_torch.models.text.clip import clip_small_test_config
    from opensora_torch.utils.ckpt import load_torch_state_dict

    port_cfg = clip_small_test_config()
    text = dict(vocab_size=port_cfg.vocab_size, hidden_size=port_cfg.hidden_size,
                intermediate_size=port_cfg.intermediate_size, num_hidden_layers=port_cfg.num_layers,
                num_attention_heads=port_cfg.num_heads, max_position_embeddings=port_cfg.max_position_embeddings,
                eos_token_id=port_cfg.eos_token_id, hidden_act="quick_gelu")
    vision = dict(hidden_size=32, intermediate_size=64, num_hidden_layers=1, num_attention_heads=2, image_size=32,
                  patch_size=16)
    torch.manual_seed(0)
    hf = transformers.CLIPModel(transformers.CLIPConfig(text_config=text, vision_config=vision)).eval()
    d = str(tmp_path / "clip_dir")
    hf.save_pretrained(d)
    keys = load_torch_state_dict(d)
    assert any(k.startswith("vision_model.") for k in keys) and "logit_scale" in keys
    jax_cfg = JCLIPConfig(**{k: getattr(port_cfg, k) for k in port_cfg.__dataclass_fields__}, dtype="fp32")
    ref = np.asarray(JEmbedder(from_pretrained=d, max_length=16, clip_config=jax_cfg)(TEXTS))
    ours = _port_embedder(d, clip_config=port_cfg)
    assert ours.is_clip
    assert max_rel_err(_embed(ours), ref) <= 1e-4


def test_broken_local_directory_raises_where_the_jax_embedder_falls_back(tmp_path):
    """A directory that exists but does not load: the JAX ``HFEmbedder``
    swallows the error and keeps random weights
    (opensora_tpu/models/text/conditioner.py:136); the port raises and
    names the key."""
    from opensora_tpu.models.text.conditioner import HFEmbedder as JEmbedder

    hf = _hf_t5(encoder_only=True)
    sd = {k: v for k, v in hf.state_dict().items() if k != "encoder.final_layer_norm.weight"}
    d = tmp_path / "t5_broken"
    d.mkdir()
    save_file(sd, str(d / "model.safetensors"))
    port_cfg, jax_cfg = _t5_configs()
    JEmbedder(from_pretrained=str(d), max_length=16, t5_config=jax_cfg)  # no error: random weights
    with pytest.raises(ValueError, match=r"encoder\.final_layer_norm\.weight is missing"):
        _port_embedder(str(d), t5_config=port_cfg)
    sd = dict(hf.state_dict(), **{"shared.weight": hf.shared.weight[:, :8]})
    save_file(sd, str(d / "model.safetensors"))
    with pytest.raises(ValueError, match=r"shared\.weight is \(128, 8\) in the checkpoint, \(128, 64\) in the model"):
        _port_embedder(str(d), t5_config=port_cfg)


def test_a_name_that_is_no_local_path_keeps_seeded_random_weights():
    records = []
    handler = logging.Handler()
    handler.emit = records.append
    log = logging.getLogger("opensora_torch.models.text.conditioner")
    log.addHandler(handler)
    log.setLevel(logging.INFO)
    try:
        torch.manual_seed(5)
        named = _port_embedder("google/t5-v1_1-xxl-not-on-this-machine")
    finally:
        log.removeHandler(handler)
    torch.manual_seed(5)
    unnamed = _port_embedder("")
    assert all(torch.equal(a, b) for a, b in zip(named.state_dict().values(), unnamed.state_dict().values()))
    assert any("no local path" in r.getMessage() for r in records)
