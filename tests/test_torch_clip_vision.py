"""The port's CLIP vision tower, its whole-CLIPModel reader and the
evaluation's ``CLIPScorer`` against the JAX package on the CPU, fp32:

- ``CLIPVisionModel`` against JAX's with the same random weights, carried by
  ``utils.weights.clip_vision_state_dict``: last hidden state and pooled
  output within 1e-5 of their scale (fp32, sums in another order);
- ``CLIPScorer.from_pretrained`` against JAX's over one HF-layout
  ``CLIPModel`` directory (``torch_parity_utils.write_tiny_clip_model``),
  with and without the CLIP tokenizer's files beside the weights: frame and
  text embeddings within
  1e-5, the score within 1e-5; and the same weights carried from the JAX
  scorer's parameters by ``clip_model_state_dict``;
- ``preprocess_frames`` at a growing (192 -> 224) and a shrinking
  (336 -> 224) crop: within 2e-6 of JAX's after CLIP's normalization (3e-7
  on [0, 1] frames, divided by std ~0.27);
- ``clip_model_configs``: head counts and eos id from ``config.json``, the
  defaults without it, and HF's legacy eos id 2 read as vocab - 1.
"""

import json
import os

import numpy as np
import pytest
import torch

from opensora_torch.eval.clip_scorer import CLIPScorer, preprocess_frames
from opensora_torch.models.text.clip import CLIPModel, CLIPVisionModel, clip_vision_small_test_config
from opensora_torch.utils.ckpt import clip_model_configs
from opensora_torch.utils.weights import clip_model_state_dict, clip_vision_state_dict, load_numpy_state_dict
from torch_parity_utils import max_rel_err, one_torch_thread, randomize, write_tiny_clip_model

_one_thread = pytest.fixture(autouse=True)(one_torch_thread)

TOL = 1e-5


def _video(t=5, h=40, w=56, seed=0):
    return np.random.default_rng(seed).uniform(-1, 1, (3, t, h, w)).astype(np.float32)


def test_vision_tower_matches_the_jax_tower():
    import jax
    import jax.numpy as jnp
    from opensora_tpu.models.text.clip import CLIPVisionConfig as JConfig
    from opensora_tpu.models.text.clip import CLIPVisionModel as JModel

    cfg = clip_vision_small_test_config()
    jm = JModel(JConfig(**{k: getattr(cfg, k) for k in cfg.__dataclass_fields__}))
    px = np.random.default_rng(1).normal(size=(2, 3, 28, 28)).astype(np.float32)
    params = randomize(jm.init(jax.random.PRNGKey(0), jnp.asarray(px))["params"], seed=3, scale=0.2)
    ref_hidden, ref_pooled = (np.asarray(a) for a in jm.apply({"params": params}, jnp.asarray(px)))
    ours = CLIPVisionModel(cfg)
    load_numpy_state_dict(ours, clip_vision_state_dict(params))
    with torch.no_grad():
        hidden, pooled = ours(torch.from_numpy(px))
    assert hidden.shape == (2, 5, 32) and pooled.shape == (2, 32)
    assert max_rel_err(hidden.numpy(), ref_hidden) <= TOL
    assert max_rel_err(pooled.numpy(), ref_pooled) <= TOL


@pytest.mark.parametrize("tokenizer", [True, False], ids=["bpe_files", "byte_fallback"])
def test_scorer_from_one_hf_directory_matches_the_jax_scorer(tmp_path, tokenizer):
    from opensora_tpu.eval.clip_scorer import CLIPScorer as JScorer

    d = write_tiny_clip_model(str(tmp_path / "clip"), tokenizer=tokenizer)
    ref = JScorer.from_pretrained(d)
    ours = CLIPScorer.from_pretrained(d, device="cpu")
    assert (ours.tokenizer is None) == (ref.tokenizer is None) == (not tokenizer)
    video = _video()
    assert max_rel_err(ours.embed_frames(torch.from_numpy(video), 4).numpy(), ref.embed_frames(video, 4)) <= TOL
    for text in ("a red panda eating bamboo", "a photo of a cat", ""):
        assert max_rel_err(ours.embed_text(text).numpy(), ref.embed_text(text)) <= TOL
        assert abs(ours(torch.from_numpy(video), text) - ref(video, text)) <= TOL
    # embed_video is the mean of the unit frame vectors, not renormalized
    frames = ours.embed_frames(torch.from_numpy(video))
    assert torch.equal(ours.embed_video(torch.from_numpy(video)), frames.mean(dim=0))
    assert max_rel_err(ours.embed_video(torch.from_numpy(video)).numpy(), ref.embed_video(video)) <= TOL


def test_scorer_weights_carried_from_the_jax_parameters(tmp_path):
    """The JAX scorer's parameter trees (its converters over the same file)
    through ``clip_model_state_dict`` into the port's ``CLIPModel``."""
    from opensora_tpu.eval.clip_scorer import CLIPScorer as JScorer
    from opensora_tpu.utils.ckpt import (
        convert_clip_text_state_dict,
        convert_clip_vision_state_dict,
        load_torch_state_dict,
    )

    d = write_tiny_clip_model(str(tmp_path / "clip"))
    ref = JScorer.from_pretrained(d)
    sd = load_torch_state_dict(d)
    model = CLIPModel(*clip_model_configs(d))
    load_numpy_state_dict(model, clip_model_state_dict(convert_clip_text_state_dict(sd),
                                                       convert_clip_vision_state_dict(sd), ref.visual_proj,
                                                       ref.text_proj))
    ours = CLIPScorer(model)
    video = _video(seed=2)
    assert abs(ours(torch.from_numpy(video), "a dog") - ref(video, "a dog")) <= TOL


@pytest.mark.parametrize("h, w", [(192, 336), (400, 336)], ids=["grow_192", "shrink_336"])
def test_preprocess_frames_matches_jax_resize(h, w):
    from opensora_tpu.eval.clip_scorer import preprocess_frames as jax_preprocess

    video = _video(t=3, h=h, w=w, seed=4)
    ours = preprocess_frames(torch.from_numpy(video), 224).numpy()
    ref = jax_preprocess(video, 224)
    assert ours.shape == ref.shape == (3, 3, 224, 224)
    assert np.abs(ours - ref).max() <= 2e-6


def test_clip_model_configs_read_config_json_or_default(tmp_path):
    d = write_tiny_clip_model(str(tmp_path / "clip"), vocab_size=99)
    text, vision = clip_model_configs(d)
    assert (text.vocab_size, text.hidden_size, text.num_layers, text.num_heads, text.max_position_embeddings,
            text.eos_token_id) == (99, 32, 2, 2, 77, 98)
    assert (vision.hidden_size, vision.num_layers, vision.num_heads, vision.image_size, vision.patch_size,
            vision.projection_dim) == (32, 2, 2, 28, 14, 16)
    with open(os.path.join(d, "config.json")) as f:
        cfg = json.load(f)
    cfg["text_config"]["eos_token_id"] = 2  # HF's legacy value in openai's files: pool at the largest id
    cfg["vision_config"]["num_attention_heads"] = 4
    with open(os.path.join(d, "config.json"), "w") as f:
        json.dump(cfg, f)
    text, vision = clip_model_configs(d)
    assert text.eos_token_id == 98 and vision.num_heads == 4
    os.remove(os.path.join(d, "config.json"))
    text, vision = clip_model_configs(os.path.join(d, "model.safetensors"))
    assert text.num_heads == vision.num_heads == 1 and text.eos_token_id == 98  # 32 // 64 -> 1 head, eos = vocab - 1
