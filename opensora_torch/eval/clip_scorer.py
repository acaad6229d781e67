"""CLIP text-video similarity for the VBench-style evaluation (counterpart
of opensora_tpu/eval/clip_scorer.py).

Frames go through the CLIP ViT-L/14 vision tower and prompts through the
CLIP text tower, both projected into the shared space (``CLIPModel``'s
``visual_projection`` / ``text_projection``); the score is the mean
frame-text cosine (CLIPScore, VBench's overall consistency). Weights come
from a local HF ``CLIPModel`` checkpoint (``utils/ckpt.clip_model_configs``
and ``load_checkpoint(kind="clip_model")``); without them the scorer is not
built, since a random CLIP score carries no signal. Prompts are tokenized
by the CLIP BPE tokenizer read from the checkpoint directory
(``models/text/clip_tokenizer``), else by the byte fallback, as the JAX
package does. Everything runs on the scorer's device, cuda unless the
caller names another, in full fp32: the towers run with TF32 off for cuBLAS
and cuDNN (the patch convolution), whatever the process has set, as the
JAX package computes them in fp32 (``full_fp32``).
"""

from __future__ import annotations

import contextlib
import logging
import os
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

# CLIP preprocessing constants (openai/clip-vit-large-patch14)
MEAN = (0.48145466, 0.4578275, 0.40821073)
STD = (0.26862954, 0.26130258, 0.27577711)


def preprocess_frames(video: torch.Tensor, image_size: int = 224) -> torch.Tensor:
    """(C, T, H, W) in [-1, 1] -> (T, 3, S, S) CLIP-normalized: the
    centered square crop, bilinear to ``image_size``. ``jax.image.resize``
    (the JAX package's) antialiases when it shrinks and ``F.interpolate``
    only with ``antialias=True``, which is also what matches it there;
    growing, the plain bilinear matches it (within 3e-7 of it on [0, 1]
    frames at 192 -> 224 and 336 -> 224: tests/test_torch_clip_vision.py)."""
    c, t, h, w = video.shape
    side = min(h, w)
    top, left = (h - side) // 2, (w - side) // 2
    x = ((video[:, :, top:top + side, left:left + side].float() + 1.0) / 2.0).transpose(0, 1)  # (T, C, S0, S0)
    x = F.interpolate(x, size=(image_size, image_size), mode="bilinear", align_corners=False,
                      antialias=side > image_size)
    mean = torch.tensor(MEAN, device=x.device).view(1, 3, 1, 1)
    std = torch.tensor(STD, device=x.device).view(1, 3, 1, 1)
    return (x - mean) / std


def frame_indices(t: int, max_frames: int) -> np.ndarray:
    """``max_frames`` evenly spaced frame indices of ``t`` (numpy's
    ``linspace(...).round()``, half to even, as the JAX package)."""
    return np.linspace(0, t - 1, min(t, max_frames)).round().astype(int)


@contextlib.contextmanager
def full_fp32():
    """TF32 off for cuBLAS and cuDNN inside the block, restored after it."""
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def _unit(x: torch.Tensor) -> torch.Tensor:
    return x / (torch.linalg.vector_norm(x, dim=-1, keepdim=True) + 1e-8)


class CLIPScorer:
    """Callable (video, text) -> cosine similarity in CLIP space, over a
    ``models.text.clip.CLIPModel`` and a tokenizer (None: byte fallback)."""

    def __init__(self, model, tokenizer=None):
        self.model = model.eval()
        self.tokenizer = tokenizer
        self._text_cache: Dict[str, torch.Tensor] = {}

    @property
    def device(self) -> torch.device:
        return self.model.visual_projection.weight.device

    @classmethod
    def from_pretrained(cls, path: str, tokenizer_path: Optional[str] = None, device=None) -> "CLIPScorer":
        """From a local HF CLIPModel checkpoint directory or file; the
        tokenizer's files from ``tokenizer_path`` (default: ``path``)."""
        from opensora_torch.models.text.clip import CLIPModel
        from opensora_torch.models.text.conditioner import load_tokenizer
        from opensora_torch.utils.ckpt import clip_model_configs, load_checkpoint
        from opensora_torch.utils.misc import resolve_device

        device = resolve_device(device)
        text_cfg, vision_cfg = clip_model_configs(path)
        model = load_checkpoint(CLIPModel(text_cfg, vision_cfg, device="meta"), path, "clip_model", device)
        return cls(model, load_tokenizer(tokenizer_path or path, True, text_cfg.max_position_embeddings))

    @torch.inference_mode()
    def embed_frames(self, video: torch.Tensor, max_frames: int = 8) -> torch.Tensor:
        """(N, proj) unit embeddings of up to ``max_frames`` evenly spaced
        frames (chosen before the resize)."""
        video = torch.as_tensor(video, device=self.device)
        idx = torch.from_numpy(frame_indices(video.shape[1], max_frames)).to(self.device)
        px = preprocess_frames(video.index_select(1, idx), self.model.vision_config.image_size)
        with full_fp32():
            return _unit(self.model.image_features(px))

    def embed_video(self, video: torch.Tensor, max_frames: int = 8) -> torch.Tensor:
        """Mean of the unit frame embeddings, not renormalized: its dot with a
        unit text vector is the mean frame-text cosine."""
        return self.embed_frames(video, max_frames).mean(dim=0)

    @torch.inference_mode()
    def embed_text(self, text: str) -> torch.Tensor:
        """(proj,) unit embedding of ``text`` (kept for the texts seen)."""
        if text not in self._text_cache:
            cfg = self.model.text_config
            if self.tokenizer is None:
                # byte ids (no tokenizer files on disk): relative scores stay usable
                from opensora_torch.models.text.conditioner import ByteFallbackTokenizer

                ids = ByteFallbackTokenizer(cfg.vocab_size, cfg.max_position_embeddings, cfg.eos_token_id)([text])
            else:
                ids = self.tokenizer([text], cfg.max_position_embeddings)
            with full_fp32():
                self._text_cache[text] = _unit(self.model.text_features(torch.from_numpy(ids).to(self.device)))[0]
        return self._text_cache[text]

    def __call__(self, video: torch.Tensor, text: str) -> float:
        """Mean frame-text cosine (CLIPScore without the max(0, .))."""
        return float(self.embed_video(video) @ self.embed_text(text))


def try_load_scorer(path: Optional[str], device=None) -> Optional[CLIPScorer]:
    """For CLIs: the scorer at ``path``, or None (logged) when no weights are
    on disk or they are no full CLIPModel."""
    if not path or not os.path.exists(path):
        return None
    try:
        return CLIPScorer.from_pretrained(path, device=device)
    except (OSError, ValueError, KeyError) as e:
        logging.getLogger("opensora_torch").warning("clip_score disabled: %s", e)
        return None
