"""Text embedders: T5 (context tokens) and CLIP (pooled vector) --
counterpart of opensora_tpu/models/text/conditioner.py.

- T5 pads to ``max_length`` (512), then further pads so
  (added_tokens + txt_len) % seq_align == 0;
- CLIP pads/truncates to ``max_length`` (77) and returns the pooled EOT state.

Weights come from a local Hugging Face directory or file that
``from_pretrained`` names (its ``model.safetensors``, sharded safetensors
with their index, or ``pytorch_model.bin``; read by ``utils/ckpt``, without
``transformers``); a name that is no local path (``"google/t5-v1_1-xxl"``
on a machine without it) keeps the seeded random weights and logs so, as
the JAX package does. A local path that fails to load raises (the JAX
package falls back to random weights there).

Tokenization is the deterministic byte-fallback tokenizer, the path the JAX
package takes too when no tokenizer assets are present; tokenizers read
from the checkpoint directory's own files are a later item (ROADMAP).
"""

from __future__ import annotations

import logging
import os
from typing import List, Optional

import numpy as np
import torch
import torch.nn as nn

from opensora_torch.models.text.clip import (
    CLIPTextConfig,
    CLIPTextModel,
    clip_l_config,
    clip_small_test_config,
)
from opensora_torch.models.text.t5 import T5Config, T5Encoder, t5_small_test_config, t5_xxl_config
from opensora_torch.registry import MODELS


class ByteFallbackTokenizer:
    """UTF-8 bytes shifted past the specials: 0 = pad, 1 = eos/eot, byte b ->
    2 + b, clamped into the vocab. Not the T5/CLIP vocab: it keeps the
    pipeline runnable and reproducible without tokenizer assets."""

    def __init__(self, vocab_size: int, max_length: int, eos_token_id: int = 1):
        self.vocab_size = vocab_size
        self.max_length = max_length
        self.pad_token_id = 0
        self.eos_token_id = min(eos_token_id, vocab_size - 1)

    def __call__(self, texts: List[str], max_length: Optional[int] = None) -> np.ndarray:
        max_length = max_length or self.max_length
        out = np.full((len(texts), max_length), self.pad_token_id, np.int64)
        for i, t in enumerate(texts):
            ids = [min(2 + b, self.vocab_size - 1) for b in t.encode("utf-8")]
            ids = ids[: max_length - 1] + [self.eos_token_id]
            out[i, : len(ids)] = ids
        return out


@MODELS.register_module("text_embedder")
class HFEmbedder(nn.Module):
    """text -> embeddings: T5 last hidden state, or CLIP pooled output when
    ``from_pretrained`` names a CLIP model. Weights are loaded where
    ``from_pretrained`` is a local path, else random (the module's default
    init; see the module docstring)."""

    def __init__(
        self,
        from_pretrained: str = "",
        max_length: int = 512,
        t5_config: Optional[T5Config] = None,
        clip_config: Optional[CLIPTextConfig] = None,
        _tiny: bool = False,
        device=None,
        dtype: Optional[torch.dtype] = None,
        **_,
    ):
        super().__init__()
        self.is_clip = "openai" in from_pretrained or "clip" in from_pretrained.lower()
        self.max_length = max_length
        self.from_pretrained = from_pretrained
        local = bool(from_pretrained) and os.path.exists(from_pretrained)
        if from_pretrained and not local:
            logging.getLogger(__name__).info("%s is no local path: %s weights are random", from_pretrained,
                                             "CLIP" if self.is_clip else "T5")
        factory = dict(device="meta" if local else device, dtype=dtype)
        if self.is_clip:
            self.config = clip_config or (clip_small_test_config() if _tiny else clip_l_config())
            self.module = CLIPTextModel(self.config, **factory)
            eos = self.config.eos_token_id
        else:
            self.config = t5_config or (t5_small_test_config() if _tiny else t5_xxl_config())
            self.module = T5Encoder(self.config, **factory)
            eos = 1
        if local:
            from opensora_torch.utils.ckpt import load_checkpoint

            load_checkpoint(self.module, from_pretrained, "clip" if self.is_clip else "t5", device)
        self.tokenizer = ByteFallbackTokenizer(self.config.vocab_size, max_length, eos)
        self.pad_token_id = self.tokenizer.pad_token_id

    @property
    def device(self) -> torch.device:
        return next(self.parameters()).device

    def forward(self, text: List[str], added_tokens: int = 0, seq_align: int = 1) -> torch.Tensor:
        if isinstance(text, str):
            text = [text]
        ids = self.tokenizer(text)
        seq_len = ids.shape[1]
        if (added_tokens + seq_len) % seq_align != 0:
            num_pad = seq_align - (added_tokens + seq_len) % seq_align
            ids = np.pad(ids, ((0, 0), (0, num_pad)), constant_values=self.pad_token_id)
        out = self.module(torch.from_numpy(ids).to(self.device))
        return out[1] if self.is_clip else out
