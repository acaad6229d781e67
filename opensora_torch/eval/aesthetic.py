"""LAION aesthetic predictor head for the VBench 'aesthetic quality'
dimension (counterpart of opensora_tpu/eval/aesthetic.py).

The head is the LAION improved-aesthetic-predictor's MLP over the unit CLIP
ViT-L/14 image embedding: five ``Linear`` layers (768 -> 1024 -> 128 -> 64 ->
16 -> 1), fp32, with dropouts between the first four and no activations, so
at inference a stack of affine maps. It loads the published state dict's
``layers.N.weight/bias`` keys (the dropouts hold the gaps in N), bare or
under ``state_dict``. Like the CLIP score, the dimension needs the weights
on disk: a random head carries no signal. It runs in full fp32 (TF32 off),
as the scorer does.
"""

from __future__ import annotations

import logging
import os
from typing import Dict, Optional, Tuple

import torch
import torch.nn as nn


class AestheticHead(nn.Module):
    """(N, d) unit CLIP embeddings -> (N,) raw scores (LAION's scale,
    roughly 1-10; VBench divides by 10). ``shapes`` maps each ``Linear``'s
    index in the published ``nn.Sequential`` to its (out, in) shape."""

    def __init__(self, shapes: Dict[int, Tuple[int, int]], device=None):
        super().__init__()
        if not shapes:
            raise ValueError("aesthetic head: no layers")
        self.layers = nn.Sequential(*(nn.Linear(shapes[i][1], shapes[i][0], device=device) if i in shapes
                                      else nn.Identity() for i in range(max(shapes) + 1)))
        self.requires_grad_(False)  # a scorer: it takes the CLIP tower's inference-mode embeddings

    @property
    def input_dim(self) -> int:
        return next(m for m in self.layers if isinstance(m, nn.Linear)).in_features

    @classmethod
    def from_pretrained(cls, path: str, device=None) -> "AestheticHead":
        """The LAION predictor's torch state dict (.pth / .pt / .safetensors)."""
        from opensora_torch.utils.ckpt import load_torch_state_dict

        sd = load_torch_state_dict(path)
        idx = sorted({int(k.split(".")[1]) for k in sd if k.startswith("layers.") and k.endswith(".weight")})
        if not idx:
            raise FileNotFoundError(f"{path} has no `layers.N.weight` keys: not a LAION aesthetic-predictor "
                                    "state dict")
        head = cls({i: tuple(sd[f"layers.{i}.weight"].shape) for i in idx}, device=device)
        head.load_state_dict({f"layers.{i}.{p}": sd[f"layers.{i}.{p}"].float()
                              for i in idx for p in ("weight", "bias")})
        return head

    def forward(self, emb: torch.Tensor) -> torch.Tensor:
        if emb.shape[-1] != self.input_dim:
            raise ValueError(f"aesthetic head expects {self.input_dim}-d CLIP embeddings, got {emb.shape[-1]} "
                             "(use a ViT-L/14 CLIPModel for VBench parity)")
        from opensora_torch.eval.clip_scorer import full_fp32

        with full_fp32():
            return self.layers(emb.float())[..., 0]


def try_load_head(path: Optional[str], device=None) -> Optional[AestheticHead]:
    """For CLIs: the head at ``path``, or None (logged) when no weights are
    on disk or they do not load."""
    if not path or not os.path.exists(path):
        return None
    try:
        return AestheticHead.from_pretrained(path, device)
    except (OSError, ValueError, KeyError, RuntimeError) as e:
        logging.getLogger("opensora_torch").warning("aesthetic_quality disabled: %s", e)
        return None
