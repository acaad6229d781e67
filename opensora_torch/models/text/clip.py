"""CLIP towers (counterpart of opensora_tpu/models/text/clip.py).

The text tower (CLIP-L, the MMDiT's pooled-vector conditioner): learned
positional embeddings, pre-LN transformer with a causal mask, quick-GELU
MLP, final LayerNorm; the pooled output is the hidden state at the EOT
token. The vision tower (ViT-L/14, the evaluation's scorer): a patch
convolution without bias and a class token, pre-LN ``pre_layrnorm``, the
same encoder layers without a mask; the pooled output is the post-LN class
token and the last hidden state has no post-LN. ``CLIPModel`` holds both
towers and their projections. Attention is plain torch with fp32 scores, as
the JAX package's einsum computes it. Parameter names follow HF's
``CLIPTextModel`` / ``CLIPVisionModel`` / ``CLIPModel`` state dicts
(``text_model.encoder.layers.{i}.self_attn.q_proj``,
``vision_model.embeddings.patch_embedding``, ``visual_projection``, ...).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch
import torch.nn as nn


@dataclass
class CLIPTextConfig:
    vocab_size: int = 49408
    hidden_size: int = 768
    intermediate_size: int = 3072
    num_layers: int = 12
    num_heads: int = 12
    max_position_embeddings: int = 77
    layer_norm_eps: float = 1e-5
    eos_token_id: int = 49407


def clip_l_config() -> CLIPTextConfig:
    return CLIPTextConfig()


def clip_small_test_config() -> CLIPTextConfig:
    return CLIPTextConfig(vocab_size=128, hidden_size=32, intermediate_size=64, num_layers=2,
                          num_heads=2, max_position_embeddings=16, eos_token_id=127)


@dataclass
class CLIPVisionConfig:
    """ViT-L/14 (openai/clip-vit-large-patch14's vision side). The
    transformer fields carry CLIPTextConfig's names, so the towers share
    ``CLIPEncoderLayer``."""

    hidden_size: int = 1024
    intermediate_size: int = 4096
    num_layers: int = 24
    num_heads: int = 16
    image_size: int = 224
    patch_size: int = 14
    projection_dim: int = 768
    layer_norm_eps: float = 1e-5


def clip_vision_l_config() -> CLIPVisionConfig:
    return CLIPVisionConfig()


def clip_vision_small_test_config() -> CLIPVisionConfig:
    return CLIPVisionConfig(hidden_size=32, intermediate_size=64, num_layers=2, num_heads=2, image_size=28,
                            patch_size=14, projection_dim=16)


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(1.702 * x)


class CLIPAttention(nn.Module):
    def __init__(self, cfg: CLIPTextConfig, **factory):
        super().__init__()
        self.num_heads = cfg.num_heads
        h = cfg.hidden_size
        self.q_proj = nn.Linear(h, h, **factory)
        self.k_proj = nn.Linear(h, h, **factory)
        self.v_proj = nn.Linear(h, h, **factory)
        self.out_proj = nn.Linear(h, h, **factory)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor]) -> torch.Tensor:
        b, l, c = x.shape
        hd = c // self.num_heads
        q, k, v = (p(x).reshape(b, l, self.num_heads, hd) for p in (self.q_proj, self.k_proj, self.v_proj))
        scores = torch.einsum("blhd,bmhd->bhlm", q.float(), k.float()) / hd**0.5
        if mask is not None:
            scores = scores.masked_fill(~mask, -1e9)
        probs = scores.softmax(dim=-1).to(x.dtype)
        return self.out_proj(torch.einsum("bhlm,bmhd->blhd", probs, v).reshape(b, l, c))


class CLIPMLP(nn.Module):
    def __init__(self, cfg: CLIPTextConfig, **factory):
        super().__init__()
        self.fc1 = nn.Linear(cfg.hidden_size, cfg.intermediate_size, **factory)
        self.fc2 = nn.Linear(cfg.intermediate_size, cfg.hidden_size, **factory)

    def forward(self, x):
        return self.fc2(quick_gelu(self.fc1(x)))


class CLIPEncoderLayer(nn.Module):
    def __init__(self, cfg: CLIPTextConfig, **factory):
        super().__init__()
        self.layer_norm1 = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps, **factory)
        self.self_attn = CLIPAttention(cfg, **factory)
        self.layer_norm2 = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps, **factory)
        self.mlp = CLIPMLP(cfg, **factory)

    def forward(self, x, mask):
        x = x + self.self_attn(self.layer_norm1(x), mask)
        return x + self.mlp(self.layer_norm2(x))


class CLIPEmbeddings(nn.Module):
    def __init__(self, cfg: CLIPTextConfig, **factory):
        super().__init__()
        self.token_embedding = nn.Embedding(cfg.vocab_size, cfg.hidden_size, **factory)
        self.position_embedding = nn.Embedding(cfg.max_position_embeddings, cfg.hidden_size, **factory)

    def forward(self, input_ids):
        return self.token_embedding(input_ids) + self.position_embedding.weight[None, : input_ids.shape[1]]


class CLIPEncoder(nn.Module):
    def __init__(self, cfg: CLIPTextConfig, **factory):
        super().__init__()
        self.layers = nn.ModuleList(CLIPEncoderLayer(cfg, **factory) for _ in range(cfg.num_layers))


class CLIPTextTransformer(nn.Module):
    def __init__(self, cfg: CLIPTextConfig, **factory):
        super().__init__()
        self.eos_token_id = cfg.eos_token_id
        self.embeddings = CLIPEmbeddings(cfg, **factory)
        self.encoder = CLIPEncoder(cfg, **factory)
        self.final_layer_norm = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps, **factory)

    def forward(self, input_ids: torch.Tensor):
        b, l = input_ids.shape
        x = self.embeddings(input_ids)
        causal = torch.ones(l, l, dtype=torch.bool, device=x.device).tril()[None, None]
        for layer in self.encoder.layers:
            x = layer(x, causal)
        x = self.final_layer_norm(x)
        # pooled = hidden state at the first EOT token
        eot = (input_ids == self.eos_token_id).int().argmax(dim=-1)
        return x, x[torch.arange(b, device=x.device), eot]


class CLIPTextModel(nn.Module):
    """input_ids (B, L) -> (last hidden state (B, L, C), pooled (B, C))."""

    def __init__(self, config: CLIPTextConfig, device=None, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.config = config
        self.text_model = CLIPTextTransformer(config, device=device, dtype=dtype)

    def forward(self, input_ids: torch.Tensor):
        return self.text_model(input_ids)


class CLIPVisionEmbeddings(nn.Module):
    def __init__(self, cfg: CLIPVisionConfig, **factory):
        super().__init__()
        self.class_embedding = nn.Parameter(torch.empty(cfg.hidden_size, **factory).normal_(std=0.02))
        self.patch_embedding = nn.Conv2d(3, cfg.hidden_size, cfg.patch_size, stride=cfg.patch_size, bias=False,
                                         **factory)
        self.position_embedding = nn.Embedding((cfg.image_size // cfg.patch_size) ** 2 + 1, cfg.hidden_size,
                                               **factory)

    def forward(self, pixel_values: torch.Tensor) -> torch.Tensor:
        w = self.patch_embedding.weight
        x = self.patch_embedding(pixel_values.to(w.dtype)).flatten(2).transpose(1, 2)  # (B, N, C), rows first
        x = torch.cat([self.class_embedding.expand(x.shape[0], 1, -1), x], dim=1)
        return x + self.position_embedding.weight[None, : x.shape[1]]


class CLIPVisionTransformer(nn.Module):
    def __init__(self, cfg: CLIPVisionConfig, **factory):
        super().__init__()
        self.embeddings = CLIPVisionEmbeddings(cfg, **factory)
        self.pre_layrnorm = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps, **factory)  # HF's spelling
        self.encoder = CLIPEncoder(cfg, **factory)
        self.post_layernorm = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps, **factory)

    def forward(self, pixel_values: torch.Tensor):
        x = self.pre_layrnorm(self.embeddings(pixel_values))
        for layer in self.encoder.layers:
            x = layer(x, None)
        return x, self.post_layernorm(x[:, 0])


class CLIPVisionModel(nn.Module):
    """pixel_values (B, 3, S, S) -> (last hidden state (B, 1 + N, C) without
    the post-LN, pooled (B, C): the post-LN class token)."""

    def __init__(self, config: CLIPVisionConfig, device=None, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.config = config
        self.vision_model = CLIPVisionTransformer(config, device=device, dtype=dtype)

    def forward(self, pixel_values: torch.Tensor):
        return self.vision_model(pixel_values)


class CLIPModel(nn.Module):
    """Both towers and their bias-free projections into the shared space,
    under HF ``CLIPModel``'s names."""

    def __init__(self, text_config: CLIPTextConfig, vision_config: CLIPVisionConfig, device=None,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.text_config, self.vision_config = text_config, vision_config
        factory = dict(device=device, dtype=dtype)
        self.text_model = CLIPTextTransformer(text_config, **factory)
        self.vision_model = CLIPVisionTransformer(vision_config, **factory)
        proj = vision_config.projection_dim
        self.visual_projection = nn.Linear(vision_config.hidden_size, proj, bias=False, **factory)
        self.text_projection = nn.Linear(text_config.hidden_size, proj, bias=False, **factory)

    def image_features(self, pixel_values: torch.Tensor) -> torch.Tensor:
        return self.visual_projection(self.vision_model(pixel_values)[1])

    def text_features(self, input_ids: torch.Tensor) -> torch.Tensor:
        return self.text_projection(self.text_model(input_ids)[1])
