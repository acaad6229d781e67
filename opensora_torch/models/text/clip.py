"""CLIP-L text tower (counterpart of opensora_tpu/models/text/clip.py).

Learned positional embeddings, pre-LN transformer with a causal mask,
quick-GELU MLP, final LayerNorm; the pooled output is the hidden state at
the EOT token. Parameter names follow HF's ``CLIPTextModel`` state dict
(``text_model.encoder.layers.{i}.self_attn.q_proj``, ...).
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

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        b, l, c = x.shape
        hd = c // self.num_heads
        q, k, v = (p(x).reshape(b, l, self.num_heads, hd) for p in (self.q_proj, self.k_proj, self.v_proj))
        scores = torch.einsum("blhd,bmhd->bhlm", q.float(), k.float()) / hd**0.5
        probs = scores.masked_fill(~mask, -1e9).softmax(dim=-1).to(x.dtype)
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
        self.embeddings = CLIPEmbeddings(cfg, **factory)
        self.encoder = CLIPEncoder(cfg, **factory)
        self.final_layer_norm = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps, **factory)


class CLIPTextModel(nn.Module):
    """input_ids (B, L) -> (last hidden state (B, L, C), pooled (B, C))."""

    def __init__(self, config: CLIPTextConfig, device=None, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.config = config
        self.text_model = CLIPTextTransformer(config, device=device, dtype=dtype)

    def forward(self, input_ids: torch.Tensor):
        tm = self.text_model
        b, l = input_ids.shape
        x = tm.embeddings(input_ids)
        causal = torch.ones(l, l, dtype=torch.bool, device=x.device).tril()[None, None]
        for layer in tm.encoder.layers:
            x = layer(x, causal)
        x = tm.final_layer_norm(x)
        # pooled = hidden state at the first EOT token
        eot = (input_ids == self.config.eos_token_id).int().argmax(dim=-1)
        return x, x[torch.arange(b, device=x.device), eot]
