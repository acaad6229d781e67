"""T5 v1.1 encoder (counterpart of opensora_tpu/models/text/t5.py).

Pre-RMSNorm blocks, relative-position-bucket bias computed in the first
layer and shared by all, unscaled attention (no 1/sqrt(d)), gated-GELU
feed-forward, biasless linears, final RMSNorm. Parameter names follow HF's
``T5EncoderModel`` state dict (``encoder.block.{i}.layer.0.SelfAttention.q``,
...), so its checkpoints load with ``load_state_dict`` once they are in the
repository.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from opensora_torch.ops.norms import rms_norm


@dataclass
class T5Config:
    vocab_size: int = 32128
    d_model: int = 4096
    d_kv: int = 64
    d_ff: int = 10240
    num_layers: int = 24
    num_heads: int = 64
    relative_attention_num_buckets: int = 32
    relative_attention_max_distance: int = 128
    layer_norm_epsilon: float = 1e-6


def t5_xxl_config() -> T5Config:
    return T5Config()


def t5_small_test_config() -> T5Config:
    return T5Config(vocab_size=128, d_model=64, d_kv=16, d_ff=128, num_layers=2, num_heads=4)


def relative_position_bucket(
    relative_position: torch.Tensor, num_buckets: int = 32, max_distance: int = 128
) -> torch.Tensor:
    """Bidirectional T5 relative-position bucketing."""
    num_buckets //= 2
    ret = (relative_position > 0).to(torch.int64) * num_buckets
    n = relative_position.abs()
    max_exact = num_buckets // 2
    is_small = n < max_exact
    val_if_large = max_exact + (
        torch.log(n.float() / max_exact + 1e-6)
        / math.log(max_distance / max_exact)
        * (num_buckets - max_exact)
    ).to(torch.int64)
    val_if_large = val_if_large.clamp(max=num_buckets - 1)
    return ret + torch.where(is_small, n, val_if_large)


class T5LayerNorm(nn.Module):
    """RMSNorm without mean subtraction."""

    def __init__(self, dim: int, eps: float = 1e-6, **factory):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim, **factory))
        self.eps = eps

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return rms_norm(x, self.weight, self.eps)


class T5Attention(nn.Module):
    def __init__(self, cfg: T5Config, has_relative_bias: bool = False, **factory):
        super().__init__()
        self.cfg = cfg
        inner = cfg.num_heads * cfg.d_kv
        self.q = nn.Linear(cfg.d_model, inner, bias=False, **factory)
        self.k = nn.Linear(cfg.d_model, inner, bias=False, **factory)
        self.v = nn.Linear(cfg.d_model, inner, bias=False, **factory)
        self.o = nn.Linear(inner, cfg.d_model, bias=False, **factory)
        if has_relative_bias:
            self.relative_attention_bias = nn.Embedding(
                cfg.relative_attention_num_buckets, cfg.num_heads, **factory
            )

    def position_bias(self, length: int, device) -> torch.Tensor:
        """(1, H, L, L) bias from the bucket table."""
        pos = torch.arange(length, device=device)
        buckets = relative_position_bucket(
            pos[None, :] - pos[:, None],
            self.cfg.relative_attention_num_buckets,
            self.cfg.relative_attention_max_distance,
        )
        return self.relative_attention_bias.weight[buckets].permute(2, 0, 1)[None]

    def forward(self, x, mask=None, position_bias=None):
        cfg = self.cfg
        b, l, _ = x.shape
        q, k, v = (proj(x).reshape(b, l, cfg.num_heads, cfg.d_kv) for proj in (self.q, self.k, self.v))
        if hasattr(self, "relative_attention_bias"):
            position_bias = self.position_bias(l, x.device)
        scores = torch.einsum("blhd,bmhd->bhlm", q.float(), k.float())
        if position_bias is not None:
            scores = scores + position_bias.float()
        if mask is not None:
            scores = scores.masked_fill(~mask[:, None, None, :], -1e9)
        probs = scores.softmax(dim=-1).to(x.dtype)
        out = torch.einsum("bhlm,bmhd->blhd", probs, v).reshape(b, l, -1)
        return self.o(out), position_bias


class T5LayerSelfAttention(nn.Module):
    def __init__(self, cfg: T5Config, has_relative_bias: bool, **factory):
        super().__init__()
        self.SelfAttention = T5Attention(cfg, has_relative_bias, **factory)
        self.layer_norm = T5LayerNorm(cfg.d_model, cfg.layer_norm_epsilon, **factory)

    def forward(self, x, mask=None, position_bias=None):
        out, position_bias = self.SelfAttention(self.layer_norm(x), mask, position_bias)
        return x + out, position_bias


class T5DenseGatedActDense(nn.Module):
    def __init__(self, cfg: T5Config, **factory):
        super().__init__()
        self.wi_0 = nn.Linear(cfg.d_model, cfg.d_ff, bias=False, **factory)
        self.wi_1 = nn.Linear(cfg.d_model, cfg.d_ff, bias=False, **factory)
        self.wo = nn.Linear(cfg.d_ff, cfg.d_model, bias=False, **factory)

    def forward(self, x):
        return self.wo(F.gelu(self.wi_0(x), approximate="tanh") * self.wi_1(x))


class T5LayerFF(nn.Module):
    def __init__(self, cfg: T5Config, **factory):
        super().__init__()
        self.DenseReluDense = T5DenseGatedActDense(cfg, **factory)
        self.layer_norm = T5LayerNorm(cfg.d_model, cfg.layer_norm_epsilon, **factory)

    def forward(self, x):
        return x + self.DenseReluDense(self.layer_norm(x))


class T5Block(nn.Module):
    def __init__(self, cfg: T5Config, has_relative_bias: bool = False, **factory):
        super().__init__()
        self.layer = nn.ModuleList([T5LayerSelfAttention(cfg, has_relative_bias, **factory),
                                    T5LayerFF(cfg, **factory)])

    def forward(self, x, mask=None, position_bias=None):
        x, position_bias = self.layer[0](x, mask, position_bias)
        return self.layer[1](x), position_bias


class T5Stack(nn.Module):
    def __init__(self, cfg: T5Config, **factory):
        super().__init__()
        self.block = nn.ModuleList(T5Block(cfg, i == 0, **factory) for i in range(cfg.num_layers))
        self.final_layer_norm = T5LayerNorm(cfg.d_model, cfg.layer_norm_epsilon, **factory)

    def forward(self, x, mask=None):
        position_bias = None
        for blk in self.block:
            x, position_bias = blk(x, mask, position_bias)
        return self.final_layer_norm(x)


class T5Encoder(nn.Module):
    """input_ids (B, L) -> last hidden state (B, L, d_model)."""

    def __init__(self, config: T5Config, device=None, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.config = config
        factory = dict(device=device, dtype=dtype)
        self.shared = nn.Embedding(config.vocab_size, config.d_model, **factory)
        self.encoder = T5Stack(config, **factory)

    def forward(self, input_ids: torch.Tensor, attention_mask: Optional[torch.Tensor] = None):
        return self.encoder(self.shared(input_ids), attention_mask)
