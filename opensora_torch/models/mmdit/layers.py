"""MMDiT building blocks (counterpart of opensora_tpu/models/mmdit/layers.py).

Parameter names follow the upstream Open-Sora v2 state-dict layout
(``img_attn.qkv`` or ``q_proj``/``k_proj``/``v_proj``, ``img_mlp.0``/``.2``,
``final_layer.adaLN_modulation.1``, ...), so a published checkpoint loads
with ``load_state_dict``. Every module takes ``device`` and ``dtype``
factory arguments (the parameters' dtype); activations run in the dtype
they come in, each float linear casting its parameters to it at use
(``models/cast_layers.py``). ``quantized``
(False, True/"w8", "w8a8", "w8a8_pallas", "w8a8_fq") makes every linear of
the blocks, the modulation's included, an int8 ``QuantLinear``
(``ops/quant.py``) where the JAX package uses ``dense``; the embedders and
the final layer stay float.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from opensora_torch.models.cast_layers import Linear
from opensora_torch.ops.attention import attention
from opensora_torch.ops.norms import layer_norm, rms_norm
from opensora_torch.ops.quant import dense


def timestep_embedding(
    t: torch.Tensor, dim: int, max_period: float = 10000.0, time_factor: float = 1000.0
) -> torch.Tensor:
    """Sinusoidal timestep embedding, fp32."""
    t = time_factor * t.float()
    half = dim // 2
    freqs = torch.exp(
        -math.log(max_period) * torch.arange(half, dtype=torch.float32, device=t.device) / half
    )
    args = t[:, None] * freqs[None]
    emb = torch.cat([torch.cos(args), torch.sin(args)], dim=-1)
    if dim % 2:
        emb = torch.cat([emb, torch.zeros_like(emb[:, :1])], dim=-1)
    return emb


class MLPEmbedder(nn.Module):
    def __init__(self, in_dim: int, hidden_dim: int, **factory):
        super().__init__()
        self.in_layer = Linear(in_dim, hidden_dim, **factory)
        self.out_layer = Linear(hidden_dim, hidden_dim, **factory)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.out_layer(F.silu(self.in_layer(x)))


class RMSNorm(nn.Module):
    def __init__(self, dim: int, **factory):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(dim, **factory))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return rms_norm(x, self.scale)


class QKNorm(nn.Module):
    """Per-head RMSNorm on q and k."""

    def __init__(self, head_dim: int, **factory):
        super().__init__()
        self.query_norm = RMSNorm(head_dim, **factory)
        self.key_norm = RMSNorm(head_dim, **factory)

    def forward(self, q: torch.Tensor, k: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        return self.query_norm(q), self.key_norm(k)


class Modulation(nn.Module):
    """AdaLN modulation: vec -> (shift, scale, gate) x (1 or 2), each (B, 1, dim)."""

    def __init__(self, dim: int, double: bool, quantized=False, **factory):
        super().__init__()
        self.multiplier = 6 if double else 3
        self.lin = dense(quantized, dim, self.multiplier * dim, **factory)

    def forward(self, vec: torch.Tensor):
        chunks = self.lin(F.silu(vec))[:, None, :].chunk(self.multiplier, dim=-1)
        return tuple(chunks[:3]), (tuple(chunks[3:]) if self.multiplier == 6 else None)


def _split_heads(x: torch.Tensor, num_heads: int) -> torch.Tensor:
    b, l, d = x.shape
    return x.reshape(b, l, num_heads, d // num_heads)


def modulate(x: torch.Tensor, shift: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return (1 + scale) * x + shift


class SelfAttention(nn.Module):
    """QKV projection + QKNorm + output projection (driven by the blocks)."""

    def __init__(self, dim: int, num_heads: int, qkv_bias: bool = False, fused_qkv: bool = True,
                 quantized=False, **factory):
        super().__init__()
        self.num_heads = num_heads
        self.fused_qkv = fused_qkv
        if fused_qkv:
            self.qkv = dense(quantized, dim, dim * 3, bias=qkv_bias, **factory)
        else:
            self.q_proj = dense(quantized, dim, dim, bias=qkv_bias, **factory)
            self.k_proj = dense(quantized, dim, dim, bias=qkv_bias, **factory)
            self.v_proj = dense(quantized, dim, dim, bias=qkv_bias, **factory)
        self.norm = QKNorm(dim // num_heads, **factory)
        self.proj = dense(quantized, dim, dim, **factory)

    def qkv_heads(self, x: torch.Tensor):
        """Per-head q, k, v of shape (B, L, H, D), q and k normalized."""
        if self.fused_qkv:
            q, k, v = self.qkv(x).chunk(3, dim=-1)
        else:
            q, k, v = self.q_proj(x), self.k_proj(x), self.v_proj(x)
        q, k, v = (_split_heads(t, self.num_heads) for t in (q, k, v))
        q, k = self.norm(q, k)
        return q.to(v.dtype), k.to(v.dtype), v


def _mlp(hidden: int, mlp_hidden: int, quantized=False, **factory) -> nn.Sequential:
    return nn.Sequential(
        dense(quantized, hidden, mlp_hidden, **factory),
        nn.GELU(approximate="tanh"),
        dense(quantized, mlp_hidden, hidden, **factory),
    )


class DoubleStreamBlock(nn.Module):
    """Dual-stream block: img and txt keep their own modulation, projections
    and MLPs; attention is joint over the concatenated [txt, img] sequence."""

    def __init__(self, hidden_size: int, num_heads: int, mlp_ratio: float, qkv_bias: bool = False,
                 fused_qkv: bool = True, rope_convention: str = "split",
                 attn_backend: Optional[str] = None, quantized=False, **factory):
        super().__init__()
        mlp_hidden = int(hidden_size * mlp_ratio)
        self.rope_convention = rope_convention
        self.attn_backend = attn_backend
        q = dict(quantized=quantized, **factory)
        self.img_mod = Modulation(hidden_size, double=True, **q)
        self.txt_mod = Modulation(hidden_size, double=True, **q)
        self.img_attn = SelfAttention(hidden_size, num_heads, qkv_bias, fused_qkv, **q)
        self.txt_attn = SelfAttention(hidden_size, num_heads, qkv_bias, fused_qkv, **q)
        self.img_mlp = _mlp(hidden_size, mlp_hidden, **q)
        self.txt_mlp = _mlp(hidden_size, mlp_hidden, **q)

    def forward(self, img, txt, vec, pe):
        (img_shift1, img_scale1, img_gate1), (img_shift2, img_scale2, img_gate2) = self.img_mod(vec)
        (txt_shift1, txt_scale1, txt_gate1), (txt_shift2, txt_scale2, txt_gate2) = self.txt_mod(vec)

        img_q, img_k, img_v = self.img_attn.qkv_heads(modulate(layer_norm(img), img_shift1, img_scale1))
        txt_q, txt_k, txt_v = self.txt_attn.qkv_heads(modulate(layer_norm(txt), txt_shift1, txt_scale1))
        attn_out = attention(
            torch.cat([txt_q, img_q], dim=1),
            torch.cat([txt_k, img_k], dim=1),
            torch.cat([txt_v, img_v], dim=1),
            pe=pe, rope_convention=self.rope_convention, backend=self.attn_backend,
        )
        txt_len = txt_q.shape[1]
        txt_attn, img_attn = attn_out[:, :txt_len], attn_out[:, txt_len:]

        img = img + img_gate1 * self.img_attn.proj(img_attn)
        txt = txt + txt_gate1 * self.txt_attn.proj(txt_attn)
        img = img + img_gate2 * self.img_mlp(modulate(layer_norm(img), img_shift2, img_scale2))
        txt = txt + txt_gate2 * self.txt_mlp(modulate(layer_norm(txt), txt_shift2, txt_scale2))
        return img, txt


class SingleStreamBlock(nn.Module):
    """Single-stream block with parallel attention and MLP."""

    def __init__(self, hidden_size: int, num_heads: int, mlp_ratio: float = 4.0,
                 fused_qkv: bool = True, rope_convention: str = "split",
                 attn_backend: Optional[str] = None, quantized=False, **factory):
        super().__init__()
        self.hidden_size = hidden_size
        self.num_heads = num_heads
        self.mlp_hidden_dim = int(hidden_size * mlp_ratio)
        self.fused_qkv = fused_qkv
        self.rope_convention = rope_convention
        self.attn_backend = attn_backend
        mlp = self.mlp_hidden_dim
        if fused_qkv:
            self.linear1 = dense(quantized, hidden_size, hidden_size * 3 + mlp, **factory)
        else:
            self.q_proj = dense(quantized, hidden_size, hidden_size, **factory)
            self.k_proj = dense(quantized, hidden_size, hidden_size, **factory)
            self.v_mlp = dense(quantized, hidden_size, hidden_size + mlp, **factory)
        self.linear2 = dense(quantized, hidden_size + mlp, hidden_size, **factory)
        self.norm = QKNorm(hidden_size // num_heads, **factory)
        self.modulation = Modulation(hidden_size, double=False, quantized=quantized, **factory)

    def forward(self, x, vec, pe):
        (shift, scale, gate), _ = self.modulation(vec)
        h = self.hidden_size
        x_mod = modulate(layer_norm(x), shift, scale)
        if self.fused_qkv:
            qkv, mlp = self.linear1(x_mod).split([3 * h, self.mlp_hidden_dim], dim=-1)
            q, k, v = qkv.chunk(3, dim=-1)
        else:
            q, k = self.q_proj(x_mod), self.k_proj(x_mod)
            v, mlp = self.v_mlp(x_mod).split([h, self.mlp_hidden_dim], dim=-1)
        q, k, v = (_split_heads(t, self.num_heads) for t in (q, k, v))
        q, k = self.norm(q, k)
        attn_out = attention(
            q.to(v.dtype), k.to(v.dtype), v, pe=pe,
            rope_convention=self.rope_convention, backend=self.attn_backend,
        )
        out = self.linear2(torch.cat([attn_out, F.gelu(mlp, approximate="tanh")], dim=-1))
        return x + gate * out


class LastLayer(nn.Module):
    """AdaLN final projection."""

    def __init__(self, hidden_size: int, out_dim: int, **factory):
        super().__init__()
        self.adaLN_modulation = nn.Sequential(nn.SiLU(), Linear(hidden_size, 2 * hidden_size, **factory))
        self.linear = Linear(hidden_size, out_dim, **factory)

    def forward(self, x: torch.Tensor, vec: torch.Tensor) -> torch.Tensor:
        shift, scale = self.adaLN_modulation(vec).chunk(2, dim=-1)
        x = (1 + scale[:, None, :]) * layer_norm(x) + shift[:, None, :]
        return self.linear(x)
