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

Each block's ``forward_tp`` runs it over the tp ranks of a sharded model
(``parallel/sharding.RankGroup``): rank r reads its shards of the weights
(whole heads of ``qkv`` and ``linear1``, its MLP columns), attends over
its heads, and the row-parallel products (``proj``, ``img_mlp.2``,
``txt_mlp.2``, ``linear2``) are summed over the ranks with the bias added
once. The unsharded ``forward`` is ``forward_tp`` over one rank
(``parallel/sharding.ONE_RANK``), so the block's math is written once.
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
from opensora_torch.parallel.sharding import ONE_RANK


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


def _split_heads(x: torch.Tensor, head_dim: int) -> torch.Tensor:
    """(B, L, n * head_dim) -> (B, L, n, head_dim): n is all the heads, or
    a tp rank's share of them."""
    b, l, d = x.shape
    return x.reshape(b, l, d // head_dim, head_dim)


def modulate(x: torch.Tensor, shift: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return (1 + scale) * x + shift


class SelfAttention(nn.Module):
    """QKV projection + QKNorm + output projection (driven by the blocks)."""

    def __init__(self, dim: int, num_heads: int, qkv_bias: bool = False, fused_qkv: bool = True,
                 quantized=False, **factory):
        super().__init__()
        self.num_heads = num_heads
        self.head_dim = dim // num_heads
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
        q, k, v = (_split_heads(t, self.head_dim) for t in (q, k, v))
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

    def _attend(self, img_x, txt_x, pe):
        """Joint attention of the modulated streams over the heads this rank
        holds: (txt, img) outputs, heads merged."""
        img_q, img_k, img_v = self.img_attn.qkv_heads(img_x)
        txt_q, txt_k, txt_v = self.txt_attn.qkv_heads(txt_x)
        attn_out = attention(
            torch.cat([txt_q, img_q], dim=1),
            torch.cat([txt_k, img_k], dim=1),
            torch.cat([txt_v, img_v], dim=1),
            pe=pe, rope_convention=self.rope_convention, backend=self.attn_backend,
        )
        txt_len = txt_q.shape[1]
        return attn_out[:, :txt_len], attn_out[:, txt_len:]

    def forward(self, img, txt, vec, pe):
        img, txt = self.forward_tp(ONE_RANK, [img], [txt], [vec], [pe])
        return img[0], txt[0]

    def forward_tp(self, g, img, txt, vec, pe):
        """The block over the tp ranks of ``g`` (``parallel/sharding.
        RankGroup`` or ``ONE_RANK``); every argument and result is a list
        with one entry per rank. Modulation, norms and residuals are
        replicated (once per device); each rank attends over its heads and
        computes its MLP columns; one all-reduce follows each row-parallel
        product."""
        mods = g.rep(lambda t: (self.img_mod(vec[t]), self.txt_mod(vec[t])))

        def first(t):
            ((img_shift1, img_scale1, _), _), ((txt_shift1, txt_scale1, _), _) = mods[t]
            return (modulate(layer_norm(img[t]), img_shift1, img_scale1),
                    modulate(layer_norm(txt[t]), txt_shift1, txt_scale1))

        x = g.rep(first)
        attn = g.each(lambda t: self._attend(*x[t], pe[t]))
        img_o = g.row(self.img_attn.proj, [a[1] for a in attn])
        txt_o = g.row(self.txt_attn.proj, [a[0] for a in attn])

        def second(t):
            ((_, _, img_gate1), (img_shift2, img_scale2, _)), ((_, _, txt_gate1), (txt_shift2, txt_scale2, _)) = mods[t]
            i, x_ = img[t] + img_gate1 * img_o[t], txt[t] + txt_gate1 * txt_o[t]
            return (i, x_, modulate(layer_norm(i), img_shift2, img_scale2),
                    modulate(layer_norm(x_), txt_shift2, txt_scale2))

        r = g.rep(second)
        img_m = g.row(self.img_mlp[2], g.each(lambda t: self.img_mlp[1](self.img_mlp[0](r[t][2]))))
        txt_m = g.row(self.txt_mlp[2], g.each(lambda t: self.txt_mlp[1](self.txt_mlp[0](r[t][3]))))
        out = g.rep(lambda t: (r[t][0] + mods[t][0][1][2] * img_m[t], r[t][1] + mods[t][1][1][2] * txt_m[t]))
        return [o[0] for o in out], [o[1] for o in out]


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

    def _attn_mlp(self, x_mod, pe, tp: int):
        """[attention | gelu(mlp)] of the modulated input over the heads and
        MLP columns of one of ``tp`` ranks: the input of ``linear2``."""
        h, mlp_w = self.hidden_size // tp, self.mlp_hidden_dim // tp
        if self.fused_qkv:
            qkv, mlp = self.linear1(x_mod).split([3 * h, mlp_w], dim=-1)
            q, k, v = qkv.chunk(3, dim=-1)
        else:
            q, k = self.q_proj(x_mod), self.k_proj(x_mod)
            v, mlp = self.v_mlp(x_mod).split([h, mlp_w], dim=-1)
        q, k, v = (_split_heads(t, self.hidden_size // self.num_heads) for t in (q, k, v))
        q, k = self.norm(q, k)
        attn_out = attention(
            q.to(v.dtype), k.to(v.dtype), v, pe=pe,
            rope_convention=self.rope_convention, backend=self.attn_backend,
        )
        return torch.cat([attn_out, F.gelu(mlp, approximate="tanh")], dim=-1)

    def forward(self, x, vec, pe):
        return self.forward_tp(ONE_RANK, [x], [vec], [pe])[0]

    def forward_tp(self, g, x, vec, pe):
        """The block over the tp ranks of ``g``, per-rank lists in and out
        (see ``DoubleStreamBlock.forward_tp``): one all-reduce, after
        ``linear2``."""
        mods = g.rep(lambda t: self.modulation(vec[t])[0])
        x_mod = g.rep(lambda t: modulate(layer_norm(x[t]), mods[t][0], mods[t][1]))
        out = g.row(self.linear2, g.each(lambda t: self._attn_mlp(x_mod[t], pe[t], g.tp)))
        return g.rep(lambda t: x[t] + mods[t][2] * out[t])


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
