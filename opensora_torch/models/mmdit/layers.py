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

Each block's ``forward_tp`` runs it over the ranks of a sharded model
(``parallel/sharding.RankGroup``), per-rank lists in and out: rank r reads
its shards of the weights (whole heads of ``qkv`` and ``linear1``, its MLP
columns), and the row-parallel products (``proj``, ``img_mlp.2``,
``txt_mlp.2``, ``linear2``) are summed over the tp ranks with the bias
added once. Over an sp group (a ``seq`` RankGroup) each rank also holds
only its chunk of the joint [txt, img] sequence: a double block's chunk is
a text part and an image part, either possibly empty, to which the rank
applies the text and the image weights; the attention is the one step that
spans the group. Each block runs in three steps: per-rank q, k, v and
their norms, the group's attention (:func:`group_attention`), then per
rank the output projections, MLPs and residuals. A part without tokens
runs none of its linears (:func:`tokenwise`), so no kernel is launched
with no rows. The unsharded ``forward`` is ``forward_tp`` over one rank
(``parallel/sharding.ONE_RANK``), so the block's math is written once.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from opensora_torch.models.cast_layers import Linear
from opensora_torch.ops.attention import attention, attention_shards
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


def tokenwise(fn, x: torch.Tensor, width: int) -> torch.Tensor:
    """``fn(x)`` over x's tokens (B, L, ·); where L is 0, an empty (B, 0,
    width) in x's dtype, and ``fn`` is not called."""
    return fn(x) if x.shape[1] else x.new_empty((x.shape[0], 0, width))


def group_attention(g, qkv, pe, rope_convention: str, backend: Optional[str]):
    """The attention of every rank of ``g`` (``parallel/sharding.
    RankGroup`` or ``ONE_RANK``): per-rank (q, k, v), each (B, L_r, H_r,
    D), and pe in, per-rank outputs (B, L_r, H_r * D) out. Over whole
    sequences each rank attends by itself; over an sp group (``g.seq``)
    the ranks of each tp coordinate attend together over their chunks
    (``ops/attention.attention_shards``), with the group's ranks in other
    processes where it spans them (``g.shard_group``)."""
    kw = dict(rope_convention=rope_convention, backend=backend)
    if not g.seq:
        return g.each(lambda r: attention(*qkv[r], pe=pe[r], **kw))
    out = [None] * len(qkv)
    for t, ranks in enumerate(g.sp_sets()):
        parts = attention_shards(*([qkv[r][i] for r in ranks] for i in range(3)), [pe[r] for r in ranks], **kw,
                                 group=g.shard_group(t))
        for r, o in zip(ranks, parts):
            out[r] = o
    return out


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

    def qkv_heads(self, x: torch.Tensor, tp: int = 1):
        """Per-head q, k, v of shape (B, L, H / tp, D) (one of ``tp``
        ranks' heads), q and k normalized; empty where x has no tokens."""
        if not x.shape[1]:
            empty = x.new_empty((x.shape[0], 0, self.num_heads // tp, self.head_dim))
            return empty, empty, empty
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
        mlp_hidden = self.mlp_hidden_dim = int(hidden_size * mlp_ratio)
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
        img, txt = self.forward_tp(ONE_RANK, [img], [txt], [vec], [pe])
        return img[0], txt[0]

    def forward_tp(self, g, img, txt, vec, pe):
        """The block over the ranks of ``g`` (``parallel/sharding.
        RankGroup`` or ``ONE_RANK``); every argument and result is a list
        with one entry per rank, a rank's img and txt its parts of the
        joint sequence. Modulation, norms and residuals are replicated over
        'tp' (once per chunk and device); each rank attends over its heads
        and computes its MLP columns; one all-reduce over 'tp' follows each
        row-parallel product."""
        hidden = img[0].shape[-1]
        mods = g.rep(lambda r: (self.img_mod(vec[r]), self.txt_mod(vec[r])))

        def first(r):
            ((img_shift1, img_scale1, _), _), ((txt_shift1, txt_scale1, _), _) = mods[r]
            return (modulate(layer_norm(img[r]), img_shift1, img_scale1),
                    modulate(layer_norm(txt[r]), txt_shift1, txt_scale1))

        x = g.rep(first)

        def qkv(r):  # the joint [txt, img] q, k, v of the rank's heads
            img_q, txt_q = self.img_attn.qkv_heads(x[r][0], g.tp), self.txt_attn.qkv_heads(x[r][1], g.tp)
            return tuple(torch.cat([a, b], dim=1) for a, b in zip(txt_q, img_q))

        attn = group_attention(g, g.each(qkv), pe, self.rope_convention, self.attn_backend)
        n_txt = [t.shape[1] for t in txt]
        img_o = g.row(self.img_attn.proj, [a[:, n:] for a, n in zip(attn, n_txt)], hidden)
        txt_o = g.row(self.txt_attn.proj, [a[:, :n] for a, n in zip(attn, n_txt)], hidden)

        def second(r):
            ((_, _, img_gate1), (img_shift2, img_scale2, _)), ((_, _, txt_gate1), (txt_shift2, txt_scale2, _)) = mods[r]
            i, x_ = img[r] + img_gate1 * img_o[r], txt[r] + txt_gate1 * txt_o[r]
            return (i, x_, modulate(layer_norm(i), img_shift2, img_scale2),
                    modulate(layer_norm(x_), txt_shift2, txt_scale2))

        r2 = g.rep(second)
        mlp_w = self.mlp_hidden_dim // g.tp
        img_m = g.row(self.img_mlp[2], g.each(lambda r: tokenwise(lambda y: self.img_mlp[1](self.img_mlp[0](y)),
                                                                   r2[r][2], mlp_w)), hidden)
        txt_m = g.row(self.txt_mlp[2], g.each(lambda r: tokenwise(lambda y: self.txt_mlp[1](self.txt_mlp[0](y)),
                                                                   r2[r][3], mlp_w)), hidden)
        out = g.rep(lambda r: (r2[r][0] + mods[r][0][1][2] * img_m[r], r2[r][1] + mods[r][1][1][2] * txt_m[r]))
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

    def _qkv_mlp(self, x_mod, tp: int):
        """q, k, v (B, L, H / tp, D), q and k normalized, and the MLP's
        pre-activation of the modulated input, over the heads and MLP
        columns of one of ``tp`` ranks."""
        h, mlp_w = self.hidden_size // tp, self.mlp_hidden_dim // tp
        if self.fused_qkv:
            qkv, mlp = self.linear1(x_mod).split([3 * h, mlp_w], dim=-1)
            q, k, v = qkv.chunk(3, dim=-1)
        else:
            q, k = self.q_proj(x_mod), self.k_proj(x_mod)
            v, mlp = self.v_mlp(x_mod).split([h, mlp_w], dim=-1)
        q, k, v = (_split_heads(t, self.hidden_size // self.num_heads) for t in (q, k, v))
        q, k = self.norm(q, k)
        return q.to(v.dtype), k.to(v.dtype), v, mlp

    def forward(self, x, vec, pe):
        return self.forward_tp(ONE_RANK, [x], [vec], [pe])[0]

    def forward_tp(self, g, x, vec, pe):
        """The block over the ranks of ``g``, per-rank lists in and out
        (see ``DoubleStreamBlock.forward_tp``): the [attention | gelu(mlp)]
        input of ``linear2``, then one all-reduce over 'tp' after it."""
        mods = g.rep(lambda r: self.modulation(vec[r])[0])
        x_mod = g.rep(lambda r: modulate(layer_norm(x[r]), mods[r][0], mods[r][1]))
        qkv_mlp = g.each(lambda r: self._qkv_mlp(x_mod[r], g.tp))
        attn = group_attention(g, [a[:3] for a in qkv_mlp], pe, self.rope_convention, self.attn_backend)
        hidden = g.each(lambda r: torch.cat([attn[r], F.gelu(qkv_mlp[r][3], approximate="tanh")], dim=-1))
        out = g.row(self.linear2, hidden, x[0].shape[-1])
        return g.rep(lambda r: x[r] + mods[r][2] * out[r])


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
