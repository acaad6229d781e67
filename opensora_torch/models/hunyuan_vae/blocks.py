"""Causal 3D conv building blocks of the HunyuanVideo VAE (counterpart of
opensora_tpu/models/hunyuan_vae/blocks.py).

Layout NCTHW (the JAX package works channels-last inside). Temporal
causality is a replicate pad of k - 1 frames on the left only; spatial
padding is a symmetric k // 2 replicate pad. The mid-block attention runs
the flash-attention kernel with the frame-causal mask (``causal_block`` =
H * W tokens per frame) and never builds the L x L mask.

Each block also runs height-sharded (``parallel/vae_sharding.py``):
``forward_strips(cp, xs)`` maps the strips of one activation, one per sp
rank of ``cp`` (a ``HeightStrips``), to the strips of its output. The
convolutions take halo rows from the neighbouring strips, the group norms
all-reduce their statistics, the mid-block attention gathers the height;
each strip runs through its own device's replica of the block's weights
(``cp.on(block, r)``; the block itself where the strip lies on the VAE's
device).
Over ``ONE_STRIP`` (one strip: the whole tensor) every block is its plain
forward, which the composite blocks' ``forward`` is.

Constructors take the input channel counts that flax infers at init.
Parameters may be kept in another dtype than the activations (fp32 master
weights under bf16 compute, for training): every conv and linear casts its
parameters to its input's dtype at use (``models/cast_layers.py``).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple, Union

import torch
import torch.nn as nn
import torch.nn.functional as F

from opensora_torch.models.cast_layers import Conv3d, Linear
from opensora_torch.ops.attention import scaled_dot_product_attention
from opensora_torch.ops.norms import group_norm
from opensora_torch.parallel.vae_sharding import ONE_STRIP


def _triple(x: Union[int, Sequence[int]]) -> Tuple[int, int, int]:
    return (x, x, x) if isinstance(x, int) else tuple(x)


class CausalConv3d(nn.Module):
    """3D conv with left-only temporal replicate padding."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size=3, stride=1, **factory):
        super().__init__()
        kt, kh, kw = _triple(kernel_size)
        # F.pad order: (W left, W right, H top, H bottom, T front, T back)
        self.pad = (kw // 2, kw // 2, kh // 2, kh // 2, kt - 1, 0)
        self.conv = Conv3d(in_channels, out_channels, (kt, kh, kw), stride=_triple(stride), **factory)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if any(self.pad):
            x = F.pad(x, self.pad, mode="replicate")
        return self.conv(x)

    def forward_strips(self, cp, xs):
        """Each strip with its halo rows (k // 2 above, k - stride - k // 2
        below), padded in T and W, then convolved: the unsharded conv's
        output rows of that strip."""
        if cp.n == 1:
            return [cp.on(self, r)(x) for r, x in enumerate(xs)]
        kh, sh = self.conv.kernel_size[1], self.conv.stride[1]
        if any(x.shape[3] % sh for x in xs):
            raise ValueError(f"strips of {xs[0].shape[3]} rows under a height stride of {sh}")
        pad = self.pad[:2] + (0, 0) + self.pad[4:]
        xs = cp.halo(xs, kh // 2, kh - sh - kh // 2)
        return [cp.on(self, r).conv(F.pad(x, pad, mode="replicate") if any(pad) else x) for r, x in enumerate(xs)]


class GroupNorm(nn.Module):
    def __init__(self, num_channels: int, num_groups: int = 32, eps: float = 1e-6, **factory):
        super().__init__()
        self.num_groups = num_groups
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(num_channels, **factory))
        self.bias = nn.Parameter(torch.zeros(num_channels, **factory))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return group_norm(x, self.num_groups, self.weight, self.bias, self.eps)

    def forward_strips(self, cp, xs):
        """The norm with each group's mean and variance over the whole
        height (``cp.group_moments``), applied as ``F.group_norm`` applies
        its statistics: x * a + b in fp32 with a = rstd * weight and
        b = bias - mean * a per channel, rounded once."""
        if cp.n == 1:
            return [cp.on(self, r)(x) for r, x in enumerate(xs)]
        means, vars_ = cp.group_moments(xs, self.num_groups)
        out = []
        for r, (x, mean, var) in enumerate(zip(xs, means, vars_)):
            own = cp.on(self, r)
            a = torch.rsqrt(var + self.eps) * own.weight.float().reshape(self.num_groups, -1)  # (B, G, C / G)
            b = own.bias.float().reshape(self.num_groups, -1) - mean * a
            y = x.float().reshape(*a.shape, -1) * a[..., None] + b[..., None]
            out.append(y.reshape(x.shape).to(x.dtype))
        return out


def upsample_nearest_causal(x: torch.Tensor, factor: Tuple[int, int, int]) -> torch.Tensor:
    """Nearest-neighbour upsample of (B, C, T, H, W); the first frame only
    upsamples spatially, so causal latents map back to image-frame-first."""
    ft, fh, fw = factor
    first = F.interpolate(x[:, :, :1], scale_factor=(1, fh, fw), mode="nearest")
    if x.shape[2] == 1:
        return first
    rest = F.interpolate(x[:, :, 1:], scale_factor=(ft, fh, fw), mode="nearest")
    return torch.cat([first, rest], dim=2)


class UpsampleCausal3D(nn.Module):
    def __init__(self, channels: int, upsample_factor=(2, 2, 2), **factory):
        super().__init__()
        self.upsample_factor = tuple(upsample_factor)
        self.conv = CausalConv3d(channels, channels, 3, 1, **factory)

    def forward(self, x):
        return self.conv(upsample_nearest_causal(x, self.upsample_factor))

    def forward_strips(self, cp, xs):
        return self.conv.forward_strips(cp, [upsample_nearest_causal(x, self.upsample_factor) for x in xs])


class ResnetBlockCausal3D(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, groups: int = 32, eps: float = 1e-6,
                 **factory):
        super().__init__()
        self.norm1 = GroupNorm(in_channels, groups, eps, **factory)
        self.conv1 = CausalConv3d(in_channels, out_channels, 3, 1, **factory)
        self.norm2 = GroupNorm(out_channels, groups, eps, **factory)
        self.conv2 = CausalConv3d(out_channels, out_channels, 3, 1, **factory)
        if in_channels != out_channels:
            self.conv_shortcut = CausalConv3d(in_channels, out_channels, 1, 1, **factory)

    def forward(self, x):
        return self.forward_strips(ONE_STRIP, [x])[0]

    def forward_strips(self, cp, xs):
        h = self.conv1.forward_strips(cp, [F.silu(y) for y in self.norm1.forward_strips(cp, xs)])
        h = self.conv2.forward_strips(cp, [F.silu(y) for y in self.norm2.forward_strips(cp, h)])
        if hasattr(self, "conv_shortcut"):
            xs = self.conv_shortcut.forward_strips(cp, xs)
        return [x + y for x, y in zip(xs, h)]


class CausalAttention(nn.Module):
    """One-head self-attention over the flattened T*H*W tokens with a
    frame-causal mask: group norm -> q, k, v -> attention -> out-proj ->
    residual. ``attn_backend`` None runs the flash kernel (bf16 on a card);
    "xla", the plain attention (any dtype, e.g. an fp32 check)."""

    def __init__(self, channels: int, num_groups: int = 32, eps: float = 1e-6, attn_backend: Optional[str] = None,
                 **factory):
        super().__init__()
        self.attn_backend = attn_backend
        self.group_norm = GroupNorm(channels, num_groups, eps, **factory)
        self.to_q = Linear(channels, channels, **factory)
        self.to_k = Linear(channels, channels, **factory)
        self.to_v = Linear(channels, channels, **factory)
        self.to_out = nn.ModuleList([Linear(channels, channels, **factory)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self._attend(self.group_norm(x)) + x

    def _attend(self, normed: torch.Tensor) -> torch.Tensor:
        """The attention of the normalized activation, (B, C, T, H, W) in
        and out, before the residual."""
        b, c, t, h, w = normed.shape
        y = normed.flatten(2).transpose(1, 2)  # (B, T*H*W, C)
        q, k, v = (proj(y)[:, None].contiguous() for proj in (self.to_q, self.to_k, self.to_v))
        out = scaled_dot_product_attention(q, k, v, causal_block=h * w, backend=self.attn_backend)[:, 0]
        out = self.to_out[0](out)
        return out.transpose(1, 2).reshape(b, c, t, h, w)

    def forward_strips(self, cp, xs):
        """The normalized strips gathered along H, attended once per
        distinct device over the full height, each rank's rows cut back
        out."""
        if cp.n == 1:
            return [cp.on(self, r)(x) for r, x in enumerate(xs)]
        outs = cp.gathered(lambda full, r: cp.on(self, r)._attend(full), self.group_norm.forward_strips(cp, xs))
        return [o + x for o, x in zip(outs, xs)]


class UNetMidBlockCausal3D(nn.Module):
    def __init__(self, channels: int, num_groups: int = 32, eps: float = 1e-6,
                 add_attention: bool = True, num_layers: int = 1, attn_backend: Optional[str] = None, **factory):
        super().__init__()
        self.resnets = nn.ModuleList(
            ResnetBlockCausal3D(channels, channels, num_groups, eps, **factory) for _ in range(num_layers + 1)
        )
        self.attentions = nn.ModuleList(
            CausalAttention(channels, num_groups, eps, attn_backend, **factory)
            for _ in range(num_layers if add_attention else 0)
        )

    def forward(self, x):
        return self.forward_strips(ONE_STRIP, [x])[0]

    def forward_strips(self, cp, xs):
        xs = self.resnets[0].forward_strips(cp, xs)
        for i, resnet in enumerate(self.resnets[1:]):
            if len(self.attentions):
                xs = self.attentions[i].forward_strips(cp, xs)
            xs = resnet.forward_strips(cp, xs)
        return xs


class DownsampleCausal3D(nn.Module):
    def __init__(self, channels: int, stride=(2, 2, 2), **factory):
        super().__init__()
        self.conv = CausalConv3d(channels, channels, 3, stride, **factory)

    def forward(self, x):
        return self.conv(x)

    def forward_strips(self, cp, xs):
        return self.conv.forward_strips(cp, xs)


class DownEncoderBlockCausal3D(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, num_layers: int = 2,
                 add_downsample: bool = True, downsample_stride=(2, 2, 2), num_groups: int = 32,
                 eps: float = 1e-6, **factory):
        super().__init__()
        self.resnets = nn.ModuleList(
            ResnetBlockCausal3D(in_channels if i == 0 else out_channels, out_channels, num_groups, eps, **factory)
            for i in range(num_layers)
        )
        self.downsamplers = nn.ModuleList(
            [DownsampleCausal3D(out_channels, downsample_stride, **factory)] if add_downsample else []
        )

    def forward(self, x):
        return self.forward_strips(ONE_STRIP, [x])[0]

    def forward_strips(self, cp, xs):
        for resnet in self.resnets:
            xs = resnet.forward_strips(cp, xs)
        for down in self.downsamplers:
            xs = down.forward_strips(cp, xs)
        return xs


class UpDecoderBlockCausal3D(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, num_layers: int = 3,
                 add_upsample: bool = True, upsample_scale_factor=(2, 2, 2), num_groups: int = 32,
                 eps: float = 1e-6, **factory):
        super().__init__()
        self.resnets = nn.ModuleList(
            ResnetBlockCausal3D(in_channels if i == 0 else out_channels, out_channels, num_groups, eps, **factory)
            for i in range(num_layers)
        )
        self.upsamplers = nn.ModuleList(
            [UpsampleCausal3D(out_channels, upsample_scale_factor, **factory)] if add_upsample else []
        )

    def forward(self, x):
        return self.forward_strips(ONE_STRIP, [x])[0]

    def forward_strips(self, cp, xs):
        for resnet in self.resnets:
            xs = resnet.forward_strips(cp, xs)
        for up in self.upsamplers:
            xs = up.forward_strips(cp, xs)
        return xs
