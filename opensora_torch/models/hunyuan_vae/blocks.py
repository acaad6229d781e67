"""Causal 3D conv building blocks of the HunyuanVideo VAE (counterpart of
opensora_tpu/models/hunyuan_vae/blocks.py).

Layout NCTHW (the JAX package works channels-last inside). Temporal
causality is a replicate pad of k - 1 frames on the left only; spatial
padding is a symmetric k // 2 replicate pad. The mid-block attention runs
the flash-attention kernel with the frame-causal mask (``causal_block`` =
H * W tokens per frame) and never builds the L x L mask.

Constructors take the input channel counts that flax infers at init.
"""

from __future__ import annotations

from typing import Sequence, Tuple, Union

import torch
import torch.nn as nn
import torch.nn.functional as F

from opensora_torch.ops.attention import scaled_dot_product_attention
from opensora_torch.ops.norms import group_norm


def _triple(x: Union[int, Sequence[int]]) -> Tuple[int, int, int]:
    return (x, x, x) if isinstance(x, int) else tuple(x)


class CausalConv3d(nn.Module):
    """3D conv with left-only temporal replicate padding."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size=3, stride=1, **factory):
        super().__init__()
        kt, kh, kw = _triple(kernel_size)
        # F.pad order: (W left, W right, H top, H bottom, T front, T back)
        self.pad = (kw // 2, kw // 2, kh // 2, kh // 2, kt - 1, 0)
        self.conv = nn.Conv3d(in_channels, out_channels, (kt, kh, kw), stride=_triple(stride), **factory)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if any(self.pad):
            x = F.pad(x, self.pad, mode="replicate")
        return self.conv(x)


class GroupNorm(nn.Module):
    def __init__(self, num_channels: int, num_groups: int = 32, eps: float = 1e-6, **factory):
        super().__init__()
        self.num_groups = num_groups
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(num_channels, **factory))
        self.bias = nn.Parameter(torch.zeros(num_channels, **factory))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return group_norm(x, self.num_groups, self.weight, self.bias, self.eps)


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
        h = self.conv1(F.silu(self.norm1(x)))
        h = self.conv2(F.silu(self.norm2(h)))
        if hasattr(self, "conv_shortcut"):
            x = self.conv_shortcut(x)
        return x + h


class CausalAttention(nn.Module):
    """One-head self-attention over the flattened T*H*W tokens with a
    frame-causal mask: group norm -> q, k, v -> attention -> out-proj ->
    residual."""

    def __init__(self, channels: int, num_groups: int = 32, eps: float = 1e-6, **factory):
        super().__init__()
        self.group_norm = GroupNorm(channels, num_groups, eps, **factory)
        self.to_q = nn.Linear(channels, channels, **factory)
        self.to_k = nn.Linear(channels, channels, **factory)
        self.to_v = nn.Linear(channels, channels, **factory)
        self.to_out = nn.ModuleList([nn.Linear(channels, channels, **factory)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, c, t, h, w = x.shape
        y = self.group_norm(x).flatten(2).transpose(1, 2)  # (B, T*H*W, C)
        q, k, v = (proj(y)[:, None].contiguous() for proj in (self.to_q, self.to_k, self.to_v))
        out = scaled_dot_product_attention(q, k, v, causal_block=h * w)[:, 0]
        out = self.to_out[0](out)
        return out.transpose(1, 2).reshape(b, c, t, h, w) + x


class UNetMidBlockCausal3D(nn.Module):
    def __init__(self, channels: int, num_groups: int = 32, eps: float = 1e-6,
                 add_attention: bool = True, num_layers: int = 1, **factory):
        super().__init__()
        self.resnets = nn.ModuleList(
            ResnetBlockCausal3D(channels, channels, num_groups, eps, **factory) for _ in range(num_layers + 1)
        )
        self.attentions = nn.ModuleList(
            CausalAttention(channels, num_groups, eps, **factory) for _ in range(num_layers if add_attention else 0)
        )

    def forward(self, x):
        x = self.resnets[0](x)
        for i, resnet in enumerate(self.resnets[1:]):
            if len(self.attentions):
                x = self.attentions[i](x)
            x = resnet(x)
        return x


class DownsampleCausal3D(nn.Module):
    def __init__(self, channels: int, stride=(2, 2, 2), **factory):
        super().__init__()
        self.conv = CausalConv3d(channels, channels, 3, stride, **factory)

    def forward(self, x):
        return self.conv(x)


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
        for resnet in self.resnets:
            x = resnet(x)
        for down in self.downsamplers:
            x = down(x)
        return x


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
        for resnet in self.resnets:
            x = resnet(x)
        for up in self.upsamplers:
            x = up(x)
        return x
