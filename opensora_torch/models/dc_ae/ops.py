"""Building blocks of the Video DC-AE (counterpart of
opensora_tpu/models/dc_ae/ops.py): norms and activations, pixel
(un)shuffle in 2D and 3D, ``ConvLayer`` and the down/up-sample layers,
``ResBlock``, ``GLUMBConv``, ``LiteMLA`` and ``EfficientViTBlock``, with the
residual wrappers that give upstream's state-dict names (``ResidualBlock``
-> ``main``, ``OpSequential`` -> ``op_list``).

Layout: images (B, C, H, W), videos (B, C, T, H, W); the JAX package works
channels-last inside, and every channel order here (pixel shuffles, the
channel-averaging and channel-duplicating shortcuts, LiteMLA's heads) is
the JAX package's. Convolutions pad as flax's "SAME" does: k // 2 on both
sides at stride 1, and (0, 1) along a dimension of stride 2 and kernel 3
(upstream pads 1 on both sides there). Parameters may be kept in another
dtype than the activations (``models/cast_layers.py``). LiteMLA's linear
attention runs in fp32 whatever the compute dtype, as in the JAX package;
its products are plain ``torch.matmul``.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from opensora_torch.models.cast_layers import Conv2d, Conv3d

# ----------------------------------------------------------------------
# norms / acts
# ----------------------------------------------------------------------


def _channel_shape(x: torch.Tensor) -> Tuple[int, ...]:
    return (1, x.shape[1]) + (1,) * (x.dim() - 2)


class RMSNormND(nn.Module):
    """rms2d / rms3d: RMS over the channel dim (fp32 statistics), affine
    weight and bias in the input's dtype."""

    def __init__(self, num_features: int, eps: float = 1e-5, **factory):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(num_features, **factory))
        self.bias = nn.Parameter(torch.zeros(num_features, **factory))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        y = (xf / torch.sqrt(xf.pow(2).mean(dim=1, keepdim=True) + self.eps)).to(x.dtype)
        shape = _channel_shape(x)
        return y * self.weight.to(x.dtype).reshape(shape) + self.bias.to(x.dtype).reshape(shape)


class LayerNormND(nn.Module):
    """ln2d: mean and variance over the channel dim."""

    def __init__(self, num_features: int, eps: float = 1e-5, **factory):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(num_features, **factory))
        self.bias = nn.Parameter(torch.zeros(num_features, **factory))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        out = xf - xf.mean(dim=1, keepdim=True)
        out = (out / torch.sqrt(out.pow(2).mean(dim=1, keepdim=True) + self.eps)).to(x.dtype)
        shape = _channel_shape(x)
        return out * self.weight.to(x.dtype).reshape(shape) + self.bias.to(x.dtype).reshape(shape)


def build_norm(name: Optional[str], num_features: int, **factory) -> Optional[nn.Module]:
    if name is None:
        return None
    if name in ("rms2d", "rms3d"):
        return RMSNormND(num_features, **factory)
    if name in ("ln", "ln2d"):
        return LayerNormND(num_features, **factory)
    raise ValueError(f"norm {name!r} not supported")


def build_act(name: Optional[str]) -> Optional[nn.Module]:
    if name is None:
        return None
    return {
        "silu": nn.SiLU,
        "swish": nn.SiLU,
        "relu": nn.ReLU,
        "relu6": nn.ReLU6,
        "gelu": lambda: nn.GELU(approximate="tanh"),
    }[name]()


# ----------------------------------------------------------------------
# pixel shuffle, channels-first; channel orders as torch's pixel_(un)shuffle
# ----------------------------------------------------------------------


def pixel_unshuffle_2d(x: torch.Tensor, r: int) -> torch.Tensor:
    """(B, C, [T,] H, W) -> (B, C r^2, [T,] H / r, W / r), channel order
    (C, rh, rw)."""
    if r == 1:
        return x
    b, c, *mid, h, w = x.shape
    nm = len(mid)
    x = x.reshape(b, c, *mid, h // r, r, w // r, r)
    x = x.permute(0, 1, 3 + nm, 5 + nm, *range(2, 2 + nm), 2 + nm, 4 + nm)
    return x.reshape(b, c * r * r, *mid, h // r, w // r)


def pixel_shuffle_2d(x: torch.Tensor, r: int) -> torch.Tensor:
    """Inverse of :func:`pixel_unshuffle_2d`."""
    if r == 1:
        return x
    b, c, *mid, h, w = x.shape
    nm = len(mid)
    x = x.reshape(b, c // (r * r), r, r, *mid, h, w)
    x = x.permute(0, 1, *range(4, 4 + nm), 4 + nm, 2, 5 + nm, 3)
    return x.reshape(b, c // (r * r), *mid, h * r, w * r)


def pixel_unshuffle_3d(x: torch.Tensor, r: int) -> torch.Tensor:
    """(B, C, T, H, W) -> (B, C r^3, T / r, H / r, W / r), channel order
    (C, rt, rh, rw)."""
    b, c, t, h, w = x.shape
    x = x.reshape(b, c, t // r, r, h // r, r, w // r, r).permute(0, 1, 3, 5, 7, 2, 4, 6)
    return x.reshape(b, c * r**3, t // r, h // r, w // r)


def pixel_shuffle_3d(x: torch.Tensor, r: int) -> torch.Tensor:
    b, c, t, h, w = x.shape
    cn = c // r**3
    x = x.reshape(b, cn, r, r, r, t, h, w).permute(0, 1, 5, 2, 6, 3, 7, 4)
    return x.reshape(b, cn, t * r, h * r, w * r)


# ----------------------------------------------------------------------
# containers with upstream's names
# ----------------------------------------------------------------------


class ResidualBlock(nn.Module):
    """main(x) + shortcut(x), the identity when no shortcut is given."""

    def __init__(self, main: nn.Module, shortcut: Optional[nn.Module] = None):
        super().__init__()
        self.main = main
        self.shortcut = shortcut

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.main(x) + (x if self.shortcut is None else self.shortcut(x))


class OpSequential(nn.Module):
    def __init__(self, ops: Sequence[nn.Module]):
        super().__init__()
        self.op_list = nn.ModuleList(ops)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for op in self.op_list:
            x = op(x)
        return x


# ----------------------------------------------------------------------
# conv layers
# ----------------------------------------------------------------------


def _same_pad(x: torch.Tensor, kernel: Tuple[int, ...], stride: Tuple[int, ...]) -> torch.Tensor:
    """Zero padding as flax's "SAME": ceil(n / s) outputs per dim, the extra
    pad after."""
    pads = []
    for n, k, s in zip(reversed(x.shape[2:]), reversed(kernel), reversed(stride)):
        total = max((math.ceil(n / s) - 1) * s + k - n, 0)
        pads += [total // 2, total - total // 2]
    return F.pad(x, pads) if any(pads) else x


class ConvLayer(nn.Module):
    """conv -> norm -> act, "SAME" padding, optional groups."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int = 3, stride=1, groups: int = 1,
                 use_bias: bool = False, norm: Optional[str] = None, act_func: Optional[str] = None,
                 is_video: bool = False, **factory):
        super().__init__()
        nd = 3 if is_video else 2
        self.kernel = (kernel_size,) * nd
        self.stride = tuple(stride) if isinstance(stride, (tuple, list)) else (stride,) * nd
        # stride 1: the symmetric pad goes into the conv; otherwise _same_pad
        self.pad_outside = any(s != 1 for s in self.stride)
        conv = Conv3d if is_video else Conv2d
        self.conv = conv(in_channels, out_channels, kernel_size, stride=self.stride,
                         padding=0 if self.pad_outside else kernel_size // 2, groups=groups, bias=use_bias,
                         **factory)
        self.norm = build_norm(norm, out_channels, **factory)
        self.act = build_act(act_func)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.pad_outside:
            x = _same_pad(x, self.kernel, self.stride)
        x = self.conv(x)
        if self.norm is not None:
            x = self.norm(x)
        if self.act is not None:
            x = self.act(x)
        return x


class ConvPixelUnshuffleDownSampleLayer(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, kernel_size: int = 3, factor: int = 2, **factory):
        super().__init__()
        assert out_channels % factor**2 == 0
        self.factor = factor
        self.conv = ConvLayer(in_channels, out_channels // factor**2, kernel_size, 1, use_bias=True, **factory)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return pixel_unshuffle_2d(self.conv(x), self.factor)


class PixelUnshuffleChannelAveragingDownSampleLayer(nn.Module):
    """Parameter-free downsample shortcut: pixel unshuffle, then the mean
    over groups of consecutive channels."""

    def __init__(self, in_channels: int, out_channels: int, factor: int = 2, temporal_downsample: bool = False):
        super().__init__()
        self.in_channels, self.out_channels = in_channels, out_channels
        self.factor, self.temporal_downsample = factor, temporal_downsample

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        r = self.factor
        if x.dim() == 5 and self.temporal_downsample and x.shape[2] != 1:
            x, group = pixel_unshuffle_3d(x, r), self.in_channels * r**3 // self.out_channels
        else:
            assert self.in_channels * r**2 % self.out_channels == 0
            x, group = pixel_unshuffle_2d(x, r), self.in_channels * r**2 // self.out_channels
        return x.reshape(x.shape[0], self.out_channels, group, *x.shape[2:]).mean(dim=2)


class ConvPixelShuffleUpSampleLayer(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, kernel_size: int = 3, factor: int = 2, **factory):
        super().__init__()
        self.factor = factor
        self.conv = ConvLayer(in_channels, out_channels * factor**2, kernel_size, 1, use_bias=True, **factory)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return pixel_shuffle_2d(self.conv(x), self.factor)


class ChannelDuplicatingPixelShuffleUpSampleLayer(nn.Module):
    """Parameter-free upsample shortcut: each channel repeated, then pixel
    shuffle."""

    def __init__(self, in_channels: int, out_channels: int, factor: int = 2, temporal_upsample: bool = False):
        super().__init__()
        self.in_channels, self.out_channels = in_channels, out_channels
        self.factor, self.temporal_upsample = factor, temporal_upsample

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        r = self.factor
        three_d = x.dim() == 5 and self.temporal_upsample and x.shape[2] != 1
        repeats = self.out_channels * r ** (3 if three_d else 2) // self.in_channels
        x = x.repeat_interleave(repeats, dim=1)
        return pixel_shuffle_3d(x, r) if three_d else pixel_shuffle_2d(x, r)


class InterpolateConvUpSampleLayer(nn.Module):
    """Nearest upsample (in T too with ``temporal_upsample``, unless T is 1),
    then a conv."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int = 3, factor: int = 2,
                 is_video: bool = False, temporal_upsample: bool = False, **factory):
        super().__init__()
        self.factor, self.temporal_upsample = factor, temporal_upsample
        self.conv = ConvLayer(in_channels, out_channels, kernel_size, 1, use_bias=True, is_video=is_video, **factory)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        r = self.factor
        if x.dim() == 4:
            scale: Tuple[int, ...] = (r, r)
        else:
            scale = (r if self.temporal_upsample and x.shape[2] != 1 else 1, r, r)
        return self.conv(F.interpolate(x, scale_factor=scale, mode="nearest"))


# ----------------------------------------------------------------------
# blocks
# ----------------------------------------------------------------------


class ResBlock(nn.Module):
    """conv-norm-act sandwich (the residual add is a ``ResidualBlock``)."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int = 3,
                 norm=(None, "rms3d"), act_func=("silu", None), use_bias=(True, False), is_video: bool = False,
                 **factory):
        super().__init__()
        common = dict(is_video=is_video, **factory)
        self.conv1 = ConvLayer(in_channels, out_channels, kernel_size, 1, use_bias=use_bias[0], norm=norm[0],
                               act_func=act_func[0], **common)
        self.conv2 = ConvLayer(out_channels, out_channels, kernel_size, 1, use_bias=use_bias[1], norm=norm[1],
                               act_func=act_func[1], **common)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv2(self.conv1(x))


class GLUMBConv(nn.Module):
    """Gated inverted bottleneck with a depthwise conv."""

    def __init__(self, in_channels: int, out_channels: int, expand_ratio: float = 6, kernel_size: int = 3,
                 norm=(None, None, "ln2d"), act_func=("silu", "silu", None), is_video: bool = False, **factory):
        super().__init__()
        mid = round(in_channels * expand_ratio)
        common = dict(is_video=is_video, **factory)
        self.inverted_conv = ConvLayer(in_channels, 2 * mid, 1, 1, use_bias=False, norm=norm[0],
                                       act_func=act_func[0], **common)
        self.depth_conv = ConvLayer(2 * mid, 2 * mid, kernel_size, 1, groups=2 * mid, use_bias=False,
                                    norm=norm[1], **common)
        self.point_conv = ConvLayer(mid, out_channels, 1, 1, use_bias=False, norm=norm[2], act_func=act_func[2],
                                    **common)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x, gate = self.depth_conv(self.inverted_conv(x)).chunk(2, dim=1)
        return self.point_conv(x * F.silu(gate))


class LiteMLA(nn.Module):
    """Multi-scale linear ReLU attention. The attention itself is an fp32
    island: ReLU q and k, v padded with a row of ones, vk = v k^T summed
    over tokens, out = vk q divided by its last row."""

    def __init__(self, in_channels: int, out_channels: int, dim: int = 8, scales: Sequence[int] = (5,),
                 norm=(None, "rms3d"), eps: float = 1e-15, is_video: bool = False, **factory):
        super().__init__()
        heads = in_channels // dim
        total = heads * dim
        self.dim, self.eps = dim, eps
        common = dict(is_video=is_video, **factory)
        self.qkv = ConvLayer(in_channels, 3 * total, 1, 1, use_bias=False, **common)
        conv = Conv3d if is_video else Conv2d
        self.aggreg = nn.ModuleList(
            nn.Sequential(
                conv(3 * total, 3 * total, s, padding=s // 2, groups=3 * total, bias=False, **factory),
                conv(3 * total, 3 * total, 1, groups=3 * heads, bias=False, **factory),
            )
            for s in scales
        )
        self.proj = ConvLayer(total * (1 + len(scales)), out_channels, 1, 1, use_bias=False, norm=norm[1],
                              **common)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        qkv = self.qkv(x)
        qkv = torch.cat([qkv] + [agg(qkv) for agg in self.aggreg], dim=1)
        b, spatial, d = qkv.shape[0], qkv.shape[2:], self.dim
        qkv = qkv.float().reshape(b, -1, 3 * d, math.prod(spatial))  # (B, heads, 3 d, N)
        q, k, v = F.relu(qkv[:, :, :d]), F.relu(qkv[:, :, d:2 * d]), qkv[:, :, 2 * d:]
        v = torch.cat([v, torch.ones_like(v[:, :, :1])], dim=2)
        out = torch.matmul(torch.matmul(v, k.transpose(-1, -2)), q)  # (B, heads, d + 1, N)
        out = out[:, :, :-1] / (out[:, :, -1:] + self.eps)
        return self.proj(out.reshape(b, -1, *spatial).to(x.dtype))


class EfficientViTBlock(nn.Module):
    """LiteMLA then GLUMBConv, each residual."""

    def __init__(self, in_channels: int, scales: Sequence[int] = (5,), norm: str = "rms3d", act_func: str = "silu",
                 is_video: bool = False, **factory):
        super().__init__()
        self.context_module = ResidualBlock(LiteMLA(in_channels, in_channels, scales=tuple(scales),
                                                    norm=(None, norm), is_video=is_video, **factory))
        self.local_module = ResidualBlock(GLUMBConv(in_channels, in_channels, expand_ratio=4,
                                                    norm=(None, None, norm), act_func=(act_func, act_func, None),
                                                    is_video=is_video, **factory))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.local_module(self.context_module(x))
