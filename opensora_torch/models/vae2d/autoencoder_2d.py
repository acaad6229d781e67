"""The Flux 2D image KL-VAE (8x spatial, 16 latent channels) of the t2i2v
image stage (counterpart of opensora_tpu/models/vae2d/autoencoder_2d.py).

Layout NCHW; module names follow upstream Flux's ``ae.safetensors``
(``encoder.down.{i}.block.{j}``, ``.downsample.conv``, ``mid.block_1``,
``mid.attn_1``, ``decoder.up.{i}.upsample.conv``). A (B, C, T, H, W) clip
is folded into (B*T, C, H, W) images at the boundary. Parameters are kept
in ``param_dtype`` (fp32 by default, as in the JAX module) and cast to the
compute ``dtype`` at use (``models/cast_layers.py``). The mid-block
attention is the JAX module's plain fp32 product and softmax over all
H*W tokens, one head of the full channel width.
"""

from __future__ import annotations

import functools
import math
from dataclasses import dataclass, field
from typing import Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from opensora_torch.models.cast_layers import Conv2d
from opensora_torch.models.hunyuan_vae.model import DiagonalGaussianDistribution
from opensora_torch.registry import MODELS


@dataclass
class AutoEncoderConfig:
    from_pretrained: Optional[str] = None
    resolution: int = 256
    in_channels: int = 3
    ch: int = 128
    out_ch: int = 3
    ch_mult: Sequence[int] = field(default_factory=lambda: [1, 2, 4, 4])
    num_res_blocks: int = 2
    z_channels: int = 16
    scale_factor: float = 0.3611
    shift_factor: float = 0.1159
    dtype: str = "bf16"
    param_dtype: str = "fp32"


class GroupNorm2D(nn.Module):
    """32 groups (fewer where the width is smaller), statistics and affine
    in fp32, the result in the input's dtype."""

    def __init__(self, channels: int, num_groups: int = 32, eps: float = 1e-6, **factory):
        super().__init__()
        self.num_groups = min(num_groups, channels)
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(channels, **factory))
        self.bias = nn.Parameter(torch.zeros(channels, **factory))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.group_norm(x.float(), self.num_groups, self.weight.float(), self.bias.float(), self.eps).to(x.dtype)


class ResnetBlock(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, **factory):
        super().__init__()
        self.norm1 = GroupNorm2D(in_channels, **factory)
        self.conv1 = Conv2d(in_channels, out_channels, 3, padding=1, **factory)
        self.norm2 = GroupNorm2D(out_channels, **factory)
        self.conv2 = Conv2d(out_channels, out_channels, 3, padding=1, **factory)
        if in_channels != out_channels:
            self.nin_shortcut = Conv2d(in_channels, out_channels, 1, **factory)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.conv1(F.silu(self.norm1(x)))
        h = self.conv2(F.silu(self.norm2(h)))
        if hasattr(self, "nin_shortcut"):
            x = self.nin_shortcut(x)
        return x + h


class AttnBlock(nn.Module):
    def __init__(self, channels: int, **factory):
        super().__init__()
        self.norm = GroupNorm2D(channels, **factory)
        self.q = Conv2d(channels, channels, 1, **factory)
        self.k = Conv2d(channels, channels, 1, **factory)
        self.v = Conv2d(channels, channels, 1, **factory)
        self.proj_out = Conv2d(channels, channels, 1, **factory)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, c, h, w = x.shape
        y = self.norm(x)
        q, k, v = (m(y).flatten(2).transpose(1, 2).float() for m in (self.q, self.k, self.v))  # (b, hw, c)
        s = torch.softmax(q @ k.transpose(1, 2) / math.sqrt(c), dim=-1)
        out = (s @ v).to(x.dtype).transpose(1, 2).reshape(b, c, h, w)
        return x + self.proj_out(out)


class Downsample(nn.Module):
    """Pad one row and column at the bottom/right, then a stride-2 3x3 conv."""

    def __init__(self, channels: int, **factory):
        super().__init__()
        self.conv = Conv2d(channels, channels, 3, stride=2, **factory)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(F.pad(x, (0, 1, 0, 1)))


class Upsample(nn.Module):
    """Nearest x2, then a 3x3 conv."""

    def __init__(self, channels: int, **factory):
        super().__init__()
        self.conv = Conv2d(channels, channels, 3, padding=1, **factory)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(F.interpolate(x, scale_factor=2.0, mode="nearest"))


def _mid(channels: int, **factory) -> nn.Module:
    mid = nn.Module()
    mid.block_1 = ResnetBlock(channels, channels, **factory)
    mid.attn_1 = AttnBlock(channels, **factory)
    mid.block_2 = ResnetBlock(channels, channels, **factory)
    return mid


def _run_mid(mid: nn.Module, h: torch.Tensor) -> torch.Tensor:
    return mid.block_2(mid.attn_1(mid.block_1(h)))


class Encoder2D(nn.Module):
    def __init__(self, cfg: AutoEncoderConfig, **factory):
        super().__init__()
        self.conv_in = Conv2d(cfg.in_channels, cfg.ch, 3, padding=1, **factory)
        self.down = nn.ModuleList()
        ch = cfg.ch
        for i, mult in enumerate(cfg.ch_mult):
            level = nn.Module()
            level.block = nn.ModuleList()
            for _ in range(cfg.num_res_blocks):
                level.block.append(ResnetBlock(ch, cfg.ch * mult, **factory))
                ch = cfg.ch * mult
            if i != len(cfg.ch_mult) - 1:
                level.downsample = Downsample(ch, **factory)
            self.down.append(level)
        self.mid = _mid(ch, **factory)
        self.norm_out = GroupNorm2D(ch, **factory)
        self.conv_out = Conv2d(ch, 2 * cfg.z_channels, 3, padding=1, **factory)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.conv_in(x)
        for level in self.down:
            for block in level.block:
                h = block(h)
            if hasattr(level, "downsample"):
                h = level.downsample(h)
        h = _run_mid(self.mid, h)
        return self.conv_out(F.silu(self.norm_out(h)))


class Decoder2D(nn.Module):
    def __init__(self, cfg: AutoEncoderConfig, **factory):
        super().__init__()
        ch = cfg.ch * cfg.ch_mult[-1]
        self.conv_in = Conv2d(cfg.z_channels, ch, 3, padding=1, **factory)
        self.mid = _mid(ch, **factory)
        levels = []
        for i in reversed(range(len(cfg.ch_mult))):
            level = nn.Module()
            level.block = nn.ModuleList()
            for _ in range(cfg.num_res_blocks + 1):
                level.block.append(ResnetBlock(ch, cfg.ch * cfg.ch_mult[i], **factory))
                ch = cfg.ch * cfg.ch_mult[i]
            if i != 0:
                level.upsample = Upsample(ch, **factory)
            levels.insert(0, level)
        self.up = nn.ModuleList(levels)  # up[i] is level i, run from the last
        self.norm_out = GroupNorm2D(ch, **factory)
        self.conv_out = Conv2d(ch, cfg.out_ch, 3, padding=1, **factory)

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        h = _run_mid(self.mid, self.conv_in(z))
        for level in reversed(self.up):
            for block in level.block:
                h = block(h)
            if hasattr(level, "upsample"):
                h = level.upsample(h)
        return self.conv_out(F.silu(self.norm_out(h)))


class AutoEncoder2D(nn.Module):
    """``encode``: images (B, C, H, W) or a clip (B, C, T, H, W) -> scaled
    latents of the same rank; ``decode`` the reverse."""

    def __init__(self, config: AutoEncoderConfig, device=None, dtype: Optional[torch.dtype] = None,
                 compute_dtype: Optional[torch.dtype] = None):
        """``dtype``: the parameters'; ``compute_dtype``: the activations'
        (default: the parameters')."""
        super().__init__()
        self.config = config
        self.compute_dtype = compute_dtype
        factory = dict(device=device, dtype=dtype)
        self.encoder = Encoder2D(config, **factory)
        self.decoder = Decoder2D(config, **factory)

    @property
    def dtype(self) -> torch.dtype:
        """The compute dtype: inputs are cast to it."""
        return self.compute_dtype or self.decoder.conv_in.weight.dtype

    @property
    def spatial_compression_ratio(self) -> int:
        return 2 ** (len(self.config.ch_mult) - 1)

    @staticmethod
    def _fold_t(x: torch.Tensor):
        """(B, C, T, H, W) -> (B*T, C, H, W) and T; 4-D input passes with None."""
        if x.dim() == 5:
            b, c, t, h, w = x.shape
            return x.transpose(1, 2).reshape(b * t, c, h, w), t
        return x, None

    @staticmethod
    def _unfold_t(x: torch.Tensor, t: Optional[int]) -> torch.Tensor:
        if t is None:
            return x
        bt, c, h, w = x.shape
        return x.reshape(bt // t, t, c, h, w).transpose(1, 2)

    def encode(self, x: torch.Tensor, generator: Optional[torch.Generator] = None, sample_posterior: bool = True,
               return_posterior: bool = False, noise: Optional[torch.Tensor] = None):
        """A sample of the posterior (noise drawn from ``generator``, or the
        given ``noise`` shaped like the latents), or its mode; scaled and
        shifted."""
        x, t = self._fold_t(x.to(self.dtype))
        posterior = DiagonalGaussianDistribution(self.encoder(x), dim=1)
        if sample_posterior:
            z = posterior.sample(generator, None if noise is None else self._fold_t(noise)[0])
        else:
            z = posterior.mode()
        z = self._unfold_t(self.config.scale_factor * (z - self.config.shift_factor), t)
        return (z, posterior) if return_posterior else z

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        z, t = self._fold_t(z)
        z = (z / self.config.scale_factor + self.config.shift_factor).to(self.dtype)
        return self._unfold_t(self.decoder(z), t)


@MODELS.register_module("autoencoder_2d")
def AutoEncoderFlux(from_pretrained: Optional[str] = None, device=None, **kwargs) -> AutoEncoder2D:
    """Build from a config dict's entries; unknown keys are ignored, as the
    JAX builder ignores them. Weights from the checkpoint ``from_pretrained``
    names (upstream Flux names, e.g. ``ae.safetensors``), else random."""
    from opensora_torch.utils.ckpt import load_checkpoint
    from opensora_torch.utils.misc import torch_dtype

    known = set(AutoEncoderConfig.__dataclass_fields__)
    cfg = AutoEncoderConfig(from_pretrained=from_pretrained, **{k: v for k, v in kwargs.items() if k in known})
    build = functools.partial(AutoEncoder2D, cfg, dtype=torch_dtype(cfg.param_dtype),
                              compute_dtype=torch_dtype(cfg.dtype))
    if from_pretrained:
        return load_checkpoint(build(device="meta"), from_pretrained, "vae2d", device)
    return build(device=device)
