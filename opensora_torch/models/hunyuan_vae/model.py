"""HunyuanVideo causal 3D KL-VAE (counterpart of
opensora_tpu/models/hunyuan_vae/model.py): 4x in T, 8x in H/W, 16 latent
channels; the first latent frame is a pure-image frame.

Both sides: ``EncoderCausal3D`` + ``quant_conv`` with the diagonal
Gaussian posterior, and ``post_quant_conv`` + ``DecoderCausal3D``, the
scale/shift, and the module-level spatial and temporal tiling with the
linear overlap blend. Eager PyTorch already runs tile by tile, so the JAX
package's host-level tile runner (``tiled.py``) has no counterpart.

``forward`` is the training forward, ``(x_rec, posterior, z)``, with the
posterior's noise drawn from a generator or given. ``param_dtype`` keeps
the parameters in another dtype than the compute ``dtype`` (fp32 master
weights under bf16 compute, the JAX modules' default, which VAE training
asks for); left unset, the parameters are in the compute dtype, as the
inference and LoRA paths build them.

The encoder runs sample by sample (the same values as one batched call):
at the 256px 129-frame training bucket one activation of its first stage
is 2.1 GB per sample in bf16, and a batch of three would hold several such
tensors at once beside the resident models.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from opensora_torch.models.cast_layers import Conv3d
from opensora_torch.models.hunyuan_vae.blocks import (
    CausalConv3d,
    DownEncoderBlockCausal3D,
    GroupNorm,
    UNetMidBlockCausal3D,
    UpDecoderBlockCausal3D,
)
from opensora_torch.registry import MODELS


@dataclass
class AutoEncoder3DConfig:
    from_pretrained: Optional[str] = None
    in_channels: int = 3
    out_channels: int = 3
    latent_channels: int = 16
    layers_per_block: int = 2
    norm_num_groups: int = 32
    scale_factor: float = 0.476986
    shift_factor: float = 0.0
    time_compression_ratio: int = 4
    spatial_compression_ratio: int = 8
    mid_block_add_attention: bool = True
    block_out_channels: Sequence[int] = field(default_factory=lambda: (128, 256, 512, 512))
    sample_size: int = 256
    sample_tsize: int = 64
    use_spatial_tiling: bool = False
    use_temporal_tiling: bool = False
    tile_overlap_factor: float = 0.25
    dtype: str = "bf16"
    param_dtype: Optional[str] = None  # None: the compute dtype


def blend_tiles(a: torch.Tensor, b: torch.Tensor, extent: int, dim: int) -> torch.Tensor:
    """Linear overlap blend of the tail of ``a`` into the head of ``b``."""
    extent = min(a.shape[dim], b.shape[dim], extent)
    if extent == 0:
        return b
    shape = [1] * b.dim()
    shape[dim] = extent
    ramp = (torch.arange(extent, dtype=torch.float32, device=b.device) / extent).reshape(shape)
    a_tail = a.narrow(dim, a.shape[dim] - extent, extent).float()
    b_head = b.narrow(dim, 0, extent).float()
    blended = (a_tail * (1 - ramp) + b_head * ramp).to(b.dtype)
    return torch.cat([blended, b.narrow(dim, extent, b.shape[dim] - extent)], dim=dim)


class DiagonalGaussianDistribution:
    """The latent posterior over moments (B, 2C, ...) split on ``dim``."""

    def __init__(self, parameters: torch.Tensor, dim: int = 1):
        self.mean, self.logvar = parameters.chunk(2, dim=dim)
        self.logvar = self.logvar.clamp(-30.0, 20.0)
        self.std = torch.exp(0.5 * self.logvar)
        self.var = torch.exp(self.logvar)

    def sample(self, generator: Optional[torch.Generator] = None, noise: Optional[torch.Tensor] = None) -> torch.Tensor:
        """mean + std * noise; the noise (fp32) is drawn from ``generator``
        unless given."""
        if noise is None:
            noise = torch.randn(self.mean.shape, generator=generator, device=self.mean.device, dtype=torch.float32)
        return self.mean + self.std * noise.to(self.mean.dtype)

    def mode(self) -> torch.Tensor:
        return self.mean

    def kl(self) -> torch.Tensor:
        """KL to N(0, I) per sample (B,), fp32."""
        m = self.mean.float()
        return 0.5 * (m * m + self.var.float() - 1.0 - self.logvar.float()).sum(dim=tuple(range(1, m.dim())))

    def nll(self, sample: torch.Tensor, dims=(1, 2, 3)) -> torch.Tensor:
        """Negative log-likelihood of ``sample``, summed over ``dims``."""
        s, m = sample.float(), self.mean.float()
        return 0.5 * (math.log(2.0 * math.pi) + self.logvar.float() + (s - m) ** 2 / self.var.float()).sum(dim=dims)


def _block_strides(cfg: AutoEncoder3DConfig, i: int) -> Tuple[bool, Tuple[int, int, int]]:
    """Stride schedule from the compression ratios (the same for the
    encoder's down blocks and the decoder's up blocks)."""
    n = len(cfg.block_out_channels)
    is_final = i == n - 1
    n_spatial = int(np.log2(cfg.spatial_compression_ratio))
    n_time = int(np.log2(cfg.time_compression_ratio))
    if cfg.time_compression_ratio == 4:
        add_spatial = i < n_spatial
        add_time = i >= (n - 1 - n_time) and not is_final
    elif cfg.time_compression_ratio == 8:
        add_spatial = i < n_spatial
        add_time = i < n_spatial
    else:
        raise ValueError(f"Unsupported time_compression_ratio {cfg.time_compression_ratio}")
    stride = (2 if add_time else 1, 2 if add_spatial else 1, 2 if add_spatial else 1)
    return (add_spatial or add_time), stride


class EncoderCausal3D(nn.Module):
    def __init__(self, cfg: AutoEncoder3DConfig, **factory):
        super().__init__()
        boc = list(cfg.block_out_channels)
        g = cfg.norm_num_groups
        self.conv_in = CausalConv3d(cfg.in_channels, boc[0], 3, 1, **factory)
        blocks = []
        for i, ch in enumerate(boc):
            add_down, stride = _block_strides(cfg, i)
            blocks.append(DownEncoderBlockCausal3D(
                boc[max(i - 1, 0)], ch, num_layers=cfg.layers_per_block, add_downsample=add_down,
                downsample_stride=stride, num_groups=g, **factory,
            ))
        self.down_blocks = nn.ModuleList(blocks)
        self.mid_block = UNetMidBlockCausal3D(boc[-1], g, add_attention=cfg.mid_block_add_attention, **factory)
        self.conv_norm_out = GroupNorm(boc[-1], g, 1e-6, **factory)
        self.conv_out = CausalConv3d(boc[-1], 2 * cfg.latent_channels, 3, 1, **factory)

    def forward(self, x):
        x = self.conv_in(x)
        for blk in self.down_blocks:
            x = blk(x)
        x = self.mid_block(x)
        return self.conv_out(F.silu(self.conv_norm_out(x)))


class DecoderCausal3D(nn.Module):
    def __init__(self, cfg: AutoEncoder3DConfig, **factory):
        super().__init__()
        rev = list(reversed(cfg.block_out_channels))
        g = cfg.norm_num_groups
        self.conv_in = CausalConv3d(cfg.latent_channels, rev[0], 3, 1, **factory)
        self.mid_block = UNetMidBlockCausal3D(rev[0], g, add_attention=cfg.mid_block_add_attention, **factory)
        blocks = []
        for i, ch in enumerate(rev):
            add_up, stride = _block_strides(cfg, i)
            blocks.append(UpDecoderBlockCausal3D(
                rev[max(i - 1, 0)], ch, num_layers=cfg.layers_per_block + 1, add_upsample=add_up,
                upsample_scale_factor=stride, num_groups=g, **factory,
            ))
        self.up_blocks = nn.ModuleList(blocks)
        self.conv_norm_out = GroupNorm(rev[-1], g, 1e-6, **factory)
        self.conv_out = CausalConv3d(rev[-1], cfg.out_channels, 3, 1, **factory)

    def forward(self, z):
        x = self.mid_block(self.conv_in(z))
        for blk in self.up_blocks:
            x = blk(x)
        return self.conv_out(F.silu(self.conv_norm_out(x)))


class AutoencoderKLCausal3D(nn.Module):
    """The KL-VAE with tiled encode and decode; public tensors are
    (B, C, T, H, W)."""

    def __init__(self, config: AutoEncoder3DConfig, device=None, dtype: Optional[torch.dtype] = None,
                 compute_dtype: Optional[torch.dtype] = None):
        """``dtype``: the parameters'; ``compute_dtype``: the activations'
        (default: the parameters')."""
        super().__init__()
        self.config = config
        self.compute_dtype = compute_dtype
        factory = dict(device=device, dtype=dtype)
        self.encoder = EncoderCausal3D(config, **factory)
        self.decoder = DecoderCausal3D(config, **factory)
        self.quant_conv = Conv3d(2 * config.latent_channels, 2 * config.latent_channels, 1, **factory)
        self.post_quant_conv = Conv3d(config.latent_channels, config.latent_channels, 1, **factory)

    @property
    def time_compression_ratio(self) -> int:
        return self.config.time_compression_ratio

    @property
    def dtype(self) -> torch.dtype:
        """The compute dtype: inputs are cast to it."""
        return self.compute_dtype or self.post_quant_conv.weight.dtype

    @property
    def tile_sample_min_size(self) -> int:
        return self.config.sample_size

    @property
    def tile_latent_min_size(self) -> int:
        return self.config.sample_size // self.config.spatial_compression_ratio

    @property
    def tile_sample_min_tsize(self) -> int:
        return self.config.sample_tsize

    @property
    def tile_latent_min_tsize(self) -> int:
        return self.config.sample_tsize // self.config.time_compression_ratio

    def _encode_moments(self, x: torch.Tensor) -> torch.Tensor:
        return torch.cat([self.quant_conv(self.encoder(x[i:i + 1])) for i in range(x.shape[0])])

    def _decode_core(self, z: torch.Tensor) -> torch.Tensor:
        return self.decoder(self.post_quant_conv(z))

    def spatial_tiled_encode(self, x: torch.Tensor) -> torch.Tensor:
        """Overlapping tiles over H/W, encoded one by one and blended."""
        ts = self.tile_sample_min_size
        overlap = int(ts * (1 - self.config.tile_overlap_factor))
        blend = int(self.tile_latent_min_size * self.config.tile_overlap_factor)
        limit = self.tile_latent_min_size - blend
        rows = [
            [self._encode_moments(x[:, :, :, i:i + ts, j:j + ts]) for j in range(0, x.shape[4], overlap)]
            for i in range(0, x.shape[3], overlap)
        ]
        return self._stitch(rows, blend, limit)

    def temporal_tiled_encode(self, x: torch.Tensor) -> torch.Tensor:
        """Causal temporal tiles: each carries one extra leading frame, whose
        latent frame is dropped for all but the first tile before blending."""
        tst = self.tile_sample_min_tsize
        overlap = int(tst * (1 - self.config.tile_overlap_factor))
        blend = int(self.tile_latent_min_tsize * self.config.tile_overlap_factor)
        limit = self.tile_latent_min_tsize - blend
        tiles = []
        for i in range(0, x.shape[2], overlap):
            tile = x[:, :, i:i + tst + 1]
            if self.config.use_spatial_tiling and (
                tile.shape[3] > self.tile_sample_min_size or tile.shape[4] > self.tile_sample_min_size
            ):
                tile = self.spatial_tiled_encode(tile)
            else:
                tile = self._encode_moments(tile)
            tiles.append(tile[:, :, 1:] if i > 0 else tile)
        return self._join_temporal(tiles, blend, limit)

    def encode_moments(self, x: torch.Tensor) -> torch.Tensor:
        """Video (B, 3, T, H, W) -> the posterior's moments (B, 2C, T', H',
        W'), tiled as the config asks."""
        assert x.dim() == 5, "expected (B, C, T, H, W)"
        x = x.to(self.dtype)
        cfg = self.config
        if cfg.use_temporal_tiling and x.shape[2] > self.tile_sample_min_tsize:
            return self.temporal_tiled_encode(x)
        if cfg.use_spatial_tiling and (
            x.shape[3] > self.tile_sample_min_size or x.shape[4] > self.tile_sample_min_size
        ):
            return self.spatial_tiled_encode(x)
        return self._encode_moments(x)

    def _sample(self, moments: torch.Tensor, generator, sample_posterior: bool, noise):
        posterior = DiagonalGaussianDistribution(moments, dim=1)
        z = posterior.sample(generator, noise) if sample_posterior else posterior.mode()
        return self.config.scale_factor * (z - self.config.shift_factor), posterior

    def encode(self, x: torch.Tensor, generator: Optional[torch.Generator] = None,
               sample_posterior: bool = True, return_posterior: bool = False, noise=None):
        """Video (B, 3, T, H, W) -> scaled latents (B, C, T', H', W'): a
        sample of the posterior (noise drawn from ``generator``, or the
        given ``noise``), or its mode."""
        z, posterior = self._sample(self.encode_moments(x), generator, sample_posterior, noise)
        return (z, posterior) if return_posterior else z

    @staticmethod
    def _stitch(rows, blend: int, limit: int) -> torch.Tensor:
        """Blend a grid of spatial tiles into their neighbours and keep each
        tile's first ``limit`` rows and columns."""
        result_rows = []
        for i, row in enumerate(rows):
            result = []
            for j, tile in enumerate(row):
                if i > 0:
                    tile = blend_tiles(rows[i - 1][j], tile, blend, 3)
                if j > 0:
                    tile = blend_tiles(row[j - 1], tile, blend, 4)
                result.append(tile[:, :, :, :limit, :limit])
            result_rows.append(torch.cat(result, dim=4))
        return torch.cat(result_rows, dim=3)

    @staticmethod
    def _join_temporal(tiles, blend: int, limit: int) -> torch.Tensor:
        result = []
        for i, tile in enumerate(tiles):
            if i > 0:
                result.append(blend_tiles(tiles[i - 1], tile, blend, 2)[:, :, :limit])
            else:
                result.append(tile[:, :, :limit + 1])
        return torch.cat(result, dim=2)

    def spatial_tiled_decode(self, z: torch.Tensor) -> torch.Tensor:
        """Overlapping tiles over H/W, decoded one by one and blended."""
        tl = self.tile_latent_min_size
        overlap = int(tl * (1 - self.config.tile_overlap_factor))
        blend = int(self.tile_sample_min_size * self.config.tile_overlap_factor)
        limit = self.tile_sample_min_size - blend
        rows = [
            [self._decode_core(z[:, :, :, i:i + tl, j:j + tl]) for j in range(0, z.shape[4], overlap)]
            for i in range(0, z.shape[3], overlap)
        ]
        return self._stitch(rows, blend, limit)

    def temporal_tiled_decode(self, z: torch.Tensor) -> torch.Tensor:
        """Causal temporal tiles: each carries one extra leading frame, whose
        decode is dropped for all but the first tile before blending."""
        tlt = self.tile_latent_min_tsize
        overlap = int(tlt * (1 - self.config.tile_overlap_factor))
        blend = int(self.tile_sample_min_tsize * self.config.tile_overlap_factor)
        limit = self.tile_sample_min_tsize - blend
        tiles = []
        for i in range(0, z.shape[2], overlap):
            tile = z[:, :, i:i + tlt + 1]
            if self.config.use_spatial_tiling and (
                tile.shape[3] > self.tile_latent_min_size or tile.shape[4] > self.tile_latent_min_size
            ):
                dec = self.spatial_tiled_decode(tile)
            else:
                dec = self._decode_core(tile)
            tiles.append(dec[:, :, 1:] if i > 0 else dec)
        return self._join_temporal(tiles, blend, limit)

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        """Scaled latents (B, C, T, H, W) -> video (B, 3, T', H', W')."""
        assert z.dim() == 5, "expected (B, C, T, H, W)"
        z = (z / self.config.scale_factor + self.config.shift_factor).to(self.dtype)
        cfg = self.config
        if cfg.use_temporal_tiling and z.shape[2] > self.tile_latent_min_tsize:
            return self.temporal_tiled_decode(z)
        if cfg.use_spatial_tiling and (
            z.shape[3] > self.tile_latent_min_size or z.shape[4] > self.tile_latent_min_size
        ):
            return self.spatial_tiled_decode(z)
        return self._decode_core(z)

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None,
                sample_posterior: bool = True, noise: Optional[torch.Tensor] = None,
                grad_checkpoint: bool = False):
        """The training forward: (x_rec (B, 3, T', H', W'), posterior, z),
        with the posterior's noise (shaped like its mean, (B, C, t, h, w))
        drawn from ``generator`` unless given. ``grad_checkpoint`` recomputes
        the encoder and the decoder in the backward; the posterior's draw
        sits between the two and is not repeated."""
        moments = checkpoint_if(grad_checkpoint, self.encode_moments, x)
        z, posterior = self._sample(moments, generator, sample_posterior, noise)
        return checkpoint_if(grad_checkpoint, self.decode, z), posterior, z


def checkpoint_if(enabled: bool, fn, *args):
    """``fn(*args)``, under a non-reentrant activation checkpoint when
    ``enabled``."""
    return checkpoint(fn, *args, use_reentrant=False) if enabled else fn(*args)


@MODELS.register_module("hunyuan_vae")
def CausalVAE3D_HUNYUAN(from_pretrained: Optional[str] = None, device=None, **kwargs) -> AutoencoderKLCausal3D:
    from opensora_torch.utils.misc import torch_dtype

    known = set(AutoEncoder3DConfig.__dataclass_fields__)
    cfg = AutoEncoder3DConfig(from_pretrained=from_pretrained, **{k: v for k, v in kwargs.items() if k in known})
    return AutoencoderKLCausal3D(cfg, device=device, dtype=torch_dtype(cfg.param_dtype or cfg.dtype),
                                 compute_dtype=torch_dtype(cfg.dtype))
