"""Video DC-AE, the deep-compression autoencoder: 4x in T, 32x in H/W, 128
latent channels, no posterior (counterpart of
opensora_tpu/models/dc_ae/model.py).

``dc-ae-f32t4c128``: 6 stages of widths 128, 256, 512, 512, 1024, 1024,
three of ResBlocks then three of EfficientViT blocks (LiteMLA + GLUMBConv,
scale 5), temporal down/up-sampling at stages 3 and 4, rms3d norms, a
strided conv downsample with a channel-averaging shortcut and an
interpolate-conv upsample with a channel-duplicating shortcut.

State-dict names follow upstream's layout: ``encoder.project_in``,
``encoder.stages.{s}.op_list.{i}`` (the stage's blocks, then its
downsample), ``encoder.project_out.main.op_list.{0,2}`` (norm, conv);
``decoder.project_in.main``, ``decoder.stages.{s}.op_list.{i}`` (the
upsample first, then the blocks), ``decoder.project_out.op_list.{0,2}``.

Layout (B, C, T, H, W). ``param_dtype`` keeps the parameters in another
dtype than the compute ``dtype`` (fp32 master weights for training); left
unset, they are in the compute dtype.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional, Sequence

import torch
import torch.nn as nn

from opensora_torch.models.dc_ae.ops import (
    ChannelDuplicatingPixelShuffleUpSampleLayer,
    ConvLayer,
    EfficientViTBlock,
    InterpolateConvUpSampleLayer,
    OpSequential,
    PixelUnshuffleChannelAveragingDownSampleLayer,
    ResBlock,
    ResidualBlock,
    build_act,
    build_norm,
)
from opensora_torch.models.hunyuan_vae.model import blend_tiles, checkpoint_if
from opensora_torch.registry import MODELS
from opensora_torch.utils.misc import torch_dtype


@dataclass
class DCAEConfig:
    from_pretrained: Optional[str] = None
    in_channels: int = 3
    latent_channels: int = 128
    time_compression_ratio: int = 4
    spatial_compression_ratio: int = 32
    width_list: Sequence[int] = field(default_factory=lambda: (128, 256, 512, 512, 1024, 1024))
    encoder_depth_list: Sequence[int] = field(default_factory=lambda: (2, 2, 2, 3, 3, 3))
    decoder_depth_list: Sequence[int] = field(default_factory=lambda: (3, 3, 3, 3, 3, 3))
    block_type: Sequence[str] = field(
        default_factory=lambda: ("ResBlock", "ResBlock", "ResBlock", "EViTS5_GLU", "EViTS5_GLU", "EViTS5_GLU")
    )
    norm: str = "rms3d"
    act: str = "silu"
    temporal_downsample: Sequence[bool] = field(default_factory=lambda: (False, False, False, True, True, False))
    downsample_block_type: str = "Conv"
    upsample_block_type: str = "InterpolateConv"
    is_video: bool = True
    scaling_factor: Optional[float] = None
    is_training: bool = False
    use_spatial_tiling: bool = False
    use_temporal_tiling: bool = False
    spatial_tile_size: int = 256
    temporal_tile_size: int = 32
    tile_overlap_factor: float = 0.25
    dtype: str = "bf16"
    param_dtype: Optional[str] = None  # None: the compute dtype


def _build_block(block_type: str, width: int, norm: str, act: str, is_video: bool, **factory) -> nn.Module:
    if block_type == "ResBlock":
        return ResidualBlock(ResBlock(width, width, norm=(None, norm), act_func=(act, None), use_bias=(True, False),
                                      is_video=is_video, **factory))
    if block_type in ("EViT_GLU", "EViTS5_GLU"):
        scales = (5,) if block_type == "EViTS5_GLU" else ()
        return EfficientViTBlock(width, scales=scales, norm=norm, act_func=act, is_video=is_video, **factory)
    raise ValueError(f"block_type {block_type!r} not supported")


def _temporal(cfg: DCAEConfig, sid: int) -> bool:
    return bool(cfg.temporal_downsample[sid]) if cfg.temporal_downsample else False


class DCAEEncoder(nn.Module):
    def __init__(self, cfg: DCAEConfig, **factory):
        super().__init__()
        widths, depths, n = list(cfg.width_list), list(cfg.encoder_depth_list), len(cfg.width_list)
        video = cfg.is_video
        self.project_in = ConvLayer(cfg.in_channels, widths[0], 3, 1, use_bias=True, is_video=video, **factory)
        stages = []
        for sid in range(n):
            ops = [_build_block(cfg.block_type[sid], widths[sid], cfg.norm, cfg.act, video, **factory)
                   for _ in range(depths[sid])]
            if sid < n - 1 and depths[sid] > 0:
                tdown = _temporal(cfg, sid)
                stride = (2, 2, 2) if (video and tdown) else ((1, 2, 2) if video else 2)
                ops.append(ResidualBlock(
                    ConvLayer(widths[sid], widths[sid + 1], 3, stride, use_bias=True, is_video=video, **factory),
                    PixelUnshuffleChannelAveragingDownSampleLayer(widths[sid], widths[sid + 1], 2, tdown),
                ))
            stages.append(OpSequential(ops))
        self.stages = nn.ModuleList(stages)
        self.project_out = ResidualBlock(
            OpSequential([
                build_norm(cfg.norm, widths[-1], **factory),
                build_act(cfg.act),
                ConvLayer(widths[-1], cfg.latent_channels, 3, 1, use_bias=True, is_video=video, **factory),
            ]),
            PixelUnshuffleChannelAveragingDownSampleLayer(widths[-1], cfg.latent_channels, 1),
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.project_in(x)
        for stage in self.stages:
            x = stage(x)
        return self.project_out(x)


class DCAEDecoder(nn.Module):
    def __init__(self, cfg: DCAEConfig, **factory):
        super().__init__()
        widths, depths, n = list(cfg.width_list), list(cfg.decoder_depth_list), len(cfg.width_list)
        video = cfg.is_video
        self.project_in = ResidualBlock(
            ConvLayer(cfg.latent_channels, widths[-1], 3, 1, use_bias=True, is_video=video, **factory),
            ChannelDuplicatingPixelShuffleUpSampleLayer(cfg.latent_channels, widths[-1], 1),
        )
        stages = []
        for sid in range(n):
            ops = []
            if sid < n - 1 and depths[sid] > 0:
                tup = _temporal(cfg, sid)
                ops.append(ResidualBlock(
                    InterpolateConvUpSampleLayer(widths[sid + 1], widths[sid], 3, 2, is_video=video,
                                                 temporal_upsample=tup, **factory),
                    ChannelDuplicatingPixelShuffleUpSampleLayer(widths[sid + 1], widths[sid], 2, tup),
                ))
            ops += [_build_block(cfg.block_type[sid], widths[sid], cfg.norm, cfg.act, video, **factory)
                    for _ in range(depths[sid])]
            stages.append(OpSequential(ops))
        self.stages = nn.ModuleList(stages)
        self.project_out = OpSequential([
            build_norm(cfg.norm, widths[0], **factory),
            build_act(cfg.act),
            ConvLayer(widths[0], cfg.in_channels, 3, 1, use_bias=True, is_video=video, **factory),
        ])

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        x = self.project_in(z)
        for stage in reversed(self.stages):
            x = stage(x)
        return self.project_out(x)


class DCAE(nn.Module):
    """Deterministic deep-compression AE with tiled encode and decode:
    z = enc(x) [/ scaling_factor], no posterior."""

    def __init__(self, config: DCAEConfig, device=None, dtype: Optional[torch.dtype] = None,
                 compute_dtype: Optional[torch.dtype] = None):
        """``dtype``: the parameters'; ``compute_dtype``: the activations'
        (default: the parameters')."""
        super().__init__()
        self.config = config
        self.compute_dtype = compute_dtype
        factory = dict(device=device, dtype=dtype)
        self.encoder = DCAEEncoder(config, **factory)
        self.decoder = DCAEDecoder(config, **factory)

    @property
    def dtype(self) -> torch.dtype:
        """The compute dtype: inputs are cast to it."""
        return self.compute_dtype or self.encoder.project_in.conv.weight.dtype

    @property
    def spatial_tile_latent_size(self) -> int:
        return self.config.spatial_tile_size // self.config.spatial_compression_ratio

    @property
    def temporal_tile_latent_size(self) -> int:
        return self.config.temporal_tile_size // self.config.time_compression_ratio

    def _encode(self, x: torch.Tensor) -> torch.Tensor:
        z = self.encoder(x)
        return z if self.config.scaling_factor is None else z / self.config.scaling_factor

    def _decode(self, z: torch.Tensor) -> torch.Tensor:
        if self.config.scaling_factor is not None:
            z = z * self.config.scaling_factor
        return self.decoder(z)

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
        return torch.cat([(blend_tiles(tiles[i - 1], tile, blend, 2) if i > 0 else tile)[:, :, :limit]
                          for i, tile in enumerate(tiles)], dim=2)

    def spatial_tiled_encode(self, x: torch.Tensor) -> torch.Tensor:
        ts = self.config.spatial_tile_size
        net = int(ts * (1 - self.config.tile_overlap_factor))
        blend = int(self.spatial_tile_latent_size * self.config.tile_overlap_factor)
        rows = [[self._encode(x[:, :, :, i:i + ts, j:j + ts]) for j in range(0, x.shape[4], net)]
                for i in range(0, x.shape[3], net)]
        return self._stitch(rows, blend, self.spatial_tile_latent_size - blend)

    def temporal_tiled_encode(self, x: torch.Tensor) -> torch.Tensor:
        tt = self.config.temporal_tile_size
        overlap = int(tt * (1 - self.config.tile_overlap_factor))
        blend = int(self.temporal_tile_latent_size * self.config.tile_overlap_factor)
        tiles = []
        for i in range(0, x.shape[2], overlap):
            tile = x[:, :, i:i + tt]
            if self.config.use_spatial_tiling and (
                tile.shape[3] > self.config.spatial_tile_size or tile.shape[4] > self.config.spatial_tile_size
            ):
                tiles.append(self.spatial_tiled_encode(tile))
            else:
                tiles.append(self._encode(tile))
        return self._join_temporal(tiles, blend, self.temporal_tile_latent_size - blend)

    def spatial_tiled_decode(self, z: torch.Tensor) -> torch.Tensor:
        tl = self.spatial_tile_latent_size
        net = int(tl * (1 - self.config.tile_overlap_factor))
        blend = int(self.config.spatial_tile_size * self.config.tile_overlap_factor)
        rows = [[self._decode(z[:, :, :, i:i + tl, j:j + tl]) for j in range(0, z.shape[4], net)]
                for i in range(0, z.shape[3], net)]
        return self._stitch(rows, blend, self.config.spatial_tile_size - blend)

    def temporal_tiled_decode(self, z: torch.Tensor) -> torch.Tensor:
        tl = self.temporal_tile_latent_size
        overlap = int(tl * (1 - self.config.tile_overlap_factor))
        blend = int(self.config.temporal_tile_size * self.config.tile_overlap_factor)
        tiles = []
        for i in range(0, z.shape[2], overlap):
            tile = z[:, :, i:i + tl]
            if self.config.use_spatial_tiling and (
                tile.shape[3] > self.spatial_tile_latent_size or tile.shape[4] > self.spatial_tile_latent_size
            ):
                tiles.append(self.spatial_tiled_decode(tile))
            else:
                tiles.append(self._decode(tile))
        return self._join_temporal(tiles, blend, self.config.temporal_tile_size - blend)

    def encode(self, x: torch.Tensor, *_, **__) -> torch.Tensor:
        """Video (B, 3, T, H, W) -> latents (B, C, T / 4, H / 32, W / 32)."""
        assert x.dim() == 5, "expected (B, C, T, H, W)"
        x = x.to(self.dtype)
        cfg = self.config
        if cfg.use_temporal_tiling and x.shape[2] > cfg.temporal_tile_size:
            return self.temporal_tiled_encode(x)
        if cfg.use_spatial_tiling and (x.shape[3] > cfg.spatial_tile_size or x.shape[4] > cfg.spatial_tile_size):
            return self.spatial_tiled_encode(x)
        return self._encode(x)

    def decode(self, z: torch.Tensor, *_, **__) -> torch.Tensor:
        assert z.dim() == 5, "expected (B, C, T, H, W)"
        z = z.to(self.dtype)
        cfg = self.config
        if cfg.use_temporal_tiling and z.shape[2] > self.temporal_tile_latent_size:
            return self.temporal_tiled_decode(z)
        if cfg.use_spatial_tiling and (
            z.shape[3] > self.spatial_tile_latent_size or z.shape[4] > self.spatial_tile_latent_size
        ):
            return self.spatial_tiled_decode(z)
        return self._decode(z)

    def forward(self, x: torch.Tensor, generator=None, sample_posterior: bool = True, noise=None,
                grad_checkpoint: bool = False):
        """(x_rec, posterior = None, z), as the training forward of the
        HunyuanVAE returns them (there is no posterior: ``generator``,
        ``sample_posterior`` and ``noise`` are unused). ``grad_checkpoint``
        recomputes the encoder and the decoder in the backward."""
        z = checkpoint_if(grad_checkpoint, self.encode, x)
        return checkpoint_if(grad_checkpoint, self.decode, z), None, z


def dc_ae_f32(name: str = "dc-ae-f32t4c128", **overrides) -> DCAEConfig:
    """The model-zoo config of ``name``."""
    if name != "dc-ae-f32t4c128":
        raise NotImplementedError(name)
    return DCAEConfig(**overrides)


@MODELS.register_module("dc_ae")
def DC_AE(model_name: str = "dc-ae-f32t4c128", from_pretrained: Optional[str] = None, device=None,
          **kwargs) -> DCAE:
    if from_pretrained:
        raise NotImplementedError(
            f"from_pretrained={from_pretrained!r}: checkpoint loading is not ported yet (ROADMAP); "
            "leave it unset for random weights from the seed")
    known = set(DCAEConfig.__dataclass_fields__)
    cfg = dc_ae_f32(model_name, **{k: v for k, v in kwargs.items() if k in known})
    return DCAE(cfg, device=device, dtype=torch_dtype(cfg.param_dtype or cfg.dtype),
                compute_dtype=torch_dtype(cfg.dtype))
