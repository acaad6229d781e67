"""HunyuanVAE context parallelism over height (counterpart of
opensora_tpu/parallel/vae_sharding.py:27-53).

The JAX package jits the VAE with its input and latent (B, C, T, H, W) laid
out batch on 'data' and height on 'sp', and GSPMD inserts the halo
exchanges of the convolutions, the all-reduce of the group norms'
statistics and the gather of the mid-block attention. Here they are
written out (``models/hunyuan_vae/blocks.py``, each block's
``forward_strips``) over a :class:`HeightStrips` group: sp rank r holds
rows [r h, (r + 1) h) of every activation, on its device.

- A causal conv (kernel k, height stride s, symmetric pad p = k // 2) on a
  strip takes p rows from the neighbour above and k - s - p from the one
  below, so that its output rows are the unsharded conv's; the replicate
  pad applies at the global top and bottom only.
- A group norm's mean and variance are over the whole height: per strip
  sums in fp32, all-reduced over the sp ranks (the mean first, then the
  centred second moment).
- The mid-block attention gathers the strips along H (a strip is not
  contiguous in the T * H * W token order), runs the D = 512 frame-causal
  flash forward with ``causal_block = H * W`` of the full height, and cuts
  each rank's rows back out; ranks that share a device run it once.
- The upsampler's nearest-neighbour step is local.

:func:`make_sharded_vae_fn` runs the VAE's core passes (``_encode_moments``,
``_decode_core``) this way on each tile; the tile loops, the blend and the
posterior's draw are the unsharded ones, so the sharded encode and decode
equal them, tiles included. A height splits when every level's strip has
whole rows: H % (sp * 2^n) == 0 for the encoder's n spatial downsamplers,
the latent's height % sp == 0 for the decoder; else ``ValueError``.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Dict, List, Optional, Sequence

import torch
import torch.nn as nn

from opensora_torch.parallel.comm import all_gather, all_reduce, gather, shard
from opensora_torch.parallel.mesh import DATA_AXIS, SP_AXIS, Mesh


class HeightStrips:
    """The sp ranks that one activation's height is cut over, strip r on
    ``devices[r]``."""

    def __init__(self, devices: Sequence[torch.device]):
        self.devices = list(devices)
        self.n = len(self.devices)

    def halo(self, xs: Sequence[torch.Tensor], top: int, bottom: int) -> List[torch.Tensor]:
        """Each strip extended along H by ``top`` rows of the strip above
        and ``bottom`` rows of the strip below, or by its own edge row
        repeated at the global top and bottom (the replicate pad)."""
        out = []
        for r, x in enumerate(xs):
            if max(top, bottom) > x.shape[3]:
                raise ValueError(f"a halo of {max(top, bottom)} rows over strips of {x.shape[3]}")
            parts = []
            if top:
                parts.append(xs[r - 1][:, :, :, -top:].to(x.device) if r > 0
                             else x[:, :, :, :1].expand(-1, -1, -1, top, -1))
            parts.append(x)
            if bottom:
                parts.append(xs[r + 1][:, :, :, :bottom].to(x.device) if r < self.n - 1
                             else x[:, :, :, -1:].expand(-1, -1, -1, bottom, -1))
            out.append(torch.cat(parts, 3) if len(parts) > 1 else x)
        return out

    def group_moments(self, xs: Sequence[torch.Tensor], num_groups: int):
        """Per strip, (mean, var) of each (sample, group) over the whole
        height, fp32, as (B, G, 1) tensors on the strip's device."""
        flat = [x.float().reshape(x.shape[0], num_groups, -1) for x in xs]
        count = sum(f.shape[-1] for f in flat)
        mean = [s[..., None] / count for s in all_reduce([f.sum(-1) for f in flat])]
        var = [s[..., None] / count for s in all_reduce([(f - m).square().sum(-1) for f, m in zip(flat, mean)])]
        return mean, var

    def gathered(self, fn: Callable[[torch.Tensor], torch.Tensor], xs: Sequence[torch.Tensor]
                 ) -> List[torch.Tensor]:
        """Rank r's rows of ``fn`` of the whole height: the strips gathered
        along H on each rank's device, ``fn`` run once per distinct device
        (the ranks on one device share the gathered tensor), its output cut
        back into strips."""
        done: Dict[int, torch.Tensor] = {}
        out = []
        for r, full in enumerate(all_gather(xs, 3)):
            if id(full) not in done:
                done[id(full)] = fn(full)
            out.append(done[id(full)].chunk(self.n, 3)[r])
        return out


ONE_STRIP = HeightStrips([None])  # the unsharded forward: one strip, the blocks' plain forward


def encoder_levels(vae) -> int:
    """The encoder's spatial downsamplers (3 in the HunyuanVAE)."""
    return sum(d.conv.conv.stride[1] == 2 for blk in vae.encoder.down_blocks for d in blk.downsamplers)


def check_height(vae, height: int, sp: int, decode: bool) -> None:
    """Raise ``ValueError`` unless ``height`` splits over ``sp`` ranks at
    every level: the encoder's input height by sp * 2^levels, the latent's
    by sp."""
    step = sp if decode else sp * 2 ** encoder_levels(vae)
    if height % step:
        what = "latent height" if decode else "height"
        raise ValueError(f"{what} {height} does not split over sp={sp} at every level of the "
                         f"{'decoder' if decode else 'encoder'} (it must divide by {step})")


class HeightSharding:
    """A VAE's core passes over ``mesh``: rows over 'data', height over
    'sp' (the ranks at tp coordinate 0). The ranks are logical ranks on the
    VAE's own device: a rank on another card would need a replica of the
    VAE there, which is not ported (ROADMAP Queue 1: VAE context parallel over
    several cards)."""

    def __init__(self, vae: nn.Module, mesh: Mesh):
        self.mesh = mesh
        self.dp, self.sp = mesh.shape[DATA_AXIS], mesh.shape[SP_AXIS]
        home = next(vae.parameters()).device
        devices = [[mesh.devices[r] for r in mesh.group(SP_AXIS, mesh.rank((d, 0, 0)))] for d in range(self.dp)]
        away = {str(d) for group in devices for d in group if torch.empty(0, device=d).device != home}
        if away:
            raise NotImplementedError(f"the VAE's height sharding over ranks on {sorted(away)}, away from the VAE's "
                                      f"{home}: not ported (ROADMAP Queue 1: VAE context parallel over several cards)")
        self.groups = [HeightStrips(group) for group in devices]

    def _rows(self, b: int) -> int:
        if b % self.dp:
            raise ValueError(f"batch {b} does not split over the mesh 'data' axis ({self.dp})")
        return b // self.dp

    def encode_moments(self, vae, x: torch.Tensor) -> torch.Tensor:
        """``vae._encode_moments``: sample by sample, each on its data
        rank's sp group, the moments gathered on ``x``'s device."""
        check_height(vae, x.shape[3], self.sp, decode=False)
        per = self._rows(x.shape[0])
        out = []
        for i in range(x.shape[0]):
            cp = self.groups[i // per]
            ys = vae.encoder.forward_strips(cp, shard(x[i:i + 1], 3, cp.devices))
            out.append(gather([vae.quant_conv(y) for y in ys], 3, x.device))
        return torch.cat(out)

    def decode_core(self, vae, z: torch.Tensor) -> torch.Tensor:
        """``vae._decode_core``: each data rank's rows on its sp group, the
        video gathered on ``z``'s device."""
        check_height(vae, z.shape[3], self.sp, decode=True)
        per = self._rows(z.shape[0])
        out = []
        for d, cp in enumerate(self.groups):
            zs = shard(z[d * per:(d + 1) * per], 3, cp.devices)
            ys = vae.decoder.forward_strips(cp, [vae.post_quant_conv(s) for s in zs])
            out.append(gather(ys, 3, z.device))
        return torch.cat(out)

    @contextlib.contextmanager
    def on(self, vae):
        """The VAE's core passes run over the mesh while open."""
        outer, vae.height_sharding = vae.height_sharding, self
        try:
            yield
        finally:
            vae.height_sharding = outer


def make_sharded_vae_fn(vae, mesh: Mesh, method="encode", generator: Optional[torch.Generator] = None) -> Callable:
    """The VAE's ``encode`` or ``decode`` (``method``: the name, or the
    unbound method) over ``mesh``, height on 'sp' and rows on 'data'
    (``make_sharded_vae_fn``). Encode: ``fn(x, generator=generator,
    **encode_kwargs)``, the posterior's noise drawn as the unsharded encode
    draws it (or given as ``noise=``); decode: ``fn(z)``. Inputs and outputs are whole tensors; each tile of the
    tiled passes runs height-sharded."""
    name = getattr(method, "__name__", method)
    sharding = HeightSharding(vae, mesh)
    if name == "encode":
        def fn(x, generator=generator, **kwargs):
            with sharding.on(vae):
                return vae.encode(x, generator=generator, **kwargs)
    elif name == "decode":
        def fn(z):
            with sharding.on(vae):
                return vae.decode(z)
    else:
        raise ValueError(f"method {method!r}: encode or decode")
    return fn
