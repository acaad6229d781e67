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

The ranks may lie on several devices, and in several processes, as JAX's
mesh spans its devices (opensora_tpu/parallel/vae_sharding.py:36-53
replicates the variables over the mesh). :class:`HeightSharding` keeps one
replica of the VAE on each distinct device of this process's sp ranks (the
VAE itself on its own device), and each strip runs through its device's
replica of every block (:meth:`HeightStrips.on`). Where an sp group spans
processes (a :class:`~opensora_torch.parallel.comm.ShardGroup`), each
process runs its own ranks' strips: the halo rows at a process boundary
come from the neighbouring process (one batched exchange a convolution),
the group norms' fp32 sums are all-reduced over the group's processes, and
the attention's and the output's height is all-gathered across them;
``VAE_REMOTE`` counts those messages and their bytes. Every process passes
the whole tensor and gets the whole result back: where some processes
hold no rank of a data coordinate's sp group (at tp coordinate 0), the
group's first process broadcasts that coordinate's rows to every process.
"""

from __future__ import annotations

import contextlib
import copy
from typing import Callable, Dict, List, Optional, Sequence

import torch
import torch.nn as nn

from opensora_torch.parallel import distributed
from opensora_torch.parallel.comm import ShardGroup, all_gather, all_reduce, process_all_gather, \
    process_all_reduce, process_broadcast, process_exchange
from opensora_torch.parallel.mesh import DATA_AXIS, SP_AXIS, Mesh

# the height sharding's traffic across processes since the last reset, per
# process: the halo rows it sent (messages, bytes), the group norms'
# all-reduced sums and the all-gathers of the height (calls, bytes of this
# process's part)
VAE_REMOTE = {"halo_sends": 0, "halo_bytes": 0, "moment_all_reduces": 0, "moment_bytes": 0, "gathers": 0,
              "gather_bytes": 0}


def reset_vae_remote() -> None:
    VAE_REMOTE.update(dict.fromkeys(VAE_REMOTE, 0))


def _count(kind: str, x: torch.Tensor, calls: str) -> None:
    VAE_REMOTE[calls] += 1
    VAE_REMOTE[f"{kind}_bytes"] += x.numel() * x.element_size()


class HeightStrips:
    """The sp ranks that one activation's height is cut over: ``n`` strips,
    of which this process holds the run from ``group.first`` (``group``,
    default: every strip here), strip ``group.first + r`` on ``devices[r]``
    run by ``twins[r]`` (per module of the VAE, its counterpart in the
    replica on that device; None: the VAE itself)."""

    def __init__(self, devices: Sequence[torch.device], group: Optional[ShardGroup] = None,
                 twins: Optional[Sequence[Optional[Dict[int, nn.Module]]]] = None):
        self.devices = list(devices)
        self.group = group or ShardGroup.local(len(self.devices))
        self.n = self.group.size
        self.twins = list(twins) if twins is not None else [None] * len(self.devices)

    def on(self, module: nn.Module, r: int) -> nn.Module:
        """``module``'s counterpart in strip r's replica."""
        twins = self.twins[r]
        return module if twins is None else twins[id(module)]

    def shard(self, x: torch.Tensor) -> List[torch.Tensor]:
        """This process's strips of ``x``, each on its device."""
        if x.shape[3] % self.n:
            raise ValueError(f"dimension 3 of {tuple(x.shape)} does not split over {self.n} ranks")
        pieces = x.chunk(self.n, 3)
        return [pieces[self.group.first + r].to(d).contiguous() for r, d in enumerate(self.devices)]

    def join(self, xs: Sequence[torch.Tensor], device) -> torch.Tensor:
        """The strips of every rank joined along H on ``device`` (gathered
        across the group's processes)."""
        local = torch.cat([x.to(device) for x in xs], 3)
        if not self.group.spans:
            return local
        _count("gather", local, "gathers")
        return process_all_gather(local.contiguous(), 3, self.group.comm)

    def _edges(self, xs: Sequence[torch.Tensor], top: int, bottom: int):
        """The rows of the neighbouring processes' strips: ``top`` rows of
        the strip above this process's first, ``bottom`` of the one below
        its last (None at the global edges), in one batched exchange."""
        g, first, last = self.group, self.group.first, self.group.first + len(xs) - 1
        up = g.process_of(first - 1) if first > 0 else None
        down = g.process_of(last + 1) if last < self.n - 1 else None
        sends, recvs = [], []
        if up is not None:
            if bottom:
                sends.append((up, xs[0][:, :, :, :bottom]))
            if top:
                recvs.append((up, xs[0][:, :, :, :top]))
        if down is not None:
            if top:
                sends.append((down, xs[-1][:, :, :, -top:]))
            if bottom:
                recvs.append((down, xs[-1][:, :, :, -bottom:]))
        for _, x in sends:
            _count("halo", x, "halo_sends")
        got = iter(process_exchange(sends, recvs, g.comm))
        above = next(got) if up is not None and top else None
        below = next(got) if down is not None and bottom else None
        return above, below

    def halo(self, xs: Sequence[torch.Tensor], top: int, bottom: int) -> List[torch.Tensor]:
        """Each strip extended along H by ``top`` rows of the strip above
        and ``bottom`` rows of the strip below (from the neighbouring
        process at this process's ends), or by its own edge row repeated at
        the global top and bottom (the replicate pad)."""
        if any(max(top, bottom) > x.shape[3] for x in xs):
            raise ValueError(f"a halo of {max(top, bottom)} rows over strips of {xs[0].shape[3]}")
        above, below = self._edges(xs, top, bottom) if self.group.spans and (top or bottom) else (None, None)
        first, m = self.group.first, len(xs)
        out = []
        for r, x in enumerate(xs):
            i = first + r
            parts = []
            if top:
                parts.append(xs[r - 1][:, :, :, -top:].to(x.device) if r > 0
                             else above.to(x.device) if i > 0
                             else x[:, :, :, :1].expand(-1, -1, -1, top, -1))
            parts.append(x)
            if bottom:
                parts.append(xs[r + 1][:, :, :, :bottom].to(x.device) if r < m - 1
                             else below.to(x.device) if i < self.n - 1
                             else x[:, :, :, -1:].expand(-1, -1, -1, bottom, -1))
            out.append(torch.cat(parts, 3) if len(parts) > 1 else x)
        return out

    def _sum(self, parts: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        """The sum over every strip of the group of the strips' fp32
        ``parts``, on each strip's device."""
        if not self.group.spans:
            return all_reduce(parts)
        local = sum(p.to(parts[0].device) for p in parts)
        _count("moment", local, "moment_all_reduces")
        total = process_all_reduce(local, self.group.comm)
        return [total.to(p.device) for p in parts]

    def group_moments(self, xs: Sequence[torch.Tensor], num_groups: int):
        """Per strip, (mean, var) of each (sample, group) over the whole
        height, fp32, as (B, G, 1) tensors on the strip's device."""
        flat = [x.float().reshape(x.shape[0], num_groups, -1) for x in xs]
        count = flat[0].shape[-1] * self.n  # the strips are alike
        mean = [s[..., None] / count for s in self._sum([f.sum(-1) for f in flat])]
        var = [s[..., None] / count for s in self._sum([(f - m).square().sum(-1) for f, m in zip(flat, mean)])]
        return mean, var

    def gathered(self, fn: Callable[[torch.Tensor, int], torch.Tensor], xs: Sequence[torch.Tensor]
                 ) -> List[torch.Tensor]:
        """Rank r's rows of ``fn(whole, r)`` of the whole height: the strips
        gathered along H (across the group's processes too) on each rank's
        device, ``fn`` run once per distinct device (the ranks on one
        device share the gathered tensor; ``r`` is the first of them), its
        output cut back into strips."""
        if self.group.spans:
            whole = self.join(xs, xs[0].device)
            fulls = [whole if x.device == whole.device else whole.to(x.device) for x in xs]
        else:
            fulls = all_gather(xs, 3)
        done: Dict[torch.device, torch.Tensor] = {}
        out = []
        for r, full in enumerate(fulls):
            dev = self.devices[r]
            if dev not in done:
                done[dev] = fn(full, r)
            out.append(done[dev].chunk(self.n, 3)[self.group.first + r])
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


def _key(device) -> torch.device:
    """A device as a replica's key: with its index (``cpu`` is ``cpu:0``)."""
    device = torch.device(device)
    return torch.device(device.type, device.index or 0)


class HeightSharding:
    """A VAE's core passes over ``mesh``: rows over 'data', height over
    'sp' (the ranks at tp coordinate 0), each rank's strip run by the
    replica of the VAE on the rank's device (see the module docstring)."""

    def __init__(self, vae: nn.Module, mesh: Mesh):
        self.mesh = mesh
        self.dp, self.sp = mesh.shape[DATA_AXIS], mesh.shape[SP_AXIS]
        self.vae = vae
        home = _key(next(vae.parameters()).device)
        replicas: Dict[torch.device, Optional[Dict[int, nn.Module]]] = {home: None}
        self.groups: Dict[int, HeightStrips] = {}  # data coordinate -> its sp group's strips here
        self.holders: List[List[int]] = []  # per data coordinate, the processes of its sp group
        for d in range(self.dp):
            ranks = mesh.group(SP_AXIS, mesh.rank((d, 0, 0)))
            self.holders.append(sorted({mesh.processes[r] for r in ranks}))
            mine = [i for i, r in enumerate(ranks) if mesh.is_local(r)]
            if not mine:
                continue
            devices = [mesh.devices[ranks[i]] for i in mine]
            for dev in devices:
                if _key(dev) not in replicas:
                    replicas[_key(dev)] = _twins(vae, dev)
            group = ShardGroup(self.sp, mine[0], tuple(mesh.processes[r] for r in ranks),
                               mesh.process_group(SP_AXIS, ranks[0]))
            self.groups[d] = HeightStrips(devices, group, [replicas[_key(dev)] for dev in devices])
        self.replicas = [twins[id(vae)] for twins in replicas.values() if twins is not None]

    def _rows(self, b: int) -> int:
        if b % self.dp:
            raise ValueError(f"batch {b} does not split over the mesh 'data' axis ({self.dp})")
        return b // self.dp

    def _share(self, y: Optional[torch.Tensor], d: int, device) -> torch.Tensor:
        """Data coordinate d's output on every process: broadcast by its sp
        group's first process where other processes hold none of its
        ranks."""
        if len(self.holders[d]) == distributed.process_count():
            return y
        src = self.holders[d][0]
        shape = distributed.broadcast_object(None if y is None else (tuple(y.shape), y.dtype), src)
        return process_broadcast(torch.empty(shape[0], dtype=shape[1], device=device) if y is None else y, src)

    def encode_moments(self, vae, x: torch.Tensor) -> torch.Tensor:
        """``vae._encode_moments``: sample by sample, each on its data
        rank's sp group, the moments gathered on ``x``'s device."""
        check_height(vae, x.shape[3], self.sp, decode=False)
        per = self._rows(x.shape[0])
        out = []
        for i in range(x.shape[0]):
            d = i // per
            cp, y = self.groups.get(d), None
            if cp is not None:
                ys = vae.encoder.forward_strips(cp, cp.shard(x[i:i + 1]))
                y = cp.join([cp.on(vae.quant_conv, r)(y) for r, y in enumerate(ys)], x.device)
            out.append(self._share(y, d, x.device))
        return torch.cat(out)

    def decode_core(self, vae, z: torch.Tensor) -> torch.Tensor:
        """``vae._decode_core``: each data rank's rows on its sp group, the
        video gathered on ``z``'s device."""
        check_height(vae, z.shape[3], self.sp, decode=True)
        per = self._rows(z.shape[0])
        out = []
        for d in range(self.dp):
            cp, y = self.groups.get(d), None
            if cp is not None:
                zs = cp.shard(z[d * per:(d + 1) * per])
                ys = vae.decoder.forward_strips(cp, [cp.on(vae.post_quant_conv, r)(s) for r, s in enumerate(zs)])
                y = cp.join(ys, z.device)
            out.append(self._share(y, d, z.device))
        return torch.cat(out)

    @contextlib.contextmanager
    def on(self, vae):
        """The VAE's core passes run over the mesh while open (the replicas
        given the VAE's current weights first)."""
        with torch.no_grad():
            for replica in self.replicas:
                for a, b in zip(vae.state_dict().values(), replica.state_dict().values()):
                    b.copy_(a)
        outer, vae.height_sharding = vae.height_sharding, self
        try:
            yield
        finally:
            vae.height_sharding = outer


def _twins(vae: nn.Module, device) -> Dict[int, nn.Module]:
    """A replica of ``vae`` on ``device``: per module of the VAE (by id),
    its counterpart in the replica."""
    replica = copy.deepcopy(vae).to(torch.empty(0, device=device).device)
    return {id(a): b for a, b in zip(vae.modules(), replica.modules())}


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
