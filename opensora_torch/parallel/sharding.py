"""Parameter sharding rules (TP + FSDP) and the placement of a sharded
MMDiT over the ranks of a mesh (counterpart of
opensora_tpu/parallel/sharding.py:28-137).

The rules are JAX's, over the port's upstream-named parameters, each JAX
kernel axis mapped to its transposed torch dim (a torch weight is (out,
in)), and an int8 linear's ``weight_q`` (``ops/quant.QuantLinear``) is cut
as its float weight would be, its per-output-channel ``weight_scale`` as
the bias of a column-parallel linear (JAX leaves ``kernel_q`` /
``kernel_scale`` replicated and lets GSPMD split the products; each tp
rank here holds only the int8 columns or rows it multiplies, which is
exact since every scale belongs to one output channel):

- column-parallel ``qkv``, ``linear1``, ``img_mlp.0``, ``txt_mlp.0``,
  ``q_proj``, ``k_proj``, ``v_proj``, ``v_mlp``: output features (dim 0)
  and the bias on 'tp';
- row-parallel ``proj``, ``linear2``, ``img_mlp.2``, ``txt_mlp.2``: input
  features (dim 1) on 'tp', the bias replicated;
- with ``fsdp``, the other dim of those weights on 'data', and so the input
  dim of the modulation, embedder and final-layer weights.

JAX lays the 'tp' cut of a fused product out contiguously and lets GSPMD
reshard after it. The port computes each tp rank's heads itself, so a
fused output axis ([q | k | v] of ``qkv``, [q | k | v | mlp] of
``linear1``, [v | mlp] of ``v_mlp``) and ``linear2``'s input axis ([attn |
mlp]) are cut per segment: rank r holds rows r of each segment, as
upstream's ColossalAI policy does. The rule table still names the axis.

:func:`shard_params` turns a built model into per-rank shards: every
parameter (and an int8 linear's ``weight_q`` / ``weight_scale`` buffers)
becomes a :class:`Placement` whose leaves (one per distinct shard and
device: ranks on one device share one leaf) are the trained parameters,
registered as ``<name>_shards``. The module keeps its name and reads, in
place of the parameter, the shard of the rank whose scope is open
(``parallel/context.rank_scope``): cast to the compute dtype first (a
float weight; the LoRA factors, the int8 weights and their fp32 scales
keep their dtype), then, where it is cut over 'data', gathered (FSDP; the
gathered copy lives as long as the product that reads it). A row-parallel
linear reads no bias: :func:`row_parallel` sums the ranks' partial
products (fp32, rounded once) and adds the bias once.

On an sp mesh (data, sp, tp) every rank (d, s, t) computes on its own
device (``Mesh.home``) and reads its shards there in the scope (d, t, s).
No rule names 'sp', so each weight is replicated over the sp ranks, as JAX
leaves it: one leaf per distinct device, the ranks that share a device
sharing it (autograd sums their gradients there), the replicas on other
devices summed by :meth:`ModelSharding.sync_replica_grads` and counted once
in the clip's norm. FSDP still cuts over 'data' and gathers on each sp
rank's device. Where the joint sequence splits over 'sp', a
:class:`RankGroup` with ``seq`` runs every (s, t) rank of a data
coordinate, sp rank s on its own chunk of the tokens
(``models/mmdit/model.py``); else the ranks at sp coordinate 0 run the
whole sequence and only the attention is cut over 'sp'.
:func:`unshard_params` puts a sharded model back on one device.

On a pipeline mesh (data, pp, tp) a parameter may belong to one stage
(``stages``: a block of the stack, ``training/pp.py``): its leaves then lie
on that stage's devices only, and the ranks (d, s, t) of its stage read it
in the scope (d, t, s). A parameter of no stage (the embedders, the final
layer) is replicated on every stage's devices. PP cuts nothing over
'data'.

Over processes (a mesh whose axes may each cross them,
``parallel/mesh.py``) a process makes the leaves of its own ranks only: its
(data, sp or stage, tp) coordinates' (none of a block of another process's
stage). A leaf's key is (i, j, (process, device)); the processes that hold
a shard (i, j) are its :meth:`Placement.holders`: every process of its
stage for a shard whole along 'data' and 'tp', the processes of data
coordinate i for one cut over 'data', of tp coordinate j for one cut over
'tp'. The FSDP read joins the process's shards with the other processes'
of its 'data' group by ``comm.process_gather_shards`` (its backward the
reduce-scatter over that group); :meth:`ModelSharding.sync_replica_grads`
sums a shard's gradient over its holders (per device, in buckets; a data
shard's after that reduce-scatter, so over the data ranks and the sp and
tp ranks both); a shard counts in the clip's norm on its first holder only
(:meth:`ModelSharding.non_canonical`); :meth:`Placement.gather` brings a
full tensor to process 0, each shard from its first holder. A
:class:`RankGroup` runs this process's ranks: with ``seq`` its sp ranks,
the others reached through :meth:`RankGroup.shard_group`; where the tp
group spans processes, its tp ranks, the row-parallel sums taken across
the group's processes (``RankGroup.tp_comm``). Each process of a tp group
computes the replicated part of a block (modulation, norms, residuals,
embedders, final layer) with its share of the loss's gradient
(``training/diffusion.tp_share``): the shares meet in the sums' backward
(``comm.tp_all_reduce``) and in the replicated leaves' sum over their
holders, so no process computes a partial result it keeps.
"""

from __future__ import annotations

import contextlib
import re
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn as nn

from opensora_torch.parallel import distributed
from opensora_torch.parallel.comm import (
    ShardGroup,
    all_reduce,
    copy_to,
    gather,
    process_all_reduce,
    process_gather_shards,
    process_isend,
    process_recv,
    wait_sends,
)
from opensora_torch.parallel.context import get_mesh, get_scope, rank_scope
from opensora_torch.parallel.mesh import DATA_AXIS, SP_AXIS, TP_AXIS, Mesh

Spec = Tuple[Optional[str], ...]

REPLICA_BUCKET = 1 << 26  # fp32 elements of one cross-process gradient sum (256 MB)
# an int8 linear's buffers, placed as parameters are (``ops/quant.QuantLinear``)
QUANT_BUFFERS = ("weight_q", "weight_scale")
# leaves read in their own dtype, not the compute dtype: the LoRA factors
# (fp32, merged in fp32) and the int8 weights' fp32 scales
OWN_DTYPE = (".lora_A", ".lora_B", ".weight_scale")

_COL = r"(qkv|linear1|img_mlp\.0|txt_mlp\.0|q_proj|k_proj|v_proj|v_mlp)"
_ROW = r"(proj|linear2|img_mlp\.2|txt_mlp\.2)"


def _mmdit_rules(fsdp: bool):
    dp = DATA_AXIS if fsdp else None
    return [
        (rf".*{_COL}\.weight(_q)?", (TP_AXIS, dp)),
        (rf".*{_COL}\.(bias|weight_scale)", (TP_AXIS,)),
        (rf".*{_ROW}\.weight(_q)?", (dp, TP_AXIS)),
        (rf".*{_ROW}\.bias", (None,)),
        # modulation / embedders / final layer: replicated over tp, the
        # input dim on 'data' under FSDP
        (r".*(mod|modulation|adaLN_modulation\.1|lin)\.weight", (None, dp)),
        (r".*(img_in|txt_in|cond_in|in_layer|out_layer|linear)\.weight", (None, dp)),
    ]


def placed_tensors(model: nn.Module) -> Dict[str, torch.Tensor]:
    """What :func:`shard_params` places, by state-dict name: the
    parameters and the int8 linears' :data:`QUANT_BUFFERS`."""
    out = dict(model.named_parameters())
    out.update((n, b) for n, b in model.named_buffers() if n.rpartition(".")[2] in QUANT_BUFFERS)
    return out


def mmdit_param_specs(state_dict_or_model, fsdp: bool = True) -> Dict[str, Spec]:
    """The spec of each parameter (by state-dict name; of a model, each of
    :func:`placed_tensors`): per torch dim the mesh axis it is cut over, or
    None."""
    if isinstance(state_dict_or_model, nn.Module):
        shapes = {n: p.shape for n, p in placed_tensors(state_dict_or_model).items()}
    else:
        shapes = {n: getattr(v, "shape", v) for n, v in state_dict_or_model.items()}
    rules = _mmdit_rules(fsdp)
    out = {}
    for name, shape in shapes.items():
        spec: Spec = (None,) * len(shape)
        for pattern, rule in rules:
            if re.fullmatch(pattern, name):
                spec = tuple(rule[len(rule) - len(shape):]) if len(rule) >= len(shape) else spec
                break
        out[name] = spec
    return out


def tp_segments(name: str, shape, config) -> Optional[List[int]]:
    """The segments of a fused axis that 'tp' cuts one by one (see the
    module docstring), or None for one contiguous cut."""
    if config is None:
        return None
    h = config.hidden_size
    leaf = name.rsplit(".", 2)[-2]
    if leaf == "qkv":
        return [h, h, h]
    if leaf == "linear1":
        return [h, h, h, shape[0] - 3 * h]
    if leaf == "v_mlp":
        return [h, shape[0] - h]
    if leaf == "linear2" and name.endswith((".weight", ".weight_q")):
        return [h, shape[1] - h]
    return None


def _tp_cut(x: torch.Tensor, dim: int, j: int, tp: int, segments) -> torch.Tensor:
    if tp == 1:
        return x
    segs = x.split(segments, dim) if segments else (x,)
    return torch.cat([s.chunk(tp, dim)[j] for s in segs], dim) if len(segs) > 1 else segs[0].chunk(tp, dim)[j]


def _tp_join(locals_: Sequence[torch.Tensor], dim: int, segments) -> torch.Tensor:
    if len(locals_) == 1:
        return locals_[0]
    if not segments:
        return torch.cat(list(locals_), dim)
    tp = len(locals_)
    parts = [x.split([s // tp for s in segments], dim) for x in locals_]
    return torch.cat([torch.cat([p[s] for p in parts], dim) for s in range(len(segments))], dim)


class Placement:
    """One parameter cut over the mesh: ``keys`` lists (data index, tp
    index, (process, device)) of each leaf, one per distinct shard and
    device of this process's ranks (d, m, t) that hold it (m: every sp rank
    of an sp mesh; on a pipeline mesh its ``stage``, every stage where it
    has none); ``leaves`` (set by :func:`shard_params`) holds them."""

    def __init__(self, name: str, shape, spec: Spec, segments, sharding: "ModelSharding",
                 stage: Optional[int] = None, dtype: Optional[torch.dtype] = None):
        self.name, self.shape, self.spec, self.segments = name, tuple(shape), spec, segments
        self.sharding, self.stage = sharding, stage
        self.dtype = dtype or sharding.dtype  # what a rank reads it in
        self.data_dim = spec.index(DATA_AXIS) if DATA_AXIS in spec else None
        self.tp_dim = spec.index(TP_AXIS) if TP_AXIS in spec else None
        # ``q_proj.bias`` also ends in "proj.bias": the column rule comes first, as in the table
        self.row_bias = bool(re.fullmatch(rf".*{_ROW}\.bias", name)) and not re.fullmatch(rf".*{_COL}\.bias", name)
        mesh = sharding.mesh
        self.keys: List[Tuple[int, int, Tuple[int, torch.device]]] = []
        mids = mesh.local_mid if stage is None else (stage,)
        for d in mesh.local_data:
            for s in mids:
                for t in range(sharding.tp):
                    if not mesh.is_local(mesh.rank((d, s, t))):
                        continue  # another process's rank (of this tp group, or of another stage)
                    key = (d if self.data_dim is not None else 0, t if self.tp_dim is not None else 0,
                           mesh.home_key(d, t, s))
                    if key not in self.keys:
                        self.keys.append(key)
        self.index = {k: i for i, k in enumerate(self.keys)}
        self.leaves: Optional[nn.ParameterList] = None
        self.trained = False  # whether the leaves require grad (known on every process, set by shard_params)
        self.leaf_dtype = torch.float32  # the leaves' dtype (every process knows it, holding leaves or not)

    def holders(self, i: int, j: int) -> Tuple[int, ...]:
        """The processes that hold shard (i, j), in order."""
        mesh = self.sharding.mesh
        out = set()
        for r, p in enumerate(mesh.processes):
            d, m, t = mesh.coords(r)
            if (self.data_dim is None or d == i) and (self.tp_dim is None or t == j) \
                    and (self.stage is None or m == self.stage):
                out.add(p)
        return tuple(sorted(out))

    def piece(self, full: torch.Tensor, i: int, j: int) -> torch.Tensor:
        """Shard (i, j) of a tensor of the full shape (a view where it can be)."""
        x = full
        if self.tp_dim is not None:
            x = _tp_cut(x, self.tp_dim, j, self.sharding.tp, self.segments)
        if self.data_dim is not None:
            x = x.chunk(self.sharding.dp, self.data_dim)[i]
        return x

    def shard(self, full: torch.Tensor) -> List[torch.Tensor]:
        """One tensor per key: the key's shard of ``full`` on its device,
        owning its memory (``full`` itself where the key holds all of it on
        its device)."""
        out = []
        for i, j, (_, dev) in self.keys:
            x = self.piece(full, i, j)
            out.append(full if x.shape == full.shape and full.device == dev else copy_to(x, dev))
        return out

    def canonical(self) -> List[int]:
        """The index of one leaf per distinct shard (i, j)."""
        seen: Dict[Tuple[int, int], int] = {}
        for n, (i, j, _) in enumerate(self.keys):
            seen.setdefault((i, j), n)
        return list(seen.values())

    def gather(self, tensors: Sequence[torch.Tensor], device=None, dtype=None) -> Optional[torch.Tensor]:
        """The full tensor from one tensor per key (the leaves, or their
        gradients or optimizer moments), on ``device`` (default: the
        first's). Over processes every process calls it, for the
        placements in one order (a process may hold no leaf of one); each
        shard comes from its first holder, process 0 gets the tensor (its
        ``dtype``, default the leaves', tells it the shards' dtype), the
        others None."""
        by_shard = {self.keys[n][:2]: tensors[n] for n in self.canonical()}
        if self.sharding.across_processes:
            by_shard = self._on_process_0(by_shard, dtype or self.leaf_dtype)
            if by_shard is None:
                return None
        device = device or next(iter(by_shard.values())).device
        by_shard = {k: v.to(device) for k, v in by_shard.items()}
        n_i = self.sharding.dp if self.data_dim is not None else 1
        n_j = self.sharding.tp if self.tp_dim is not None else 1
        locals_ = [torch.cat([by_shard[(i, j)] for i in range(n_i)], self.data_dim) if self.data_dim is not None
                   else by_shard[(0, j)] for j in range(n_j)]
        return _tp_join(locals_, self.tp_dim, self.segments) if self.tp_dim is not None else locals_[0]

    def _on_process_0(self, by_shard: Dict[Tuple[int, int], torch.Tensor], dtype
                      ) -> Optional[Dict[Tuple[int, int], torch.Tensor]]:
        """Every shard (i, j) on process 0, sent there by its first holder
        in (i, j) order (None on the other processes)."""
        me = distributed.process_index()
        n_i = self.sharding.dp if self.data_dim is not None else 1
        n_j = self.sharding.tp if self.tp_dim is not None else 1
        meta = torch.empty(self.shape, device="meta")
        out = {}
        for i in range(n_i):
            for j in range(n_j):
                src = self.holders(i, j)[0]
                if src == me:
                    if me == 0:
                        out[(i, j)] = by_shard[(i, j)]
                    else:
                        process_isend(by_shard[(i, j)], 0)
                elif me == 0:
                    out[(i, j)] = process_recv(self.piece(meta, i, j).shape, dtype, "cpu", src)
        wait_sends()
        return out if me == 0 else None

    def local(self, d: int, t: int, dtype, s: int = 0) -> torch.Tensor:
        """What rank (d, s, t) computes with (s: its sp rank or pipeline
        stage): its tp shard, cast to ``dtype``, then gathered over 'data'
        (FSDP) on its device."""
        if self.stage is not None and s != self.stage:
            raise RuntimeError(f"{self.name} belongs to pipeline stage {self.stage}, read in stage {s}'s scope")
        mesh = self.sharding.mesh
        dev = mesh.home(d, t, s)
        j = t if self.tp_dim is not None else 0
        if self.data_dim is None:
            return self.leaves[self.index[(0, j, mesh.home_key(d, t, s))]].to(dtype)
        parts = [self.leaves[self.index[(i, j, mesh.home_key(i, t, s))]] for i in mesh.local_data]
        # the FSDP all-gather for the one rank that reads it; its gradient
        # is the reduce-scatter: each shard receives the sum of the data
        # ranks' gradients of its slice
        if self.sharding.across_processes:
            group = mesh.process_group(DATA_AXIS, mesh.rank((d, s, t)))
            return process_gather_shards(parts, self.data_dim, dtype, dev, group)
        return gather([p.to(dtype) for p in parts], self.data_dim, dev)

    def current(self) -> Optional[torch.Tensor]:
        scope = get_scope()
        if scope is None:
            raise RuntimeError(f"{self.name} is sharded over {self.sharding.mesh}: read it inside a rank scope")
        d, t, mid = scope
        return None if self.row_bias else self.local(d, t, self.dtype, mid)

    def rank_piece(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """The open scope's tp rank's cut of ``x`` along ``dim``, per
        segment as this placement's 'tp' dim is cut (a LoRA factor's rows or
        columns that meet the rank's weight shard)."""
        return _tp_cut(x, dim, get_scope()[1], self.sharding.tp, self.segments)


class ModelSharding:
    """The placements of a sharded model's parameters (by unsharded name,
    in the model's order) over ``mesh``; ``dtype`` is the compute dtype."""

    def __init__(self, mesh: Mesh, dtype: torch.dtype):
        self.mesh, self.dtype = mesh, dtype
        self.dp, self.tp = mesh.shape[DATA_AXIS], mesh.shape[TP_AXIS]
        self.sp = mesh.shape.get(SP_AXIS, 1)
        self.mid = mesh.shape[mesh.axes[1]]  # the middle axis: 'sp', or 'pp' on a pipeline mesh
        self.across_processes = mesh.n_processes > 1
        self.placements: Dict[str, Placement] = {}

    def leaf_names(self) -> Dict[str, List[str]]:
        """Per unsharded name, the state-dict names of its leaves."""
        out = {}
        for name, pl in self.placements.items():
            mod, _, leaf = name.rpartition(".")
            prefix = f"{mod}.{leaf}_shards" if mod else f"{leaf}_shards"
            out[name] = [f"{prefix}.{i}" for i in range(len(pl.keys))]
        return out

    def replicas(self) -> List[List[nn.Parameter]]:
        """The leaves that hold one shard on several devices, grouped."""
        groups = []
        for pl in self.placements.values():
            by_shard: Dict[Tuple[int, int], List[nn.Parameter]] = {}
            for n, (i, j, _) in enumerate(pl.keys):
                by_shard.setdefault((i, j), []).append(pl.leaves[n])
            groups += [g for g in by_shard.values() if len(g) > 1]
        return groups

    def non_canonical(self) -> set:
        """The ids of the leaves that repeat a shard another leaf holds: in
        this process, or in a process before this one (the first of the
        shard's holders counts it)."""
        me = distributed.process_index()
        keep = {id(pl.leaves[n]) for pl in self.placements.values() for n in pl.canonical()
                if pl.holders(*pl.keys[n][:2])[0] == me}
        return {id(p) for pl in self.placements.values() for p in pl.leaves if id(p) not in keep}

    @torch.no_grad()
    def sync_replica_grads(self) -> None:
        """Replicas on different devices each received their ranks' part
        of the gradient: every replica gets the sum (the DP all-reduce),
        first over this process's devices, then, for a shard several
        processes hold, over its holders (the sp ranks' partials in other
        processes; a shard whole along 'data', every process's): fp32
        all-reduces of at most ``REPLICA_BUCKET`` elements, each of the
        leaves of one set of holders, pipeline stage and tp rank (on one
        device), so that no device holds another's gradients. Every process
        issues its sums in the order of the holders, so that the processes
        of each group meet in the same order."""
        for group in self.replicas():
            if not group[0].requires_grad:  # a frozen leaf (a LoRA run's base) has no gradient
                continue
            grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in group]
            for p, g in zip(group, all_reduce(grads)):
                p.grad = g
        # per (holders, stage, tp index): the leaves of each shard that several
        # processes hold, its first (this process's first rank's) leading
        shared: Dict[Tuple[Tuple[int, ...], int, int], List[List[nn.Parameter]]] = {}
        for pl in self.placements.values():
            if self.across_processes and len(pl.leaves) and pl.leaves[0].requires_grad:
                for n in pl.canonical():
                    shard = pl.keys[n][:2]
                    holders = pl.holders(*shard)
                    if len(holders) > 1:
                        shared.setdefault((holders, pl.stage or 0, shard[1]), []).append(
                            [pl.leaves[m] for m, key in enumerate(pl.keys) if key[:2] == shard])
        for where in sorted(shared):
            holders = distributed.subgroup(where[0])
            for bucket in _buckets(shared[where], REPLICA_BUCKET):
                grads = [g[0].grad if g[0].grad is not None else torch.zeros_like(g[0]) for g in bucket]
                total = process_all_reduce(torch.cat([x.detach().float().flatten() for x in grads]), holders)
                for group, piece in zip(bucket, total.split([x.numel() for x in grads])):
                    for p in group:
                        p.grad = piece.view(p.shape).to(device=p.device, dtype=p.dtype)


def _buckets(groups: List[List[nn.Parameter]], limit: int) -> List[List[List[nn.Parameter]]]:
    """``groups`` in order, cut into runs of at most ``limit`` elements (of
    their first leaves; a larger leaf makes a run of its own)."""
    out: List[List[List[nn.Parameter]]] = [[]]
    size = 0
    for g in groups:
        if out[-1] and size + g[0].numel() > limit:
            out.append([])
            size = 0
        out[-1].append(g)
        size += g[0].numel()
    return out


class RankGroup:
    """The ranks of a sharded model at one data coordinate that run a
    forward together, each on its home device: this process's tp ranks at
    (data, mid, ·) (``mid``: the pipeline stage, or sp coordinate 0 where
    the tokens stay whole), or with ``seq`` (on a mesh with an 'sp' axis)
    this process's ranks (data, s, t), sp rank s holding the s-th chunk of
    the tokens: ``sps`` lists their sp coordinates (every one, unless the sp
    group spans processes), ``tps`` their tp coordinates (every one, unless
    the tp group spans processes: then ``tp_comm`` is the group of its
    processes, over which the row-parallel sums run). ``tp`` is the mesh's
    tp size, which cuts the heads and MLP columns. Per-rank lists are
    indexed r = k * n_tp + i, k the position in ``sps``, i in ``tps``;
    ``at(r)`` opens rank r's scope."""

    def __init__(self, sharding: ModelSharding, data: int, mid: int = 0, seq: bool = False):
        if data not in sharding.mesh.local_data:
            raise RuntimeError(f"data rank {data} is another process's (this one holds {sharding.mesh.local_data})")
        self.sharding, self.data, self.mid, self.tp = sharding, data, mid, sharding.tp
        mesh = sharding.mesh
        self.seq = seq and sharding.sp > 1
        self.sps = list(mesh.local_mid) if self.seq else [mid]
        self.sp = len(self.sps)
        self.tps = [t for t in range(self.tp) if mesh.is_local(mesh.rank((data, self.sps[0], t)))]
        if not self.tps:
            raise RuntimeError(f"no rank at (data {data}, {mesh.axes[1]} {self.sps[0]}) in this process")
        self.n_tp = len(self.tps)
        self.tp_comm = mesh.process_group(TP_AXIS, mesh.rank((data, self.sps[0], self.tps[0])))
        self.coords = [(s, t) for s in self.sps for t in self.tps]
        self.devices = [mesh.home(data, t, s) for s, t in self.coords]
        self.keys = [mesh.home_key(data, t, s) for s, t in self.coords]

    @contextlib.contextmanager
    def at(self, r: int):
        s, t = self.coords[r]
        with rank_scope(self.data, t, s):
            yield

    def each(self, fn: Callable[[int], object]) -> list:
        """``fn(r)`` in each rank's scope."""
        out = []
        for r in range(len(self.coords)):
            with self.at(r):
                out.append(fn(r))
        return out

    def rep(self, fn: Callable[[int], object]) -> list:
        """A computation replicated over 'tp': ``fn(r)`` once per chunk of
        the tokens and distinct device, in the scope of its first rank,
        shared by the tp ranks of that chunk on that device. The chunk is
        part of the key: ranks that share a device but hold other tokens
        compute their own."""
        done: Dict[Tuple[int, Tuple[int, torch.device]], object] = {}
        out = []
        for r, key in enumerate(self.keys):
            key = (self.coords[r][0], key)
            if key not in done:
                with self.at(r):
                    done[key] = fn(r)
            out.append(done[key])
        return out

    def chunks(self, fn: Callable[[int], object]) -> list:
        """``fn(r)`` once per chunk of the tokens, in the scope of its tp
        rank 0: a list over the sp ranks."""
        out = []
        for r in range(0, len(self.coords), self.n_tp):
            with self.at(r):
                out.append(fn(r))
        return out

    def sp_sets(self) -> List[List[int]]:
        """Per tp rank of this process (in ``tps`` order), its ranks of that
        rank's sp group in sp order: the ranks an attention over sequence
        shards runs over."""
        return [list(range(i, len(self.coords), self.n_tp)) for i in range(self.n_tp)]

    def shard_group(self, i: int) -> Optional[ShardGroup]:
        """The sp group of this process's i-th tp rank (``tps[i]``) where its
        ranks lie in several processes (None where all lie in this one)."""
        mesh = self.sharding.mesh
        ranks = mesh.group(SP_AXIS, mesh.rank((self.data, 0, self.tps[i])))
        if all(mesh.is_local(r) for r in ranks):
            return None
        return ShardGroup(len(ranks), self.sps[0], tuple(mesh.processes[r] for r in ranks),
                          mesh.process_group(SP_AXIS, ranks[0]))

    def row(self, linear: nn.Module, xs: Sequence[torch.Tensor], width: Optional[int] = None) -> List[torch.Tensor]:
        """A row-parallel product over the tp ranks of each chunk: each
        rank's partial, then :func:`row_parallel`. A linear with
        ``tp_row_partials`` (an int8 ``QuantLinear``, whose activation scale
        spans the whole row) makes its partials itself, and the sum is
        rounded to its ``dtype``. A chunk without tokens (the text part of
        an image-only chunk) gets an empty output ``width`` wide and runs
        nothing."""
        if self.seq:
            out: List[torch.Tensor] = []
            for k, s in enumerate(self.sps):
                part = xs[k * self.n_tp:(k + 1) * self.n_tp]
                if part[0].shape[1] == 0:
                    out += [x.new_empty((*x.shape[:-1], width)) for x in part]
                else:
                    out += RankGroup(self.sharding, self.data, s).row(linear, part)
            return out
        partials = getattr(linear, "tp_row_partials", None)
        if partials is None:
            return row_parallel(linear, self.each(lambda t: linear(xs[t])), self)
        return row_parallel(linear, partials(self, xs), self, dtype=linear.dtype)


class OneRank:
    """The one-rank form of :class:`RankGroup`, for an unsharded model: each
    function runs once, and a row-parallel product is the linear itself,
    its bias included."""

    tp = sp = n_tp = 1
    seq = False

    @staticmethod
    def each(fn: Callable[[int], object]) -> list:
        return [fn(0)]

    rep = each

    @staticmethod
    def row(linear: nn.Module, xs: Sequence[torch.Tensor], width: Optional[int] = None) -> List[torch.Tensor]:
        return [linear(xs[0])]


ONE_RANK = OneRank()


def row_parallel(linear: nn.Module, partials: Sequence[torch.Tensor], group: RankGroup,
                 dtype=None) -> List[torch.Tensor]:
    """The all-reduce of the tp ranks' partial products, summed in fp32 and
    rounded once (to ``dtype``, default the partials'), with the row bias
    added once to the sum: over the tp group's processes where it spans
    several (``group.tp_comm``; the bias then added after the sum across
    them, once per tp group)."""
    bias = getattr(linear, "_placements", {}).get("bias")
    b = None if bias is None else [bias.local(group.data, t, partials[i].dtype, group.mid)
                                   for i, t in enumerate(group.tps)]
    return all_reduce(partials, dtype=dtype, bias=b, group=group.tp_comm)


_SHARDED_CLASSES: Dict[Tuple[type, Tuple[str, ...]], type] = {}


def _sharded_class(cls: type, names: Tuple[str, ...]) -> type:
    """``cls`` with each of ``names`` read from its placement."""
    key = (cls, names)
    if key not in _SHARDED_CLASSES:
        def reader(n):
            return property(lambda self: self._placements[n].current())

        _SHARDED_CLASSES[key] = type(f"Sharded{cls.__name__}", (cls,), {n: reader(n) for n in names})
    return _SHARDED_CLASSES[key]


def _check_tp(model: nn.Module, mesh: Mesh) -> None:
    tp, sp = mesh.shape[TP_AXIS], mesh.shape.get(SP_AXIS, 1)
    config = getattr(model, "config", None)
    if config is None or tp == 1:
        return
    mlp = int(config.hidden_size * config.mlp_ratio)
    if config.num_heads % tp or mlp % tp:
        raise ValueError(f"tp {tp} must divide the heads ({config.num_heads}) and the MLP width ({mlp}); "
                         f"(tp, sp) = ({tp}, {sp})")


def mesh_spec(spec: Spec, shape, mesh: Mesh) -> Spec:
    """The spec a parameter of ``shape`` takes on ``mesh``: a 'data' dim
    stays whole where the axis has one rank or does not divide it ('tp'
    must divide what it cuts: ``shard_params`` raises)."""
    dp = mesh.shape[DATA_AXIS]
    return tuple(a if a != DATA_AXIS or (dp > 1 and shape[i] % dp == 0) else None for i, a in enumerate(spec))


def shard_params(mesh: Mesh, model: nn.Module, fsdp: bool = True, specs: Optional[Dict[str, Spec]] = None,
                 stages: Optional[Dict[str, Optional[int]]] = None) -> nn.Module:
    """Cut ``model``'s parameters into per-rank shards on the ranks'
    devices, in place: each parameter is replaced by its leaves as they are
    made, so its unsharded copy is freed before the next one is cut. Sets
    ``model.sharding`` (a :class:`ModelSharding`); its forward then runs
    over the mesh. ``specs`` (by name, on this mesh; a train state's come
    from ``training/diffusion.state_shardings``) default to the rules
    through :func:`mesh_spec`: an axis whose size does not divide a 'data'
    dim, or a mesh of one data rank, leaves that dim replicated
    (``constrain``'s rule); 'tp' must divide what it cuts. ``stages`` (by
    name, on a pipeline mesh) puts a parameter on one stage's ranks."""
    _check_tp(model, mesh)
    config = getattr(model, "config", None)
    dtype = getattr(model, "compute_dtype", None) or next(model.parameters()).dtype
    sharding = ModelSharding(mesh, dtype)
    rules = mmdit_param_specs(model, fsdp)
    specs = dict(specs or {})
    for name, p in placed_tensors(model).items():
        specs.setdefault(name, mesh_spec(rules[name], p.shape, mesh))
    for mod_name, module in list(model.named_modules()):
        names = tuple(n for n, p in module._parameters.items() if p is not None)
        names += tuple(n for n in QUANT_BUFFERS if module._buffers.get(n) is not None)
        if not names:
            continue
        module._placements = {}
        for pn in names:
            full = f"{mod_name}.{pn}" if mod_name else pn
            p = module._parameters.pop(pn) if pn in module._parameters else module._buffers.pop(pn)
            spec = specs[full]
            own = not p.is_floating_point() or full.endswith(OWN_DTYPE)
            pl = Placement(full, p.shape, spec, tp_segments(full, p.shape, config) if TP_AXIS in spec else None,
                           sharding, (stages or {}).get(full), dtype=p.dtype if own else None)
            if pl.tp_dim is not None and p.shape[pl.tp_dim] % sharding.tp:
                raise ValueError(f"{full} {tuple(p.shape)}: dim {pl.tp_dim} does not split over tp {sharding.tp}")
            requires_grad = p.requires_grad
            pl.trained, pl.leaf_dtype = requires_grad, p.dtype
            tensors = pl.shard(p.data)
            del p
            pl.leaves = nn.ParameterList([nn.Parameter(x, requires_grad=requires_grad) for x in tensors])
            setattr(module, f"{pn}_shards", pl.leaves)
            module._placements[pn] = pl
            sharding.placements[full] = pl
        module.__class__ = _sharded_class(type(module), names)
    if hasattr(model, "compute_dtype") and model.compute_dtype is None:
        model.compute_dtype = dtype
    model.sharding = sharding
    return model


def unshard_params(model: nn.Module) -> nn.Module:
    """The inverse of :func:`shard_params`, in place: each placement's
    leaves joined into one parameter (or int8 buffer) on the device of its
    first leaf, where a leaf that holds the whole tensor is taken as it is
    (a mesh of logical ranks on the model's device copies nothing), and the
    modules' classes restored. One process only."""
    sharding = getattr(model, "sharding", None)
    if sharding is None:
        return model
    if sharding.across_processes:
        raise NotImplementedError("unsharding a model whose shards span processes")
    for module in model.modules():
        placements = module.__dict__.pop("_placements", None)
        if placements is None:
            continue
        module.__class__ = module.__class__.__bases__[0]
        for pn, pl in placements.items():
            leaves = getattr(module, f"{pn}_shards")
            delattr(module, f"{pn}_shards")
            full = pl.gather([p.detach() for p in leaves])
            if pn in QUANT_BUFFERS:
                module.register_buffer(pn, full)
            else:
                module.register_parameter(pn, nn.Parameter(full, requires_grad=leaves[0].requires_grad))
    del model.sharding
    return model


def constrain(shape, spec: Spec, mesh: Optional[Mesh] = None) -> Spec:
    """The spec a tensor of ``shape`` takes on the mesh (default: the
    process's): an axis the mesh lacks, or whose size does not divide its
    dim, degrades to None (replicated), as the JAX package's ``constrain``
    does (the reference's degenerate-split guard)."""
    mesh = mesh or get_mesh()
    if mesh is None:
        return (None,) * len(shape)
    return tuple(a if a is not None and a in mesh.shape and dim % mesh.shape[a] == 0 else None
                 for a, dim in zip(spec, shape))
