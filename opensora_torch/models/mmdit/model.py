"""MMDiT -- the 11B Flux-derived dual/single-stream diffusion transformer
(counterpart of opensora_tpu/models/mmdit/model.py).

The JAX package stacks the blocks under ``nn.scan``; here they are
``nn.ModuleList``s run by a Python loop, with state-dict keys
``double_blocks.{i}.*`` / ``single_blocks.{i}.*`` in the upstream Open-Sora
v2 layout.

Gradient checkpointing (``remat``, ``remat_policy``; the JAX package's
``nn.remat`` policies, opensora_tpu/models/mmdit/model.py:215-226) wraps
each block in ``torch.utils.checkpoint`` when gradients are enabled:
"full" keeps only the block's inputs and recomputes the rest in the
backward; "dots" also keeps every matmul output (selective checkpointing);
"offload" recomputes as "full" does and parks each block's saved inputs in
pinned host memory until its backward (the JAX policy is
``save_and_offload_only_these_names`` with both name lists empty: nothing
inside a block is saved, and what stays per block is the scanned carry).

``param_dtype`` keeps the parameters in another dtype than the compute
``dtype`` (fp32 master weights under bf16 compute, as the JAX package
trains): every float linear casts its weight and bias to the input's dtype
at use (``models/cast_layers.py``), the norm scales are cast by the norms.
Left unset, the parameters are in the compute dtype; the trainer sets it
for a full finetune (``opensora_torch/train.py``).

Sharded over a mesh (``parallel/sharding.shard_params``, which sets
``sharding``; a pipeline mesh's forward is ``training/pp.make_pp_forward``
over :meth:`MMDiTModel.prepare_block_inputs`, :meth:`MMDiTModel.run_block`
and ``final_layer``), the forward cuts the rows over the data ranks
(:meth:`MMDiTModel.forward_rank` runs one data rank's rows) and runs each
block's ``forward_tp`` over the ranks of the data coordinate: the
embedders and the final layer replicated over 'tp', each rank's heads and
MLP columns on its own device, the row-parallel products all-reduced. The
blocks are checkpointed as above, so an FSDP weight is gathered inside the
checkpointed function (and again for its recompute) and freed after use.

On a mesh with an 'sp' axis the tokens are cut over it from the embedders
to the final layer, in the layout JAX's attention under SP sees
(``parallel/data.joint_chunks``): sp rank s holds the joint [txt, img]
tokens [s L / sp, (s + 1) L / sp) with their RoPE ids and rows of
``cond``, and runs every linear, norm, MLP and modulation of both stacks
on them alone, on its own device; only the attention spans the group. In
a double block a rank's chunk is a text part and an image part (rank 0
holds all 512 text tokens of a 256px clip and 1695 image tokens, ranks 1-3
2207 image tokens each); the final layer runs on each rank's image part,
and the parts are gathered in order on the device of rank (d, 0, 0), whose
backward cuts the gradient. Every op outside the attention works token by
token (the modulation per sample), so the result is the unsharded
forward's up to rounding. JAX pins the text and the image stream to 'sp'
each in the double blocks (opensora_tpu/models/mmdit/model.py:178-185);
the joint chunks give the same result and need only that L divides by sp,
which ``seq_align`` sees to. Where L does not divide, the tokens stay whole
on the ranks at sp coordinate 0 and only the attention is cut over 'sp',
as JAX's ``constrain`` leaves them replicated.

``quantized`` (False | True/"w8" | "w8a8" | "w8a8_pallas" | "w8a8_fq")
builds every linear of the blocks as an int8 ``QuantLinear``
(``ops/quant.py``), zero-initialized as in the JAX package; a quantized
model for serving comes from a float one by ``quantize_model_`` or from a
quantized state dict; ``from_pretrained`` quantizes the checkpoint's float
weights as they load (``utils/ckpt.load_checkpoint``).
"""

from __future__ import annotations

import functools
import logging
from dataclasses import dataclass, field
from typing import Optional, Sequence, Union

import torch
import torch.nn as nn
from torch.utils.checkpoint import CheckpointPolicy, checkpoint, create_selective_checkpoint_contexts

from opensora_torch.models.cast_layers import Linear
from opensora_torch.models.mmdit.layers import (
    DoubleStreamBlock,
    LastLayer,
    MLPEmbedder,
    SingleStreamBlock,
    timestep_embedding,
    tokenwise,
)
from opensora_torch.ops.quant import quant_mode
from opensora_torch.ops.rope import embed_nd
from opensora_torch.registry import MODELS

logger = logging.getLogger(__name__)


@functools.lru_cache(maxsize=None)
def _log_whole_sequence(n: int, sp: int) -> None:
    """Logs, once per length and sp size, that the tokens stay whole."""
    logger.info("%d joint tokens do not split over sp %d: the blocks run the whole sequence on sp rank 0, the "
                "attention cut over 'sp'", n, sp)


@dataclass
class MMDiTConfig:
    in_channels: int = 64
    vec_in_dim: int = 768
    context_in_dim: int = 4096
    hidden_size: int = 3072
    mlp_ratio: float = 4.0
    num_heads: int = 24
    depth: int = 19
    depth_single_blocks: int = 38
    axes_dim: Sequence[int] = field(default_factory=lambda: [16, 56, 56])
    theta: int = 10_000
    qkv_bias: bool = True
    guidance_embed: bool = True
    cond_embed: bool = False
    fused_qkv: bool = True
    patch_size: int = 2
    rope_convention: str = "split"
    # the RoPE pairing the from_pretrained weights were trained with (original
    # Flux checkpoints: "interleaved"); the loader permutes q/k rows to rope_convention
    ckpt_rope_convention: str = "split"
    # None = flash attention; "xla" = plain attention; "int8" / "int8_qk8" = int8 attention
    attn_backend: Optional[str] = None
    quantized: Union[bool, str] = False  # False | True/"w8" | "w8a8" | "w8a8_pallas" | "w8a8_fq"
    remat: bool = False  # checkpoint each block when gradients are enabled
    remat_policy: str = "full"  # "full" | "dots" | "offload"
    dtype: str = "bf16"
    param_dtype: Optional[str] = None  # None: the compute dtype
    from_pretrained: Optional[str] = None

    @property
    def pe_dim(self) -> int:
        return self.hidden_size // self.num_heads


_MATMULS = frozenset({
    torch.ops.aten.mm.default, torch.ops.aten.addmm.default,
    torch.ops.aten.bmm.default, torch.ops.aten.baddbmm.default,
})


def _save_matmuls(ctx, op, *args, **kwargs):
    """Selective-checkpoint policy of "dots" (jax.checkpoint_policies.
    dots_saveable): keep matmul outputs, recompute everything else."""
    return CheckpointPolicy.MUST_SAVE if op in _MATMULS else CheckpointPolicy.PREFER_RECOMPUTE


REMAT_CONTEXTS = {
    "full": {},
    "dots": dict(context_fn=functools.partial(create_selective_checkpoint_contexts, _save_matmuls)),
    "offload": {},
}


class MMDiTModel(nn.Module):
    sharding = None  # a parallel/sharding.ModelSharding once shard_params has cut the parameters

    def __init__(self, config: MMDiTConfig, device=None, dtype: Optional[torch.dtype] = None,
                 compute_dtype: Optional[torch.dtype] = None):
        """``dtype``: the parameters'; ``compute_dtype``: the activations'
        (default: the parameters')."""
        super().__init__()
        cfg = self.config = config
        self.compute_dtype = compute_dtype
        if cfg.remat and cfg.remat_policy not in REMAT_CONTEXTS:
            raise ValueError(f"unknown remat_policy {cfg.remat_policy!r}; expected one of {sorted(REMAT_CONTEXTS)}")
        if cfg.hidden_size % cfg.num_heads != 0:
            raise ValueError(f"hidden_size {cfg.hidden_size} not divisible by num_heads {cfg.num_heads}")
        if sum(cfg.axes_dim) != cfg.pe_dim:
            raise ValueError(f"axes_dim {cfg.axes_dim} != pe dim {cfg.pe_dim}")
        quant_mode(cfg.quantized)  # an unknown mode raises
        factory = dict(device=device, dtype=dtype)
        hidden = cfg.hidden_size
        self.img_in = Linear(cfg.in_channels, hidden, **factory)
        self.time_in = MLPEmbedder(256, hidden, **factory)
        self.vector_in = MLPEmbedder(cfg.vec_in_dim, hidden, **factory)
        if cfg.guidance_embed:
            self.guidance_in = MLPEmbedder(256, hidden, **factory)
        if cfg.cond_embed:
            self.cond_in = Linear(cfg.in_channels + cfg.patch_size**2, hidden, **factory)
            nn.init.zeros_(self.cond_in.weight)
            nn.init.zeros_(self.cond_in.bias)
        self.txt_in = Linear(cfg.context_in_dim, hidden, **factory)
        common = dict(num_heads=cfg.num_heads, mlp_ratio=cfg.mlp_ratio, fused_qkv=cfg.fused_qkv,
                      rope_convention=cfg.rope_convention, attn_backend=cfg.attn_backend,
                      quantized=cfg.quantized, **factory)
        self.double_blocks = nn.ModuleList(
            DoubleStreamBlock(hidden, qkv_bias=cfg.qkv_bias, **common) for _ in range(cfg.depth)
        )
        self.single_blocks = nn.ModuleList(
            SingleStreamBlock(hidden, **common) for _ in range(cfg.depth_single_blocks)
        )
        self.final_layer = LastLayer(hidden, cfg.in_channels, **factory)

    @property
    def dtype(self) -> torch.dtype:
        """The compute dtype: inputs are cast to it."""
        return self.compute_dtype or self.img_in.weight.dtype

    def prepare_block_inputs(self, img, img_ids, txt, txt_ids, timesteps, y_vec, cond=None,
                             guidance=None):
        """Project the streams, build the conditioning vector and RoPE tables."""
        cfg = self.config
        if img.dim() != 3 or txt.dim() != 3:
            raise ValueError("img and txt must be (B, L, C)")
        dt, hidden = self.dtype, cfg.hidden_size
        img = tokenwise(self.img_in, img.to(dt), hidden)
        if cfg.cond_embed:
            if cond is None:
                raise ValueError("cond_embed=True requires a cond input")
            img = img + tokenwise(self.cond_in, cond.to(dt), hidden)
        vec = self.time_in(timestep_embedding(timesteps, 256).to(dt))
        if cfg.guidance_embed:
            if guidance is None:
                raise ValueError("guidance_embed=True requires a guidance input")
            vec = vec + self.guidance_in(timestep_embedding(guidance, 256).to(dt))
        vec = vec + self.vector_in(y_vec.to(dt))
        txt = tokenwise(self.txt_in, txt.to(dt), hidden)
        pe = embed_nd(torch.cat([txt_ids, img_ids], dim=1), cfg.axes_dim, cfg.theta)
        return img, txt, vec, pe

    def _run_block(self, block: nn.Module, *args):
        cfg = self.config
        if not (cfg.remat and torch.is_grad_enabled()):
            return block(*args)
        if cfg.remat_policy == "offload":
            # the checkpoint saves the block's inputs through the hooks open
            # around it: these move them to pinned host memory and back
            with torch.autograd.graph.save_on_cpu(pin_memory=True):
                return checkpoint(block, *args, use_reentrant=False)
        return checkpoint(block, *args, use_reentrant=False, **REMAT_CONTEXTS[cfg.remat_policy])

    def run_block(self, block: nn.Module, g, *args):
        """One block over the tp ranks of ``g`` (``parallel/sharding.
        RankGroup``), per-rank lists in and out, checkpointed as the
        config asks: what a pipeline stage runs block by block
        (``training/pp.py``), as :meth:`forward_rank` does."""
        return self._run_block(functools.partial(block.forward_tp, g), *args)

    def forward(self, img, img_ids, txt, txt_ids, timesteps, y_vec, cond=None, guidance=None):
        if self.sharding is not None:
            return self._forward_sharded(img, img_ids, txt, txt_ids, timesteps, y_vec, cond, guidance)
        img, txt, vec, pe = self.prepare_block_inputs(
            img, img_ids, txt, txt_ids, timesteps, y_vec, cond, guidance
        )
        for block in self.double_blocks:
            img, txt = self._run_block(block, img, txt, vec, pe)
        x = torch.cat([txt, img], dim=1)
        for block in self.single_blocks:
            x = self._run_block(block, x, vec, pe)
        return self.final_layer(x[:, txt.shape[1]:], vec)

    def _forward_sharded(self, img, *inputs):
        """The forward over the mesh the parameters are sharded on: the rows
        cut over the data ranks (all rows on data rank 0 where they do not
        divide, as the JAX package's ``constrain`` leaves them replicated),
        each run by :meth:`forward_rank`, the outputs joined on ``img``'s
        device. Over processes, the rows are this process's, cut over its
        data ranks."""
        from opensora_torch.parallel.data import row_slice

        b, local = img.shape[0], self.sharding.mesh.local_data
        pieces = len(local) if b % len(local) == 0 else 1
        outs = []
        for k in range(pieces):
            rows = row_slice(b, pieces, k)
            out = self.forward_rank(local[k], img[rows], *(None if x is None else x[rows] for x in inputs))
            outs.append(out.to(img.device))
        return torch.cat(outs, 0) if len(outs) > 1 else outs[0]

    def forward_rank(self, d, img, img_ids, txt, txt_ids, timesteps, y_vec, cond=None, guidance=None):
        """Data rank ``d``'s rows through the sharded model: its ranks
        (``parallel/sharding.RankGroup``) run every block together, each on
        its home device. On an sp mesh whose joint sequence splits over
        'sp', sp rank s embeds and runs its chunk of the tokens (see the
        module docstring). Returns the output on the device of the group's
        first rank (of rank (d, 0, 0) in one process); where the sp group
        spans processes, each holds its ranks' chunks, and the output is
        joined over the group's processes (``comm.gather_replicated``: the
        loss over it is then the same on each of them)."""
        from opensora_torch.parallel.comm import gather_replicated
        from opensora_torch.parallel.data import joint_chunks
        from opensora_torch.parallel.sharding import RankGroup

        n_txt, n_img, sp = txt.shape[1], img.shape[1], self.sharding.sp
        seq = (n_txt + n_img) % sp == 0
        g = RankGroup(self.sharding, d, seq=seq)
        group = g.shard_group(0) if seq else None
        if not seq:
            if len(self.sharding.mesh.local_mid) < sp:  # the sp group spans processes
                raise NotImplementedError(f"{n_txt + n_img} joint tokens do not split over sp {sp}, whose group "
                                          f"spans processes: pad the text so that they do (seq_align)")
            _log_whole_sequence(n_txt + n_img, sp)
        chunks = joint_chunks(n_txt, n_img, sp if seq else 1)

        def prepare(r):
            ts, is_ = chunks[g.coords[r][0]]
            dev = g.devices[r]

            def cut(x, rows):
                return None if x is None else x[:, rows].to(dev)

            return self.prepare_block_inputs(cut(img, is_), cut(img_ids, is_), cut(txt, ts), cut(txt_ids, ts),
                                             *(None if x is None else x.to(dev) for x in (timesteps, y_vec)),
                                             cut(cond, is_), None if guidance is None else guidance.to(dev))

        prep = g.rep(prepare)
        img, txt, vec, pe = ([p[i] for p in prep] for i in range(4))
        for block in self.double_blocks:
            img, txt = self.run_block(block, g, img, txt, vec, pe)
        x = g.rep(lambda r: torch.cat([txt[r], img[r]], dim=1))
        for block in self.single_blocks:
            x = self.run_block(block, g, x, vec, pe)
        out_dim = self.config.in_channels
        outs = g.chunks(lambda r: tokenwise(lambda y: self.final_layer(y, vec[r]), x[r][:, txt[r].shape[1]:], out_dim))
        out = torch.cat([o.to(g.devices[0]) for o in outs], 1) if len(outs) > 1 else outs[0]
        if group is None:
            return out
        # each process's image tokens: those of its run of sp ranks
        sizes = [sum(chunks[s][1].stop - chunks[s][1].start for s in range(sp) if group.processes[s] == q)
                 for q in group.comm.ranks]
        return gather_replicated(out, 1, sizes, group.comm, anchors=list({id(y): y for y in x}.values()))


@MODELS.register_module("flux")
def Flux(from_pretrained: Optional[str] = None, dtype: str = "bf16", device=None, **kwargs) -> MMDiTModel:
    """Build an MMDiT from a config dict's entries; unknown keys are ignored.
    Weights, in the torch dtype named by ``param_dtype`` (by ``dtype`` where
    it is unset), are loaded from the checkpoint ``from_pretrained`` names
    (either upstream layout and RoPE pairing, quantized at load for a
    ``quantized`` config, cast to the parameters' dtype; see
    ``utils/ckpt.load_checkpoint``), else random (nn.Linear init, zero
    ``cond_in``); the model computes in ``dtype``."""
    from opensora_torch.utils.ckpt import load_checkpoint
    from opensora_torch.utils.misc import torch_dtype

    known = set(MMDiTConfig.__dataclass_fields__)
    config = MMDiTConfig(from_pretrained=from_pretrained, dtype=dtype,
                         **{k: v for k, v in kwargs.items() if k in known})
    build = functools.partial(MMDiTModel, config, dtype=torch_dtype(config.param_dtype or dtype),
                              compute_dtype=torch_dtype(dtype))
    if from_pretrained:
        return load_checkpoint(build(device="meta"), from_pretrained, "mmdit", device)
    return build(device=device)
