"""Pipeline-parallel MMDiT training forward (counterpart of
opensora_tpu/training/pp.py).

The block stacks are cut into stages over a mesh's 'pp' axis: block i of a
stack of L goes to stage i // (L / S), and its parameters lie on that
stage's devices only (the PP memory win); under PP x TP each stage's
linears are also cut over its 'tp' ranks by the TP rules
(``parallel/sharding.py``, the q / k / v segments by heads). Embedders and
the final layer are replicated over the pp ranks. The forward runs
``prepare_block_inputs`` on stage 0's ranks, the double-stream stack as one
GPipe pipeline (``parallel/pipeline.pipeline_apply``), ``cat([txt, img])``,
the single-stream stack as a second pipeline (two bubbles, as in JAX), and
the final layer on the last stage's ranks. Each microbatch's rows are cut
over the 'data' ranks (JAX's ``batch_spec = P(None, 'data')``). Autograd
through the pipelines gives the reverse schedule, so the train step is the
shared one (``training/diffusion.make_train_step(forward_fn=)``).

Across processes (a pipeline whose stages, or a stage's tp group, span
them: ``parallel/pipeline.py``; under gloo and nccl alike) each process
runs its own stages only: stage 0's processes prepare the inputs, and the
last stage's compute the final layer and return the output; the others
return None. With grad on, the forward records its slots on a
``pipeline.PipelineTape`` (``pipeline.take_tape``), cut from the stage-0
inputs (the embedders' outputs stand as leaves, the cut's backward runs
last); ``training/diffusion.pipeline_loss`` runs the backward from it, slot
by slot in reverse tick order, on every process. The activations' shapes
between stages, which both sides of a message must know, follow from the
batch and the config (``boundaries``).

The depths must divide by the pp size (19 double blocks of the 11B config:
pp sizes that divide 19), as the reference's stage manager assumes.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch
import torch.nn as nn
from torch.utils._pytree import tree_flatten, tree_map, tree_unflatten

from opensora_torch.parallel.mesh import DATA_AXIS, PP_AXIS, TP_AXIS, Mesh
from opensora_torch.parallel.mesh import create_pp_mesh  # noqa: F401  (JAX's training/pp.py has it here)
from opensora_torch.parallel.comm import wait_sends
from opensora_torch.parallel.pipeline import check_transport, holds, pipeline_apply, split_stages, start_tape
from opensora_torch.parallel.sharding import RankGroup, Spec, mmdit_param_specs, shard_params
from opensora_torch.training.diffusion import match_opt_shardings

BLOCK_STACKS = ("double_blocks", "single_blocks")


def _check_depths(model: nn.Module, n_stages: int) -> None:
    cfg = model.config
    if cfg.depth % n_stages or cfg.depth_single_blocks % n_stages:
        raise ValueError(f"block depths ({cfg.depth}, {cfg.depth_single_blocks}) must divide by pp={n_stages}")


def pp_param_specs(model: nn.Module, n_stages: int, tp: bool = False) -> Dict[str, Tuple[Optional[int], Spec]]:
    """Per parameter (by state-dict name): the pipeline stage that holds it
    (None: replicated over the pp ranks) and its spec (``pp_param_specs``,
    opensora_tpu/training/pp.py:43-89). With ``tp`` the spec is the TP
    rule's (no FSDP); else every dim is whole."""
    _check_depths(model, n_stages)
    base = mmdit_param_specs(model, fsdp=False) if tp else None
    out = {}
    for name, p in model.named_parameters():
        stack, _, rest = name.partition(".")
        stage = None
        if stack in BLOCK_STACKS:
            per = len(getattr(model, stack)) // n_stages
            stage = int(rest.split(".", 1)[0]) // per
        out[name] = (stage, base[name] if tp else (None,) * p.dim())
    return out


def pp_state_shardings(mesh: Mesh, state, model: nn.Module, tp: Optional[bool] = None) -> dict:
    """The specs and stages of an unsharded train state on a pipeline mesh
    (``pp_state_shardings``, :92-116): the parameters' by
    :func:`pp_param_specs`, the EMA's and the optimizer moments' those of
    their parameter, matched by name, not by shape (a moment is kept by
    its parameter's position). ``tp`` defaults to whether the mesh's 'tp'
    axis has more than one rank. The result is ``shard_state``'s
    ``shardings``."""
    if tp is None:
        tp = mesh.shape.get(TP_AXIS, 1) > 1
    specs = pp_param_specs(model, mesh.shape[PP_AXIS], tp=tp)
    pspecs = {n: specs[n][1] for n in state.params}
    return dict(step=(), params=pspecs, stages={n: specs[n][0] for n in state.params},
                ema=pspecs if state.ema is not None else None,
                optimizer=match_opt_shardings(state.params, pspecs, state.optimizer.state_dict()))


def shard_pp(mesh: Mesh, model: nn.Module) -> nn.Module:
    """Place ``model``'s parameters on the pipeline mesh in place
    (``parallel/sharding.shard_params`` with each block's stage), by TP
    rules inside each stage where the mesh's 'tp' axis has more than one
    rank."""
    specs = pp_param_specs(model, mesh.shape[PP_AXIS], tp=mesh.shape.get(TP_AXIS, 1) > 1)
    return shard_params(mesh, model, fsdp=False, specs={n: s for n, (_, s) in specs.items()},
                        stages={n: st for n, (st, _) in specs.items()})


def make_pp_forward(model: nn.Module, mesh: Mesh, n_micro: int, axis: str = PP_AXIS,
                    data_axis: Optional[str] = DATA_AXIS) -> Callable:
    """The MMDiT forward with the block stacks as GPipe pipelines over
    ``mesh``'s ``axis`` (``make_pp_forward``, :119-190): the model's
    signature, the global batch in (over processes: this process's rows,
    over its own data ranks), the output on ``img``'s device. The model
    must be placed on ``mesh`` (:func:`shard_pp`). ``n_micro``
    microbatches must divide the batch (fill the pipeline with n_micro >=
    2 * pp for a small bubble), and each microbatch's rows the (process's)
    'data' ranks. Over processes a process that holds no last stage
    returns None (see the module docstring)."""
    n_stages = mesh.shape[axis]
    _check_depths(model, n_stages)
    sharding = model.sharding
    if sharding is None or sharding.mesh is not mesh:
        raise ValueError("make_pp_forward: place the model on the mesh first (training/pp.shard_pp)")
    local = mesh.local_data if data_axis and data_axis in mesh.shape else [0]
    dp = len(local)
    spans = check_transport(mesh, axis)
    last = n_stages - 1
    groups = {(d, s): RankGroup(sharding, d, s) for d in local for s in range(n_stages) if holds(mesh, d, s)}
    first, final = holds(mesh, local[0], 0), holds(mesh, local[0], last)
    dbl = split_stages(model.double_blocks, n_stages)
    sgl = split_stages(model.single_blocks, n_stages)
    cfg = model.config

    def boundaries(rows, n_txt, n_img):
        """One tp rank's activation between two stages of the double and of
        the single stack as meta tensors: (img, txt, vec, pe) and (x, vec,
        pe), in the compute dtype; RoPE's (cos, sin), fp32, carry no
        gradient."""
        def meta(*shape, dtype=model.dtype, grad=True):
            return torch.empty(shape, dtype=dtype, device="meta", requires_grad=grad)

        n, h = n_txt + n_img, cfg.hidden_size
        vec = meta(rows, h)
        pe = tuple(meta(rows, n, sum(cfg.axes_dim) // 2, dtype=torch.float32, grad=False) for _ in range(2))
        return (meta(rows, n_img, h), meta(rows, n_txt, h), vec, pe), (meta(rows, n, h), vec, pe)

    def fields(act, n):
        return [[a[i] for a in act] for i in range(n)]

    def dbl_stage(blocks, act, d, s):
        g = groups[(d, s)]
        img, txt, vec, pe = fields(act, 4)
        for block in blocks:
            img, txt = model.run_block(block, g, img, txt, vec, pe)
        return [(img[t], txt[t], vec[t], pe[t]) for t in range(g.n_tp)]

    def sgl_stage(blocks, act, d, s):
        g = groups[(d, s)]
        x, vec, pe = fields(act, 3)
        for block in blocks:
            x = model.run_block(block, g, x, vec, pe)
        return [(x[t], vec[t], pe[t]) for t in range(g.n_tp)]

    def forward(img, img_ids, txt, txt_ids, timesteps, y_vec, cond=None, guidance=None):
        b = img.shape[0]
        if b % n_micro:
            raise ValueError(f"batch {b} not divisible by n_micro {n_micro}")
        mb = b // n_micro
        if mb % dp:
            raise ValueError(f"microbatch {mb} (batch {b} / n_micro {n_micro}) not divisible by the mesh "
                             f"'{data_axis}' axis ({dp})")
        per = mb // dp
        inputs = (img, img_ids, txt, txt_ids, timesteps, y_vec, cond, guidance)
        n_txt = txt.shape[1]
        dbl_like, sgl_like = boundaries(per, n_txt, img.shape[1])
        tape = start_tape() if spans and torch.is_grad_enabled() else None
        x_mb, cut = [], {}

        def microbatches(p):  # ranks that share a device share their pieces
            if id(p) not in cut:
                cut[id(p)] = [tree_map(lambda f: f.chunk(n_micro)[m], p) for m in range(n_micro)]
            return cut[id(p)]

        def leaves_for(prep, k):
            """The tp ranks' stage-0 inputs as leaves of the tape's first cut
            (tensors that several ranks share stay shared)."""
            flat, spec = tree_flatten(prep)
            uniq = list({id(x): x for x in flat}.values())
            stand = dict(zip(map(id, uniq), tape.cut((-1, k), uniq)))
            return tree_unflatten([stand[id(x)] for x in flat], spec)

        for k, d in enumerate(local):
            if not first:  # another process holds stage 0
                x_mb.append([None] * n_micro)
                continue
            # data rank d's rows of every microbatch, microbatch by microbatch
            rows = torch.cat([torch.arange(m * mb + k * per, m * mb + (k + 1) * per) for m in range(n_micro)])
            g = groups[(d, 0)]
            prep = g.rep(lambda t: model.prepare_block_inputs(
                *(None if x is None else x[rows.to(x.device)].to(g.devices[t]) for x in inputs)))
            if tape is not None:
                prep = leaves_for(prep, k)
            x_mb.append([[microbatches(prep[t])[m] for t in range(g.n_tp)] for m in range(n_micro)])
        outs = pipeline_apply(dbl_stage, dbl, x_mb, mesh, axis, deliver=[0], like=dbl_like, call=0, tape=tape)
        x_mb = []
        for k, d in enumerate(local):
            if not first:
                x_mb.append([None] * n_micro)
                continue
            g = groups[(d, 0)]
            row = []
            for m in range(n_micro):
                act = outs[k][m][0]
                x = g.rep(lambda t: torch.cat([act[t][1], act[t][0]], dim=1))
                row.append([(x[t], act[t][2], act[t][3]) for t in range(g.n_tp)])
            x_mb.append(row)
        del outs
        outs = pipeline_apply(sgl_stage, sgl, x_mb, mesh, axis, deliver=[last], like=sgl_like, call=1, tape=tape)
        wait_sends()  # the forward's sends have left
        if not final:
            return None  # another process holds the last stage
        pieces = []
        for m in range(n_micro):
            for k, d in enumerate(local):
                g = groups[(d, last)]
                act = outs[k][m][last]
                y = g.rep(lambda t: model.final_layer(act[t][0][:, n_txt:], act[t][1]))[0]
                pieces.append(y.to(img.device))
        return torch.cat(pieces, 0)

    return forward
