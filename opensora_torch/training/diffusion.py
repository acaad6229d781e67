"""Diffusion (MMDiT) training: the train state and the rectified-flow step
(counterpart of opensora_tpu/training/diffusion.py:34-241; upstream
scripts/diffusion/train.py:363-499).

One step: logit-normal t shifted by the batch's ``shift_alpha``, noise x1,
CFG dropout of the text and the pooled vector, x_t and the velocity target,
the MMDiT forward, the (masked) MSE, backward, the optimizer, and the fp32
EMA of the trained parameters. The random draws of a step come from one
``torch.Generator`` (:func:`draw_step`), or are passed in whole: that seam
lets a test feed the JAX package's ``jax.random`` draws.

Under LoRA (``training/lora.py``) the trained parameters are the factors
only; the step is the same.

Over a mesh (``parallel/``): :func:`shard_state` cuts the model, the
optimizer's moments and the EMA by the TP + FSDP rules
(``parallel/sharding.py``; the counterparts of JAX's ``state_shardings``,
``match_opt_shardings`` and ``shard_state``), and the step of a sharded
model places the batch (``parallel/data.make_global_batch``), draws t, x1
and the dropout choices over the global batch, runs each data rank's
forward and backward on its rows (the loss is the mean over the global
batch: the mean of the data ranks' means), sums the gradients of a shard's
replicas on other devices, and takes the norm over each shard once; AdamW
and the EMA run on the shards. A state dict is always in the unsharded
layout (gathered on the host), so a checkpoint crosses between sharded and
unsharded runs both ways. On a pipeline mesh (``training/pp.py``) the
state's shards are placed by stage, and the step's forward is the
pipeline's (``make_train_step(forward_fn=)``) on the global batch: the
draws, the loss and the optimizer are the unsharded step's.

Over processes (a mesh whose axes may each cross them, each process given
its data block's rows): every process draws the global
batch's t, x1 and dropout choices from the same generator in the unsharded
order and cuts its rows (JAX's ``r_step`` draw on the global array,
scripts/diffusion/train.py:366-367); it runs its own ranks; where a data
rank's sp group spans processes, its output is joined over them
(``MMDiTModel.forward_rank``), so each of them computes the rank's whole
(masked) loss, its sums over all the group's tokens before the division,
and its gradient reaches each process's chunk alone; the loss the gradient
flows through is the sum over this process's data ranks divided by dp
(:func:`process_mean`), its value the mean over the data blocks; where
a tp group spans processes, each of them computes the same loss, and its
gradient enters once per tp group (:func:`tp_share`); the gradients meet
in the FSDP reduce-scatter, the tp sums' backward and the replicas'
all-reduce over their holders, the norm is summed across processes, and a
state dict is gathered on process 0. A pipeline over processes runs each
process's stages of its data block's pipelines on the global batch's draws
(:func:`process_draws`): the last stage's processes compute the loss and
broadcast its value, for logging, to their data block's other processes;
every process then runs the pipeline's backward slot by slot in reverse
tick order (:func:`pipeline_loss`, ``parallel/pipeline.PipelineTape``), so
that its messages, and the tp all-reduces inside each slot's backward,
fall in one order on every process; the sends' gradients have left when
the step's backward returns (``comm.wait_sends``).
"""

from __future__ import annotations

import functools
import math
from dataclasses import dataclass
from types import SimpleNamespace
from typing import Callable, Dict, List, Optional, Tuple

import torch
import torch.nn as nn

from opensora_torch.parallel import distributed
from opensora_torch.parallel.comm import process_all_gather, process_all_reduce, process_broadcast, wait_sends
from opensora_torch.parallel.data import Placed, make_global_batch, row_slice
from opensora_torch.parallel.mesh import DATA_AXIS
from opensora_torch.parallel.sharding import ModelSharding, mesh_spec, mmdit_param_specs, shard_params
from opensora_torch.utils.optimizer import Optimizer, global_norm
from opensora_torch.utils.sampling import get_res_lin_function, time_shift
from opensora_torch.utils.train import (
    draw_dropout,
    dropout_condition,
    get_batch_loss,
    rf_interpolate,
    update_ema,
)


@dataclass
class TrainState:
    """The trained parameters (by state-dict name), their optimizer, an
    optional fp32 EMA of them, and the count of steps taken. ``sharding``
    is the model's where its parameters are cut over a mesh: ``params``
    then holds the shards."""

    params: Dict[str, nn.Parameter]
    optimizer: Optimizer
    ema: Optional[Dict[str, torch.Tensor]] = None
    step: int = 0
    sharding: Optional[ModelSharding] = None

    @classmethod
    def create(cls, model: nn.Module, optimizer: Optimizer, ema: bool = True) -> "TrainState":
        """The state of ``model``'s trained parameters; of a sharded model,
        its shards (the EMA made from them, and the shards that repeat
        another on a second device left out of the clip's norm)."""
        params = {n: p for n, p in model.named_parameters() if p.requires_grad}
        ema_params = {n: p.detach().float().clone() for n, p in params.items()} if ema else None
        sharding = getattr(model, "sharding", None)
        if sharding is not None:
            optimizer.replica_ids = sharding.non_canonical()
            optimizer.across_processes = sharding.across_processes
        return cls(params=params, optimizer=optimizer, ema=ema_params, sharding=sharding)

    def _layout(self) -> List[Tuple[str, object, List[int]]]:
        """Per trained unsharded parameter: its name, placement and the
        positions of its shards in ``params`` (the optimizer's order)."""
        pos = {n: i for i, n in enumerate(self.params)}
        names = self.sharding.leaf_names()
        # every trained parameter, in one order on every process (a process
        # may hold none of a parameter's shards: another stage's block)
        return [(name, pl, [pos[n] for n in names[name]]) for name, pl in self.sharding.placements.items()
                if pl.trained]

    def state_dict(self) -> Optional[dict]:
        """The state in the unsharded layout. A state cut across processes
        is gathered on process 0 (every process calls it; the others get
        None)."""
        if self.sharding is not None:
            return self._gathered_state_dict()
        return dict(
            step=self.step,
            params={n: p.detach() for n, p in self.params.items()},
            optimizer=self.optimizer.state_dict(),
            ema=self.ema,
        )

    @torch.no_grad()
    def load_state_dict(self, state: dict) -> None:
        if self.sharding is not None:
            state = self._sharded(state)
        self.step = state["step"]
        for n, p in self.params.items():
            p.copy_(state["params"][n])
        self.optimizer.load_state_dict(state["optimizer"])
        if self.ema is not None:
            for n, e in self.ema.items():
                e.copy_(state["ema"][n])

    @torch.no_grad()
    def _gathered_state_dict(self) -> Optional[dict]:
        """The unsharded layout, each tensor gathered on the host (of
        process 0, over processes)."""
        layout, leaves = self._layout(), list(self.params)

        def gather(per_leaf, dtype=None):
            return {name: pl.gather([per_leaf[leaves[j]] for j in idx], "cpu", dtype) for name, pl, idx in layout}

        opt = self.optimizer.state_dict()
        adam, acc = opt["adamw"], opt["acc"]
        # AdamW keeps a state for every leaf once it has stepped: one step count for all
        any_state = next(iter(adam["state"].values()), None)
        moments = {i: dict(step=any_state["step"].cpu(),
                           **{k: pl.gather([adam["state"][j][k] for j in idx], "cpu")
                              for k in ("exp_avg", "exp_avg_sq")})
                   for i, (_, pl, idx) in enumerate(layout)} if any_state is not None else {}
        groups = [dict(g, params=list(range(len(layout)))) for g in adam["param_groups"]]
        out = dict(
            step=self.step,
            params=gather({n: p.detach() for n, p in self.params.items()}),
            optimizer=dict(opt, adamw=dict(state=moments, param_groups=groups),
                           acc=None if acc is None else [pl.gather([acc[j] for j in idx], "cpu")
                                                         for _, pl, idx in layout]),
            ema=None if self.ema is None else gather(self.ema, torch.float32),
        )
        return out if distributed.process_index() == 0 or not self.sharding.across_processes else None

    def _sharded(self, state: dict) -> dict:
        """An unsharded-layout state dict cut into this state's shards."""
        layout, leaves = self._layout(), list(self.params)

        def cut(full):
            return {leaves[j]: x for name, pl, idx in layout for j, x in zip(idx, pl.shard(full[name]))}

        return dict(step=state["step"], params=cut(state["params"]),
                    optimizer=self._sharded_optimizer(state["optimizer"]),
                    ema=None if self.ema is None else cut(state["ema"]))

    def _sharded_optimizer(self, opt: dict, consume: bool = False) -> dict:
        """The optimizer's unsharded-layout state dict cut into shards: each
        moment (and accumulated gradient) as its parameter is cut, since
        ``match_opt_shardings`` gives a moment its parameter's spec. With
        ``consume``, each full moment leaves ``opt`` as it is cut."""
        layout, n_leaves = self._layout(), len(self.params)
        adam, moments, acc = opt["adamw"], {}, [None] * n_leaves
        for i, (_, pl, idx) in enumerate(layout):
            if i in adam["state"]:
                st = adam["state"].pop(i) if consume else adam["state"][i]
                cut = {k: pl.shard(st[k]) for k in ("exp_avg", "exp_avg_sq")}
                for n, j in enumerate(idx):
                    # a step count of each leaf's own: AdamW adds to it in place
                    moments[j] = dict(step=st["step"].clone(), exp_avg=cut["exp_avg"][n],
                                      exp_avg_sq=cut["exp_avg_sq"][n])
            if opt["acc"] is not None:
                for j, x in zip(idx, pl.shard(opt["acc"][i])):
                    acc[j] = x
                if consume:
                    opt["acc"][i] = None
        groups = [dict(g, params=list(range(n_leaves))) for g in adam["param_groups"]]
        return dict(opt, adamw=dict(state=moments, param_groups=groups), acc=None if opt["acc"] is None else acc)


def state_shardings(mesh, state: TrainState, fsdp: bool = True) -> dict:
    """The spec of each entry of an unsharded train state on ``mesh``: the
    parameters' by the rules (``parallel/sharding.mesh_spec``), the EMA's
    and the optimizer moments' the same (matched by
    :func:`match_opt_shardings`), the step replicated."""
    pspecs = {n: mesh_spec(s, state.params[n].shape, mesh)
              for n, s in mmdit_param_specs(state.params, fsdp=fsdp).items()}
    return dict(step=(), params=pspecs, ema=pspecs if state.ema is not None else None,
                optimizer=match_opt_shardings(state.params, pspecs, state.optimizer.state_dict()))


def match_opt_shardings(params: Dict[str, torch.Tensor], pspecs: dict, opt_state: dict) -> dict:
    """The spec of each optimizer-state entry: AdamW keeps its moments by
    the position of their parameter, so moment i takes parameter i's spec
    where the shapes agree (the JAX package matches by tree path, with the
    same shape check); anything else is replicated."""
    names = list(params)
    out = {}
    for i, st in opt_state["adamw"]["state"].items():
        out[i] = {k: (pspecs[names[i]] if hasattr(v, "shape") and tuple(v.shape) == tuple(params[names[i]].shape)
                      else (None,) * getattr(v, "ndim", 0)) for k, v in st.items()}
    return out


def shard_state(mesh, state: TrainState, model: nn.Module, fsdp: bool = True,
                shardings: Optional[dict] = None) -> TrainState:
    """``state`` (of the unsharded ``model``) cut by ``shardings`` (default
    :func:`state_shardings`; on a pipeline mesh ``training/pp.
    pp_state_shardings``, whose ``stages`` place each block): the model's
    parameters into shards (``parallel/sharding.shard_params``, in place),
    a new optimizer over the shards with the same settings and the moments
    cut to match, the EMA cut tensor by tensor. Each full parameter, moment
    and EMA tensor is freed as its shards are made."""
    shardings = shardings or state_shardings(mesh, state, fsdp)
    specs = shardings["params"]
    old, ema = state.optimizer, state.ema
    opt = old.state_dict()
    old.params.clear()  # the unsharded parameters are freed as they are cut
    old.adamw.param_groups.clear()
    old.adamw.state.clear()
    state.params = state.ema = None
    shard_params(mesh, model, fsdp=fsdp, specs=specs, stages=shardings.get("stages"))
    sharded = TrainState.create(model, old.like([p for p in model.parameters() if p.requires_grad]), ema=False)
    sharded.step = state.step
    layout, leaves = sharded._layout(), list(sharded.params)
    if ema is not None:
        sharded.ema = {}
        for name, pl, idx in layout:
            for j, x in zip(idx, pl.shard(ema.pop(name))):
                sharded.ema[leaves[j]] = x
    if opt["adamw"]["state"] or opt["acc"] is not None:
        sharded.optimizer.load_state_dict(sharded._sharded_optimizer(opt, consume=True))
    return sharded


def draw_step(batch: Dict, text_dropout_prob: float, generator: Optional[torch.Generator] = None) -> Dict:
    """A step's random draws: t (B,) shifted, noise x1 like x0, and the
    per-sample text / pooled-vector dropout choices."""
    x0 = batch["x0"]
    b, dev = x0.shape[0], x0.device
    n = torch.randn((b,), generator=generator, device=dev, dtype=torch.float32)
    t = time_shift(batch["shift_alpha"].float(), torch.sigmoid(n))
    x1 = torch.randn(x0.shape, generator=generator, device=dev, dtype=torch.float32)
    draws = dict(t=t, x1=x1)
    if text_dropout_prob > 0:
        draws["drop_txt"] = draw_dropout(b, text_dropout_prob, generator, dev)
        draws["drop_vec"] = draw_dropout(b, text_dropout_prob, generator, dev)
    return draws


def compute_loss(
    model: nn.Module,
    batch: Dict,
    t: torch.Tensor,
    x1: torch.Tensor,
    drop_txt: Optional[torch.Tensor] = None,
    drop_vec: Optional[torch.Tensor] = None,
    sigma_min: float = 1e-5,
    use_masked_loss: bool = False,
    patch_size: int = 2,
) -> torch.Tensor:
    """The rectified-flow loss of one batch given its draws (the JAX
    package's ``loss_fn``)."""
    pred, v_t = predict(model, batch, t, x1, drop_txt, drop_vec, sigma_min)
    return flow_loss(pred, v_t, batch, use_masked_loss, patch_size)


def predict(model, batch: Dict, t, x1, drop_txt=None, drop_vec=None, sigma_min: float = 1e-5):
    """The model's velocity on the noised batch, and the target velocity."""
    x0 = batch["x0"].float()
    x_t, v_t = rf_interpolate(x0, x1, t, sigma_min)
    txt, y_vec = batch["txt"], batch["y_vec"]
    if drop_txt is not None:
        txt = dropout_condition(drop_txt, txt, batch["null_txt"])
    if drop_vec is not None:
        y_vec = dropout_condition(drop_vec, y_vec, batch["null_vec"])
    pred = model(
        img=x_t.to(txt.dtype), img_ids=batch["img_ids"], txt=txt, txt_ids=batch["txt_ids"],
        timesteps=t, y_vec=y_vec, cond=batch.get("cond"), guidance=batch.get("guidance"),
    )
    return pred, v_t


def flow_loss(pred: torch.Tensor, v_t: torch.Tensor, batch: Dict, use_masked_loss: bool = False,
              patch_size: int = 2) -> torch.Tensor:
    """The mean squared error of the velocity (masked where asked)."""
    masks = batch.get("masks")
    if use_masked_loss and masks is not None:
        return get_batch_loss(pred, v_t, masks, latent_shape=tuple(masks.shape[-3:]), patch_size=patch_size)
    return ((pred.float() - v_t) ** 2).mean()


def make_train_step(
    model: nn.Module,
    ema_decay: Optional[float] = 0.9999,
    text_dropout_prob: float = 0.0,
    sigma_min: float = 1e-5,
    use_masked_loss: bool = False,
    patch_size: int = 2,
    forward_fn: Optional[Callable] = None,
) -> Callable:
    """``train_step(state, batch, generator=None, draws=None) -> metrics``:
    one rectified-flow step that updates ``state`` in place. ``draws``
    (t, x1 and, with text dropout, drop_txt / drop_vec) replaces the
    draws from ``generator``. Metrics: the loss and the global norm of the
    step's gradients, as 0-d tensors on the model's device.
    ``forward_fn`` (the model's signature) replaces the model's forward on
    the whole batch, e.g. the pipeline-parallel forward
    (``training/pp.make_pp_forward``); the loss, the optimizer and the EMA
    stay shared (the JAX package's ``forward_fn``,
    opensora_tpu/training/diffusion.py:122).

    batch: x0 packed clean latent (B, L, C); img_ids (B, L, 3); txt,
    txt_ids, y_vec; cond (B, L, C + p^2) or None; masks (B, 1, T, H, W) or
    None; shift_alpha (B,); guidance (B,) or None; null_txt, null_vec."""

    loss_kw = dict(sigma_min=sigma_min, use_masked_loss=use_masked_loss, patch_size=patch_size)

    def train_step(state: TrainState, batch: Dict, generator: Optional[torch.Generator] = None,
                   draws: Optional[Dict] = None) -> Dict[str, torch.Tensor]:
        backward = None
        if state.sharding is not None and forward_fn is None:
            loss = sharded_loss(model, state.sharding, batch, generator, draws, text_dropout_prob, loss_kw)
        elif state.sharding is not None and state.sharding.across_processes:
            # a pipeline over processes: this process's data block's rows, the global draws
            if draws is None:
                draws = process_draws(batch, text_dropout_prob, generator, state.sharding.mesh)
            loss, backward = pipeline_loss(forward_fn, state.sharding.mesh, batch, draws, loss_kw)
        else:
            if draws is None:
                draws = draw_step(batch, text_dropout_prob, generator)
            loss = compute_loss(forward_fn or model, batch, **loss_kw, **draws)
        if backward is None:
            loss.backward()
        else:
            backward()
        wait_sends()  # the pipeline's gradients sent to other processes have left
        params = list(state.params.values())
        device = params[0].device
        if state.sharding is not None:
            state.sharding.sync_replica_grads()
            params = [p for p in params if id(p) not in state.optimizer.replica_ids]
        grad_norm = global_norm([torch.zeros_like(p) if p.grad is None else p.grad for p in params],
                                state.optimizer.across_processes, device)
        state.optimizer.step()
        state.optimizer.zero_grad()
        if state.ema is not None:
            update_ema(state.ema, state.params, ema_decay)
        state.step += 1
        return {"loss": loss.detach(), "grad_norm": grad_norm}

    return train_step


def sharded_loss(model: nn.Module, sharding: ModelSharding, batch: Dict, generator, draws, text_dropout_prob: float,
                 loss_kw: dict) -> torch.Tensor:
    """The loss of a model sharded over a mesh: the batch placed (unless it
    is), the draws made over the global batch (as the unsharded step makes
    them: one generator, one order) and cut by rows, each data rank's loss
    on its rows (this process's data ranks), their mean on the device of
    the first of them, then over the data blocks (:func:`process_mean`)."""
    mesh = sharding.mesh
    if not all(v is None or isinstance(v, Placed) for v in batch.values()):
        batch = make_global_batch(mesh, batch)
    if draws is None:
        draws = global_draws(batch, text_dropout_prob, generator)
    b = batch["x0"].shape[0]
    losses = []
    for d in mesh.local_data:
        rows = {k: None if v is None else v.rows(d) for k, v in batch.items()}
        dev = rows["x0"].device
        cut = {k: v[row_slice(b, sharding.dp, d)].to(dev) for k, v in draws.items()}
        losses.append(compute_loss(functools.partial(model.forward_rank, d), rows, **loss_kw, **cut))
    home = losses[0].device
    loss = process_mean(data_mean([x.to(home) for x in losses]), mesh.data_blocks,
                        mesh.process_group(DATA_AXIS, mesh.local_ranks[0]))
    return tp_share(loss, mesh.tp_processes)


def pipeline_loss(forward_fn: Callable, mesh, batch: Dict, draws: Dict, loss_kw: dict):
    """A pipeline over processes (``training/pp.make_pp_forward``): the
    loss's value on every process, and the step's backward. The last
    stage's processes compute the loss (the mean over the data blocks, its
    gradient once per tp group, as :func:`sharded_loss`'s) and give its
    value to their data block's other processes, for the metrics alone.
    Where the pipeline spans processes the backward is its tape's
    (``parallel/pipeline.PipelineTape.backward``): the loss's gradient of
    each microbatch's last-stage output, then the slots in reverse tick
    order, the same on every process."""
    from opensora_torch.parallel.mesh import PP_AXIS
    from opensora_torch.parallel.pipeline import take_tape

    pred, v_t = predict(forward_fn, batch, sigma_min=loss_kw["sigma_min"], **draws)
    tape = take_tape()
    root = None
    value = torch.zeros((), dtype=torch.float32, device=batch["x0"].device)
    if pred is not None:  # this process holds the last stage
        loss = process_mean(flow_loss(pred, v_t, batch, loss_kw["use_masked_loss"], loss_kw["patch_size"]),
                            mesh.data_blocks, mesh.process_group(DATA_AXIS, mesh.local_ranks[0]))
        root = tp_share(loss, mesh.tp_processes)
        value = loss.detach()
    src = mesh.processes[mesh.rank((mesh.local_data[0], mesh.shape[PP_AXIS] - 1, 0))]
    value = process_broadcast(value, src, mesh.block_group)
    return value, (lambda: root.backward()) if tape is None else (lambda: tape.backward(root))


def global_draws(batch: Dict[str, Optional[Placed]], text_dropout_prob: float, generator) -> Dict:
    """The step's draws over the placed global batch, as the unsharded step
    draws them (every process alike)."""
    return draw_step(dict(x0=batch["x0"], shift_alpha=batch["shift_alpha"].full()), text_dropout_prob, generator)


def process_draws(batch: Dict, text_dropout_prob: float, generator, mesh) -> Dict:
    """The step's draws for this process's data block's rows (``batch``,
    unplaced) of the global batch (the blocks' rows joined in block order):
    drawn over the global batch, as the unsharded step draws them, and
    cut."""
    n, p = mesh.data_blocks, mesh.data_block
    x0, rows = batch["x0"], batch["x0"].shape[0]
    whole = SimpleNamespace(shape=torch.Size((rows * n, *x0.shape[1:])), device=x0.device)
    alpha = process_all_gather(batch["shift_alpha"].float(), 0, mesh.process_group(DATA_AXIS, mesh.local_ranks[0]))
    draws = draw_step(dict(x0=whole, shift_alpha=alpha), text_dropout_prob, generator)
    return {k: v[p * rows:(p + 1) * rows] for k, v in draws.items()}


def data_mean(losses) -> torch.Tensor:
    """The mean of the data ranks' losses (each the mean over its rows):
    the loss of the global batch, whose gradient reaches each shard as the
    data ranks' gradients summed and divided by dp."""
    return torch.stack(losses).mean()


def process_mean(loss: torch.Tensor, n_processes: int, group=None) -> torch.Tensor:
    """Over ``n_processes`` processes (``group``, default every process),
    each holding the mean ``loss`` of its data ranks: the mean over the
    processes (all-reduced), whose gradient is that of ``loss /
    n_processes``: the data ranks' gradients meet in the cross-process
    sums, so each is divided by dp once."""
    if n_processes == 1:
        return loss
    mine = loss / n_processes
    return mine - mine.detach() + process_all_reduce(mine.detach(), group)


def tp_share(loss: torch.Tensor, n_processes: int) -> torch.Tensor:
    """The loss every process of a tp group across ``n_processes``
    processes computes alike: its value, its gradient divided by
    ``n_processes``. Each process's gradient of what the group replicates
    is then its share, the shares meeting in the row-parallel sums'
    backward (``comm.tp_all_reduce``) and in the replicated leaves' sum
    over their holders, so the loss's gradient enters once per tp group."""
    if n_processes == 1:
        return loss
    share = loss / n_processes
    return share - share.detach() + loss.detach()


def compute_shift_alpha(latent_h: int, latent_w: int, latent_t: int) -> float:
    """Resolution/temporal shift factor res_lin((h * w) // 4) * sqrt(T) over
    latent dims (upstream scripts/diffusion/train.py:385-390)."""
    return get_res_lin_function()((latent_h * latent_w) // 4) * math.sqrt(latent_t)
