"""MMDiT diffusion training CLI of the PyTorch port (counterpart of
scripts/diffusion/train.py).

    python -m opensora_torch.train configs/diffusion/train/demo.py \\
        [--dotted.key value ...] [--device cpu]

The same configs and overrides as the JAX script: a bucketed video-text
dataloader, the MMDiT / VAE / T5 / CLIP built from the config (each loaded
from its ``from_pretrained`` where set, checked against the model's shapes
and cast to its dtype, else random weights from ``seed``), LoRA factors on
the (loaded) base when ``lora_config`` is set, else a full finetune
of the MMDiT over fp32 master weights computing in the config's ``dtype``
(with an fp32 EMA), the rectified-flow step, logging to
``<outputs>/<exp_name>/log.txt``, checkpoints every ``ckpt_every`` steps
and at the end, resume from ``load``, and a Chrome trace of the global
steps in ``profile = dict(start=, end=)`` under ``<exp_dir>/profile``.

:class:`Trainer` holds the models and the train state;
:meth:`Trainer.run_batch` is the body of one iteration -- encode the video,
build the visual condition, encode the text, take the step -- and is what
``chip_smoke.py`` drives on the card. Runs on cuda unless ``--device``
names another device. The config's ``mesh`` is built over the host's
cards where there are several (:func:`train_mesh`): data and tensor
parallelism with FSDP (``parallel/sharding.py``, ``parallel/data.py``) and
sequence parallelism over them. A ``pipeline = dict(pp_size, tp_size=1,
data_size=None, n_micro=2 * pp_size)`` key trains over a (data, pp, tp)
mesh instead (:func:`pipeline_mesh`; GPipe, ``training/pp.py``).

``multi_host=True`` trains over processes that torchrun starts:

    python -m torch.distributed.run --nproc-per-node N -m opensora_torch.train CFG --multi_host True

    python -m torch.distributed.run --nproc-per-node 2 -m opensora_torch.train configs/diffusion/train/stage1.py \\
        --multi_host True --mesh.tp_size 2           # one tp rank a process
    python -m torch.distributed.run --nproc-per-node 2 -m opensora_torch.train configs/diffusion/train/stage1.py \\
        --multi_host True --pipeline.pp_size 2       # one pipeline stage a process

Each process joins the group first (``parallel/distributed.initialize``:
its card, ``nccl`` where each process has a card of its own, else
``gloo``), and the mesh is over every process's device, each process an
equal run of its ranks along any axis (:func:`train_mesh`: ``stage2.py``'s
sp group of 4, or ``--mesh.tp_size 2``'s tp group, spans the processes;
:func:`pipeline_mesh`: one stage a process; a process holds several
consecutive ranks as logical ranks on its card where there are more ranks
than processes). The processes of one 'data' coordinate read the same
samples (``parallel/data.data_replicas``); each process encodes its data
block's rows (the posterior noise and the visual conditions drawn for the
global batch and cut, as the step's draws are), the block's first process
gives its inputs to the others (:meth:`Trainer.block_inputs`), and each
runs its ranks; process 0 names the experiment directory, logs, writes the
checkpoints (gathered from every process), the metrics and the profile.
"""

from __future__ import annotations

import math
import os
import sys
from typing import Dict, List, NamedTuple, Optional

import numpy as np
import torch

from opensora_torch.inference import _pop_flag


# as the JAX train script refuses it (scripts/diffusion/train.py:226-230)
PIPELINE_LORA = "pipeline + lora_config: not ported (LoRA's factors fit without pipeline stages)"


def fit_null_txt(null_txt: torch.Tensor, txt_len: int) -> torch.Tensor:
    """Cut, or pad by repeating the last token, the null text embedding to
    ``txt_len`` rows (upstream scripts/diffusion/train.py:415-420)."""
    if null_txt.shape[1] >= txt_len:
        return null_txt[:, :txt_len]
    pad = null_txt[:, -1:].expand(-1, txt_len - null_txt.shape[1], -1)
    return torch.cat([null_txt, pad], dim=1)


def train_mesh(cfg, device):
    """The config's ``mesh`` over the host's cards, or None where there is
    one (as ``inference.inference_mesh``): stage1.py's ``dp_size=-1`` and
    stage2.py's ``sp_size=4`` then train on one card without a mesh. In a
    multi-process run, the mesh (default ``dp_size=-1``) over every
    process's device (a collective): one rank a process where the
    processes fill the mesh (``dp_size=-1``: as many data coordinates as
    they fill), else each process holds an equal run of consecutive ranks
    as logical ranks on its device, as :func:`pipeline_mesh` lays out
    stages (``stage2.py``'s sp 4 over 2 processes: 2 sp ranks each,
    ``dp_size=-1`` then 1; ``stage1.py --mesh.tp_size 2`` over 2
    processes: one tp rank each)."""
    from opensora_torch.inference import inference_mesh
    from opensora_torch.parallel import distributed
    from opensora_torch.parallel.mesh import MeshConfig, create_mesh

    n_proc = distributed.process_count()
    if n_proc == 1:
        return inference_mesh(cfg, device)
    mc = MeshConfig(**(cfg.get("mesh") or {}))
    sizes = [mc.dp_size, mc.sp_size, mc.tp_size]
    fixed = math.prod(x for x in sizes if x != -1)
    if -1 in sizes and n_proc % fixed == 0:
        total = n_proc  # the -1 axis fills the processes
    else:
        sizes = [1 if x == -1 else x for x in sizes]
        total = math.prod(sizes)
    if total % n_proc:
        raise ValueError(f"mesh {cfg.get('mesh')}: {total} ranks do not split over {n_proc} processes")
    return create_mesh(MeshConfig(*sizes), [distributed.group().device] * (total // n_proc))


def pipeline_mesh(cfg, device):
    """The (data, pp, tp) mesh of the config's ``pipeline`` key (JAX's
    scripts/diffusion/train.py:83-97): ``data_size`` None is the host's
    cards (one device for another ``device`` type) // (pp_size * tp_size).
    The ranks go over the cards in order, consecutive ranks sharing a card
    where there are fewer cards than ranks (logical ranks). In a
    multi-process run the mesh's ranks split into equal runs over the
    processes, each on its own device: a process's run is whole pipelines
    (its data coordinates'), or one stage, a run of stages or part of a
    stage's tp group (``--pipeline.pp_size 2`` over 2 processes: one stage
    a process)."""
    from opensora_torch.parallel import distributed
    from opensora_torch.parallel.mesh import create_pp_mesh

    p = dict(cfg.pipeline)
    pp, tp = p["pp_size"], p.get("tp_size", 1)
    device = torch.device(device)
    n_proc = distributed.process_count()
    if n_proc > 1:  # each process lays its run of the mesh over its own device
        cards = [distributed.group().device]
    else:
        cards = ([torch.device("cuda", i) for i in range(torch.cuda.device_count())] if device.type == "cuda"
                 else [device])
    data = p.get("data_size") or n_proc * len(cards) // (pp * tp)
    total = data * pp * tp
    if data < 1 or total % n_proc:
        raise ValueError(f"pipeline {p}: {len(cards)} device(s) in each of {n_proc} process(es) hold no pp_size x "
                         f"tp_size = {pp * tp} ranks, or the mesh's ranks do not split over the processes; set "
                         f"pipeline.data_size to lay the ranks over them as logical ranks")
    n = total // n_proc  # this process's ranks
    devices = cards[:n] if len(cards) >= n else [cards[r * len(cards) // n] for r in range(n)]
    return create_pp_mesh(pp, data, tp, devices)


class Trainer:
    """Models, train state and the per-batch body of the training loop.
    ``mesh`` (``opensora_torch.parallel.mesh``) becomes the process's mesh,
    as the JAX train script sets its mesh, so that a model whose
    ``attn_backend`` is sequence-parallel ("ring_rdma", "ring", "ulysses")
    runs its attention over the mesh's 'sp' ranks. Where the mesh has more
    than one rank, the MMDiT's parameters are sharded by the TP + FSDP
    rules (``fsdp=True``, as JAX's scripts/diffusion/train.py:167-168 does;
    ``parallel/sharding.shard_params``; replicated over 'sp', whose ranks
    each run their chunk of the tokens through every block, as
    ``prepare_api`` does for inference) once the models are built
    (until then the whole MMDiT lies on ``device``), each full weight freed
    as its shards are made; the optimizer and the EMA are then made over
    the shards, so no full copy of them exists. Each batch
    is placed over the mesh (``parallel/data.make_global_batch``) before
    the step. Under LoRA the frozen base is sharded so, and the factors
    (the trained parameters: no EMA) are replicated on every rank, as the
    JAX script places its factor tree (``training/lora.py``); a pipeline
    mesh with LoRA raises, as in JAX. A pipeline mesh
    (``parallel/mesh.create_pp_mesh``, or :func:`pipeline_mesh` from the
    config's ``pipeline`` key) places each block on its stage's ranks, cut
    over 'tp' inside the stage where that axis has more than one rank
    (``training/pp.shard_pp``), and the step runs the GPipe forward over
    the global batch with the ``pipeline`` key's ``n_micro`` microbatches
    (default 2 * pp_size; ``training/pp.make_pp_forward``). A mesh across
    processes (a multi-process run's :func:`train_mesh` /
    :func:`pipeline_mesh`) gives each process its run of the ranks (its
    'data' coordinates', or some sp, tp ranks or stages of one);
    :meth:`run_batch` then takes the process's data block's rows of the
    global batch (:meth:`process_rows`)."""

    def __init__(self, cfg, device=None, mesh=None):
        from opensora_torch.parallel.context import set_mesh
        from opensora_torch.parallel.mesh import PP_AXIS
        from opensora_torch.parallel.sharding import shard_params
        from opensora_torch.training.diffusion import TrainState, make_train_step
        from opensora_torch.training.lora import apply_lora, count_lora_params
        from opensora_torch.utils.api import prepare_models
        from opensora_torch.utils.config import Config
        from opensora_torch.utils.logger import create_logger
        from opensora_torch.utils.misc import Timers, count_params, format_numel
        from opensora_torch.utils.optimizer import create_optimizer

        lora_cfg = cfg.get("lora_config")
        if not lora_cfg and cfg.model.get("param_dtype") is None:
            # a full finetune trains fp32 master weights under the compute
            # dtype, as the JAX package does (its MMDiTConfig.param_dtype is
            # "fp32"); the default is set here and not in MMDiTConfig, where
            # a served bf16 model would double its resident weights
            cfg = Config(cfg, model=Config(cfg.model, param_dtype="fp32"))
        self.cfg = cfg
        self.logger = create_logger()
        if mesh is not None:
            set_mesh(mesh)
        seed = cfg.get("seed", 42)
        self.model, self.ae, self.t5, self.clip, _ = prepare_models(cfg, device=device, seed=seed)
        self.device = next(self.model.parameters()).device
        if cfg.model.get("from_pretrained"):
            self.logger.info("loaded pretrained MMDiT weights from %s", cfg.model["from_pretrained"])
        self.logger.info("MMDiT params: %s on %s", format_numel(count_params(self.model.parameters())), self.device)
        self.patch_size = cfg.get("patch_size", 2)
        self.gen = torch.Generator(device=self.device).manual_seed(seed)
        self.host_rng = np.random.default_rng(seed)

        if lora_cfg:
            rank = lora_cfg.get("r", lora_cfg.get("rank", 16))
            scale = lora_cfg.get("lora_alpha", rank) / rank  # peft semantics
            apply_lora(self.model, rank=rank, scale=scale, generator=self.gen,
                       **({"target_regex": lora_cfg["target_regex"]} if "target_regex" in lora_cfg else {}))
            self.logger.info("LoRA enabled: rank %d, scale %.3f, %s trainable factor params",
                             rank, scale, format_numel(count_lora_params(self.model)))
        else:
            self.model.requires_grad_(True)
            self.logger.info("full finetune: %s parameters, computing in %s",
                             next(self.model.parameters()).dtype, self.model.dtype)

        pp = mesh is not None and PP_AXIS in mesh.shape
        self.mesh = mesh if pp or mesh is not None and len(mesh.devices) > 1 else None
        forward_fn = None
        if pp:
            from opensora_torch.training.pp import make_pp_forward, shard_pp

            if lora_cfg:
                raise NotImplementedError(PIPELINE_LORA)
            n_micro = dict(cfg.get("pipeline") or {}).get("n_micro") or 2 * mesh.shape[PP_AXIS]
            shard_pp(mesh, self.model)
            forward_fn = make_pp_forward(self.model, mesh, n_micro)
            self.logger.info("MMDiT placed over the pipeline mesh %s, %d microbatches", mesh, n_micro)
        elif self.mesh is not None:
            shard_params(self.mesh, self.model, fsdp=True)
            self.logger.info("MMDiT sharded over %s (TP + FSDP, the tokens over 'sp')%s", self.mesh,
                             ", the LoRA factors replicated" if lora_cfg else "")
        optimizer = create_optimizer(
            [p for p in self.model.parameters() if p.requires_grad],
            lr=cfg.get("lr", 1e-4), weight_decay=cfg.get("weight_decay", 0.0), eps=cfg.get("adam_eps", 1e-8),
            warmup_steps=cfg.get("warmup_steps"), grad_clip=cfg.get("grad_clip"),
            accumulation_steps=cfg.get("accumulation_steps", 1),
        )
        ema_decay = cfg.get("ema_decay", 0.9999)
        self.state = TrainState.create(self.model, optimizer, ema=ema_decay is not None and not lora_cfg)
        dropout = cfg.get("dropout_ratio") or {}
        self.condition_config = cfg.get("condition_config")
        self.train_step = make_train_step(
            self.model, ema_decay=ema_decay, text_dropout_prob=dropout.get("t5", 0.0),
            use_masked_loss=self.condition_config is not None, patch_size=self.patch_size, forward_fn=forward_fn,
        )
        self.place_batch = self.mesh is not None and forward_fn is None
        with torch.no_grad():
            self.null_txt = self.t5([""])
            self.null_vec = self.clip([""])
        self.timers = Timers(sync=self.device.type == "cuda")
        self.mask_conds: Optional[List[str]] = None  # the last batch's visual-condition types

    def run_batch(self, batch: Dict) -> Dict[str, torch.Tensor]:
        """One iteration on a collated batch: ``video`` (B, 3, T, H, W) in
        [-1, 1] and ``text``, or, with ``cached_video``, ``video_latents``,
        ``text_t5`` and ``text_clip``. Returns the step's metrics (0-d
        tensors on the device)."""
        from opensora_torch.parallel.data import make_global_batch

        group = None if self.mesh is None else self.mesh.block_group
        shared = group is not None and group.size > 1
        if shared:  # the data block's first process encodes for all of them
            tb = self.block_inputs(self.step_inputs(batch) if group.index() == 0 else None, group)
        else:
            tb = self.step_inputs(batch)
        if self.place_batch:
            tb = make_global_batch(self.mesh, tb)
        with self.timers("step"):
            return self.train_step(self.state, tb, self.gen)

    def step_inputs(self, batch: Dict) -> Dict[str, Optional[torch.Tensor]]:
        """The train step's inputs of this process's data block's rows of a
        collated batch: the latents, the text embeddings, the visual
        condition and the loss's masks."""
        from opensora_torch.training.diffusion import compute_shift_alpha
        from opensora_torch.utils.sampling import pack, prepare, prepare_ids
        from opensora_torch.utils.train import build_visual_condition, choose_mask_conditions

        cfg, dev = self.cfg, self.device
        masks = cond = None
        with torch.no_grad():
            with self.timers("encode_video"):
                if cfg.get("cached_video", False):
                    x0 = torch.as_tensor(batch["video_latents"], device=dev)
                    inp = prepare_ids(x0, torch.as_tensor(batch["text_t5"], device=dev),
                                      torch.as_tensor(batch["text_clip"], device=dev), self.patch_size)
                else:
                    x = torch.as_tensor(batch["video"], device=dev)
                    rows = self.process_rows(x.shape[0])
                    x0 = self.encode_rows(x, rows)
                    if self.condition_config is not None:
                        tc = self.ae.config.time_compression_ratio
                        # the global batch's draws
                        self.mask_conds = choose_mask_conditions(dict(self.condition_config), rows.n, x0.shape[2],
                                                                 tc, self.host_rng)
                        mine = self.mask_conds[rows.start:rows.stop]
                        masks, cond = build_visual_condition(x, mine, self.single_frame_encoder(x0, rows), x0, tc)
                        cond = pack(cond, patch_size=self.patch_size)
            with self.timers("encode_text"):
                if not cfg.get("cached_video", False):
                    inp = prepare(self.t5, self.clip, x0, prompt=list(batch["text"]),
                                  seq_align=cfg.get("seq_align", 1), patch_size=self.patch_size)
        lt, lh, lw = x0.shape[2:]
        b = x0.shape[0]
        tb = dict(
            x0=inp["img"], img_ids=inp["img_ids"], txt=inp["txt"], txt_ids=inp["txt_ids"], y_vec=inp["y_vec"],
            cond=cond, masks=masks,
            guidance=torch.full((b,), cfg.get("guidance", 4.0), device=dev),
            shift_alpha=torch.full((b,), compute_shift_alpha(lh, lw, lt), device=dev),
            null_txt=fit_null_txt(self.null_txt, inp["txt"].shape[1]).expand_as(inp["txt"]).to(inp["txt"].dtype),
            null_vec=self.null_vec.expand_as(inp["y_vec"]).to(inp["y_vec"].dtype),
        )
        return tb

    def block_inputs(self, tb: Optional[Dict], group) -> Dict:
        """The step's inputs that ``group``'s first process encoded
        (``tb`` there, None on the others), on each process of the group
        (its data block: the processes of one data coordinate, its sp, tp
        or pp ranks', must feed the model the same bits): their shapes and
        the random state the encode left (the generator's, the host's, the
        visual conditions chosen), then each tensor, broadcast. The others
        encode nothing, and their random state goes on as the first
        process's."""
        from opensora_torch.parallel import distributed
        from opensora_torch.parallel.comm import process_broadcast

        src = group.ranks[0]
        with self.timers("block_inputs"):
            head = None if tb is None else dict(
                meta={k: None if v is None else (tuple(v.shape), v.dtype) for k, v in tb.items()},
                gen=self.gen.get_state(), host_rng=self.host_rng.bit_generator.state, mask_conds=self.mask_conds)
            head = distributed.broadcast_object(head, src, group)
            if tb is None:
                self.gen.set_state(head["gen"])
                self.host_rng.bit_generator.state = head["host_rng"]
                self.mask_conds = head["mask_conds"]
                tb = {k: None if m is None else torch.empty(m[0], dtype=m[1], device=self.device)
                      for k, m in head["meta"].items()}
            return {k: None if v is None else process_broadcast(v, src, group) for k, v in tb.items()}

    def process_rows(self, n_local: int) -> "Rows":
        """This process's rows [p * n_local, (p + 1) * n_local) of the global
        batch of n_local * n rows: p its data block of the mesh's n (one
        process holds them all; the processes of one data block, its sp
        ranks, hold the same rows)."""
        p, n = (self.mesh.data_block, self.mesh.data_blocks) if self.mesh is not None else (0, 1)
        return Rows(p * n_local, (p + 1) * n_local, n_local * n)

    def encode_rows(self, x: torch.Tensor, rows: "Rows") -> torch.Tensor:
        """The latents of this process's clips ``x``: the AE's posterior
        noise drawn from the generator for the global batch, as one process
        draws it for all the rows, and cut to ``rows``. An AE without
        ``sample_moments`` draws its own rows' noise from the generator
        (the 2-D AE), or none (the DC-AE)."""
        if not hasattr(self.ae, "sample_moments"):
            return self.ae.encode(x, generator=self.gen)
        moments = self.ae.encode_moments(x)
        noise = torch.randn((rows.n, moments.shape[1] // 2, *moments.shape[2:]), generator=self.gen,
                            device=moments.device, dtype=torch.float32)
        return self.ae.sample_moments(moments, noise=noise[rows.start:rows.stop])[0]

    def single_frame_encoder(self, x0: torch.Tensor, rows: "Rows"):
        """The encoder of the visual conditions' single frames: the noise of
        every single frame the global batch encodes is drawn, in the global
        batch's order, and this process's are used in turn."""
        if not hasattr(self.ae, "sample_moments"):
            return lambda xi: self.ae.encode(xi, generator=self.gen)
        from opensora_torch.utils.train import single_frame_encodes

        # build_visual_condition encodes no single frame at one latent frame
        frames = single_frame_encodes if x0.shape[2] > 1 else (lambda conds: 0)
        before = frames(self.mask_conds[:rows.start])
        mine = frames(self.mask_conds[rows.start:rows.stop])
        shape = (1, x0.shape[1], 1, *x0.shape[3:])
        noises = [torch.randn(shape, generator=self.gen, device=x0.device, dtype=torch.float32)
                  for _ in range(frames(self.mask_conds))]
        ours = iter(noises[before:before + mine])
        return lambda xi: self.ae.encode(xi, noise=next(ours))


class Rows(NamedTuple):
    """Rows [start, stop) of a global batch of ``n`` rows."""

    start: int
    stop: int
    n: int


class ProfileWindow:
    """The config's ``profile = dict(start=, end=)`` in global steps, as the
    JAX train script traces it (scripts/diffusion/train.py:362-371):
    ``torch.profiler`` (host, and the card's kernels on cuda) starts before
    the step taken at ``global_step == start`` and stops after the step that
    brings ``global_step`` to ``end``; the Chrome trace goes to
    ``<exp_dir>/profile/trace.json``. A window that does not open, or whose
    end the run never reaches, writes nothing, as the JAX script's
    unstopped trace writes nothing."""

    def __init__(self, window: Optional[dict], exp_dir: str, device: torch.device, logger):
        self.window, self.device, self.logger = window or {}, device, logger
        self.out_dir = os.path.join(exp_dir, "profile")
        self.prof = None

    def before_step(self, global_step: int) -> None:
        if self.window and global_step == self.window.get("start", -1):
            from torch.profiler import ProfilerActivity, profile

            activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if self.device.type == "cuda" else [])
            self.prof = profile(activities=activities)
            self.prof.start()

    def after_step(self, global_step: int) -> None:
        if self.prof is not None and global_step == self.window.get("end", -1):
            self._stop()
            os.makedirs(self.out_dir, exist_ok=True)
            self.prof.export_chrome_trace(os.path.join(self.out_dir, "trace.json"))
            self.prof = None
            self.logger.info("profile written to %s", self.out_dir)

    def close(self) -> None:
        if self.prof is not None:
            self._stop()
            self.prof = None
            self.logger.warning("profile window %s: its end was not reached, no trace written", self.window)

    def _stop(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.prof.stop()


def main(argv: Optional[List[str]] = None) -> Trainer:
    """Run the CLI; returns the trainer after the last step."""
    import opensora_torch.datasets.datasets  # noqa: F401  (registers the datasets)
    from opensora_torch.datasets.dataloader import prepare_dataloader
    from opensora_torch.parallel import distributed
    from opensora_torch.parallel.data import data_replicas
    from opensora_torch.registry import DATASETS, build_module
    from opensora_torch.utils.ckpt import CheckpointIO
    from opensora_torch.utils.config import ae_spatial_compression, create_experiment_workspace, parse_configs
    from opensora_torch.utils.logger import create_logger
    from opensora_torch.utils.tb import MetricsWriter

    argv = list(sys.argv[1:] if argv is None else argv)
    device = _pop_flag(argv, ("--device",))
    cfg = parse_configs(argv)
    main_process = True
    if cfg.get("multi_host"):
        # multi-host: every process joins the group before anything else
        # (scripts/diffusion/train.py:69-72)
        device = distributed.initialize(device or "cuda")
        main_process = distributed.is_main_process()
    if cfg.get("pipeline") and cfg.get("lora_config"):
        raise NotImplementedError(PIPELINE_LORA)
    # process 0 names the directory (a timestamped name could differ by a
    # second between processes); the others take its name
    exp_dir = distributed.broadcast_object(create_experiment_workspace(cfg) if main_process else None)
    logger = create_logger(exp_dir)
    logger.info("experiment dir: %s", exp_dir)
    if cfg.get("multi_host"):
        logger.info("multi_host: %d processes, backend %s, devices %s", distributed.process_count(),
                    distributed.backend(), distributed.all_gather_object(str(device)))

    mesh = pipeline_mesh(cfg, device or "cuda") if cfg.get("pipeline") else train_mesh(cfg, device or "cuda")
    dataset = build_module(dict(cfg.dataset), DATASETS)
    # the processes of one data coordinate (its sp ranks) read the same samples
    dataloader, sampler = prepare_dataloader(
        dataset, batch_size=cfg.get("batch_size"), bucket_config=cfg.get("bucket_config"), seed=cfg.get("seed", 42),
        spatial_compression=ae_spatial_compression(cfg), **data_replicas(mesh),
    )
    trainer = Trainer(cfg, device, mesh=mesh)
    ckpt_io = CheckpointIO()
    start_epoch = start_step = global_step = 0
    if cfg.get("load"):
        _, running, sampler_state = ckpt_io.load(cfg.load, trainer.state)
        start_epoch, start_step, global_step = running["epoch"], running["step"], running["global_step"]
        if sampler_state and hasattr(sampler, "load_state_dict"):
            sampler.load_state_dict(sampler_state)
        logger.info("resumed at epoch %d step %d", start_epoch, start_step)

    writer = MetricsWriter(exp_dir, use_wandb=cfg.get("wandb", False), config=cfg.to_dict()) if main_process \
        else None
    num_steps_per_epoch = len(dataloader)
    total_epochs = cfg.get("epochs", 1)
    log_every, ckpt_every = cfg.get("log_every", 1), cfg.get("ckpt_every", 1000)
    window = ProfileWindow(cfg.get("profile") if main_process else None, exp_dir, trainer.device, logger)
    try:
        for epoch in range(start_epoch, total_epochs):
            sampler.set_epoch(epoch)
            for step, batch in enumerate(dataloader, start=start_step):
                window.before_step(global_step)
                with torch.profiler.record_function(f"train step to global_step {global_step + 1}"):
                    metrics = trainer.run_batch(batch)
                global_step += 1
                if distributed.process_count() > 1:  # which samples each process read
                    read = distributed.all_gather_object([int(i) for i in batch.get("index", [])])
                    logger.info("global_step %d samples by process %s", global_step, read)
                window.after_step(global_step)
                if global_step % log_every == 0:
                    loss, grad_norm = float(metrics["loss"]), float(metrics["grad_norm"])
                    if not math.isfinite(loss):
                        logger.warning("non-finite loss at global step %d", global_step)
                    tdict = trainer.timers.to_dict()
                    logger.info("epoch %d step %d/%d global_step %d loss %.4f grad_norm %.3f %s",
                                epoch, step, num_steps_per_epoch, global_step, loss, grad_norm, tdict)
                    if writer is not None:
                        writer.log({"loss": loss, "grad_norm": grad_norm, **tdict}, global_step)
                if global_step % ckpt_every == 0:
                    d = ckpt_io.save(exp_dir, trainer.state, epoch, step + 1, global_step,
                                     sampler_state=sampler.state_dict(step + 1) if hasattr(sampler, "state_dict")
                                     else None, keep_n_latest=cfg.get("keep_n_latest", -1))
                    logger.info("checkpoint saved to %s", d)
            start_step = 0
    finally:
        window.close()
    d = ckpt_io.save(exp_dir, trainer.state, total_epochs - 1, num_steps_per_epoch, global_step)
    logger.info("checkpoint saved to %s", d)
    if writer is not None:
        writer.close()
    logger.info("training done")
    return trainer


if __name__ == "__main__":
    main()
