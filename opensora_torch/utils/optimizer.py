"""Optimizer and learning-rate schedules (counterpart of
opensora_tpu/utils/optimizer.py, which chains optax transforms).

:class:`Optimizer` is ``torch.optim.AdamW`` wrapped to follow the optax
chain step for step:
- ``optax.clip_by_global_norm(c)``: g if ||g|| < c, else (g / ||g||) * c
  (torch's ``clip_grad_norm_`` adds 1e-6 to the norm and clips at equality);
- the schedule is read at the count of updates made so far, starting at 0,
  so with a linear warmup the first update has lr = 0 and moves only the
  Adam moments;
- ``optax.MultiSteps(k)``: gradients are averaged over k calls
  (acc += (g - acc) / (n + 1)) and the inner update runs on every k-th.
AdamW itself is the same update: torch decays p by lr * wd * p and steps
by lr * m_hat / (sqrt(v_hat) + eps), as optax's adamw does.
"""

from __future__ import annotations

import math
from typing import Callable, Iterable, List, Optional, Union

import torch

Schedule = Callable[[int], float]


def linear_schedule(init: float, end: float, steps: int) -> Schedule:
    if steps <= 0:
        return lambda count: init
    return lambda count: init + (end - init) * min(max(count, 0), steps) / steps


def join_schedules(schedules: List[Schedule], boundaries: List[int]) -> Schedule:
    def schedule(count: int) -> float:
        out = schedules[0](count)
        for s, b in zip(schedules[1:], boundaries):
            if count >= b:
                out = s(count - b)
        return out

    return schedule


def linear_warmup_schedule(lr: float, warmup_steps: int) -> Schedule:
    if warmup_steps <= 0:
        return lambda count: lr
    return join_schedules([linear_schedule(0.0, lr, warmup_steps), lambda count: lr], [warmup_steps])


def cosine_annealing_warmup_schedule(lr: float, warmup_steps: int, total_steps: int,
                                     eta_min: float = 1e-7) -> Schedule:
    """optax.warmup_cosine_decay_schedule(0, lr, max(warmup, 1),
    max(total, warmup + 1), eta_min)."""
    warmup = max(warmup_steps, 1)
    decay = max(total_steps, warmup_steps + 1) - warmup
    alpha = 0.0 if lr == 0.0 else eta_min / lr

    def cosine(count: int) -> float:
        count = min(count, decay)
        return lr * ((1 - alpha) * 0.5 * (1 + math.cos(math.pi * count / decay)) + alpha)

    return join_schedules([linear_schedule(0.0, lr, warmup), cosine], [warmup])


def global_norm(tensors: Iterable[torch.Tensor], across_processes: bool = False, device=None) -> torch.Tensor:
    """sqrt of the sum of squares over all tensors, fp32, on the first
    tensor's device (the tensors may lie on several: a sharded state's
    shards). ``across_processes``: the tensors are this process's part
    (each shard counted on one process; there may be none, then the sum is
    0 on ``device``), and the sums of squares are summed over the processes
    before the square root, so every process gets the same norm."""
    norms = [torch.linalg.vector_norm(t.detach().float()) for t in tensors]
    if not across_processes:
        return torch.linalg.vector_norm(torch.stack([n.to(norms[0].device) for n in norms]))
    from opensora_torch.parallel.comm import process_all_reduce

    # the squares summed in fp64, so that the order of the sum (per
    # process, then over processes) leaves no trace in the fp32 norm
    dev = norms[0].device if norms else device
    squares = sum((n.double().to(dev) ** 2 for n in norms), torch.zeros((), dtype=torch.float64, device=dev))
    return process_all_reduce(squares).sqrt().float()


class Optimizer:
    """optax's clip -> adamw chain, optionally under MultiSteps, over
    ``params`` (their ``.grad`` is the input of :meth:`step`)."""

    def __init__(
        self,
        params: Iterable[torch.nn.Parameter],
        schedule: Union[float, Schedule],
        weight_decay: float = 0.0,
        eps: float = 1e-8,
        betas=(0.9, 0.999),
        grad_clip: Optional[float] = None,
        accumulation_steps: int = 1,
    ):
        self.params = list(params)
        self.settings = dict(schedule=schedule, weight_decay=weight_decay, eps=eps, betas=betas, grad_clip=grad_clip,
                             accumulation_steps=accumulation_steps)
        self.schedule = schedule if callable(schedule) else (lambda count, lr=schedule: lr)
        self.grad_clip = grad_clip
        self.accumulation_steps = accumulation_steps
        self.adamw = torch.optim.AdamW(self.params, lr=0.0, betas=betas, eps=eps, weight_decay=weight_decay)
        self.count = 0  # inner (AdamW) updates made
        self.mini_step = 0
        self.acc: Optional[List[torch.Tensor]] = None
        # ids of parameters left out of the clip's norm: replicas of a shard
        # that another parameter holds (``parallel/sharding``), counted once
        self.replica_ids: set = set()
        # the parameters are one process's part of a state cut across
        # processes: the clip's norm sums over them
        self.across_processes = False

    @torch.no_grad()
    def step(self) -> None:
        """Consume the parameters' gradients: accumulate them, or (every
        ``accumulation_steps``-th call) clip and apply AdamW."""
        grads = [torch.zeros_like(p) if p.grad is None else p.grad for p in self.params]
        if self.accumulation_steps > 1:
            if self.acc is None:
                self.acc = [torch.zeros_like(g) for g in grads]
            n = self.mini_step
            for a, g in zip(self.acc, grads):
                a.add_((g - a) / (n + 1))
            self.mini_step = (n + 1) % self.accumulation_steps
            if self.mini_step != 0:
                return
            grads = [a.clone() for a in self.acc]
            for a in self.acc:
                a.zero_()
        if self.grad_clip:
            norm = global_norm([g for p, g in zip(self.params, grads) if id(p) not in self.replica_ids],
                               self.across_processes, self.params[0].device)
            grads = [torch.where(norm.to(g.device) >= self.grad_clip, g / norm.to(g.device) * self.grad_clip, g)
                     for g in grads]
        for p, g in zip(self.params, grads):
            p.grad = g
        for group in self.adamw.param_groups:
            group["lr"] = float(self.schedule(self.count))
        self.adamw.step()
        self.count += 1

    def like(self, params: Iterable[torch.nn.Parameter]) -> "Optimizer":
        """A fresh optimizer with these settings over ``params``."""
        return Optimizer(params, **self.settings)

    def zero_grad(self) -> None:
        for p in self.params:
            p.grad = None

    def state_dict(self) -> dict:
        return dict(adamw=self.adamw.state_dict(), count=self.count, mini_step=self.mini_step, acc=self.acc)

    def load_state_dict(self, state: dict) -> None:
        self.adamw.load_state_dict(state["adamw"])
        self.count, self.mini_step = state["count"], state["mini_step"]
        acc = state["acc"]
        self.acc = None if acc is None else [a.to(p.device) for a, p in zip(acc, self.params)]


def create_optimizer(
    params: Iterable[torch.nn.Parameter],
    lr: float = 1e-4,
    weight_decay: float = 0.0,
    eps: float = 1e-8,
    betas=(0.9, 0.999),
    warmup_steps: Optional[int] = None,
    use_cosine_scheduler: bool = False,
    total_steps: int = 1_000_000,
    grad_clip: Optional[float] = None,
    accumulation_steps: int = 1,
) -> Optimizer:
    """The trainer's optimizer wiring (upstream scripts/diffusion/train.py:237-250)."""
    if use_cosine_scheduler:
        schedule: Union[float, Schedule] = cosine_annealing_warmup_schedule(lr, warmup_steps or 0, total_steps)
    elif warmup_steps:
        schedule = linear_warmup_schedule(lr, warmup_steps)
    else:
        schedule = lr
    return Optimizer(params, schedule, weight_decay, eps, betas, grad_clip, accumulation_steps)
