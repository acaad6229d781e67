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
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Dict, Optional

import torch
import torch.nn as nn

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
    optional fp32 EMA of them, and the count of steps taken."""

    params: Dict[str, nn.Parameter]
    optimizer: Optimizer
    ema: Optional[Dict[str, torch.Tensor]] = None
    step: int = 0

    @classmethod
    def create(cls, model: nn.Module, optimizer: Optimizer, ema: bool = True) -> "TrainState":
        params = {n: p for n, p in model.named_parameters() if p.requires_grad}
        ema_params = {n: p.detach().float().clone() for n, p in params.items()} if ema else None
        return cls(params=params, optimizer=optimizer, ema=ema_params)

    def state_dict(self) -> dict:
        return dict(
            step=self.step,
            params={n: p.detach() for n, p in self.params.items()},
            optimizer=self.optimizer.state_dict(),
            ema=self.ema,
        )

    @torch.no_grad()
    def load_state_dict(self, state: dict) -> None:
        self.step = state["step"]
        for n, p in self.params.items():
            p.copy_(state["params"][n])
        self.optimizer.load_state_dict(state["optimizer"])
        if self.ema is not None:
            for n, e in self.ema.items():
                e.copy_(state["ema"][n])


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
) -> Callable:
    """``train_step(state, batch, generator=None, draws=None) -> metrics``:
    one rectified-flow step that updates ``state`` in place. ``draws``
    (t, x1 and, with text dropout, drop_txt / drop_vec) replaces the
    draws from ``generator``. Metrics: the loss and the global norm of the
    step's gradients, as 0-d tensors on the model's device.

    batch: x0 packed clean latent (B, L, C); img_ids (B, L, 3); txt,
    txt_ids, y_vec; cond (B, L, C + p^2) or None; masks (B, 1, T, H, W) or
    None; shift_alpha (B,); guidance (B,) or None; null_txt, null_vec."""

    def train_step(state: TrainState, batch: Dict, generator: Optional[torch.Generator] = None,
                   draws: Optional[Dict] = None) -> Dict[str, torch.Tensor]:
        if draws is None:
            draws = draw_step(batch, text_dropout_prob, generator)
        loss = compute_loss(model, batch, sigma_min=sigma_min, use_masked_loss=use_masked_loss,
                            patch_size=patch_size, **draws)
        loss.backward()
        params = list(state.params.values())
        grad_norm = global_norm([torch.zeros_like(p) if p.grad is None else p.grad for p in params])
        state.optimizer.step()
        state.optimizer.zero_grad()
        if state.ema is not None:
            update_ema(state.ema, state.params, ema_decay)
        state.step += 1
        return {"loss": loss.detach(), "grad_norm": grad_norm}

    return train_step


def compute_shift_alpha(latent_h: int, latent_w: int, latent_t: int) -> float:
    """Resolution/temporal shift factor res_lin((h * w) // 4) * sqrt(T) over
    latent dims (upstream scripts/diffusion/train.py:385-390)."""
    return get_res_lin_function()((latent_h * latent_w) // 4) * math.sqrt(latent_t)
