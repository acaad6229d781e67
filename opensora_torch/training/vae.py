"""VAE/GAN training: the train state and the generator + discriminator step
(counterpart of opensora_tpu/training/vae.py).

One step, as the JAX package's ``train_step``:
1. the AE's training forward ``(x_rec, posterior, z)``, with the
   posterior's noise drawn from a ``torch.Generator`` or passed in whole
   (the seam a test feeds the JAX package's draws through);
2. the VAE loss (L1 + perceptual under the learned ``loss_logvar``, the
   weighted KL) and, with a discriminator, the adversarial term weighted
   by the output-space adaptive weight: ||grad nll|| / ||grad g||, both
   gradients taken with respect to the reconstruction (stopped), not the
   decoder's last layer;
3. backward and the AE optimizer; then the discriminator's own optimizer
   steps on its loss over the video and the reconstruction with its
   gradient stopped;
4. the fp32 EMA of the AE parameters (``loss_logvar`` included).

``grad_checkpoint`` recomputes the AE's encoder and decoder in the
backward; the discriminator is never recomputed. The discriminator runs
with ``deterministic=True`` (no dropout), as in the JAX step.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Optional

import torch
import torch.nn as nn

from opensora_torch.models.vae2d.losses import (
    adaptive_generator_weight,
    discriminator_loss,
    generator_loss,
    vae_loss,
)
from opensora_torch.utils.optimizer import Optimizer
from opensora_torch.utils.train import update_ema

LOGVAR = "loss_logvar"


def ae_parameters(ae: nn.Module, logvar: nn.Parameter) -> Dict[str, nn.Parameter]:
    """The trained AE parameters by state-dict name, and ``loss_logvar``."""
    params = dict(ae.named_parameters())
    params[LOGVAR] = logvar
    return params


@dataclass
class VAETrainState:
    """The AE parameters (with ``loss_logvar``) and their optimizer, an
    optional fp32 EMA of them, the discriminator's parameters and
    optimizer, and the count of steps taken."""

    params: Dict[str, nn.Parameter]
    optimizer: Optimizer
    ema: Optional[Dict[str, torch.Tensor]] = None
    disc_params: Optional[Dict[str, nn.Parameter]] = None
    disc_optimizer: Optional[Optimizer] = None
    step: int = 0

    @classmethod
    def create(cls, params: Dict[str, nn.Parameter], optimizer: Optimizer,
               disc: Optional[nn.Module] = None, disc_optimizer: Optional[Optimizer] = None,
               ema: bool = True) -> "VAETrainState":
        return cls(
            params=params, optimizer=optimizer,
            ema={n: p.detach().float().clone() for n, p in params.items()} if ema else None,
            disc_params=None if disc is None else dict(disc.named_parameters()),
            disc_optimizer=disc_optimizer,
        )

    def state_dict(self) -> dict:
        out = dict(step=self.step, params={n: p.detach() for n, p in self.params.items()},
                   optimizer=self.optimizer.state_dict(), ema=self.ema)
        if self.disc_params is not None:
            out["disc_params"] = {n: p.detach() for n, p in self.disc_params.items()}
            out["disc_optimizer"] = self.disc_optimizer.state_dict()
        return out

    @torch.no_grad()
    def load_state_dict(self, state: dict) -> None:
        self.step = state["step"]
        for n, p in self.params.items():
            p.copy_(state["params"][n])
        self.optimizer.load_state_dict(state["optimizer"])
        if self.ema is not None:
            for n, e in self.ema.items():
                e.copy_(state["ema"][n])
        if self.disc_params is not None:
            for n, p in self.disc_params.items():
                p.copy_(state["disc_params"][n])
            self.disc_optimizer.load_state_dict(state["disc_optimizer"])


def make_vae_train_step(
    ae: nn.Module,
    disc: Optional[nn.Module] = None,
    perceptual_loss_fn: Optional[Callable] = None,
    perceptual_loss_weight: float = 1.0,
    kl_loss_weight: float = 5e-4,
    gen_start: int = 2001,
    disc_start: int = 2001,
    disc_factor: float = 1.0,
    disc_weight: float = 0.5,
    disc_loss_type: str = "hinge",
    ema_decay: float = 0.9999,
    use_discriminator: bool = True,
    adaptive_disc_weight: bool = True,
    grad_checkpoint: bool = False,
) -> Callable:
    """``train_step(state, batch, generator=None, noise=None) -> metrics``:
    one step on ``batch["video"]`` (B, 3, T, H, W) in [-1, 1] that updates
    ``state`` in place. ``noise`` (shaped like the posterior's mean)
    replaces the draw from ``generator``. Metrics (0-d tensors): loss,
    gen_loss (the raw -mean(logits)), disc_loss, nll_loss, kl_loss,
    recon_loss, perceptual_loss."""
    loss_kw = dict(perceptual_loss_fn=perceptual_loss_fn, perceptual_loss_weight=perceptual_loss_weight,
                   kl_loss_weight=kl_loss_weight)

    def output_space_weight(video: torch.Tensor, x_rec: torch.Tensor, logvar: torch.Tensor) -> torch.Tensor:
        """The adaptive weight from the gradients of the nll and of the
        generator's adversarial term with respect to the reconstruction."""
        with torch.enable_grad():
            x_sg = x_rec.detach().requires_grad_()
            nll = vae_loss(video, x_sg, None, logvar.detach(), **loss_kw)["nll_loss"]
            nll_grad, = torch.autograd.grad(nll, x_sg)
            g = -disc(x_sg).float().mean()
            g_grad, = torch.autograd.grad(g, x_sg)
        return adaptive_generator_weight(nll_grad, g_grad, disc_weight)

    def train_step(state: VAETrainState, batch: Dict, generator: Optional[torch.Generator] = None,
                   noise: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
        video = batch["video"]
        step = state.step
        logvar = state.params[LOGVAR]
        with_disc = use_discriminator and disc is not None and state.disc_params is not None

        if with_disc:
            disc.requires_grad_(False)  # the generator step moves only the AE
        x_rec, posterior, _ = ae(video, generator, noise=noise, grad_checkpoint=grad_checkpoint)
        losses = vae_loss(video, x_rec, posterior, logvar, **loss_kw)
        total = losses["nll_loss"] + losses["kl_loss"]
        g_loss = torch.zeros((), device=video.device)
        if with_disc:
            logits_fake = disc(x_rec)
            d_weight = output_space_weight(video, x_rec, logvar) if adaptive_disc_weight else disc_weight
            weighted, g_loss = generator_loss(logits_fake, step, d_weight=d_weight, disc_factor=disc_factor,
                                              gen_start=gen_start)
            total = total + weighted
        total.backward()
        state.optimizer.step()
        state.optimizer.zero_grad()

        d_loss = torch.zeros((), device=video.device)
        if with_disc:
            disc.requires_grad_(True)
            d_loss = discriminator_loss(disc(video), disc(x_rec.detach()), step, disc_factor=disc_factor,
                                        disc_start=disc_start, disc_loss_type=disc_loss_type)
            d_loss.backward()
            state.disc_optimizer.step()
            state.disc_optimizer.zero_grad()

        if state.ema is not None:
            update_ema(state.ema, state.params, ema_decay)
        state.step += 1
        return {"loss": total.detach(), "gen_loss": g_loss.detach(), "disc_loss": d_loss.detach(),
                **{k: v.detach() for k, v in losses.items()}}

    return train_step
