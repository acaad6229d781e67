"""Rectified-flow evaluation loss on fixed timesteps (counterpart of
opensora_tpu/eval/rf_loss.py).

Eval loss = MSE(model(x_t, t), v_t) over a fixed grid of t, with fixed
noise and fixed data, so that it repeats between runs: the training-quality
signal Open-Sora 1.2 tracked on its validation sets. The noise is drawn
once from ``generator`` (or passed in whole, so that a test can hand in the
JAX package's ``jax.random`` draw) and shared by every t.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence

import torch

from opensora_torch.utils.train import rf_interpolate


@torch.no_grad()
def rf_eval_loss(
    model_fn: Callable,
    x0: torch.Tensor,
    model_kwargs: Dict,
    generator: Optional[torch.Generator] = None,
    timesteps: Sequence[float] = (0.1, 0.25, 0.5, 0.75, 0.9),
    sigma_min: float = 1e-5,
    noise: Optional[torch.Tensor] = None,
) -> Dict[str, torch.Tensor]:
    """``eval_loss_t{t}`` for each t and ``eval_loss_mean`` (0-d fp32
    tensors on x0's device) for packed latents x0 (B, L, C).
    ``model_fn(img=x_t, timesteps=t, **model_kwargs)`` is the velocity
    prediction; ``noise`` (x0's shape) replaces the draw from ``generator``."""
    if noise is None:
        noise = torch.randn(x0.shape, generator=generator, device=x0.device, dtype=torch.float32)
    losses = {}
    total = 0.0
    for tv in timesteps:
        t = torch.full((x0.shape[0],), tv, dtype=torch.float32, device=x0.device)
        x_t, v_t = rf_interpolate(x0, noise.to(x0.device), t, sigma_min)
        pred = model_fn(img=x_t, timesteps=t, **model_kwargs)
        loss = ((pred.float() - v_t.float()) ** 2).mean()
        losses[f"eval_loss_t{tv}"] = loss
        total = total + loss
    losses["eval_loss_mean"] = total / len(timesteps)
    return losses
