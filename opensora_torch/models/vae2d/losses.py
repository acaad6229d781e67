"""VAE training losses: reconstruction + perceptual + KL, the GAN generator
and discriminator objectives (counterpart of
opensora_tpu/models/vae2d/losses.py).

Pure functions of tensors. The adaptive generator weight takes both
gradients explicitly; ``training/vae.py`` computes them in output space,
as the JAX package's step does.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple, Union

import torch
import torch.nn.functional as F


def l1(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return (x.float() - y.float()).abs()


def batch_mean(x: torch.Tensor) -> torch.Tensor:
    """Mean over each sample, then over the batch."""
    return x.reshape(x.shape[0], -1).mean(dim=-1).mean()


def adopt_weight(weight: float, global_step: int, threshold: int = 0, value: float = 0.0) -> float:
    return value if global_step < threshold else weight


def hinge_d_loss(logits_real: torch.Tensor, logits_fake: torch.Tensor) -> torch.Tensor:
    return 0.5 * (F.relu(1.0 - logits_real.float()).mean() + F.relu(1.0 + logits_fake.float()).mean())


def vanilla_d_loss(logits_real: torch.Tensor, logits_fake: torch.Tensor) -> torch.Tensor:
    return 0.5 * (F.softplus(-logits_real.float()).mean() + F.softplus(logits_fake.float()).mean())


def wgan_gp_loss(logits_real: torch.Tensor, logits_fake: torch.Tensor) -> torch.Tensor:
    return 0.5 * (-logits_real.float().mean() + logits_fake.float().mean())


def lecam_reg(real_pred, fake_pred, ema_real_pred, ema_fake_pred) -> torch.Tensor:
    """LeCam regularization."""
    return F.relu(real_pred - ema_fake_pred).pow(2).mean() + F.relu(ema_real_pred - fake_pred).pow(2).mean()


def vae_loss(
    video: torch.Tensor,
    recon_video: torch.Tensor,
    posterior,
    logvar: torch.Tensor,
    perceptual_loss_fn: Optional[Callable] = None,
    perceptual_loss_weight: float = 1.0,
    kl_loss_weight: float = 5e-4,
) -> Dict[str, torch.Tensor]:
    """L1 + weighted perceptual term under a learned log-variance, and the
    weighted KL of the posterior. video, recon: (B, C, T, H, W); frames are
    folded into the batch for the perceptual term."""
    b, c, t, h, w = video.shape
    vid = video.transpose(1, 2).reshape(b * t, c, h, w)
    rec = recon_video.transpose(1, 2).reshape(b * t, c, h, w)

    recon = l1(vid, rec)
    if perceptual_loss_fn is not None:
        perceptual = perceptual_loss_fn(vid, rec)
    else:
        perceptual = torch.zeros((b * t, 1, 1, 1), dtype=torch.float32, device=video.device)
    nll = recon + perceptual * perceptual_loss_weight
    nll = nll / torch.exp(logvar) + logvar

    kl = torch.zeros((), dtype=torch.float32, device=video.device) if posterior is None else posterior.kl().mean()
    return {
        "nll_loss": batch_mean(nll),
        "kl_loss": kl * kl_loss_weight,
        "recon_loss": batch_mean(recon),
        "perceptual_loss": batch_mean(perceptual) * (c * h * w),
    }


def adaptive_generator_weight(nll_grad: torch.Tensor, g_grad: torch.Tensor, disc_weight: float = 0.5) -> torch.Tensor:
    """|grad nll| / |grad g| clipped to [0, 1e4], times ``disc_weight``;
    no gradient flows through it."""
    d_weight = torch.linalg.vector_norm(nll_grad.float()) / (torch.linalg.vector_norm(g_grad.float()) + 1e-4)
    return d_weight.clamp(0.0, 1e4).detach() * disc_weight


def generator_loss(
    logits_fake: torch.Tensor,
    global_step: int,
    d_weight: Union[torch.Tensor, float] = 1.0,
    disc_factor: float = 1.0,
    gen_start: int = 2001,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(weighted adversarial term, raw -mean(logits))."""
    g_loss = -logits_fake.float().mean()
    factor = adopt_weight(disc_factor, global_step, threshold=gen_start)
    return d_weight * factor * g_loss, g_loss


def discriminator_loss(
    logits_real: torch.Tensor,
    logits_fake: torch.Tensor,
    global_step: int,
    disc_factor: float = 1.0,
    disc_start: int = 2001,
    disc_loss_type: str = "hinge",
) -> torch.Tensor:
    fn = {"hinge": hinge_d_loss, "vanilla": vanilla_d_loss, "wgan-gp": wgan_gp_loss}[disc_loss_type]
    return adopt_weight(disc_factor, global_step, threshold=disc_start) * fn(logits_real, logits_fake)
