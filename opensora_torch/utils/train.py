"""Training helpers: rectified-flow targets, conditioning dropout, masked
loss, EMA and the visual conditions of training (counterpart of
opensora_tpu/utils/train.py).

Random draws take explicit ``torch.Generator``s; the per-sample mask-type
draw stays on a numpy ``Generator``, on the host, as in the JAX package.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from opensora_torch.utils.sampling import get_res_lin_function, time_shift

# ----------------------------------------------------------------------
# rectified flow
# ----------------------------------------------------------------------


def sample_timesteps(
    batch: int,
    height: int,
    width: int,
    num_frames: int,
    ae_spatial_compression: int = 16,
    patch_size: int = 2,
    generator: Optional[torch.Generator] = None,
    device=None,
) -> torch.Tensor:
    """Logit-normal t with the resolution/temporal shift (upstream
    scripts/diffusion/train.py:384-390), fp32 (B,)."""
    image_seq_len = (height // ae_spatial_compression) * (width // ae_spatial_compression)
    shift_alpha = get_res_lin_function()(image_seq_len * patch_size**2 / 4.0) * math.sqrt(num_frames)
    n = torch.randn((batch,), generator=generator, device=device, dtype=torch.float32)
    return time_shift(shift_alpha, torch.sigmoid(n))


def rf_interpolate(
    x0: torch.Tensor, x1: torch.Tensor, t: torch.Tensor, sigma_min: float = 1e-5
) -> Tuple[torch.Tensor, torch.Tensor]:
    """x_t = (1 - t) x0 + (1 - (1 - sigma) (1 - t)) x1 and the velocity
    target v_t = (1 - sigma) x1 - x0, in x0's dtype. x0 = clean latent,
    x1 = noise, t (B,)."""
    tb = t.reshape((-1,) + (1,) * (x0.dim() - 1)).float()
    x0f, x1f = x0.float(), x1.float()
    x_t = (1 - tb) * x0f + (1 - (1 - sigma_min) * (1 - tb)) * x1f
    v_t = (1 - sigma_min) * x1f - x0f
    return x_t.to(x0.dtype), v_t.to(x0.dtype)


def draw_dropout(batch: int, prob: float, generator: Optional[torch.Generator] = None, device=None) -> torch.Tensor:
    """Which samples drop their condition: uniform(B) < prob, bool (B,)."""
    return torch.rand((batch,), generator=generator, device=device) < prob


def dropout_condition(drop: torch.Tensor, cond: torch.Tensor, null: torch.Tensor) -> torch.Tensor:
    """CFG dropout: the null embedding where ``drop`` (B,) is set."""
    drop = drop.reshape((-1,) + (1,) * (cond.dim() - 1)).to(cond.device)
    return torch.where(drop, null.to(cond.dtype), cond)


# ----------------------------------------------------------------------
# masked loss
# ----------------------------------------------------------------------


def get_batch_loss(
    model_pred: torch.Tensor,
    v_t: torch.Tensor,
    masks: Optional[torch.Tensor] = None,
    latent_shape: Optional[Tuple[int, int, int]] = None,
    patch_size: int = 2,
) -> torch.Tensor:
    """MSE that leaves out head/tail latent frames which are pure i2v
    conditions (upstream train.py:410-450). ``masks`` (B, 1, T, H, W)."""
    pred, target = model_pred.float(), v_t.float()
    if masks is None:
        return ((pred - target) ** 2).mean()
    b, tdim = masks.shape[0], masks.shape[2]
    frame_mask = masks[:, 0, :, 0, 0]
    head, tail = frame_mask[:, 0], frame_mask[:, -1]
    if tdim > 2:
        middle_any = (frame_mask[:, 1:-1] > 0).any(dim=1)
    else:
        middle_any = torch.zeros((b,), dtype=torch.bool, device=masks.device)
    w = torch.ones((b, tdim), dtype=torch.float32, device=masks.device)
    w[:, 0] = torch.where((head == 1) & ~middle_any, 0.0, w[:, 0])
    w[:, -1] = torch.where((tail == 1) & ~middle_any, 0.0, w[:, -1])
    _, h_lat, w_lat = latent_shape
    tok_w = w.repeat_interleave((h_lat // patch_size) * (w_lat // patch_size), dim=1)[..., None]
    per_sample = (((pred - target) ** 2) * tok_w).sum(dim=(1, 2)) / (
        tok_w.sum(dim=(1, 2)) * pred.shape[-1] + 1e-8
    )
    return per_sample.mean()


# ----------------------------------------------------------------------
# EMA
# ----------------------------------------------------------------------


@torch.no_grad()
def update_ema(ema: Dict[str, torch.Tensor], params: Dict[str, torch.Tensor], decay: float = 0.9999) -> None:
    """ema = ema * decay + p * (1 - decay), in place over fp32 copies."""
    for name, e in ema.items():
        e.mul_(decay).add_(params[name].detach().float(), alpha=1 - decay)


# ----------------------------------------------------------------------
# visual conditioning (training)
# ----------------------------------------------------------------------

def choose_mask_conditions(
    condition_config: Dict[str, float],
    batch: int,
    latent_t: int,
    time_compression: int,
    rng: np.random.Generator,
    causal: bool = True,
) -> list:
    """Per-sample mask-type draw on the host, with the same pruning of
    types the clip is too short for (upstream train.py:219-247)."""
    cfg = dict(condition_config)
    if latent_t <= 1:
        return ["t2v"] * batch
    lim = 32 // time_compression + (1 if causal else 0)
    lim_easy = 64 // time_compression + (1 if causal else 0)
    if latent_t <= lim:
        cfg.pop("v2v_head", None)
        cfg.pop("v2v_tail", None)
    if latent_t <= lim_easy:
        cfg.pop("v2v_head_easy", None)
        cfg.pop("v2v_tail_easy", None)
    options = list(cfg.keys())
    weights = np.asarray([cfg[k] for k in options], np.float64)
    weights = weights / weights.sum()
    return [options[rng.choice(len(options), p=weights)] for _ in range(batch)]


def single_frame_encodes(mask_conds: Sequence[str]) -> int:
    """How many single frames :func:`build_visual_condition` encodes for
    these mask types."""
    return sum(("head" in mc or "loop" in mc) + ("tail" in mc or "loop" in mc)
               for mc in mask_conds if mc.startswith("i2v"))


def build_visual_condition(
    x0: torch.Tensor,
    mask_conds: Sequence[str],
    encode_single_frame: Callable[[torch.Tensor], torch.Tensor],
    latent_full: torch.Tensor,
    time_compression: int = 4,
    causal: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(masks (B, 1, T, H, W), cond = cat([masks, masks * latent], 1)) for a
    batch (upstream train.py:186-407, causal variant). Head/tail image
    frames are encoded on their own by ``encode_single_frame`` so no
    information crosses the causal boundary."""
    B, C, T, H, W = latent_full.shape
    masks = torch.zeros((B, 1, T, H, W), dtype=latent_full.dtype, device=latent_full.device)
    latent = torch.zeros_like(latent_full)
    for i, mc in enumerate(mask_conds):
        if mc == "t2v" or T <= 1:
            continue
        if mc in ("i2v_head", "i2v_loop"):
            masks[i, :, 0] = 1
            latent[i, :, :1] = encode_single_frame(x0[i:i + 1, :, :1])[0]
        if mc in ("i2v_tail", "i2v_loop"):
            masks[i, :, -1] = 1
            latent[i, :, -1:] = encode_single_frame(x0[i:i + 1, :, -1:])[0]
        if mc.startswith("v2v"):
            ref_t = 65 if "easy" in mc else 33
            if not causal:
                ref_t -= 1
            cond_t = (ref_t - 1) // time_compression + 1 if causal else ref_t // time_compression
            sl = slice(None, cond_t) if "head" in mc else slice(-cond_t, None)
            masks[i, :, sl] = 1
            latent[i, :, sl] = latent_full[i, :, sl]
    return masks, torch.cat([masks, masks * latent], dim=1)
