"""Video quality metrics: PSNR and SSIM, per frame and per clip
(counterpart of opensora_tpu/eval/metrics.py), on torch tensors on their
own device, in float64 as the JAX package computes them with numpy."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def psnr(a: torch.Tensor, b: torch.Tensor, data_range: float = 2.0) -> float:
    mse = float(((torch.as_tensor(a).double() - torch.as_tensor(b).double()) ** 2).mean())
    if mse == 0:
        return float("inf")
    return 10.0 * float(torch.log10(torch.tensor(data_range**2 / mse, dtype=torch.float64)))


def gaussian_window(size: int = 11, sigma: float = 1.5, device=None) -> torch.Tensor:
    """The 1-D factor of the SSIM window: the 2-D window, the outer product
    of a Gaussian normalized to sum 1, is this vector's outer product with
    itself."""
    x = torch.arange(size, dtype=torch.float64, device=device) - size // 2
    g = torch.exp(-(x**2) / (2 * sigma**2))
    return g / g.sum()


def _filter_valid(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """(N, H, W) -> (N, H - 10, W - 10): the 11 x 11 window applied over
    every position where it fits ('valid'), as two 1-D passes."""
    k = g.numel()
    x = F.conv2d(x[:, None], g.view(1, 1, k, 1))
    return F.conv2d(x, g.view(1, 1, 1, k))[:, 0]


def _ssim_maps(a: torch.Tensor, b: torch.Tensor, data_range: float) -> torch.Tensor:
    """Per-position SSIM of grayscale frames (N, H, W) -> (N, H', W')."""
    a, b = a.double(), b.double()
    g = gaussian_window(device=a.device)
    c1, c2 = (0.01 * data_range) ** 2, (0.03 * data_range) ** 2
    mu_a, mu_b = _filter_valid(a, g), _filter_valid(b, g)
    va = _filter_valid(a * a, g) - mu_a**2
    vb = _filter_valid(b * b, g) - mu_b**2
    cov = _filter_valid(a * b, g) - mu_a * mu_b
    return ((2 * mu_a * mu_b + c1) * (2 * cov + c2)) / ((mu_a**2 + mu_b**2 + c1) * (va + vb + c2))


def ssim_frame(a: torch.Tensor, b: torch.Tensor, data_range: float = 2.0) -> float:
    """Single-frame grayscale SSIM (a, b: (H, W))."""
    return float(_ssim_maps(torch.as_tensor(a)[None], torch.as_tensor(b)[None], data_range).mean())


def ssim_video(a: torch.Tensor, b: torch.Tensor, data_range: float = 2.0) -> float:
    """(C, T, H, W) SSIM averaged over frames (channel-mean grayscale)."""
    s = _ssim_maps(torch.as_tensor(a).mean(dim=0), torch.as_tensor(b).mean(dim=0), data_range)
    return float(s.mean(dim=(1, 2)).mean())
