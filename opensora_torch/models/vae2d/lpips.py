"""LPIPS perceptual distance: VGG16 features and learned linear heads
(counterpart of opensora_tpu/models/vae2d/lpips.py).

The module's state-dict names are those of the published files, so they
load with ``load_state_dict`` and no conversion: ``vgg.features.{i}`` are
torchvision's VGG16 ``features.{i}`` (conv layers at indices 0, 2, 5, ...,
28) and ``lin{i}.model.1.weight`` (1, C, 1, 1) are the LPIPS heads.
:func:`load_lpips` reads both files. Without an LPIPS file the heads are
1 / C, as in the JAX package. Everything runs in fp32.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn

_VGG16_CFG = [64, 64, "M", 128, 128, "M", 256, 256, 256, "M", 512, 512, 512, "M", 512, 512, 512, "M"]
# feature taps after relu1_2, relu2_2, relu3_3, relu4_3, relu5_3: index in
# the conv-only sequence
_TAPS = (1, 3, 6, 9, 12)
_CHANNELS = (64, 128, 256, 512, 512)

_SHIFT = (-0.030, -0.088, -0.188)
_SCALE = (0.458, 0.448, 0.450)


def _conv_indices():
    """The index of each conv layer in torchvision's ``features`` Sequential
    (a conv and its ReLU take two places, a max-pool one)."""
    idx, out = 0, []
    for v in _VGG16_CFG:
        if v != "M":
            out.append(idx)
        idx += 1 if v == "M" else 2
    return tuple(out)


VGG_CONV_INDICES = _conv_indices()


class VGG16Features(nn.Module):
    """torchvision's ``vgg16().features`` layout: conv, ReLU and max-pool
    layers in one ``features`` Sequential."""

    def __init__(self, device=None):
        super().__init__()
        layers, c_in = [], 3
        for v in _VGG16_CFG:
            if v == "M":
                layers.append(nn.MaxPool2d(2, 2))
            else:
                layers += [nn.Conv2d(c_in, v, 3, padding=1, device=device), nn.ReLU()]
                c_in = v
        self.features = nn.Sequential(*layers)

    def forward(self, x: torch.Tensor):
        """The five tapped activations of (B, 3, H, W)."""
        feats, conv_idx = [], 0
        for layer in self.features:
            x = layer(x)
            if isinstance(layer, nn.ReLU):
                if conv_idx in _TAPS:
                    feats.append(x)
                conv_idx += 1
        return feats


class NetLinLayer(nn.Module):
    """A 1x1 conv head without bias. Upstream's ``model.0`` is a dropout that
    LPIPS runs in eval mode: an identity here keeps the name."""

    def __init__(self, channels: int, device=None):
        super().__init__()
        self.model = nn.Sequential(nn.Identity(), nn.Conv2d(channels, 1, 1, bias=False, device=device))


def _normalize_tensor(x: torch.Tensor, eps: float = 1e-10) -> torch.Tensor:
    return x / (torch.sqrt((x * x).sum(dim=1, keepdim=True)) + eps)


class LPIPS(nn.Module):
    """(x, y) in [-1, 1], (B, C, H, W) -> per-sample distance (B, 1, 1, 1)."""

    def __init__(self, device=None):
        super().__init__()
        self.vgg = VGG16Features(device)
        for i, c in enumerate(_CHANNELS):
            self.add_module(f"lin{i}", NetLinLayer(c, device))

    def forward(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        shift = torch.tensor(_SHIFT, device=x.device).reshape(1, 3, 1, 1)
        scale = torch.tensor(_SCALE, device=x.device).reshape(1, 3, 1, 1)
        fx = self.vgg((x.float() - shift) / scale)
        fy = self.vgg((y.float() - shift) / scale)
        total = 0.0
        for i, (a, b) in enumerate(zip(fx, fy)):
            diff = (_normalize_tensor(a) - _normalize_tensor(b)) ** 2
            lin = getattr(self, f"lin{i}").model[1](diff)
            total = total + lin.mean(dim=(2, 3), keepdim=True)
        return total


@torch.no_grad()
def load_lpips(vgg_ckpt: str, lpips_ckpt: Optional[str] = None, device=None) -> LPIPS:
    """A frozen LPIPS from a torchvision VGG16 state dict (its ``features.*``
    entries, strictly) and an LPIPS head file (``lin{i}.model.1.weight``,
    strictly), or heads of 1 / C without one."""
    lpips = LPIPS(device)
    vgg_sd = torch.load(vgg_ckpt, map_location="cpu", weights_only=True)
    lpips.vgg.load_state_dict({k: v for k, v in vgg_sd.items() if k.startswith("features.")}, strict=True)
    if lpips_ckpt:
        heads = torch.load(lpips_ckpt, map_location="cpu", weights_only=True)
        own = {k for k in lpips.state_dict() if k.startswith("lin")}
        if set(heads) != own:
            raise KeyError(f"{lpips_ckpt}: expected the LPIPS heads {sorted(own)}, got {sorted(heads)}")
        lpips.load_state_dict(heads, strict=False)
    else:
        for i, c in enumerate(_CHANNELS):
            getattr(lpips, f"lin{i}").model[1].weight.fill_(1.0 / c)
    return lpips.eval().requires_grad_(False)
