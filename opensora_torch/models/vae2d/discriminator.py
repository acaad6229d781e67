"""3D PatchGAN discriminator of VAE training (counterpart of
opensora_tpu/models/vae2d/discriminator.py).

Conv3d k=3 (stride 2, then (1, 2, 2), then 1), group norm with min(32, C)
groups in place of upstream's BatchNorm3d (as in the JAX package),
LeakyReLU 0.2, a 1-channel map of patch logits. Layout (B, C, T, H, W).

Parameters are kept in ``param_dtype`` (fp32) and cast to the compute
``dtype`` (bf16) at use, like flax's ``param_dtype``/``dtype``. Dropout
(0.30) applies only with ``deterministic=False``; the VAE train step calls
the discriminator with the default ``deterministic=True``, as the JAX step
does, so it is off in training.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from opensora_torch.models.cast_layers import Conv3d
from opensora_torch.ops.norms import group_norm
from opensora_torch.registry import MODELS
from opensora_torch.utils.misc import torch_dtype


class _Norm3D(nn.Module):
    def __init__(self, channels: int, **factory):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(channels, **factory))
        self.bias = nn.Parameter(torch.zeros(channels, **factory))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return group_norm(x, min(32, x.shape[1]), self.weight, self.bias)


class NLayerDiscriminator3D(nn.Module):
    def __init__(self, input_nc: int = 3, ndf: int = 64, n_layers: int = 5, dropout: float = 0.30,
                 dtype: str = "bf16", param_dtype: str = "fp32", device=None):
        super().__init__()
        self.dropout = dropout
        self.compute_dtype = torch_dtype(dtype)
        factory = dict(device=device, dtype=torch_dtype(param_dtype))
        convs = [Conv3d(input_nc, ndf, 3, stride=2, padding=1, **factory)]
        norms = []
        nf_mult = 1
        for n in range(1, n_layers):
            nf_prev, nf_mult = nf_mult, min(2**n, 8)
            stride = 2 if n == 1 else (1, 2, 2)
            convs.append(Conv3d(ndf * nf_prev, ndf * nf_mult, 3, stride=stride, padding=1, bias=False, **factory))
            norms.append(_Norm3D(ndf * nf_mult, **factory))
        nf_prev, nf_mult = nf_mult, min(2**n_layers, 8)
        convs.append(Conv3d(ndf * nf_prev, ndf * nf_mult, 3, stride=1, padding=1, bias=False, **factory))
        norms.append(_Norm3D(ndf * nf_mult, **factory))
        convs.append(Conv3d(ndf * nf_mult, 1, 3, stride=1, padding=1, **factory))
        self.convs = nn.ModuleList(convs)
        self.norms = nn.ModuleList(norms)

    def forward(self, x: torch.Tensor, deterministic: bool = True) -> torch.Tensor:
        """(B, C, T, H, W) -> patch logits (B, 1, T', H', W') in the compute
        dtype."""
        h = F.leaky_relu(self.convs[0](x.to(self.compute_dtype)), 0.2)
        n_layers = len(self.norms)
        for n in range(1, n_layers + 1):
            h = F.leaky_relu(self.norms[n - 1](self.convs[n](h)), 0.2)
            if n < n_layers and self.dropout > 0 and not deterministic:
                h = F.dropout(h, self.dropout, training=True)
        return self.convs[-1](h)


@MODELS.register_module("N_Layer_discriminator_3D")
def build_discriminator_3d(from_pretrained: Optional[str] = None, device=None, **kwargs) -> NLayerDiscriminator3D:
    if from_pretrained:
        # the JAX builder ignores from_pretrained and draws random weights
        # (ROADMAP Queue 3 R9); raising says so rather than training from them
        raise NotImplementedError(
            "loading a pretrained discriminator is not ported (the JAX package ignores from_pretrained here; "
            "ROADMAP Queue 3 R9)")
    known = ("input_nc", "ndf", "n_layers", "dropout", "dtype", "param_dtype")
    return NLayerDiscriminator3D(**{k: v for k, v in kwargs.items() if k in known}, device=device)
