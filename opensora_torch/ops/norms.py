"""Normalization primitives (counterpart of opensora_tpu/ops/norms.py).

Statistics in fp32, result in the input's dtype, like the JAX functions.
Plain PyTorch: these are bandwidth-bound elementwise passes with no TPU
kernel behind them (``F.layer_norm``/``F.group_norm`` keep fp32 statistics
for bf16 input).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    rrms = torch.rsqrt(xf.pow(2).mean(dim=-1, keepdim=True) + eps)
    return (xf * rrms).to(x.dtype) * scale.to(x.dtype)


def layer_norm(x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """LayerNorm over the last axis without affine parameters."""
    return F.layer_norm(x, (x.shape[-1],), eps=eps)


def group_norm(
    x: torch.Tensor, num_groups: int, scale: torch.Tensor, bias: torch.Tensor, eps: float = 1e-6
) -> torch.Tensor:
    """GroupNorm over channels-first input (B, C, ...)."""
    return F.group_norm(x, num_groups, scale.to(x.dtype), bias.to(x.dtype), eps)
