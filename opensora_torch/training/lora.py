"""LoRA fine-tuning of the MMDiT (counterpart of opensora_tpu/training/lora.py;
upstream scripts/diffusion/train.py:198-217, peft LoRA on the blocks).

Every ``nn.Linear`` whose weight name matches ``target_regex`` becomes a
:class:`LoRALinear`: the frozen base weight and bias plus trainable fp32
factors ``lora_A`` (r, in) ~ N(0, 1) / r and ``lora_B`` (out, r) = 0. The
effective weight W + s * (lora_B @ lora_A) -- the JAX package's
W + s * (A @ B) in flax's (in, out) layout -- is formed per linear inside
its forward and rounded to the base weight's dtype there. The JAX package
merges the whole tree before the forward; per linear gives the same values
without a second copy of the base weights (23.6 GB in bf16 at full width).

Over a mesh (``parallel/sharding.shard_params``) the base is cut by the
TP + FSDP rules and the factors are replicated on every rank, as the JAX
package places its factor tree with ``P()``. A rank reads its shard of
the weight (gathered over 'data' first) and merges into it the part of
the delta that falls on it (:func:`rank_factors`): the rows of ``lora_B``
that meet a column-parallel weight's rows, the columns of ``lora_A`` that
meet a row-parallel weight's input columns, each cut per segment as the
weight is. The factors' gradients then meet on the shared leaf (or, on
ranks with devices of their own, in the replicas' sum).
"""

from __future__ import annotations

import re
from typing import Dict, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

# the JAX package's targets, over the port's upstream state-dict names
DEFAULT_TARGETS = r".*(qkv|proj|linear1|linear2|img_mlp\.\d|txt_mlp\.\d|q_proj|k_proj|v_proj|v_mlp)\.weight"


class LoRALinear(nn.Module):
    """A frozen linear with trainable low-rank factors; state-dict keys
    ``weight``, ``bias``, ``lora_A``, ``lora_B``."""

    def __init__(self, base: nn.Linear, rank: int, scale: float, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.weight = base.weight
        self.bias = base.bias
        self.weight.requires_grad_(False)
        if self.bias is not None:
            self.bias.requires_grad_(False)
        self.scale = scale
        out_f, in_f = base.weight.shape
        dev = base.weight.device
        a = torch.randn((rank, in_f), generator=generator, device=generator.device if generator else dev)
        self.lora_A = nn.Parameter((a / rank).to(dev))
        self.lora_B = nn.Parameter(torch.zeros((out_f, rank), device=dev))

    def merged_weight(self) -> torch.Tensor:
        """W + scale * (lora_B @ lora_A), summed in fp32 and rounded to the
        base's dtype; sharded, the open scope's rank's shard of it."""
        weight, a, b = self.weight, self.lora_A, self.lora_B
        placement = getattr(self, "_placements", {}).get("weight")
        if placement is not None:
            a, b = rank_factors(placement, a, b)
        w = torch.addmm(weight.float(), b, a, alpha=self.scale)
        return w.to(weight.dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x, self.merged_weight(), self.bias)


def rank_factors(placement, a: torch.Tensor, b: torch.Tensor):
    """The factors (A (r, in), B (out, r)) that a tp rank merges into its
    shard of the weight ``placement`` cuts: B's rows where 'tp' cuts the
    output dim, A's columns where it cuts the input dim, per segment as the
    weight (the 'data' dim is whole again after the FSDP gather)."""
    if placement.tp_dim == 0:
        return a, placement.rank_piece(b, 0)
    if placement.tp_dim == 1:
        return placement.rank_piece(a, 1), b
    return a, b


def apply_lora(
    model: nn.Module,
    rank: int = 16,
    scale: float = 1.0,
    target_regex: str = DEFAULT_TARGETS,
    generator: Optional[torch.Generator] = None,
) -> Dict[str, nn.Parameter]:
    """Freeze ``model`` and replace each target linear with a
    :class:`LoRALinear` in place, drawing the A factors in module order
    from ``generator``. Returns the trainable factors by state-dict name."""
    pattern = re.compile(target_regex)
    model.requires_grad_(False)
    targets = [
        name for name, mod in model.named_modules()
        if isinstance(mod, nn.Linear) and pattern.fullmatch(f"{name}.weight")
    ]
    for name in targets:
        parent_name, _, child = name.rpartition(".")
        parent = model.get_submodule(parent_name)
        setattr(parent, child, LoRALinear(getattr(parent, child), rank, scale, generator))
    return lora_parameters(model)


def lora_parameters(model: nn.Module) -> Dict[str, nn.Parameter]:
    return {n: p for n, p in model.named_parameters() if n.endswith((".lora_A", ".lora_B"))}


def count_lora_params(model: nn.Module) -> int:
    return sum(p.numel() for p in lora_parameters(model).values())
