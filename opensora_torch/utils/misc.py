"""Small helpers shared by the port's entry points."""

from __future__ import annotations

from typing import Optional, Union

import torch

DTYPE_MAP = {
    "bf16": torch.bfloat16,
    "bfloat16": torch.bfloat16,
    "fp16": torch.float16,
    "float16": torch.float16,
    "fp32": torch.float32,
    "float32": torch.float32,
}


def torch_dtype(dtype: Union[str, torch.dtype]) -> torch.dtype:
    return DTYPE_MAP[dtype] if isinstance(dtype, str) else dtype


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless the caller names
    another. There is no silent fallback: asking for CUDA without a GPU
    raises."""
    device = torch.device(device if device is not None else "cuda")
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device available; pass device='cpu' to run on the CPU")
    return device
