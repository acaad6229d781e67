"""Small helpers shared by the port's entry points: dtypes, the device,
section timers and parameter counts (counterpart of
opensora_tpu/utils/misc.py)."""

from __future__ import annotations

import time
from typing import Dict, Iterable, Optional, Union

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


class Timer:
    """Wall-clock section timer. ``sync=True`` waits for the CUDA device
    before reading the clock, so the section's device work is counted."""

    def __init__(self, name: str, sync: bool = False):
        self.name = name
        self.sync = sync and torch.cuda.is_available()
        self.elapsed = 0.0
        self.count = 0
        self._t0 = 0.0

    def __enter__(self):
        if self.sync:
            torch.cuda.synchronize()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if self.sync:
            torch.cuda.synchronize()
        self.elapsed += time.perf_counter() - self._t0
        self.count += 1
        return False

    @property
    def average(self) -> float:
        return self.elapsed / max(self.count, 1)


class Timers:
    """Named timers, exported as ``time/<name>`` averages for logging."""

    def __init__(self, sync: bool = False):
        self._timers: Dict[str, Timer] = {}
        self.sync = sync

    def __call__(self, name: str) -> Timer:
        if name not in self._timers:
            self._timers[name] = Timer(name, self.sync)
        return self._timers[name]

    def to_dict(self, reset: bool = True) -> Dict[str, float]:
        out = {f"time/{k}": t.average for k, t in self._timers.items() if t.count}
        if reset:
            for t in self._timers.values():
                t.elapsed, t.count = 0.0, 0
        return out


def count_params(params: Iterable[torch.Tensor]) -> int:
    return sum(p.numel() for p in params)


def format_numel(n: int) -> str:
    for unit, div in (("B", 1e9), ("M", 1e6), ("K", 1e3)):
        if n >= div:
            return f"{n / div:.2f} {unit}"
    return str(n)
