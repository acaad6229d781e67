"""What the A/B tools share: timing callables in turns on the card, the
card's name and power limit, and importing another checkout's modules
beside this one's.
"""

from __future__ import annotations

import importlib
import os
import subprocess
import sys

import torch

PACKAGE = "opensora_torch"


def time_ms(fn, iters: int = 10) -> float:
    """ms a call of FN, the mean of ITERS calls between two CUDA events
    after one call to warm up."""
    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def in_turns(names, pick, rounds: int, iters: int = 10) -> dict:
    """name -> readings (ms) of the callable PICK(name) returns (PICK may
    set up that side first), timed in order, then reversed, ROUNDS times:
    the card's clock under its power limit depends on what ran just before,
    so every side follows every other as often."""
    names = list(names)
    turns = {n: [] for n in names}
    for order in (names, names[::-1]) * rounds:
        for n in order:
            turns[n].append(time_ms(pick(n), iters))
    return turns


def summary(readings) -> str:
    return (f"ms mean {sum(readings) / len(readings):.3f} range {min(readings):.3f}-{max(readings):.3f} "
            f"({len(readings)} readings in order: {' '.join(f'{v:.3f}' for v in readings)})")


def card() -> str:
    """The card's name and power limit as nvidia-smi gives them."""
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()


def import_checkout(root: str, module: str):
    """MODULE (a dotted name under opensora_torch) as the checkout at ROOT
    has it, imported beside this checkout's: this package's modules leave
    ``sys.modules`` while it imports and come back after, so the two sides
    share no module of the package (each builds its kernels from its own
    ``csrc`` into its own ``_build``)."""
    root = os.path.abspath(root)

    def package_modules():
        return {n: m for n, m in sys.modules.items() if n == PACKAGE or n.startswith(PACKAGE + ".")}

    mine = package_modules()
    for name in mine:
        del sys.modules[name]
    sys.path.insert(0, root)
    try:
        mod = importlib.import_module(module)
    finally:
        sys.path.remove(root)
        for name in package_modules():
            del sys.modules[name]
        sys.modules.update(mine)
    if not os.path.abspath(mod.__file__).startswith(root + os.sep):
        raise RuntimeError(f"{module} came from {mod.__file__}, not from {root}")
    return mod
