"""Metrics sink (counterpart of opensora_tpu/utils/tb.py): TensorBoard
through tensorboardX and wandb, each where it is installed; without them
``log`` does nothing, as in the JAX package."""

from __future__ import annotations

import os
from typing import Dict, Optional


class MetricsWriter:
    def __init__(self, exp_dir: str, use_wandb: bool = False, config: Optional[dict] = None):
        self._tb = None
        self._wandb = None
        try:
            from tensorboardX import SummaryWriter

            self._tb = SummaryWriter(os.path.join(exp_dir, "tb"))
        except ImportError:
            pass
        if use_wandb:
            try:
                import wandb

                wandb.init(project="opensora_torch", dir=exp_dir, config=config)
                self._wandb = wandb
            except ImportError:
                pass

    def log(self, metrics: Dict[str, float], step: int):
        if self._tb is not None:
            for k, v in metrics.items():
                self._tb.add_scalar(k, float(v), step)
        if self._wandb is not None:
            self._wandb.log(metrics, step=step)

    def close(self):
        if self._tb is not None:
            self._tb.close()
        if self._wandb is not None:
            self._wandb.finish()
