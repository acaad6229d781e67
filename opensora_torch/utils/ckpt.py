"""Train-state checkpoints (counterpart of ``CheckpointIO``,
opensora_tpu/utils/ckpt.py:569-648), written with ``torch.save``.

Layout per save: ``<exp_dir>/epoch{e}-global_step{s}/``
  state.pt              the train state's ``state_dict()`` (trained params,
                        optimizer, EMA, step)
  running_states.json   epoch / step / global_step
  sampler_state.json    the sampler's resume point, when given
The JAX package's orbax layout is not read or written here.
"""

from __future__ import annotations

import json
import os
import re
import shutil
from typing import Optional, Tuple

import torch

_CKPT_DIR = re.compile(r"epoch(\d+)-global_step(\d+)")


class CheckpointIO:
    def save(self, exp_dir: str, state, epoch: int, step: int, global_step: int,
             sampler_state: Optional[dict] = None, keep_n_latest: int = -1) -> str:
        d = os.path.join(os.path.abspath(exp_dir), f"epoch{epoch}-global_step{global_step}")
        os.makedirs(d, exist_ok=True)
        torch.save(state.state_dict(), os.path.join(d, "state.pt"))
        with open(os.path.join(d, "running_states.json"), "w") as f:
            json.dump({"epoch": epoch, "step": step, "global_step": global_step}, f)
        if sampler_state is not None:
            with open(os.path.join(d, "sampler_state.json"), "w") as f:
                json.dump(sampler_state, f)
        if keep_n_latest > 0:
            self.rm_checkpoints(exp_dir, keep_n_latest)
        return d

    def load(self, path: str, state) -> Tuple[object, dict, Optional[dict]]:
        """Restore ``state`` in place from ``path``; returns (state, running
        counters, sampler state or None)."""
        state.load_state_dict(torch.load(os.path.join(path, "state.pt"), map_location="cpu", weights_only=False))
        running = {"epoch": 0, "step": 0, "global_step": 0}
        sampler_state = None
        rs, ss = os.path.join(path, "running_states.json"), os.path.join(path, "sampler_state.json")
        if os.path.exists(rs):
            with open(rs) as f:
                running = json.load(f)
        if os.path.exists(ss):
            with open(ss) as f:
                sampler_state = json.load(f)
        return state, running, sampler_state

    @staticmethod
    def rm_checkpoints(exp_dir: str, keep_n_latest: int) -> None:
        """Delete all but the ``keep_n_latest`` newest checkpoints."""
        found = sorted(
            ((int(m.group(2)), name) for name in os.listdir(exp_dir) if (m := _CKPT_DIR.fullmatch(name))),
            reverse=True,
        )
        for _, name in found[keep_n_latest:]:
            shutil.rmtree(os.path.join(exp_dir, name), ignore_errors=True)
