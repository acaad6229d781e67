"""A training checkpoint to published weights (counterpart of
scripts/cnv/export.py).

    python -m opensora_torch.cnv.export CKPT_DIR OUT.safetensors --config CONFIG.py \\
        [--source ema|params] [--kind mmdit|hunyuan_vae] [--layout published|flux|native] [--dotted.key value ...]

``CKPT_DIR`` is an ``epoch{e}-global_step{s}`` directory that the training
CLI (``--kind mmdit``) or the VAE training CLI (``--kind hunyuan_vae``)
wrote: its ``state.pt`` holds the unsharded layout, whatever mesh or
processes trained it, and is read memory-mapped. ``--source ema`` (the
default) takes the EMA, or the trained parameters where the state has no
EMA, as the JAX script does; ``--source params`` the trained parameters.
The model is built from the config's geometry (its ``model``; for
``hunyuan_vae`` the config's ``model`` where that is the HunyuanVAE, as in
a VAE training config with ``--model.type hunyuan_vae``, else its ``ae``)
on the ``meta`` device and filled from that tree: a state that lacks any of
the model's weights (a LoRA state holds only its factors) raises, naming
them. The discriminator and the VAE loss's ``loss_logvar`` are left out.

The MMDiT is written through ``utils.ckpt.export_mmdit_state_dict`` in the
layout ``--layout`` names: ``published`` (the Open-Sora v2 checkpoints:
unfused q/k/v projections, "split" RoPE pairing), ``flux`` (fused ``qkv`` /
``linear1``, "interleaved" pairing, as original Flux files) or ``native``
(the model's own fusion, "split" pairing; the default). Every tensor is
written in fp32. The files load with ``from_pretrained`` in the inference
CLI and in a second finetune.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Dict, List, Optional

import torch

from opensora_torch.training.vae import LOGVAR

# --layout: (fused, RoPE pairing) of the written MMDiT
LAYOUTS = {"published": (False, "split"), "flux": (True, "interleaved"), "native": (None, "split")}


def read_state(ckpt_dir: str) -> dict:
    """The train state of a checkpoint directory, memory-mapped."""
    return torch.load(os.path.join(ckpt_dir, "state.pt"), map_location="cpu", mmap=True, weights_only=True)


def source_tree(state: dict, source: str) -> Dict[str, torch.Tensor]:
    """The tree ``source`` names: the EMA (the trained parameters where the
    state has none) or the trained parameters."""
    if source == "ema" and state.get("ema") is not None:
        return state["ema"]
    return state["params"]


def fill(module: torch.nn.Module, tree: Dict[str, torch.Tensor], skip=()) -> torch.nn.Module:
    """``module`` (on the meta device) holding ``tree``'s tensors by name,
    in fp32; raises naming the module's weights that ``tree`` lacks, or the
    tree's tensors that the module does not hold."""
    own = module.state_dict()
    missing = [n for n in own if n not in tree]
    if missing:
        raise ValueError(f"the state lacks {len(missing)} of the model's {len(own)} weights: {missing[:8]}"
                         f"{' ...' if len(missing) > 8 else ''}")
    extra = [n for n in tree if n not in own and n not in skip]
    if extra:
        raise ValueError(f"the state holds {len(extra)} tensors the model does not: {extra[:8]}")
    module.load_state_dict({n: tree[n].float() for n in own}, strict=True, assign=True)
    return module


def build_meta(model_cfg: dict):
    """The float model of ``model_cfg`` on the meta device, in fp32."""
    import opensora_torch.models.hunyuan_vae.model  # noqa: F401  (registers "hunyuan_vae")
    import opensora_torch.models.mmdit.model  # noqa: F401  (registers "flux")
    from opensora_torch.registry import MODELS, build_module

    return build_module(dict(model_cfg, from_pretrained=None, quantized=False, param_dtype="fp32"), MODELS,
                        device="meta")


def export_state_dict(state: dict, cfg, kind: str = "mmdit", source: str = "ema",
                      layout: str = "native") -> Dict[str, torch.Tensor]:
    """The published state dict (fp32) of a train state (see the module
    docstring)."""
    from opensora_torch.utils.ckpt import export_mmdit_state_dict

    tree = source_tree(state, source)
    if kind == "mmdit":
        model = fill(build_meta(cfg.model), tree)
        fused, rope = LAYOUTS[layout]
        sd = export_mmdit_state_dict(model, fused=fused, rope_convention=rope)
    elif kind == "hunyuan_vae":
        model_cfg = cfg.model if cfg.model.get("type") == "hunyuan_vae" else cfg.ae
        sd = fill(build_meta(model_cfg), tree, skip=(LOGVAR,)).state_dict()
    else:
        raise ValueError(f"unknown kind {kind!r}")
    return {k: v.float().contiguous() for k, v in sd.items()}


def main(argv: Optional[List[str]] = None) -> dict:
    """Write the file; returns the tensor count, bytes and the step."""
    from opensora_torch.utils.config import parse_configs
    from opensora_torch.utils.safetensors_io import save_file

    argv = list(sys.argv[1:] if argv is None else argv)
    p = argparse.ArgumentParser(prog="python -m opensora_torch.cnv.export", description=__doc__.split("\n")[0])
    p.add_argument("ckpt_dir", help="epoch*-global_step* directory written by a training CLI")
    p.add_argument("out", help="output .safetensors path")
    p.add_argument("--config", required=True, help="the training config (model geometry)")
    p.add_argument("--source", choices=("ema", "params"), default="ema")
    p.add_argument("--kind", choices=("mmdit", "hunyuan_vae"), default="mmdit")
    p.add_argument("--layout", choices=tuple(LAYOUTS), default="native")
    args, overrides = p.parse_known_args(argv)
    cfg = parse_configs([args.config, *overrides])
    state = read_state(args.ckpt_dir)
    running = {}
    rs = os.path.join(args.ckpt_dir, "running_states.json")
    if os.path.exists(rs):
        with open(rs) as f:
            running = json.load(f)
    print(f"loaded {args.ckpt_dir} (global_step {running.get('global_step', state['step'])}), source={args.source}"
          f"{'' if args.source != 'ema' or state.get('ema') is not None else ' (no EMA in the state: params)'}")
    sd = export_state_dict(state, cfg, args.kind, args.source, args.layout)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    nbytes = save_file(sd, args.out)
    print(f"wrote {len(sd)} tensors to {args.out}")
    return dict(n_tensors=len(sd), bytes=nbytes, step=state["step"])


if __name__ == "__main__":
    main()
