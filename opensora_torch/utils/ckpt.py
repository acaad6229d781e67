"""Checkpoints (counterpart of opensora_tpu/utils/ckpt.py): published
weights in and out, and train-state saves.

Published weights: :func:`load_checkpoint` fills a module, built on the
``meta`` device (no random-init pass), from a torch checkpoint
(:class:`StateDictReader`: a ``.safetensors`` file; a directory with a
``*.index.json`` of safetensors or ``.bin`` shards, or else every
``*.safetensors`` (or ``.bin``/``.pt``) file in it; a ``.pt``/``.pth``/
``.bin`` file with or without a ``state_dict`` wrapper). Each tensor goes to
the module's device as it is read (to a card through two pinned 64 MiB
chunks in turn, reading one while the other's copy runs) and is cast there
to its parameter's dtype: the host holds one tensor or two chunks, never
the file. ``kind``:

- ``"mmdit"``: either upstream layout of the blocks (fused ``qkv`` /
  ``linear1``, or the published Open-Sora v2 checkpoints' ``q_proj`` /
  ``k_proj`` / ``v_proj`` / ``v_mlp``, told apart by the keys) into the
  model's ``fused_qkv`` layout; q/k rows permuted when the checkpoint's RoPE
  pairing (``ckpt_rope_convention``; flux1-dev: "interleaved") is not the
  model's; ``guidance_in`` / ``cond_in`` taken only where the model has
  them; the block linears of a ``quantized`` model quantized as they land
  (the JAX package quantizes a loaded checkpoint,
  opensora_tpu/utils/ckpt.py:553-559). :func:`export_mmdit_state_dict` is
  the inverse.
- ``"hunyuan_vae"``, ``"dc_ae"``, ``"vae2d"``: by name (the modules carry
  the upstream names, the HunyuanVAE those of the JAX package's
  ``export_hunyuan_vae_state_dict``).
- ``"t5"``, ``"clip"``: Hugging Face ``T5EncoderModel`` / ``CLIPTextModel``
  names; a ``T5ForConditionalGeneration`` or ``CLIPModel`` file's other
  half is skipped (``KNOWN_EXTRAS``).
- ``"clip_model"``: a whole HF ``CLIPModel`` (both towers and both
  projections; ``logit_scale`` skipped), the evaluation's scorer;
  :func:`clip_model_configs` reads its configuration.

A missing, unexpected or mis-shaped key raises ``ValueError`` naming it.

Train-state checkpoints (``CheckpointIO``, opensora_tpu/utils/ckpt.py:569-648)
are written with ``torch.save``; layout per save:
``<exp_dir>/epoch{e}-global_step{s}/``
  state.pt              the train state's ``state_dict()`` (trained params,
                        optimizer, EMA, step)
  running_states.json   epoch / step / global_step
  sampler_state.json    the sampler's resume point, when given
The JAX package's orbax layout is not read or written here.
"""

from __future__ import annotations

import json
import logging
import os
import re
import shutil
import time
from typing import Callable, Dict, Iterator, List, Optional, Tuple

import torch
import torch.nn as nn

from opensora_torch.ops.quant import quantize_weight
from opensora_torch.ops.rope import permute_qk_weight
from opensora_torch.utils.safetensors_io import INDEX_SUFFIX, SafetensorsFile, Staging

_CKPT_DIR = re.compile(r"epoch(\d+)-global_step(\d+)")
KINDS = ("mmdit", "hunyuan_vae", "dc_ae", "vae2d", "t5", "clip", "clip_model")
# keys of a kind's published files that its module does not hold
KNOWN_EXTRAS = {
    "t5": (r"decoder\..*", r"lm_head\.weight", r"encoder\.embed_tokens\.weight"),
    "clip": (r"vision_model\..*", r"visual_projection\..*", r"text_projection\..*", r"logit_scale",
             r".*position_ids"),
    "clip_model": (r"logit_scale", r".*position_ids"),
}
# the attention input projections of the MMDiT blocks, either layout
_MMDIT_QKV = re.compile(r"(double_blocks\.\d+\.(?:img|txt)_attn|single_blocks\.\d+)"
                        r"\.(qkv|linear1|q_proj|k_proj|v_proj|v_mlp)\.(weight|bias)")


# ----------------------------------------------------------------------
# published weights
# ----------------------------------------------------------------------


class _TorchFile:
    """A ``torch.save`` state dict (``.pt``/``.pth``/``.bin``), memory-mapped,
    with or without a ``state_dict`` wrapper, behind SafetensorsFile's
    interface."""

    def __init__(self, path: str):
        self.path = path
        sd = torch.load(path, map_location="cpu", mmap=True, weights_only=True)
        if isinstance(sd, dict) and isinstance(sd.get("state_dict"), dict):
            sd = sd["state_dict"]
        self._sd = {k: v for k, v in sd.items() if isinstance(v, torch.Tensor)}

    def keys(self) -> Iterator[str]:
        return iter(self._sd)

    def get(self, name: str) -> torch.Tensor:
        return self._sd[name]

    def nbytes(self, name: str) -> int:
        t = self._sd[name]
        return t.numel() * t.element_size()

    def close(self) -> None:
        self._sd = {}


def checkpoint_files(path: str) -> List[str]:
    """The files of the checkpoint at ``path`` (see :class:`StateDictReader`)."""
    if not os.path.isdir(path):
        if not os.path.exists(path):
            raise FileNotFoundError(f"no checkpoint at {path}")
        return [path]
    names = sorted(os.listdir(path))
    indexes = sorted((n for n in names if n.endswith(".index.json")), key=lambda n: not n.endswith(INDEX_SUFFIX))
    if indexes:
        with open(os.path.join(path, indexes[0])) as f:
            shards = sorted(set(json.load(f)["weight_map"].values()))
        return [os.path.join(path, n) for n in shards]
    for suffixes in ((".safetensors",), (".bin", ".pt", ".pth")):
        found = [os.path.join(path, n) for n in names if n.endswith(suffixes)]
        if found:
            return found
    raise FileNotFoundError(f"no checkpoint files in {path}")


class StateDictReader:
    """The tensors of the checkpoint at ``path`` by name, read one at a
    time: ``get`` returns a CPU tensor (read from a safetensors file into
    memory of its own; a view of a ``.pt`` file's mapping), ``to_device``
    the tensor on a device. ``path`` is a ``.safetensors`` file; a
    ``.pt``/``.pth``/``.bin`` file (``torch.load`` memory-mapped; a
    ``state_dict`` entry is unwrapped); or a directory: the shards named by
    its ``*.index.json`` (safetensors first), else every ``*.safetensors``
    in it, else every ``.bin``/``.pt``/``.pth``."""

    def __init__(self, path: str):
        self.path = path
        self._staging: Optional[Staging] = None
        self._files = []
        self._where: Dict[str, object] = {}
        for fn in checkpoint_files(path):
            src = SafetensorsFile(fn) if fn.endswith(".safetensors") else _TorchFile(fn)
            self._files.append(src)
            for k in src.keys():
                if k in self._where:
                    raise ValueError(f"{path}: {k} is in two files")
                self._where[k] = src

    def __enter__(self) -> "StateDictReader":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def close(self) -> None:
        for f in self._files:
            f.close()

    def keys(self) -> List[str]:
        return list(self._where)

    def __contains__(self, name: str) -> bool:
        return name in self._where

    @property
    def nbytes(self) -> int:
        return sum(f.nbytes(k) for k, f in self._where.items())

    def get(self, name: str) -> torch.Tensor:
        return self._where[name].get(name)

    def shape(self, name: str) -> Tuple[int, ...]:
        src = self._where[name]
        return tuple(src.info(name)[1] if isinstance(src, SafetensorsFile) else src.get(name).shape)

    def to_device(self, name: str, device: torch.device) -> torch.Tensor:
        """The tensor ``name`` on ``device``: from a safetensors file to a
        card through two pinned chunks in turn (``Staging``), else read on
        the CPU and moved."""
        src = self._where[name]
        if device.type == "cuda" and isinstance(src, SafetensorsFile):
            if self._staging is None or self._staging.device != device:
                self._staging = Staging(device)
            return self._staging.load(src, name)
        return src.get(name).to(device)


def load_torch_state_dict(path: str) -> Dict[str, torch.Tensor]:
    """Every tensor of the checkpoint at ``path`` on the CPU, in memory of
    its own (opensora_tpu/utils/ckpt.py:57-75)."""
    with StateDictReader(path) as reader:
        return {k: reader.get(k).clone() for k in reader.keys()}


def clip_model_configs(path: str):
    """(CLIPTextConfig, CLIPVisionConfig) of the HF ``CLIPModel`` checkpoint
    at ``path`` (``model.safetensors``, sharded safetensors or
    ``pytorch_model.bin``, or such a file): the head counts and the text
    ``eos_token_id`` from the ``config.json`` beside it, else 64-wide heads
    and eos = vocab - 1, as opensora_tpu/eval/clip_scorer.py:86-125 reads
    them; vocabulary, widths, depths, positions and image size from the
    weights' shapes. An eos id of 2 is HF's legacy value for CLIP, whose
    models pool at the largest id (their EOT, vocab - 1): read as such."""
    from opensora_torch.models.text.clip import CLIPTextConfig, CLIPVisionConfig

    cfg_json = os.path.join(path if os.path.isdir(path) else os.path.dirname(path), "config.json")
    hf = {}
    if os.path.exists(cfg_json):
        with open(cfg_json) as f:
            hf = json.load(f)
    with StateDictReader(path) as r:
        if "visual_projection.weight" not in r:
            raise FileNotFoundError(f"{path} is not a full CLIPModel checkpoint (visual_projection missing): "
                                    "the scorer needs both towers")

        def depth(tower: str) -> int:
            layer = re.compile(rf"{tower}\.encoder\.layers\.\d+\.self_attn\.q_proj\.weight")
            return sum(1 for k in r.keys() if layer.fullmatch(k))

        vocab, hidden_t = r.shape("text_model.embeddings.token_embedding.weight")
        hidden_v = r.shape("vision_model.embeddings.class_embedding")[0]
        n_pos, patch = (r.shape("vision_model.embeddings.position_embedding.weight")[0],
                        r.shape("vision_model.embeddings.patch_embedding.weight")[-1])
        heads_v = hf.get("vision_config", {}).get("num_attention_heads")
        heads_t = hf.get("text_config", {}).get("num_attention_heads")
        eos = hf.get("text_config", {}).get("eos_token_id")
        vision = CLIPVisionConfig(
            hidden_size=hidden_v, intermediate_size=r.shape("vision_model.encoder.layers.0.mlp.fc1.weight")[0],
            num_layers=depth("vision_model"), num_heads=heads_v or max(hidden_v // 64, 1),
            image_size=int(round((n_pos - 1) ** 0.5)) * patch, patch_size=patch,
            projection_dim=r.shape("visual_projection.weight")[0])
        text = CLIPTextConfig(
            vocab_size=vocab, hidden_size=hidden_t,
            intermediate_size=r.shape("text_model.encoder.layers.0.mlp.fc1.weight")[0],
            num_layers=depth("text_model"), num_heads=heads_t or max(hidden_t // 64, 1),
            max_position_embeddings=r.shape("text_model.embeddings.position_embedding.weight")[0],
            eos_token_id=vocab - 1 if eos in (None, 2) else eos)
    return text, vision


def _qk_permuter(src_rope: str, dst_rope: str, num_heads: int, head_dim: int) -> Callable:
    """The permutation of q/k projection rows (and biases) from the RoPE
    pairing a checkpoint was trained with to the model's ("split": pairs
    (i, i + D/2), the published Open-Sora v2 checkpoints; "interleaved":
    pairs (2i, 2i + 1), original Flux)."""
    if src_rope == dst_rope:
        return lambda w: w
    if {src_rope, dst_rope} != {"interleaved", "split"}:
        raise ValueError(f"unknown rope conversion {src_rope!r} -> {dst_rope!r}")
    inverse = src_rope == "split"
    return lambda w: permute_qk_weight(w, num_heads, head_dim, inverse=inverse)


def _mmdit_qkv(name: str):
    """(prefix, projection, leaf, single) of an attention input projection
    key, else None."""
    m = _MMDIT_QKV.fullmatch(name)
    return None if m is None else (*m.groups(), m.group(1).startswith("single_blocks"))


def _mmdit_producer(cfg, keys, fetch) -> Callable[[str], torch.Tensor]:
    """The model's tensor ``name`` from the checkpoint's (``fetch``), in the
    model's qkv layout and RoPE pairing."""
    h = cfg.hidden_size
    perm = _qk_permuter(cfg.ckpt_rope_convention, cfg.rope_convention, cfg.num_heads, h // cfg.num_heads)
    src_fused = any(k.endswith((".qkv.weight", ".linear1.weight")) for k in keys)

    def produce(name: str) -> torch.Tensor:
        parsed = _mmdit_qkv(name)
        if parsed is None:
            return fetch(name)
        prefix, proj, leaf, single = parsed
        if src_fused:
            w = fetch(f"{prefix}.{'linear1' if single else 'qkv'}.{leaf}")
            q, k, rest = w[:h], w[h:2 * h], w[2 * h:]
        else:
            q, k, rest = (fetch(f"{prefix}.{n}.{leaf}") for n in ("q_proj", "k_proj", "v_mlp" if single else "v_proj"))
        q, k = perm(q), perm(k)
        if proj in ("qkv", "linear1"):
            return torch.cat([q, k, rest])
        return {"q_proj": q, "k_proj": k}.get(proj, rest)

    return produce


def export_mmdit_state_dict(model: nn.Module, fused: Optional[bool] = None,
                            rope_convention: str = "split") -> Dict[str, torch.Tensor]:
    """A float MMDiT's state dict in an upstream layout: ``fused`` (None =
    the model's) and the RoPE pairing ``rope_convention`` (the inverse of
    what :func:`load_checkpoint` does; opensora_tpu/utils/ckpt.py:278)."""
    cfg = model.config
    h = cfg.hidden_size
    fused = cfg.fused_qkv if fused is None else fused
    perm = _qk_permuter(cfg.rope_convention, rope_convention, cfg.num_heads, h // cfg.num_heads)
    sd = model.state_dict()
    out: Dict[str, torch.Tensor] = {}
    for name, t in sd.items():
        parsed = _mmdit_qkv(name)
        if parsed is None:
            out[name] = t
            continue
        prefix, proj, leaf, single = parsed
        if proj not in ("qkv", "linear1", "q_proj"):
            continue  # each projection group is written at its first key
        rest_name = "v_mlp" if single else "v_proj"
        if cfg.fused_qkv:
            q, k, rest = t[:h], t[h:2 * h], t[2 * h:]
        else:
            q, k, rest = t, sd[f"{prefix}.k_proj.{leaf}"], sd[f"{prefix}.{rest_name}.{leaf}"]
        q, k = perm(q), perm(k)
        if fused:
            out[f"{prefix}.{'linear1' if single else 'qkv'}.{leaf}"] = torch.cat([q, k, rest])
        else:
            out.update({f"{prefix}.q_proj.{leaf}": q, f"{prefix}.k_proj.{leaf}": k,
                        f"{prefix}.{rest_name}.{leaf}": rest})
    return out


def load_checkpoint(module: nn.Module, path: str, kind: str = "mmdit", device=None) -> nn.Module:
    """Fill ``module`` (best built on the ``meta`` device) with the weights
    of the checkpoint at ``path`` (module docstring) on ``device`` (default
    the CPU) and return it. Loaded tensors are cast to each parameter's
    dtype; the int8 weights and scales of a quantized MMDiT's
    ``QuantLinear`` are computed from the checkpoint's float weight (upcast
    to fp32, as the JAX package's ``quantize_params`` does)."""
    if kind not in KINDS:
        raise ValueError(f"unknown checkpoint kind {kind!r}; expected one of {KINDS}")
    device = torch.device(device if device is not None else "cpu")
    own = module.state_dict()
    used, cache = set(), {}
    t0 = time.perf_counter()
    with StateDictReader(path) as reader:
        def fetch(name: str) -> torch.Tensor:
            if name not in cache:
                if name not in reader:
                    raise KeyError(name)
                cache[name] = reader.to_device(name, device)
                used.add(name)
                while len(cache) > 4:  # a fused projection is read once for its three unfused targets
                    cache.pop(next(iter(cache)))
            return cache[name]

        extras = KNOWN_EXTRAS.get(kind, ())
        produce = fetch
        if kind == "mmdit":
            produce = _mmdit_producer(module.config, reader.keys(), fetch)
            extras = tuple(rf"{m}\..*" for m in ("guidance_in", "cond_in") if not hasattr(module, m))
        elif kind == "t5" and "shared.weight" not in reader:
            produce = lambda n: fetch("encoder.embed_tokens.weight" if n == "shared.weight" else n)  # noqa: E731

        out, quantized = {}, {}
        for name, ref in own.items():
            try:
                if name.endswith((".weight_q", ".weight_scale")):
                    base = name.rsplit(".", 1)[0]
                    if base not in quantized:
                        quantized = {base: quantize_weight(produce(base + ".weight"))}
                    t = quantized[base][0 if name.endswith("_q") else 1]
                else:
                    t = produce(name)
            except KeyError as e:
                raise ValueError(f"{path}: the model's {name} is missing from the checkpoint "
                                 f"(looked for {e.args[0]})") from None
            if tuple(t.shape) != tuple(ref.shape):
                raise ValueError(f"{path}: {name} is {tuple(t.shape)} in the checkpoint, {tuple(ref.shape)} in "
                                 "the model")
            if t.is_floating_point() != ref.is_floating_point():
                raise ValueError(f"{path}: {name} is {t.dtype} in the checkpoint, {ref.dtype} in the model")
            out[name] = t.to(ref.dtype)
        unexpected = [k for k in reader.keys()
                      if k not in used and not any(re.fullmatch(p, k) for p in extras)]
        if unexpected:
            raise ValueError(f"{path}: {len(unexpected)} unexpected keys for a {kind} model: "
                             f"{unexpected[:8]}{' ...' if len(unexpected) > 8 else ''}")
        nbytes = reader.nbytes
    module.load_state_dict(out, strict=True, assign=any(v.is_meta for v in own.values()))
    logging.getLogger(__name__).info("loaded %s weights from %s (%.2f GB) in %.1f s", kind, path,
                                     nbytes / 1e9, time.perf_counter() - t0)
    return module


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


def init_ae(model_cfg: dict, device=None, seed: int = 42, **overrides) -> nn.Module:
    """The autoencoder of ``model_cfg`` (``hunyuan_vae``, ``dc_ae`` or
    ``autoencoder_2d``) on ``device``: loaded from ``from_pretrained`` where
    it is set (its builder loads it), else with random weights drawn from
    ``seed``; ``overrides`` update the config (the JAX package's
    ``init_ae_variables``, opensora_tpu/utils/ckpt.py:453-462)."""
    import opensora_torch.models.dc_ae.model  # noqa: F401  (registers "dc_ae")
    import opensora_torch.models.hunyuan_vae.model  # noqa: F401  (registers "hunyuan_vae")
    import opensora_torch.models.vae2d.autoencoder_2d  # noqa: F401  (registers "autoencoder_2d")
    from opensora_torch.registry import MODELS, build_module

    device = torch.device(device if device is not None else "cuda")
    with torch.random.fork_rng(devices=[device] if device.type == "cuda" else []):
        torch.manual_seed(seed)
        return build_module(dict(model_cfg, **overrides), MODELS, device=device)
