"""Carry JAX parameter trees (nested dicts of numpy arrays, as the JAX
package's flax modules hold them) into the port's state dicts.

Flax Dense kernels are (in, out): the torch weight is the transpose. Flax
convolution kernels are (kT, kH, kW, in, out): torch wants (out, in, kT, kH,
kW). The MMDiT's ``double_blocks``/``single_blocks`` subtrees carry a
leading layer axis (``nn.scan`` stacking) that is unstacked into
``{name}.{i}``. The port keeps its own copy of this logic; the results load
with ``load_state_dict(strict=True)``.
"""

from __future__ import annotations

from typing import Any, Dict, Iterator, Tuple

import numpy as np
import torch

Tree = Dict[str, Any]


def _flatten(tree: Tree, prefix: Tuple[str, ...] = ()) -> Iterator[Tuple[Tuple[str, ...], np.ndarray]]:
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flatten(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


def _torch_weight(val: np.ndarray) -> np.ndarray:
    """Flax kernel -> torch weight layout (torch's threaded copy makes the
    transpose of a large kernel several times faster than numpy's)."""
    perm = {5: (4, 3, 0, 1, 2), 4: (3, 2, 0, 1)}.get(val.ndim, (1, 0))
    return torch.from_numpy(np.asarray(val)).permute(perm).contiguous().numpy()


def mmdit_state_dict(params: Tree) -> Dict[str, np.ndarray]:
    """MMDiT flax params -> ``MMDiTModel`` state dict (upstream Open-Sora v2
    names). The fused/unfused qkv layout and the RoPE pairing stay as they
    are in memory, so the port's config must name the same ones. A quantized
    tree (``quantize_params``) carries ``kernel_q`` (in, out) int8 to
    ``weight_q`` (out, in) and ``kernel_scale`` to ``weight_scale``."""
    out: Dict[str, np.ndarray] = {}

    def put(path: Tuple[str, ...], val: np.ndarray) -> None:
        *mods, leaf = path
        if mods[:2] == ["final_layer", "adaLN_modulation"]:
            mods.append("1")  # nn.Sequential(SiLU, Linear)
        if leaf in ("kernel", "kernel_q"):
            out[".".join(mods) + (".weight" if leaf == "kernel" else ".weight_q")] = _torch_weight(val)
        elif leaf == "kernel_scale":
            out[".".join(mods) + ".weight_scale"] = val
        else:  # bias, RMSNorm scale
            out[".".join(mods + [leaf])] = val

    for path, val in _flatten(params):
        if path[0] in ("double_blocks", "single_blocks"):
            for i in range(val.shape[0]):
                put((path[0], str(i)) + path[1:], val[i])
        else:
            put(path, val)
    return out


def _vae_segment(seg: str) -> str:
    """'resnets_0' -> 'resnets.0', 'to_out' -> 'to_out.0'."""
    if seg == "to_out":
        return "to_out.0"
    head, _, tail = seg.rpartition("_")
    return f"{head}.{tail}" if head and tail.isdigit() else seg


def _conv_net_state_dict(params: Tree, segment) -> Dict[str, np.ndarray]:
    """Flax params of a conv net -> state dict: module names mapped segment
    by segment, kernels to torch weights, norm scales to weights."""
    out: Dict[str, np.ndarray] = {}
    for path, val in _flatten(params):
        *segs, leaf = path
        name = ".".join(segment(s) for s in segs)
        if leaf == "kernel":
            out[f"{name}.weight"] = _torch_weight(val)
        else:
            out[f"{name}.{'weight' if leaf == 'scale' else leaf}"] = val
    return out


def hunyuan_vae_state_dict(params: Tree) -> Dict[str, np.ndarray]:
    """HunyuanVAE flax params -> ``AutoencoderKLCausal3D`` state dict
    (encoder and decoder)."""
    return _conv_net_state_dict(params, _vae_segment)


def _ae2d_segment(seg: str) -> str:
    """'down_0_block_1' -> 'down.0.block.1', 'up_2_upsample' ->
    'up.2.upsample.conv', 'mid_attn_1' -> 'mid.attn_1'."""
    parts = seg.split("_")
    if parts[0] in ("down", "up") and len(parts) > 2:
        tail = ".".join(parts[2:])
        return f"{parts[0]}.{parts[1]}.{tail}" + (".conv" if tail in ("downsample", "upsample") else "")
    if parts[0] == "mid":
        return f"mid.{'_'.join(parts[1:])}"
    return seg


def autoencoder_2d_state_dict(params: Tree) -> Dict[str, np.ndarray]:
    """Flux 2D AE flax params (``encoder``/``decoder`` with ``down_{i}_block_{j}``,
    ``mid_attn_1``, ``up_{i}_upsample``, ...) -> ``AutoEncoder2D`` state dict
    (upstream Flux names)."""
    return _conv_net_state_dict(params, _ae2d_segment)


def discriminator_state_dict(params: Tree) -> Dict[str, np.ndarray]:
    """NLayerDiscriminator3D flax params (``conv_{i}``, ``conv_out``,
    ``norm_{i}``) -> the port's ``convs.{i}`` (``conv_out`` last) and
    ``norms.{i - 1}``."""
    n_convs = sum(k.startswith("conv_") and k != "conv_out" for k in params)
    out: Dict[str, np.ndarray] = {}
    for path, val in _flatten(params):
        mod, leaf = path
        kind, idx = mod.rsplit("_", 1)
        name = f"convs.{n_convs if idx == 'out' else idx}" if kind == "conv" else f"norms.{int(idx) - 1}"
        if leaf == "kernel":
            out[f"{name}.weight"] = _torch_weight(val)
        else:
            out[f"{name}.{'weight' if leaf == 'scale' else leaf}"] = val
    return out


def lpips_state_dict(params: Tree) -> Dict[str, np.ndarray]:
    """LPIPS flax params (``vgg/conv_{i}``, ``lin_{i}``) -> the port's
    torchvision / LPIPS names (``vgg.features.{idx}``, ``lin{i}.model.1``)."""
    from opensora_torch.models.vae2d.lpips import VGG_CONV_INDICES

    out: Dict[str, np.ndarray] = {}
    for path, val in _flatten(params):
        *mods, leaf = path
        if mods[0] == "vgg":
            name = f"vgg.features.{VGG_CONV_INDICES[int(mods[1].split('_')[1])]}"
        else:
            name = f"lin{mods[0].split('_')[1]}.model.1"
        out[f"{name}.{'weight' if leaf == 'kernel' else leaf}"] = _torch_weight(val) if leaf == "kernel" else val
    return out


def dc_ae_module_state_dict(params: Tree, prefix: str = "") -> Dict[str, np.ndarray]:
    """The flax params of one DC-AE module (a ``ConvLayer``, ``ResBlock``,
    ``LiteMLA``, ``EfficientViTBlock``, ...) -> the port module's state dict,
    names under ``prefix``: ``aggreg_{i}_{j}`` -> ``aggreg.{i}.{j}``, the
    EfficientViT halves gain upstream's ``.main``, kernel -> weight, norm
    scale -> weight."""
    out: Dict[str, np.ndarray] = {}
    for path, val in _flatten(params):
        *segs, leaf = path
        names = [prefix] if prefix else []
        for seg in segs:
            if seg.startswith("aggreg_"):
                names += seg.split("_")
            elif seg in ("context_module", "local_module"):
                names += [seg, "main"]
            else:
                names.append(seg)
        names.append("weight" if leaf in ("kernel", "scale") else leaf)
        out[".".join(names)] = _torch_weight(val) if leaf == "kernel" else val
    return out


def dc_ae_state_dict(params: Tree) -> Dict[str, np.ndarray]:
    """Video DC-AE flax params -> ``DCAE`` state dict (upstream's names: the
    blocks of a stage, then its downsample, in ``encoder.stages.{s}.op_list``;
    the upsample, then the blocks, in ``decoder.stages.{s}.op_list``)."""
    out: Dict[str, np.ndarray] = {}
    for side in ("encoder", "decoder"):
        tree = params[side]
        upsampled = {int(k.split("_")[1]) for k in tree if k.endswith("_upsample")}
        blocks = {}
        for k in tree:
            if "_block_" in k:
                sid = int(k.split("_")[1])
                blocks[sid] = blocks.get(sid, 0) + 1
        for top, sub in tree.items():
            if top == "project_in":
                prefix = f"{side}.project_in" + (".main" if side == "decoder" else "")
            elif top == "project_out":
                prefix = f"{side}.project_out" + (".main" if side == "encoder" else "") + ".op_list.2"
            elif top == "out_norm":
                prefix = f"{side}.project_out" + (".main" if side == "encoder" else "") + ".op_list.0"
            else:
                _, sid, kind, *rest = top.split("_")
                sid = int(sid)
                if kind == "block":
                    idx = int(rest[0]) + (1 if sid in upsampled else 0)
                elif kind == "downsample":
                    idx = blocks.get(sid, 0)
                else:  # upsample
                    idx = 0
                prefix = f"{side}.stages.{sid}.op_list.{idx}" + ("" if kind == "block" else ".main")
            out.update(dc_ae_module_state_dict(sub, prefix))
    return out


def lora_state_dict(lora: Tree) -> Dict[str, np.ndarray]:
    """The JAX package's LoRA factor tree (``training/lora.py``: in place of
    each target ``kernel`` leaf ``{"lora_a": (..., in, r), "lora_b": (...,
    r, out)}``, a leading
    layer axis under the block stacks) -> the port's ``lora_A`` (r, in) and
    ``lora_B`` (out, r) state-dict entries, so that W + s (A @ B) in flax
    is W + s (lora_B @ lora_A) on the torch weight (out, in)."""
    out: Dict[str, np.ndarray] = {}
    names = {"lora_a": "lora_A", "lora_b": "lora_B"}

    def put(mods: Tuple[str, ...], leaf: str, val: np.ndarray) -> None:
        out[".".join(mods + (names[leaf],))] = np.ascontiguousarray(np.swapaxes(val, -1, -2))

    for path, val in _flatten(lora):
        *mods, kernel, leaf = path
        assert kernel == "kernel", path
        if mods[0] in ("double_blocks", "single_blocks"):
            for i in range(val.shape[0]):
                put((mods[0], str(i), *mods[1:]), leaf, val[i])
        else:
            put(tuple(mods), leaf, val)
    return out


def t5_state_dict(params: Tree) -> Dict[str, np.ndarray]:
    """T5Encoder flax params -> port ``T5Encoder`` (HF T5EncoderModel names)."""
    out = {"shared.weight": np.asarray(params["shared"]["embedding"]),
           "encoder.final_layer_norm.weight": np.asarray(params["final_layer_norm"]["weight"])}
    i = 0
    while f"block_{i}" in params:
        blk = params[f"block_{i}"]
        p = f"encoder.block.{i}.layer"
        out[f"{p}.0.layer_norm.weight"] = np.asarray(blk["ln_attn"]["weight"])
        for n in ("q", "k", "v", "o"):
            out[f"{p}.0.SelfAttention.{n}.weight"] = _torch_weight(np.asarray(blk["attention"][n]["kernel"]))
        if "relative_attention_bias" in blk["attention"]:
            out[f"{p}.0.SelfAttention.relative_attention_bias.weight"] = np.asarray(
                blk["attention"]["relative_attention_bias"])
        out[f"{p}.1.layer_norm.weight"] = np.asarray(blk["ln_ff"]["weight"])
        for n in ("wi_0", "wi_1", "wo"):
            out[f"{p}.1.DenseReluDense.{n}.weight"] = _torch_weight(np.asarray(blk[n]["kernel"]))
        i += 1
    return out


def _ln(node: Tree) -> Dict[str, np.ndarray]:
    return {"weight": np.asarray(node["scale"]), "bias": np.asarray(node["bias"])}


def _clip_encoder_state_dict(params: Tree, pre: str) -> Dict[str, np.ndarray]:
    """The ``layers_{i}`` of a flax CLIP tower -> ``{pre}encoder.layers.{i}``."""

    def lin(node):
        return {"weight": _torch_weight(np.asarray(node["kernel"])), "bias": np.asarray(node["bias"])}

    out = {}
    i = 0
    while f"layers_{i}" in params:
        layer = params[f"layers_{i}"]
        parts = {"layer_norm1": _ln(layer["layer_norm1"]), "layer_norm2": _ln(layer["layer_norm2"]),
                 "mlp.fc1": lin(layer["fc1"]), "mlp.fc2": lin(layer["fc2"])}
        for n in ("q_proj", "k_proj", "v_proj", "out_proj"):
            parts[f"self_attn.{n}"] = lin(layer[n])
        for mod, tensors in parts.items():
            out.update({f"{pre}encoder.layers.{i}.{mod}.{k}": v for k, v in tensors.items()})
        i += 1
    return out


def clip_text_state_dict(params: Tree) -> Dict[str, np.ndarray]:
    """CLIPTextModel flax params -> port ``CLIPTextModel`` (HF names)."""
    pre = "text_model."
    out = {
        pre + "embeddings.token_embedding.weight": np.asarray(params["token_embedding"]["embedding"]),
        pre + "embeddings.position_embedding.weight": np.asarray(params["position_embedding"]),
    }
    out.update({f"{pre}final_layer_norm.{k}": v for k, v in _ln(params["final_layer_norm"]).items()})
    out.update(_clip_encoder_state_dict(params, pre))
    return out


def clip_vision_state_dict(params: Tree) -> Dict[str, np.ndarray]:
    """CLIPVisionModel flax params -> port ``CLIPVisionModel`` (HF names)."""
    pre = "vision_model."
    out = {
        pre + "embeddings.class_embedding": np.asarray(params["class_embedding"]),
        pre + "embeddings.patch_embedding.weight": _torch_weight(np.asarray(params["patch_embedding"]["kernel"])),
        pre + "embeddings.position_embedding.weight": np.asarray(params["position_embedding"]),
    }
    for name in ("pre_layrnorm", "post_layernorm"):
        out.update({f"{pre}{name}.{k}": v for k, v in _ln(params[name]).items()})
    out.update(_clip_encoder_state_dict(params, pre))
    return out


def clip_model_state_dict(text_params: Tree, vision_params: Tree, visual_projection: np.ndarray,
                          text_projection: np.ndarray) -> Dict[str, np.ndarray]:
    """Both towers' flax params and the projections, (in, out) as the JAX
    ``CLIPScorer`` holds them, -> port ``CLIPModel`` (HF CLIPModel names)."""
    out = {**clip_text_state_dict(text_params), **clip_vision_state_dict(vision_params)}
    out["visual_projection.weight"] = np.ascontiguousarray(np.asarray(visual_projection).T)
    out["text_projection.weight"] = np.ascontiguousarray(np.asarray(text_projection).T)
    return out


def load_numpy_state_dict(module: torch.nn.Module, sd: Dict[str, np.ndarray]) -> None:
    """``load_state_dict(strict=True)`` of numpy arrays, float arrays cast to
    each parameter's dtype; integer arrays (int8 weights) keep theirs. A
    module built on the ``meta`` device takes the arrays as its CPU
    parameters (no initialization pass)."""
    own = module.state_dict()
    meta = any(v.is_meta for v in own.values())
    tensors = {}
    for k, v in sd.items():
        x = torch.from_numpy(np.require(v, requirements=["C", "W"]))
        tensors[k] = x.to(own[k].dtype) if k in own and x.is_floating_point() else x
    module.load_state_dict(tensors, strict=True, assign=meta)
