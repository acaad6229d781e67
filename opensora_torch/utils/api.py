"""Model assembly and the end-to-end generation API (counterpart of
opensora_tpu/utils/api.py).

``prepare_models`` builds the MMDiT, the VAE and the two text encoders on
one device, and the t2i2v image stage (``img_flux``, ``img_flux_ae``) where
the config has one: each from the checkpoint its ``from_pretrained`` names,
else with random weights from a seed (a ``model.quantized`` config
quantizes the MMDiT's blocks as they load, or draws the float MMDiT and
quantizes each block as it is built). ``prepare_api``
returns ``api_fn``, which draws the latent noise, encodes the references
of an i2v / v2v cond type and hands both to ``generate``: text encode ->
denoise (I2V with the references' masks, or distilled) -> unpack -> the
references' latent frames put back -> AE decode -> the non-causal pad
trimmed. ``offload_to_host`` / ``load_to_device`` park a model in host
memory between its uses and bring it back.
"""

from __future__ import annotations

import itertools
import random as pyrandom
import time
from typing import Optional

import torch

import opensora_torch.models.dc_ae.model  # noqa: F401  (registers "dc_ae")
import opensora_torch.models.hunyuan_vae.model  # noqa: F401  (registers "hunyuan_vae")
import opensora_torch.models.mmdit.model  # noqa: F401  (registers "flux")
import opensora_torch.models.text.conditioner  # noqa: F401  (registers "text_embedder")
import opensora_torch.models.vae2d.autoencoder_2d  # noqa: F401  (registers "autoencoder_2d")
from opensora_torch.models.mmdit.layers import DoubleStreamBlock, SingleStreamBlock
from opensora_torch.ops.quant import quant_mode, quantize_as_built
from opensora_torch.parallel.context import set_mesh
from opensora_torch.parallel.mesh import SP_AXIS, TP_AXIS
from opensora_torch.parallel.sharding import shard_params
from opensora_torch.registry import MODELS, build_module
from opensora_torch.utils import sampling as S
from opensora_torch.utils.config import DEFAULT_AE_SPATIAL_COMPRESSION
from opensora_torch.utils.inference import collect_references_batch, prepare_inference_condition
from opensora_torch.utils.misc import resolve_device, torch_dtype


def prepare_models(cfg, device=None, seed: int = 0):
    """Build (model, ae, t5, clip, optional) from the config's dicts on
    ``device`` (default cuda), in eval mode without gradients; ``optional``
    holds ``img_flux`` and ``img_flux_ae`` where the config has them (the
    t2i2v image stage), else it is empty. A model whose dict sets
    ``from_pretrained`` is loaded from that checkpoint (a local directory or
    file for T5 / CLIP); the others are random, drawn from ``seed`` in the
    order model, ae, t5, clip (a loaded model draws nothing, so the draws
    of a config without a checkpoint are as they always were). The text
    encoders take the config's top-level ``dtype``. With ``model.quantized``
    set, a loaded MMDiT is quantized as its weights land (the JAX package's
    ``load_model_bundle``, opensora_tpu/utils/ckpt.py:553-559); a drawn one
    in its float dtype with the linears of each block swapped for their
    int8 twins as soon as the block is built (``quantize_as_built``): a
    QuantLinear built directly holds zeros, which would serve nothing."""
    device = resolve_device(device)
    with torch.random.fork_rng(devices=[device] if device.type == "cuda" else []):
        torch.manual_seed(seed)
        quantized = quant_mode(cfg.model.get("quantized", False))
        if cfg.model.get("from_pretrained"):
            model = build_module(dict(cfg.model), MODELS, device=device)
        else:
            with quantize_as_built(quantized, (DoubleStreamBlock, SingleStreamBlock)):
                model = build_module(dict(cfg.model, quantized=False), MODELS, device=device)
            if quantized:
                model.config.quantized = quantized
        ae, t5, clip = build_encoders(cfg, device)
        optional = prepare_optional_models(cfg, device)
    model.eval().requires_grad_(False)
    return model, ae, t5, clip, optional


def build_encoders(cfg, device):
    """(ae, t5, clip) of the config on ``device``, in eval mode without
    gradients: each loaded from its ``from_pretrained``, else drawn from the
    current random state; the text encoders in the config's top-level
    ``dtype``."""
    text_dtype = torch_dtype(cfg.get("dtype", "bf16"))
    ae = build_module(dict(cfg.ae), MODELS, device=device)
    t5 = build_module(dict(cfg.t5), MODELS, device=device, dtype=text_dtype)
    clip = build_module(dict(cfg.clip), MODELS, device=device, dtype=text_dtype)
    for m in (ae, t5, clip):
        m.eval().requires_grad_(False)
    return ae, t5, clip


def prepare_optional_models(cfg, device) -> dict:
    """The t2i2v image stage, ``{"img_flux": ..., "img_flux_ae": ...}``
    where the config has it (else {}), each loaded from its
    ``from_pretrained`` or drawn from the current random state, in eval mode
    without gradients."""
    if cfg.get("img_flux") is None:
        return {}
    optional = {name: build_module(dict(cfg[name]), MODELS, device=device) for name in ("img_flux", "img_flux_ae")}
    for m in optional.values():
        m.eval().requires_grad_(False)
    return optional


def _tensors(module: torch.nn.Module):
    return itertools.chain(module.parameters(), module.buffers())


def host_available_bytes() -> Optional[int]:
    """The host's available memory (``MemAvailable`` of /proc/meminfo) in
    bytes; None where the file does not say."""
    try:
        with open("/proc/meminfo") as f:
            for line in f:
                if line.startswith("MemAvailable:"):
                    return int(line.split()[1]) * 1024
    except OSError:
        pass
    return None


def offload_to_host(module: torch.nn.Module) -> int:
    """Park ``module``'s parameters and buffers in host memory and return
    the bytes parked (counterpart of opensora_tpu/utils/api.py:43-53, the
    t2i2v swap of upstream's scripts/diffusion/inference.py:161-214). Each
    tensor is copied into a host tensor of its own and the module's tensor
    points at the copy, so its device memory is freed once nothing else
    holds it. The copies are pageable: PyTorch's pinned-memory allocator
    rounds each block up to a power of two, which would come near to
    doubling the host memory a 12 B model's 24 GB take."""
    parked = 0
    for t in _tensors(module):
        t.data = t.data.to("cpu", copy=True)
        parked += t.numel() * t.element_size()
    return parked


def load_to_device(module: torch.nn.Module, device) -> int:
    """Bring a parked module's parameters and buffers to ``device`` (a copy
    each) and return the bytes moved (opensora_tpu/utils/api.py:56-60)."""
    device, moved = torch.device(device), 0
    for t in _tensors(module):
        t.data = t.data.to(device, copy=True)
        moved += t.numel() * t.element_size()
    _sync(device)
    return moved


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def replace_reference_frames(x: torch.Tensor, cond_type: str, references) -> torch.Tensor:
    """For i2v: the first sample's head and/or tail latent frame set to its
    encoded reference's before decoding (the JAX package and upstream set
    sample 0 only)."""
    if cond_type not in ("i2v_head", "i2v_tail", "i2v_loop") or references[0] is None:
        return x
    ref = references[0]
    x = x.clone()
    if cond_type in ("i2v_head", "i2v_loop"):
        x[0, :, :1] = ref[0].to(x.dtype)
    if cond_type in ("i2v_tail", "i2v_loop"):
        x[0, :, -1:] = ref[-1].to(x.dtype)
    return x


def trim_noncausal_pad(x: torch.Tensor, cond_type: str, pad_len: int) -> torch.Tensor:
    """Drop the ``pad_len`` frames a non-causal AE decodes beside an i2v
    cond type's fixed head and/or tail frame."""
    t = x.shape[2]
    start = pad_len if cond_type in ("i2v_head", "i2v_loop") else 0
    stop = t - pad_len if cond_type in ("i2v_tail", "i2v_loop") else t
    return x[:, :, start:stop]


def prepare_api(model, model_ae, model_t5, model_clip,
                spatial_compression: int = DEFAULT_AE_SPATIAL_COMPRESSION, mesh=None):
    """Returns ``api_fn(opt, cond_type, seed, text, ..., ref=paths)`` ->
    video (B, 3, T, H, W), nominally in [-1, 1] and not clamped (saving
    clips), as in the JAX package. ``api_fn.generate`` is the step after the
    noise is drawn and the references are encoded. ``spatial_compression``:
    pixels per latent token edge (the AE's stride times the patch size).
    ``mesh`` (``opensora_torch.parallel.mesh``) becomes the process's mesh,
    which the sequence-parallel attention backends (``model.attn_backend``
    "ring_rdma", "ring", "ulysses") run over; where it has a 'tp' or an
    'sp' axis, the MMDiT is sharded by the TP rules in place (``fsdp=False``,
    as the JAX package does, opensora_tpu/utils/api.py:160-169; replicated
    over 'sp'): each weight moves into its shards and its unsharded copy is
    freed, and the denoiser's calls run over the tp ranks and, with the
    tokens cut into chunks, over the sp ranks (``parallel/sharding.py``,
    ``models/mmdit/model.py``). Without one the MMDiT stays whole on its
    device."""
    device = next(model.parameters()).device
    if mesh is not None:
        set_mesh(mesh)
        if (mesh.shape[TP_AXIS] > 1 or mesh.shape[SP_AXIS] > 1) and getattr(model, "sharding", None) is None:
            shard_params(mesh, model, fsdp=False)

    @torch.inference_mode()
    def generate(z: torch.Tensor, text, opt: S.SamplingOption, cond_type: str = "t2v", references=None,
                 neg=None, patch_size: int = 2, timings: Optional[dict] = None) -> torch.Tensor:
        """Latent noise z (B, C, T, H', W') fp32 and, for an i2v / v2v cond
        type, the encoded references (``collect_references_batch``) ->
        decoded video (B, 3, T, H, W) fp32. ``timings``, if given, receives
        text_encode_s, step_s (a list) and decode_s, measured with device
        synchronization."""
        num_frames = z.shape[2]
        references = references if references is not None else [None] * len(text)
        denoiser = S.SamplingMethodDict[opt.method]
        timesteps = S.get_schedule(
            opt.num_steps, (z.shape[-1] * z.shape[-2]) // patch_size**2, num_frames,
            shift=opt.shift, shift_alpha=opt.flow_shift,
        )
        text, additional = denoiser.prepare_guidance(text=text, neg=neg, guidance_img=opt.guidance_img)
        t0 = time.perf_counter()
        inp = S.prepare(model_t5, model_clip, z, prompt=text, patch_size=patch_size)
        if timings is not None:
            _sync(device)
            timings["text_encode_s"] = time.perf_counter() - t0
            timings["step_s"] = []
        img = inp.pop("img")
        cond_kwargs = {}
        if opt.method == S.SamplingMethod.I2V:
            masks, masked_ref = prepare_inference_condition(
                z, cond_type, ref_list=references if cond_type != "t2v" else None, causal=opt.is_causal_vae)
            cond_kwargs = dict(masks=masks, masked_ref=masked_ref,
                               guidance_img=additional.get("guidance_img") or 1.0)
        x = denoiser.denoise(
            model, img=img, timesteps=timesteps, guidance=opt.guidance,
            text_osci=opt.text_osci, image_osci=opt.image_osci,
            scale_temporal_osci=opt.scale_temporal_osci and "i2v" in cond_type,
            patch_size=patch_size, cfg_batched=opt.cfg_batched,
            step_seconds=None if timings is None else timings["step_s"],
            **cond_kwargs, **{k: inp[k] for k in ("img_ids", "txt", "txt_ids", "y_vec")},
        )
        x = S.unpack(x.float(), opt.height, opt.width, num_frames, patch_size, spatial_compression)
        x = replace_reference_frames(x, cond_type, references)
        t0 = time.perf_counter()
        x = model_ae.decode(x)
        if timings is not None:
            _sync(device)
            timings["decode_s"] = time.perf_counter() - t0
        x = x[:, :, : opt.num_frames].float()
        if not opt.is_causal_vae:
            x = trim_noncausal_pad(x, cond_type, getattr(model_ae.config, "time_compression_ratio", 1) - 1)
        return x

    @torch.inference_mode()
    def encode_references(ref, cond_type: str, opt: S.SamplingOption, generator: torch.Generator) -> list:
        """Reference paths -> encoded references: samples of the AE's
        posterior with noise from ``generator``."""
        def ae_encode(x):
            return model_ae.encode(torch.as_tensor(x, device=device), generator=generator)

        return collect_references_batch(ref, cond_type, ae_encode, (opt.height, opt.width),
                                        is_causal=opt.is_causal_vae)

    def api_fn(opt: S.SamplingOption, cond_type: str = "t2v", seed: Optional[int] = None, text=None,
               neg=None, patch_size: int = 2, channel: int = 16, timings: Optional[dict] = None, ref=None):
        """``ref``: one reference path per prompt (several split by ';') for
        an i2v / v2v ``cond_type``; without ``ref`` any cond type generates
        text-to-video, as in the JAX package. ``timings`` also receives
        encode_ref_s when references are encoded."""
        if seed is None:
            seed = opt.seed if opt.seed is not None else pyrandom.randint(0, 2**32 - 1)
        if opt.is_causal_vae:
            num_frames = 1 if opt.num_frames == 1 else (opt.num_frames - 1) // opt.temporal_reduction + 1
        else:
            num_frames = 1 if opt.num_frames == 1 else opt.num_frames // opt.temporal_reduction
        gen = torch.Generator(device=device).manual_seed(seed)
        z = S.get_noise(
            len(text), opt.height, opt.width, num_frames, generator=gen, device=device,
            patch_size=patch_size, channel=channel // patch_size**2,
            spatial_compression=spatial_compression,
        )
        references = None
        if cond_type != "t2v" and ref is not None:
            # the posterior's noise from a seed split off the video's
            ae_seed = int(torch.randint(2**62, (1,), generator=torch.Generator().manual_seed(seed)))
            t0 = time.perf_counter()
            references = encode_references(ref, cond_type, opt, torch.Generator(device=device).manual_seed(ae_seed))
            if timings is not None:
                _sync(device)
                timings["encode_ref_s"] = time.perf_counter() - t0
        else:
            cond_type = "t2v"
        return generate(z, text, opt, cond_type, references, neg, patch_size, timings)

    api_fn.generate = generate
    return api_fn
