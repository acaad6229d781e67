"""Model assembly and the end-to-end generation API (counterpart of
opensora_tpu/utils/api.py, text-to-video).

``prepare_models`` builds the MMDiT, the VAE and the two text encoders on
one device with random weights from a seed (a ``model.quantized`` config
draws the float MMDiT and quantizes each block as it is built, as the JAX
package quantizes a loaded checkpoint); ``prepare_api`` returns
``api_fn``, which draws the latent noise and hands it to ``generate``:
text encode -> I2V denoise -> unpack -> VAE decode.
"""

from __future__ import annotations

import random as pyrandom
import time
from typing import Optional

import torch

import opensora_torch.models.hunyuan_vae.model  # noqa: F401  (registers "hunyuan_vae")
import opensora_torch.models.mmdit.model  # noqa: F401  (registers "flux")
import opensora_torch.models.text.conditioner  # noqa: F401  (registers "text_embedder")
from opensora_torch.models.mmdit.layers import DoubleStreamBlock, SingleStreamBlock
from opensora_torch.ops.quant import quant_mode, quantize_as_built
from opensora_torch.parallel.context import set_mesh
from opensora_torch.registry import MODELS, build_module
from opensora_torch.utils import sampling as S
from opensora_torch.utils.config import DEFAULT_AE_SPATIAL_COMPRESSION
from opensora_torch.utils.inference import prepare_inference_condition
from opensora_torch.utils.misc import resolve_device, torch_dtype


def prepare_models(cfg, device=None, seed: int = 0):
    """Build (model, ae, t5, clip) from the config's dicts on ``device``
    (default cuda), in eval mode without gradients. Weights are random,
    drawn from ``seed``; the text encoders take the config's top-level
    ``dtype``. With ``model.quantized`` set, the MMDiT is drawn in its float
    dtype and the linears of each block are swapped for their int8 twins as
    soon as the block is built (``quantize_as_built``; the JAX package
    quantizes a loaded checkpoint, opensora_tpu/utils/ckpt.py:553-559): a
    QuantLinear built directly holds zeros, which would serve nothing."""
    device = resolve_device(device)
    for name in ("model", "ae"):
        if cfg[name].get("from_pretrained"):
            raise NotImplementedError(
                f"{name}.from_pretrained: checkpoint loading is not ported yet "
                "(opensora_torch.utils.weights carries JAX parameters)"
            )
    text_dtype = torch_dtype(cfg.get("dtype", "bf16"))
    with torch.random.fork_rng(devices=[device] if device.type == "cuda" else []):
        torch.manual_seed(seed)
        quantized = quant_mode(cfg.model.get("quantized", False))
        with quantize_as_built(quantized, (DoubleStreamBlock, SingleStreamBlock)):
            model = build_module(dict(cfg.model, quantized=False), MODELS, device=device)
        if quantized:
            model.config.quantized = quantized
        ae = build_module(dict(cfg.ae), MODELS, device=device)
        t5 = build_module(dict(cfg.t5), MODELS, device=device, dtype=text_dtype)
        clip = build_module(dict(cfg.clip), MODELS, device=device, dtype=text_dtype)
    for m in (model, ae, t5, clip):
        m.eval().requires_grad_(False)
    return model, ae, t5, clip


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def prepare_api(model, model_ae, model_t5, model_clip,
                spatial_compression: int = DEFAULT_AE_SPATIAL_COMPRESSION, mesh=None):
    """Returns ``api_fn(opt, cond_type, seed, text, ...)`` -> video
    (B, 3, T, H, W), nominally in [-1, 1] and not clamped (saving clips), as
    in the JAX package. ``api_fn.generate`` is the step after the noise is
    drawn. ``mesh`` (``opensora_torch.parallel.mesh``) becomes the process's
    mesh, which the sequence-parallel attention backends
    (``model.attn_backend`` "ring_rdma", "ring", "ulysses") run over; the TP
    placement of the parameters the JAX package makes there waits for the TP
    slice: the MMDiT stays whole on its device."""
    device = next(model.parameters()).device
    if mesh is not None:
        set_mesh(mesh)

    @torch.inference_mode()
    def generate(z: torch.Tensor, text, opt: S.SamplingOption, cond_type: str = "t2v", neg=None,
                 patch_size: int = 2, timings: Optional[dict] = None) -> torch.Tensor:
        """Latent noise z (B, C, T, H', W') fp32 -> decoded video (B, 3, T, H, W)
        fp32. ``timings``, if given, receives text_encode_s, step_s (a list)
        and decode_s, measured with device synchronization."""
        num_frames = z.shape[2]
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
        masks, masked_ref = prepare_inference_condition(z, cond_type, causal=opt.is_causal_vae)
        x = denoiser.denoise(
            model, img=img, timesteps=timesteps, guidance=opt.guidance,
            guidance_img=additional.get("guidance_img") or 1.0,
            masks=masks, masked_ref=masked_ref,
            text_osci=opt.text_osci, image_osci=opt.image_osci,
            scale_temporal_osci=opt.scale_temporal_osci and "i2v" in cond_type,
            patch_size=patch_size, cfg_batched=opt.cfg_batched,
            step_seconds=None if timings is None else timings["step_s"],
            **{k: inp[k] for k in ("img_ids", "txt", "txt_ids", "y_vec")},
        )
        x = S.unpack(x.float(), opt.height, opt.width, num_frames, patch_size, spatial_compression)
        t0 = time.perf_counter()
        x = model_ae.decode(x)
        if timings is not None:
            _sync(device)
            timings["decode_s"] = time.perf_counter() - t0
        return x[:, :, : opt.num_frames].float()

    def api_fn(opt: S.SamplingOption, cond_type: str = "t2v", seed: Optional[int] = None, text=None,
               neg=None, patch_size: int = 2, channel: int = 16, timings: Optional[dict] = None):
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
        return generate(z, text, opt, cond_type, neg, patch_size, timings)

    api_fn.generate = generate
    return api_fn
