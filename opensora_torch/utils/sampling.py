"""Rectified-flow sampling: options, schedule, noise, packing, the I2V
denoiser and the distilled (guidance-embedded) denoiser (counterpart of
opensora_tpu/utils/sampling.py).

The JAX package runs the step loop as ``lax.scan`` inside one ``jit``; here
it is a Python loop over eager calls. The 3-way CFG batch (cond,
uncond-text, uncond-all) lies on the batch axis so the model runs once per
step (``cfg_batched=True``), or as three B = b passes (``False``).
"""

from __future__ import annotations

import dataclasses
import math
import time
from dataclasses import dataclass
from enum import Enum
from typing import Callable, List, Optional

import torch
from einops import rearrange, repeat

from opensora_torch.datasets.aspect import get_image_size
from opensora_torch.utils.config import DEFAULT_AE_SPATIAL_COMPRESSION


class SamplingMethod(str, Enum):
    I2V = "i2v"
    DISTILLED = "distill"


@dataclass
class SamplingOption:
    width: Optional[int] = None
    height: Optional[int] = None
    resolution: Optional[str] = None
    aspect_ratio: Optional[str] = None
    num_frames: int = 1
    num_steps: int = 50
    guidance: float = 4.0
    text_osci: bool = False
    guidance_img: Optional[float] = None
    image_osci: bool = False
    scale_temporal_osci: bool = False
    seed: Optional[int] = None
    shift: bool = True
    method: SamplingMethod | str = SamplingMethod.I2V
    temporal_reduction: int = 1
    is_causal_vae: bool = False
    flow_shift: Optional[float] = None
    # False runs the 3-way CFG as three sequential B = b model passes
    cfg_batched: bool = True


def sanitize_sampling_option(opt: SamplingOption, spatial_compression: int) -> SamplingOption:
    """Resolve resolution/aspect ratio to 16-aligned (height, width). The
    named size snaps to ``spatial_compression``, the config's
    ``ae_spatial_compression`` (``utils.config.ae_spatial_compression``)."""
    if opt.resolution is not None or opt.aspect_ratio is not None:
        assert opt.resolution is not None and opt.aspect_ratio is not None, (
            "Both resolution and aspect ratio must be provided"
        )
        height, width = get_image_size(opt.resolution, opt.aspect_ratio, training=False,
                                       spatial_compression=spatial_compression)
    else:
        assert opt.height is not None and opt.width is not None, "Both height and width must be provided"
        height, width = opt.height, opt.width
    height = (height // 16 + (1 if height % 16 else 0)) * 16
    width = (width // 16 + (1 if width % 16 else 0)) * 16
    replace = dict(height=height, width=width)
    if isinstance(opt.method, str):
        replace["method"] = SamplingMethod(opt.method)
    return dataclasses.replace(opt, **replace)


def get_oscillation_gs(guidance_scale: float, i: int, force_num: int = 10) -> float:
    """Oscillating CFG: full scale for the first steps, then every other step."""
    if i < force_num or (i >= force_num and i % 2 == 0):
        return guidance_scale
    return 1.0


def time_shift(alpha: float, t: torch.Tensor) -> torch.Tensor:
    return alpha * t / (1 + (alpha - 1) * t)


def get_res_lin_function(x1: float = 256, y1: float = 1, x2: float = 4096, y2: float = 3) -> Callable[[float], float]:
    m = (y2 - y1) / (x2 - x1)
    b = y1 - m * x1
    return lambda x: m * x + b


def get_schedule(
    num_steps: int,
    image_seq_len: int,
    num_frames: int,
    shift_alpha: Optional[float] = None,
    base_shift: float = 1.0,
    max_shift: float = 3.0,
    shift: bool = True,
) -> torch.Tensor:
    """Rectified-flow timesteps, 1 -> 0, (num_steps + 1,) fp32 on the CPU."""
    timesteps = torch.linspace(1.0, 0.0, num_steps + 1)
    if shift:
        if shift_alpha is None:
            shift_alpha = get_res_lin_function(y1=base_shift, y2=max_shift)(image_seq_len)
            shift_alpha *= math.sqrt(num_frames)
        timesteps = time_shift(shift_alpha, timesteps)
    return timesteps


def get_noise(
    num_samples: int,
    height: int,
    width: int,
    num_frames: int,
    *,
    generator: torch.Generator,
    device=None,
    dtype: torch.dtype = torch.float32,
    patch_size: int = 2,
    channel: int = 16,
    spatial_compression: int = DEFAULT_AE_SPATIAL_COMPRESSION,
) -> torch.Tensor:
    """Seeded latent noise (B, C, T, H', W'), drawn on ``device`` from
    ``generator`` (a different stream from the JAX package's jax.random)."""
    D = spatial_compression
    shape = (num_samples, channel, num_frames, patch_size * math.ceil(height / D), patch_size * math.ceil(width / D))
    return torch.randn(shape, generator=generator, device=device, dtype=torch.float32).to(dtype)


def pack(x: torch.Tensor, patch_size: int = 2) -> torch.Tensor:
    """b c t (h ph) (w pw) -> b (t h w) (c ph pw)."""
    return rearrange(x, "b c t (h ph) (w pw) -> b (t h w) (c ph pw)", ph=patch_size, pw=patch_size)


def unpack(
    x: torch.Tensor,
    height: int,
    width: int,
    num_frames: int,
    patch_size: int = 2,
    spatial_compression: int = DEFAULT_AE_SPATIAL_COMPRESSION,
) -> torch.Tensor:
    D = spatial_compression
    return rearrange(
        x, "b (t h w) (c ph pw) -> b c t (h ph) (w pw)",
        h=math.ceil(height / D), w=math.ceil(width / D), t=num_frames, ph=patch_size, pw=patch_size,
    )


def build_img_ids(t: int, h: int, w: int, patch_size: int = 2, bs: int = 1, device=None) -> torch.Tensor:
    """(t, h, w) position grid for RoPE: (bs, t * h' * w', 3) fp32."""
    hp, wp = h // patch_size, w // patch_size
    grid = torch.meshgrid(
        torch.arange(t, dtype=torch.float32, device=device),
        torch.arange(hp, dtype=torch.float32, device=device),
        torch.arange(wp, dtype=torch.float32, device=device),
        indexing="ij",
    )
    ids = torch.stack(grid, dim=-1).reshape(1, t * hp * wp, 3)
    return ids.expand(bs, -1, -1)


def prepare(t5, clip, img: torch.Tensor, prompt, seq_align: int = 1, patch_size: int = 2) -> dict:
    """Pack the latents and encode the text. ``t5``/``clip``: list[str] ->
    embeddings. ``seq_align`` pads the T5 sequence so txt_len + img_len is
    a multiple of it."""
    bs, c, t, h, w = img.shape
    dtype = img.dtype
    if isinstance(prompt, str):
        prompt = [prompt]
    if bs != len(prompt):
        bs = len(prompt)
    img = pack(img, patch_size=patch_size)
    if img.shape[0] != bs:
        img = repeat(img, "b ... -> (repeat b) ...", repeat=bs // img.shape[0])
    img_ids = build_img_ids(t, h, w, patch_size, bs, device=img.device)
    txt = t5(prompt, added_tokens=img_ids.shape[1], seq_align=seq_align)
    if txt.shape[0] == 1 and bs > 1:
        txt = repeat(txt, "1 ... -> bs ...", bs=bs)
    txt_ids = torch.zeros((bs, txt.shape[1], 3), dtype=torch.float32, device=img.device)
    vec = clip(prompt)
    if vec.shape[0] == 1 and bs > 1:
        vec = repeat(vec, "1 ... -> bs ...", bs=bs)
    return {"img": img, "img_ids": img_ids, "txt": txt.to(dtype), "txt_ids": txt_ids, "y_vec": vec.to(dtype)}


def prepare_ids(img: torch.Tensor, t5_embedding: torch.Tensor, clip_embedding: torch.Tensor,
                patch_size: int = 2) -> dict:
    """:func:`prepare` for cached text embeddings."""
    bs, c, t, h, w = img.shape
    dtype = img.dtype
    img_ids = build_img_ids(t, h, w, patch_size, bs, device=img.device)
    if t5_embedding.shape[0] == 1 and bs > 1:
        t5_embedding = repeat(t5_embedding, "1 ... -> bs ...", bs=bs)
    if clip_embedding.shape[0] == 1 and bs > 1:
        clip_embedding = repeat(clip_embedding, "1 ... -> bs ...", bs=bs)
    txt_ids = torch.zeros((bs, t5_embedding.shape[1], 3), dtype=torch.float32, device=img.device)
    return {"img": pack(img, patch_size=patch_size), "img_ids": img_ids, "txt": t5_embedding.to(dtype),
            "txt_ids": txt_ids, "y_vec": clip_embedding.to(dtype)}


class I2VDenoiser:
    """3-way CFG Euler sampler with oscillating guidance and the temporal
    image-guidance ramp."""

    def prepare_guidance(self, text, neg=None, guidance_img=None, **kwargs):
        if neg is None:
            neg = [""] * len(text)
        return list(text) + list(neg) + list(neg), {"guidance_img": guidance_img}

    def denoise(
        self,
        model_fn: Callable,
        *,
        img: torch.Tensor,
        timesteps: torch.Tensor,
        guidance: float,
        guidance_img: float,
        masks: torch.Tensor,
        masked_ref: torch.Tensor,
        text_osci: bool = False,
        image_osci: bool = False,
        scale_temporal_osci: bool = False,
        patch_size: int = 2,
        cfg_batched: bool = True,
        step_seconds: Optional[List[float]] = None,
        **model_kwargs,
    ) -> torch.Tensor:
        """Returns the cond slice of the latents after ``len(timesteps) - 1``
        steps. ``step_seconds``: if given, each step's wall time is appended
        (the device is synchronized after every step to measure it)."""
        num_steps = timesteps.shape[0] - 1
        b3 = img.shape[0]
        assert b3 % 3 == 0, "I2V denoiser expects a 3-way CFG batch"
        b = b3 // 3
        _, bc, bT, bh, bw = masked_ref.shape
        cond = pack(torch.cat([masks, masked_ref], dim=1), patch_size=patch_size)
        cond3 = torch.cat([cond, cond, torch.zeros_like(cond)], dim=0)
        guidance_vec = torch.full((b3,), guidance, dtype=img.dtype, device=img.device)
        if scale_temporal_osci:
            step_upper = torch.linspace(guidance_img, 1.0, num_steps + 1)[:-1]
            frame_ramp = torch.linspace(0.0, 1.0, bT, device=img.device)

        x = img[:b]
        ts = timesteps.float()
        for i in range(num_steps):
            t0 = time.perf_counter()
            t_curr, t_prev = ts[i], ts[i + 1]
            if cfg_batched:
                pred = model_fn(img=torch.cat([x, x, x], dim=0), cond=cond3,
                                timesteps=torch.full((b3,), float(t_curr), dtype=img.dtype, device=img.device),
                                guidance=guidance_vec, **model_kwargs)
                cond_p, uncond_p, uncond2_p = pred.chunk(3, dim=0)
            else:
                t_vec = torch.full((b,), float(t_curr), dtype=img.dtype, device=img.device)

                def one_pass(j):
                    kw = {k: (v[j * b:(j + 1) * b] if torch.is_tensor(v) and v.dim() >= 1 and v.shape[0] == b3 else v)
                          for k, v in model_kwargs.items()}
                    return model_fn(img=x, cond=cond3[j * b:(j + 1) * b], timesteps=t_vec,
                                    guidance=guidance_vec[j * b:(j + 1) * b], **kw)

                cond_p, uncond_p, uncond2_p = one_pass(0), one_pass(1), one_pass(2)

            text_gs = get_oscillation_gs(guidance, i) if text_osci else guidance
            ig_base = get_oscillation_gs(guidance_img, i) if image_osci else guidance_img
            if scale_temporal_osci and ig_base > 1.0:
                # the image guidance ramps 1 -> linspace(ig, 1)[i] across latent frames
                img_gs_t = 1.0 + (float(step_upper[i]) - 1.0) * frame_ramp
                image_gs = pack(img_gs_t[None, None, :, None, None].expand(b, bc, bT, bh, bw),
                                patch_size=patch_size).to(cond_p.dtype)
            else:
                image_gs = ig_base
            merged = uncond2_p + image_gs * (uncond_p - uncond2_p) + text_gs * (cond_p - uncond_p)
            # the fp32 Euler update, cast back to the latent dtype
            x = x + ((t_prev - t_curr) * merged.float()).to(x.dtype)
            if step_seconds is not None:
                if x.is_cuda:
                    torch.cuda.synchronize(x.device)
                step_seconds.append(time.perf_counter() - t0)
        return x


class DistilledDenoiser:
    """Plain Euler loop of a guidance-distilled model (the Flux image stage
    of t2i2v): no CFG batch, the guidance scale goes in as a vector."""

    # the I2V denoiser's arguments, which a caller may pass to either
    I2V_ONLY = ("masks", "masked_ref", "text_osci", "image_osci", "scale_temporal_osci", "patch_size",
                "guidance_img", "sigma_min", "cfg_batched")

    def prepare_guidance(self, text, neg=None, guidance_img=None, **kwargs):
        return list(text), {}

    def denoise(self, model_fn: Callable, *, img: torch.Tensor, timesteps: torch.Tensor, guidance: float,
                step_seconds: Optional[List[float]] = None, **model_kwargs) -> torch.Tensor:
        """The latents after ``len(timesteps) - 1`` steps; ``step_seconds``
        as in :meth:`I2VDenoiser.denoise`."""
        for k in self.I2V_ONLY:
            model_kwargs.pop(k, None)
        guidance_vec = torch.full((img.shape[0],), guidance, dtype=img.dtype, device=img.device)
        x = img
        ts = timesteps.float()
        for i in range(timesteps.shape[0] - 1):
            t0 = time.perf_counter()
            t_vec = torch.full((x.shape[0],), float(ts[i]), dtype=x.dtype, device=x.device)
            pred = model_fn(img=x, timesteps=t_vec, guidance=guidance_vec, **model_kwargs)
            # the fp32 Euler update, cast back to the latent dtype
            x = x + ((ts[i + 1] - ts[i]) * pred.float()).to(x.dtype)
            if step_seconds is not None:
                if x.is_cuda:
                    torch.cuda.synchronize(x.device)
                step_seconds.append(time.perf_counter() - t0)
        return x


SamplingMethodDict = {SamplingMethod.I2V: I2VDenoiser(), SamplingMethod.DISTILLED: DistilledDenoiser()}
