"""Inference-side prompt utilities, reference conditioning (i2v, v2v) and
saving (counterpart of opensora_tpu/utils/inference.py).

Samples are saved as png (one frame) or mp4 through OpenCV, imported at
call time; where OpenCV is absent they are saved as uint8 ``.npy`` arrays of
frames (T, H, W, 3), which ``datasets.utils.read_from_path`` reads back as
a reference.
"""

from __future__ import annotations

import logging
import os
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch

from opensora_torch.utils.logger import LOGGER_NAME


def ensure_sentence_ends_with_period(sentence: str) -> str:
    sentence = sentence.strip()
    return sentence if sentence.endswith(".") else sentence + "."


def check_fps_added(sentence: str) -> bool:
    return sentence.endswith(" FPS.")


def add_fps_info_to_text(text: List[str], fps: int = 16) -> List[str]:
    out = []
    for item in text:
        item = ensure_sentence_ends_with_period(item)
        if not check_fps_added(item):
            item = item + f" {fps} FPS."
        out.append(item)
    return out


def add_motion_score_to_text(text: List[str], motion_score) -> List[str]:
    """Appends a fixed motion score; 'dynamic' (GPT-scored upstream) is 5."""
    if motion_score == "dynamic":
        motion_score = 5
    return [f"{t} {motion_score} motion score." for t in text]


def add_noise_to_ref(masked_ref: torch.Tensor, masks: torch.Tensor, t: float,
                     generator: Optional[torch.Generator] = None, sigma_min: float = 1e-5,
                     noise: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The masked reference latents noised to time ``t`` (fp32 noise from
    ``generator`` unless given), zero outside the mask."""
    if noise is None:
        noise = torch.randn(masked_ref.shape, generator=generator, device=masked_ref.device, dtype=torch.float32)
    z_noisy = (1 - (1 - sigma_min) * t) * masked_ref + t * noise.to(masked_ref.dtype)
    return masks * z_noisy


def collect_references_batch(reference_paths: Sequence, cond_type: str, ae_encode: Callable, image_size,
                             is_causal: bool = False) -> list:
    """Per sample: None (no reference), or a list of encoded reference
    latents (C, T', H', W'). ``ae_encode``: numpy (B, C, T, H, W) in [-1, 1]
    -> latents. A path may name several media split by ';' (i2v_loop takes
    the first as the head and the last as the tail). v2v takes the first or
    last 32 frames, 64 for ``easy`` when the video has them, + 1 for a
    causal VAE."""
    from opensora_torch.datasets.utils import read_from_path

    def read(path):
        return read_from_path(path, image_size)

    refs_x = []
    for reference_path in reference_paths:
        if reference_path is None or reference_path == "":
            refs_x.append(None)
            continue
        ref_path = str(reference_path).split(";")
        if "v2v" in cond_type:
            r = read(ref_path[0])
            actual_t = r.shape[1]
            target_t = (64 if actual_t >= 64 and "easy" in cond_type else 32) + int(is_causal)
            if actual_t < target_t:
                raise ValueError(f"{ref_path[0]}: {actual_t} frames; v2v needs at least {target_t}")
            r = r[:, :target_t] if "head" in cond_type else r[:, -target_t:]
            ref = [ae_encode(r[None])[0]]
        elif cond_type == "i2v_head":
            ref = [ae_encode(read(ref_path[0])[None, :, :1])[0]]
        elif cond_type == "i2v_tail":
            ref = [ae_encode(read(ref_path[-1])[None, :, -1:])[0]]
        elif cond_type == "i2v_loop":
            ref = [ae_encode(read(ref_path[0])[None, :, :1])[0], ae_encode(read(ref_path[-1])[None, :, -1:])[0]]
        else:
            raise NotImplementedError(f"Unknown condition type {cond_type}")
        refs_x.append(ref)
    return refs_x


def prepare_inference_condition(z: torch.Tensor, mask_cond: str, ref_list=None, causal: bool = True):
    """(masks (B, 1, T, H, W), masked latents (B, C, T, H, W)) in z's dtype
    and device, for the I2V denoiser: ones and the reference's latent frames
    where the cond type fixes frames (i2v: the head, the tail or both; v2v:
    the first or last 8 latent frames, 16 for ``easy``, + 1 for a causal
    VAE), zeros elsewhere. Text-to-video (no references) conditions on
    nothing."""
    B, C, T, H, W = z.shape
    masks = torch.zeros((B, 1, T, H, W), dtype=torch.float32)
    masked_z = torch.zeros((B, C, T, H, W), dtype=torch.float32)
    if ref_list is None:
        if mask_cond != "t2v":
            raise ValueError(f"a reference is required for {mask_cond}")
        ref_list = [None] * B

    def frames(ref, sl):
        return ref[:, sl].float().cpu()

    for i in range(B):
        ref = ref_list[i]
        if ref is None or T == 1:
            continue
        if mask_cond == "i2v_head":
            masks[i, :, 0] = 1
            masked_z[i, :, 0] = frames(ref[0], 0)
        elif mask_cond == "i2v_tail":
            masks[i, :, -1] = 1
            masked_z[i, :, -1] = frames(ref[-1], -1)
        elif mask_cond in ("v2v_head", "v2v_tail", "v2v_head_easy", "v2v_tail_easy"):
            k = (16 if "easy" in mask_cond else 8) + int(causal)
            sl = slice(None, k) if "head" in mask_cond else slice(-k, None)
            masks[i, :, sl] = 1
            masked_z[i, :, sl] = frames(ref[0], sl)
        elif mask_cond == "i2v_loop":
            masks[i, :, 0] = masks[i, :, -1] = 1
            masked_z[i, :, 0] = frames(ref[0], 0)
            masked_z[i, :, -1] = frames(ref[-1], -1)
        elif mask_cond != "t2v":
            raise ValueError(f"Unknown mask condition {mask_cond}")
    return masks.to(z.device, z.dtype), masked_z.to(z.device, z.dtype)


def save_sample(x: np.ndarray, save_path: str, fps: int = 16) -> str:
    """Save (C, T, H, W) in [-1, 1] as uint8 frames: ``save_path + '.png'``
    for one frame, ``'.mp4'`` for more, through OpenCV; ``'.npy'`` of
    (T, H, W, C) where OpenCV is absent. Returns the path written."""
    os.makedirs(os.path.dirname(os.path.abspath(save_path)), exist_ok=True)
    x = np.clip((np.asarray(x, np.float32) + 1) / 2, 0, 1)
    frames = np.transpose((x * 255).astype(np.uint8), (1, 2, 3, 0))
    try:
        import cv2
    except ImportError:
        path = save_path + ".npy"
        np.save(path, frames)
        logging.getLogger(LOGGER_NAME).info("OpenCV is absent: saved uint8 frames %s as %s", frames.shape, path)
        return path
    if frames.shape[0] == 1:
        path = save_path + ".png"
        cv2.imwrite(path, cv2.cvtColor(frames[0], cv2.COLOR_RGB2BGR))
        return path
    path = save_path + ".mp4"
    t, h, w, _ = frames.shape
    writer = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), fps, (w, h))
    try:
        for frame in frames:
            writer.write(cv2.cvtColor(frame, cv2.COLOR_RGB2BGR))
    finally:
        writer.release()
    return path


def process_and_save(x: np.ndarray, ids, save_dir: str, sub_dir: str = "", fps: int = 16,
                     prompts: Optional[List[str]] = None) -> List[str]:
    """Save each sample of x (B, C, T, H, W) as ``sample_{id:04d}`` (with its
    prompt in a ``.txt`` beside it) under ``save_dir/sub_dir``; returns the
    paths written."""
    out_dir = os.path.join(save_dir, sub_dir) if sub_dir else save_dir
    os.makedirs(out_dir, exist_ok=True)
    paths = []
    for i, idx in enumerate(ids):
        paths.append(save_sample(x[i], os.path.join(out_dir, f"sample_{idx:04d}"), fps=fps))
        if prompts is not None:
            with open(os.path.join(out_dir, f"sample_{idx:04d}.txt"), "w") as f:
                f.write(prompts[i])
    return paths
