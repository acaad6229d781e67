"""Inference-side prompt utilities, conditioning and saving (counterpart of
the text-to-video part of opensora_tpu/utils/inference.py).

Samples are saved as uint8 ``.npy`` arrays of frames (T, H, W, 3) beside a
``.txt`` with the prompt: there is no video encoder in the port's
environment, so mp4/png output waits.
"""

from __future__ import annotations

import os
from typing import List, Optional

import numpy as np
import torch


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


def prepare_inference_condition(z: torch.Tensor, mask_cond: str, ref_list=None, causal: bool = True):
    """(masks (B, 1, T, H, W), masked latents (B, C, T, H, W)) for the I2V
    denoiser. Text-to-video conditions on nothing: both are zeros. The
    reference-frame conditions wait for the image-to-video slice."""
    if mask_cond != "t2v" or ref_list is not None:
        raise NotImplementedError(f"cond type {mask_cond!r}: only 't2v' is ported")
    B, C, T, H, W = z.shape
    masks = torch.zeros((B, 1, T, H, W), dtype=z.dtype, device=z.device)
    return masks, torch.zeros_like(z)


def save_sample(x: np.ndarray, save_path: str) -> str:
    """Save (C, T, H, W) in [-1, 1] as uint8 frames (T, H, W, C) in
    ``save_path + '.npy'``."""
    os.makedirs(os.path.dirname(os.path.abspath(save_path)), exist_ok=True)
    x = np.clip((np.asarray(x, np.float32) + 1) / 2, 0, 1)
    frames = np.transpose((x * 255).astype(np.uint8), (1, 2, 3, 0))
    path = save_path + ".npy"
    np.save(path, frames)
    return path


def process_and_save(x: np.ndarray, ids, save_dir: str, prompts: Optional[List[str]] = None) -> List[str]:
    os.makedirs(save_dir, exist_ok=True)
    paths = []
    for i, idx in enumerate(ids):
        paths.append(save_sample(x[i], os.path.join(save_dir, f"sample_{idx:04d}")))
        if prompts is not None:
            with open(os.path.join(save_dir, f"sample_{idx:04d}.txt"), "w") as f:
                f.write(prompts[i])
    return paths
