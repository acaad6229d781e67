"""Media IO and data helpers (counterpart of opensora_tpu/datasets/utils.py).

Decoding png/mp4 uses OpenCV, imported where a function needs it, so the
package imports where OpenCV is absent; the port's own samples (uint8
frames (T, H, W, 3) in ``.npy``, written where OpenCV is absent) read
without it. Resizing is torch's bilinear interpolation. Arrays are numpy
(C, T, H, W), float32.
"""

from __future__ import annotations

import math
import os
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

IMG_EXTENSIONS = (".jpg", ".jpeg", ".png", ".ppm", ".bmp", ".pgm", ".tif", ".tiff", ".webp")
VID_EXTENSIONS = (".mp4", ".avi", ".mov", ".mkv", ".webm")


def is_img(path: str) -> bool:
    return os.path.splitext(path)[1].lower() in IMG_EXTENSIONS


def read_image(path: str) -> np.ndarray:
    """(C, 1, H, W) RGB float32 in [0, 255]."""
    import cv2

    img = cv2.imread(path, cv2.IMREAD_COLOR)
    if img is None:
        raise IOError(f"cannot read image {path}")
    img = cv2.cvtColor(img, cv2.COLOR_BGR2RGB).astype(np.float32)
    return np.transpose(img, (2, 0, 1))[:, None]


def read_video(path: str, sampling_interval: int = 1) -> Tuple[np.ndarray, float]:
    """Decode every ``sampling_interval``-th frame to (C, T, H, W) RGB
    float32 in [0, 255]; returns (video, fps)."""
    import cv2

    cap = cv2.VideoCapture(path)
    if not cap.isOpened():
        raise IOError(f"cannot open video {path}")
    fps = cap.get(cv2.CAP_PROP_FPS) or 24.0
    frames = []
    idx = 0
    try:
        while True:
            ok, frame = cap.read()
            if not ok:
                break
            if idx % sampling_interval == 0:
                frames.append(cv2.cvtColor(frame, cv2.COLOR_BGR2RGB))
            idx += 1
    finally:
        cap.release()
    if not frames:
        raise IOError(f"no frames decoded from {path}")
    return np.transpose(np.stack(frames).astype(np.float32), (3, 0, 1, 2)), fps


def read_sample(path: str) -> np.ndarray:
    """A sample ``.npy`` of uint8 frames (T, H, W, 3) -> (C, T, H, W) RGB
    float32 in [0, 255], as :func:`read_image` / :func:`read_video` give."""
    frames = np.load(path)
    if frames.dtype != np.uint8 or frames.ndim != 4 or frames.shape[-1] != 3:
        raise ValueError(f"{path}: expected uint8 frames (T, H, W, 3), got {frames.dtype} {frames.shape}")
    return np.transpose(frames, (3, 0, 1, 2)).astype(np.float32)


def resize_crop(video: np.ndarray, size: Tuple[int, int]) -> np.ndarray:
    """Resize keeping the aspect ratio (bilinear with half-pixel centres and
    no antialiasing, as cv2.INTER_LINEAR samples), then center-crop to
    ``size`` (H, W); float32."""
    th, tw = size
    c, t, h, w = video.shape
    scale = max(th / h, tw / w)
    nh, nw = int(round(h * scale)), int(round(w * scale))
    i0, j0 = (nh - th) // 2, (nw - tw) // 2
    frames = torch.from_numpy(np.ascontiguousarray(video, np.float32)).transpose(0, 1)  # (T, C, H, W)
    frames = F.interpolate(frames, size=(nh, nw), mode="bilinear", align_corners=False, antialias=False)
    return frames[:, :, i0:i0 + th, j0:j0 + tw].transpose(0, 1).contiguous().numpy()


def normalize_video(video: np.ndarray) -> np.ndarray:
    """[0, 255] -> [-1, 1]."""
    return video / 127.5 - 1.0


def read_from_path(path: str, image_size: Tuple[int, int]) -> np.ndarray:
    """An image, a video or a sample ``.npy`` -> (C, T, H, W) in [-1, 1],
    resized and center-cropped to ``image_size`` (H, W)."""
    if path.endswith(".npy"):
        media = read_sample(path)
    else:
        media = read_image(path) if is_img(path) else read_video(path)[0]
    return normalize_video(resize_crop(media, image_size))


def temporal_random_crop(video: np.ndarray, num_frames: int, frame_interval: int,
                         rng: np.random.Generator) -> np.ndarray:
    total = video.shape[1]
    span = (num_frames - 1) * frame_interval + 1
    if total < span:
        raise ValueError(f"video too short: {total} < {span}")
    start = int(rng.integers(0, total - span + 1))
    return video[:, start + np.arange(num_frames) * frame_interval]


def map_target_fps(fps: float, fps_max: int = 16) -> Tuple[float, int]:
    """fps -> (target fps, frame sampling interval)."""
    if fps <= 0 or math.isnan(fps):
        return 0.0, 1
    if fps <= fps_max:
        return fps, 1
    interval = math.ceil(fps / fps_max)
    return fps / interval, interval
