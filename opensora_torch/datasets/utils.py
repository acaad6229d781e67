"""Media IO and data helpers (counterpart of opensora_tpu/datasets/utils.py).

Decoding and resizing use OpenCV, imported where a function needs it, so
the package imports where OpenCV is absent. Arrays are numpy (C, T, H, W),
float32.
"""

from __future__ import annotations

import math
import os
from typing import Tuple

import numpy as np

IMG_EXTENSIONS = (".jpg", ".jpeg", ".png", ".ppm", ".bmp", ".pgm", ".tif", ".tiff", ".webp")


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


def resize_crop(video: np.ndarray, size: Tuple[int, int]) -> np.ndarray:
    """Resize keeping the aspect ratio, then center-crop to ``size`` (H, W)."""
    import cv2

    th, tw = size
    c, t, h, w = video.shape
    scale = max(th / h, tw / w)
    nh, nw = int(round(h * scale)), int(round(w * scale))
    out = np.empty((c, t, th, tw), video.dtype)
    i0, j0 = (nh - th) // 2, (nw - tw) // 2
    for k in range(t):
        frame = cv2.resize(np.transpose(video[:, k], (1, 2, 0)), (nw, nh), interpolation=cv2.INTER_LINEAR)
        out[:, k] = np.transpose(frame[i0:i0 + th, j0:j0 + tw], (2, 0, 1))
    return out


def normalize_video(video: np.ndarray) -> np.ndarray:
    """[0, 255] -> [-1, 1]."""
    return video / 127.5 - 1.0


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
