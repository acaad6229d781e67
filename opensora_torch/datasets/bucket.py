"""Buckets: (resolution, num_frames, aspect ratio) -> (keep probability,
batch size) (counterpart of opensora_tpu/datasets/bucket.py; upstream
opensora/datasets/bucket.py:11-139). The assignment is the JAX package's,
draw for draw."""

from __future__ import annotations

from collections import OrderedDict
from typing import Dict, Optional, Tuple

import numpy as np

from opensora_torch.datasets.aspect import get_closest_ratio, get_resolution_with_aspect_ratio
from opensora_torch.datasets.utils import map_target_fps


class Bucket:
    """bucket_config: {resolution: {num_frames: (prob or (prob, next_t_prob), batch_size)}}.
    Every (height, width) snaps to ``spatial_compression``, the config's
    ``ae_spatial_compression``."""

    def __init__(self, bucket_config: Dict[str, Dict[int, tuple]], spatial_compression: int):
        aspect_ratios = {key: get_resolution_with_aspect_ratio(key, spatial_compression) for key in bucket_config}
        # resolutions by pixel count, high to low
        bucket_names = sorted(bucket_config, key=lambda x: aspect_ratios[x][0], reverse=True)
        self.bucket_probs: Dict[str, OrderedDict] = OrderedDict()
        self.bucket_bs: Dict[str, OrderedDict] = OrderedDict()
        for key in bucket_names:
            t_names = sorted(bucket_config[key], reverse=True)
            self.bucket_probs[key] = OrderedDict((t, bucket_config[key][t][0]) for t in t_names)
            self.bucket_bs[key] = OrderedDict((t, bucket_config[key][t][1]) for t in t_names)
        self.hw_criteria = {k: aspect_ratios[k][0] for k in bucket_names}
        self.t_criteria = {k: {t: t for t in bucket_config[k]} for k in bucket_names}
        self.ar_criteria = {k: {t: dict(aspect_ratios[k][1]) for t in bucket_config[k]} for k in bucket_names}
        self.num_bucket = sum(len(aspect_ratios[k][1]) * len(self.bucket_probs[k]) for k in bucket_names)

    def get_bucket_id(self, T: int, H: int, W: int, fps: float, path: Optional[str] = None,
                      seed: Optional[int] = None, fps_max: int = 16) -> Optional[Tuple[str, int, str]]:
        """Walk resolutions high to low (skipping those the sample is below
        0.8x of), then frame counts high to low with keep/skip draws from a
        per-sample seeded generator."""
        _, sampling_interval = map_target_fps(fps, fps_max)
        T = T // sampling_interval
        resolution = H * W
        rng = np.random.default_rng(seed)
        for hw_id, t_criteria in self.bucket_probs.items():
            if resolution < self.hw_criteria[hw_id] * 0.8:
                continue
            if T == 1:  # image
                if 1 in t_criteria and rng.random() < t_criteria[1]:
                    return hw_id, 1, get_closest_ratio(H, W, self.ar_criteria[hw_id][1])
                continue
            for t_id, prob in t_criteria.items():
                if T >= t_id and t_id != 1:
                    if isinstance(prob, tuple):
                        next_hw_prob, next_t_prob = prob
                        if next_t_prob >= 1 or rng.random() <= next_t_prob:
                            continue
                    else:
                        next_hw_prob = prob
                    if next_hw_prob >= 1 or rng.random() <= next_hw_prob:
                        return hw_id, t_id, get_closest_ratio(H, W, self.ar_criteria[hw_id][t_id])
                    break
        return None

    def get_thw(self, bucket_id: Tuple[str, int, str]) -> Tuple[int, int, int]:
        T = self.t_criteria[bucket_id[0]][bucket_id[1]]
        H, W = self.ar_criteria[bucket_id[0]][bucket_id[1]][bucket_id[2]]
        return T, H, W

    def get_batch_size(self, bucket_id) -> int:
        return self.bucket_bs[bucket_id[0]][bucket_id[1]]

    def __len__(self) -> int:
        return self.num_bucket
