"""Aspect-ratio and resolution geometry (the port's copy of
opensora_tpu/datasets/aspect.py).

All (height, width) pairs snap to multiples of the AE spatial stride D,
passed explicitly (16 by default). In training mode a pair is nudged by +-D
toward the pixel budget and duplicates are dropped.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

from opensora_torch.utils.config import DEFAULT_AE_SPATIAL_COMPRESSION

# width:height names, ordered by decreasing width/height ratio
ASPECT_RATIO_LD_LIST = ["2.39:1", "2:1", "16:9", "1.85:1", "9:16", "5:8", "3:2", "4:3", "1:1"]


def get_ratio(name: str) -> float:
    """height / width for a 'W:H' ratio name."""
    width, height = map(float, name.split(":"))
    return height / width


def get_aspect_ratios_dict(
    total_pixels: int = 256 * 256,
    training: bool = True,
    spatial_compression: int = DEFAULT_AE_SPATIAL_COMPRESSION,
) -> Dict[str, Tuple[int, int]]:
    D = spatial_compression
    out: Dict[str, Tuple[int, int]] = {}
    vertical: Dict[str, Tuple[int, int]] = {}
    for ratio in ASPECT_RATIO_LD_LIST:
        wr, hr = map(float, ratio.split(":"))
        width = int(math.sqrt(total_pixels * (wr / hr)) // D) * D
        height = int((total_pixels / width) // D) * D
        if training:
            best, best_diff = (height, width), abs(height * width - total_pixels)
            for h, w in ((height - D, width), (height + D, width), (height, width - D), (height, width + D)):
                if abs(h * w - total_pixels) < best_diff:
                    best, best_diff = (h, w), abs(h * w - total_pixels)
            height, width = best
        if (height, width) not in out.values() or not training:
            out[ratio] = (height, width)
            vertical[":".join(ratio.split(":")[::-1])] = (width, height)
    out.update(vertical)
    return out


def get_num_pixels_from_name(resolution: str) -> int:
    """'256px' -> 256^2, '360p' -> 360^2 * 16/9."""
    resolution = resolution.split("_")[0]
    if resolution.endswith("px"):
        size = int(resolution[:-2])
        return size * size
    if resolution.endswith("p"):
        size = int(resolution[:-1])
        return int(size * size / 9 * 16)
    raise ValueError(f"Invalid resolution {resolution}")


def get_image_size(
    resolution: str,
    ar_ratio: str,
    training: bool = True,
    spatial_compression: int = DEFAULT_AE_SPATIAL_COMPRESSION,
) -> Tuple[int, int]:
    ar_dict = get_aspect_ratios_dict(get_num_pixels_from_name(resolution), training, spatial_compression)
    assert ar_ratio in ar_dict, f"Aspect ratio {ar_ratio} not found"
    return ar_dict[ar_ratio]


def get_resolution_with_aspect_ratio(
    resolution: str, spatial_compression: int = DEFAULT_AE_SPATIAL_COMPRESSION
) -> Tuple[int, Dict[str, Tuple[int, int]]]:
    """'256px' / '360p_ar1:1' / '768px_max' -> (pixels, {ratio: (h, w)})."""
    keys = resolution.split("_")
    name, setting = (keys[0], "") if len(keys) == 1 else keys
    if setting and setting != "max" and not setting.startswith("ar"):
        raise ValueError(f"Invalid setting {setting}")
    num_pixels = get_num_pixels_from_name(name)
    ar_dict = get_aspect_ratios_dict(num_pixels, spatial_compression=spatial_compression)
    if setting == "max":
        ar = max(ar_dict, key=lambda x: ar_dict[x][0] * ar_dict[x][1])
        ar_dict = {ar: ar_dict[ar]}
    elif setting.startswith("ar"):
        ar = setting[2:]
        assert ar in ar_dict, f"Aspect ratio {ar} not found"
        ar_dict = {ar: ar_dict[ar]}
    return num_pixels, ar_dict


def get_closest_ratio(height: float, width: float, ratios: Dict) -> str:
    aspect = height / width
    return min(ratios.keys(), key=lambda r: abs(aspect - get_ratio(r)))
