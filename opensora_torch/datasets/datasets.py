"""Datasets: prompts, video-text pairs and cached latents (counterpart of
opensora_tpu/datasets/datasets.py; upstream opensora/datasets/datasets.py).

Tables load without pandas: :func:`read_data_file` reads CSV and JSON
Lines into a :class:`Table` of row dicts, with each CSV column typed as
pandas types it (int, else float, else str; empty cells NaN). Parquet
needs pandas and raises. Samples are numpy; a sample that fails to load is
None and is dropped at collate.
"""

from __future__ import annotations

import csv
import json
import logging
import math
import zlib
from typing import Dict, List, Optional

import numpy as np

from opensora_torch.datasets import utils as du
from opensora_torch.registry import DATASETS
from opensora_torch.utils.logger import LOGGER_NAME


class Table:
    """Rows of a data file as dicts, with the file's column names."""

    def __init__(self, rows: List[Dict], columns: List[str]):
        self.rows, self.columns = rows, columns

    def __len__(self) -> int:
        return len(self.rows)

    def __getitem__(self, i: int) -> Dict:
        return self.rows[i]

    def __iter__(self):
        return iter(self.rows)


def _typed_column(values: List[str]) -> list:
    """pandas.read_csv's inference for one column: int64 when every cell is
    an integer, float64 when every non-empty cell is a number (empty ->
    NaN), else strings (empty -> NaN)."""
    filled = [v for v in values if v != ""]
    for kind in (int, float):
        try:
            parsed = [kind(v) for v in filled]
        except ValueError:
            continue
        if kind is int and len(filled) < len(values):
            kind = float
        it = iter(parsed)
        return [kind(next(it)) if v != "" else math.nan for v in values]
    return [v if v != "" else math.nan for v in values]


def read_data_file(path: str) -> Table:
    if path.endswith(".csv"):
        with open(path, newline="") as f:
            reader = csv.reader(f)
            columns = next(reader)
            raw = [r + [""] * (len(columns) - len(r)) for r in reader]
        cols = [_typed_column([r[j] for r in raw]) for j in range(len(columns))]
        return Table([dict(zip(columns, vals)) for vals in zip(*cols)] if raw else [], columns)
    if path.endswith(".jsonl"):
        with open(path) as f:
            rows = [json.loads(line) for line in f if line.strip()]
        columns = list(dict.fromkeys(k for r in rows for k in r))
        return Table([{k: r.get(k, math.nan) for k in columns} for r in rows], columns)
    if path.endswith(".parquet"):
        raise NotImplementedError("parquet tables need pandas, which the port does not use; convert to csv or jsonl")
    raise ValueError(f"unsupported data file {path}")


def _is_absent(value) -> bool:
    """A cell that holds nothing: missing (None) or empty (NaN), as
    ``pd.isna`` reads a scalar."""
    return value is None or (isinstance(value, float) and math.isnan(value))


@DATASETS.register_module("text")
class TextDataset:
    """Prompts for inference: each item is ``{"text", "index"}`` plus the
    row's ``ref`` and ``neg`` where the table has the column and the cell
    is not empty (opensora_tpu/datasets/datasets.py:32-71). The texts get
    the fps / motion-score suffixes when ``fps`` / ``motion_score`` are
    given. ``table`` stands in for the file at ``data_path``."""

    def __init__(self, data_path: Optional[str] = None, fps: Optional[int] = None,
                 motion_score: Optional[str] = None, table: Optional[Table] = None, **_):
        self.data_path = data_path
        self.data = read_data_file(data_path) if table is None else table
        if "text" not in self.data.columns:
            raise ValueError(f"{data_path}: a prompt file needs a text column")
        from opensora_torch.utils.inference import add_fps_info_to_text, add_motion_score_to_text

        texts = [row["text"] for row in self.data]
        if fps is not None:
            texts = add_fps_info_to_text(texts, fps=fps)
        if motion_score is not None:
            texts = add_motion_score_to_text(texts, motion_score)
        self.texts = texts

    def __len__(self):
        return len(self.data)

    def __getitem__(self, idx: int) -> dict:
        row = self.data[idx]
        out = {"text": self.texts[idx], "index": idx}
        for key in ("ref", "neg"):
            if key in self.data.columns and not _is_absent(row[key]):
                out[key] = row[key]
        return out


@DATASETS.register_module("video_text")
class VideoTextDataset:
    """Video or image + caption, decoded at the bucket shape named by the
    sampler's "idx-T-H-W" index."""

    def __init__(self, data_path: str, transform_name: str = "resize_crop", fps_max: int = 16, **_):
        self.data_path = data_path
        self.data = read_data_file(data_path)
        self.transform_name = transform_name
        self.fps_max = fps_max
        if "height" not in self.data.columns or "width" not in self.data.columns:
            raise ValueError("dataset needs height/width columns (python -m opensora_torch.cnv.meta writes them)")

    def __len__(self):
        return len(self.data)

    def getitem(self, index: str) -> Optional[dict]:
        idx, num_frames, height, width = (int(v) for v in index.split("-"))
        row = self.data[idx]
        path = row["path"]
        # the temporal crop's generator is seeded from the file and row, the
        # same in every process
        rng = np.random.default_rng(zlib.crc32(f"{self.data_path}:{idx}".encode()))
        try:
            if du.is_img(path):
                video = np.repeat(du.read_image(path), num_frames, axis=1)
                fps = 0.0
            else:
                _, interval = du.map_target_fps(float(row.get("fps", 0) or 0), self.fps_max)
                video, fps = du.read_video(path, sampling_interval=interval)
                video = du.temporal_random_crop(video, num_frames, 1, rng)
            video = du.normalize_video(du.resize_crop(video, (height, width)))
        except Exception:  # unreadable media: the sample is dropped at collate, the run goes on
            logging.getLogger(LOGGER_NAME).warning("cannot load %s", path, exc_info=True)
            return None
        return {"video": video.astype(np.float32), "text": row.get("text", ""), "num_frames": num_frames,
                "height": height, "width": width, "fps": fps, "index": idx}

    def __getitem__(self, index):
        if isinstance(index, str):
            return self.getitem(index)
        row = self.data[int(index)]
        return {"text": row.get("text", ""), "index": int(index)}


@DATASETS.register_module("cached_video_text")
class CachedVideoTextDataset:
    """Precomputed latents and text embeddings: each row names .npy files
    (latent_path, t5_path, clip_path)."""

    def __init__(self, data_path: str, **_):
        self.data_path = data_path
        self.data = read_data_file(data_path)

    def __len__(self):
        return len(self.data)

    def __getitem__(self, idx: int) -> Optional[dict]:
        row = self.data[int(idx)]
        try:
            out = {"video_latents": np.load(row["latent_path"]), "text_t5": np.load(row["t5_path"]),
                   "text_clip": np.load(row["clip_path"]), "index": int(idx)}
        except OSError:  # a missing or unreadable file: dropped at collate
            logging.getLogger(LOGGER_NAME).warning("cannot load row %d", idx, exc_info=True)
            return None
        if "text" in row:
            out["text"] = row["text"]
        return out
