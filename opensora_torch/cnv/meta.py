"""A dataset table's media columns (counterpart of scripts/cnv/meta.py).

    python -m opensora_torch.cnv.meta INPUT.csv OUTPUT.csv
    python -m opensora_torch.cnv.meta /data/videos OUTPUT.csv

The input is a table with a ``path`` column (csv or jsonl, read by
``datasets.read_data_file``) or a directory, walked for image and video
files (paths sorted). Each file is probed with OpenCV for ``height``,
``width``, ``num_frames`` and ``fps`` (an image: one frame, fps 0.0); a
file OpenCV cannot read is left out, as the JAX script leaves it out. The
output keeps the input's columns and adds the four after them, written
with the ``csv`` module as pandas writes the JAX script's table (NaN as an
empty cell, floats by ``repr``), so that ``read_data_file`` reads it as
pandas reads that one: the columns the video dataset and the bucket
sampler need.
"""

from __future__ import annotations

import csv
import math
import os
import sys
from typing import List, Optional

from opensora_torch.datasets.datasets import Table, read_data_file
from opensora_torch.datasets.utils import IMG_EXTENSIONS, VID_EXTENSIONS, is_img

COLUMNS = ("height", "width", "num_frames", "fps")


def probe(path: str) -> Optional[dict]:
    """``height``, ``width``, ``num_frames`` and ``fps`` of an image or a
    video, or None where OpenCV cannot read it."""
    import cv2

    if is_img(path):
        img = cv2.imread(path)
        if img is None:
            return None
        h, w = img.shape[:2]
        return dict(height=h, width=w, num_frames=1, fps=0.0)
    cap = cv2.VideoCapture(path)
    if not cap.isOpened():
        return None
    try:
        return dict(height=int(cap.get(cv2.CAP_PROP_FRAME_HEIGHT)), width=int(cap.get(cv2.CAP_PROP_FRAME_WIDTH)),
                    num_frames=int(cap.get(cv2.CAP_PROP_FRAME_COUNT)), fps=float(cap.get(cv2.CAP_PROP_FPS) or 0.0))
    finally:
        cap.release()


def media_table(root: str) -> Table:
    """A one-column table of the image and video files under ``root``,
    sorted."""
    exts = IMG_EXTENSIONS + VID_EXTENSIONS
    paths = sorted(os.path.join(r, f) for r, _, fs in os.walk(root) for f in fs
                   if os.path.splitext(f)[1].lower() in exts)
    return Table([{"path": p} for p in paths], ["path"])


def _cell(value) -> str:
    if isinstance(value, float):
        return "" if math.isnan(value) else repr(value)
    return str(value)


def write_table(table: Table, path: str) -> None:
    with open(path, "w", newline="") as f:
        writer = csv.writer(f, lineterminator="\n")
        writer.writerow(table.columns)
        writer.writerows([_cell(row[c]) for c in table.columns] for row in table)


def main(argv: Optional[List[str]] = None) -> Table:
    """Write the table and return it."""
    argv = list(sys.argv[1:] if argv is None else argv)
    if len(argv) != 2:
        raise SystemExit("usage: python -m opensora_torch.cnv.meta INPUT(.csv|.jsonl|directory) OUTPUT.csv")
    src, dst = argv
    table = media_table(src) if os.path.isdir(src) else read_data_file(src)
    rows = []
    for row in table:
        meta = probe(row["path"])
        if meta is not None:
            rows.append({**row, **meta})
    out = Table(rows, list(table.columns) + [c for c in COLUMNS if c not in table.columns])
    write_table(out, dst)
    print(f"wrote {len(out)}/{len(table)} rows to {dst}")
    return out


if __name__ == "__main__":
    main()
