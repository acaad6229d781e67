"""Evaluation CLI of the PyTorch port (counterpart of scripts/eval.py): VAE
reconstruction metrics and VBench-style generation metrics over a directory
of samples.

    python -m opensora_torch.evaluate --samples DIR [--clip DIR] \\
        [--aesthetic FILE] [--suite vbench] [--suite-dir DIR] \\
        [--emit-prompts CSV] [--device cpu]

Samples are ``.mp4`` / ``.png`` (read through OpenCV, which must then be
installed) and the port's ``.npy`` samples (uint8 frames (T, H, W, 3),
which ``save_sample`` writes where OpenCV is absent), each with its prompt
in a ``.txt`` beside it and optionally a ``.json`` sidecar naming
detection slots (``object``, ``objects``, ``color_object``, ``scene``,
``action``, ``spatial``, or a suite ``dimension``). ``--clip`` names a
local HF CLIPModel checkpoint (skipped if absent), ``--aesthetic`` the
LAION predictor's state dict (needs ``--clip`` too). Pooled metrics by
default; ``--suite vbench`` scores each dimension over its own prompt
suite; ``--emit-prompts`` with ``--suite`` writes the suites' prompts and
exits. ``_orig`` / ``_recn`` pairs add ``recon_psnr`` / ``recon_ssim``. The
JSON report is printed (and returned by :func:`main`). Runs on cuda unless
``--device`` names another device. The decoded samples stay on the host,
as uint8; each video moves to the device only while it is scored, so the
card's memory does not grow with the number of samples.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from collections.abc import Sequence
from typing import List, Optional

import numpy as np
import torch

SAMPLE_EXTENSIONS = (".mp4", ".png", ".npy")


def load_frames(path: str) -> torch.Tensor:
    """A sample file -> (C, T, H, W) uint8 frames on the host."""
    from opensora_torch.datasets.utils import read_image, read_sample, read_video

    if path.endswith(".npy"):
        media = read_sample(path)
    else:
        try:
            import cv2  # noqa: F401
        except ImportError:
            raise RuntimeError(f"{path}: reading .mp4 / .png samples needs OpenCV, which is not installed (the "
                               "port's save_sample writes .npy samples where it is absent)") from None
        media = read_image(path) if path.endswith(".png") else read_video(path)[0]
    return torch.from_numpy(media.astype(np.uint8))  # the readers give whole numbers in [0, 255]


def to_video(frames: torch.Tensor, device) -> torch.Tensor:
    """uint8 frames -> (C, T, H, W) float32 in [-1, 1] on ``device``."""
    return frames.to(device).float() / 127.5 - 1.0


class DeviceVideos(Sequence):
    """Host uint8 samples, each moved to ``device`` in [-1, 1] when it is
    indexed (``evaluate_videos`` and ``evaluate_suite`` index a video only
    while they score it)."""

    def __init__(self, frames: List[torch.Tensor], device):
        self.frames, self.device = frames, device

    def __len__(self) -> int:
        return len(self.frames)

    def __getitem__(self, i: int) -> torch.Tensor:
        return to_video(self.frames[i], self.device)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="VAE reconstruction + VBench-style metrics over a sample dir")
    p.add_argument("--samples", default="samples", help="directory of .mp4/.png/.npy samples")
    p.add_argument("--prompts", default=None, help="unused placeholder (prompts are read from per-sample .txt files)")
    p.add_argument("--clip", default="./ckpts/clip-vit-large-patch14",
                   help="local HF CLIPModel checkpoint for clip_score (skipped if absent)")
    p.add_argument("--aesthetic", default="./ckpts/aesthetic_predictor.pth",
                   help="LAION aesthetic-predictor state dict for aesthetic_quality "
                        "(skipped if absent; needs --clip too)")
    p.add_argument("--suite", default=None, choices=["vbench"],
                   help="score each dimension over its OWN prompt suite (opensora_torch/eval/suites.py)")
    p.add_argument("--suite-dir", default=None,
                   help="suite directory (default data/vbench_suites; <dim>.official.txt files there take precedence)")
    p.add_argument("--emit-prompts", default=None, metavar="CSV",
                   help="with --suite: write every dimension's prompts to CSV (columns text,dimension), then exit")
    p.add_argument("--device", default=None, help="device to run on (default cuda)")
    return p


def _sidecar(stem: str, ext: str):
    """The sample's ``.txt`` (its prompt; "" when absent) or ``.json`` (None when absent)."""
    if not os.path.exists(stem + ext):
        return "" if ext == ".txt" else None
    with open(stem + ext) as f:
        return f.read() if ext == ".txt" else json.load(f)


def main(argv: Optional[List[str]] = None) -> dict:
    from opensora_torch.utils.misc import resolve_device

    parser = build_parser()
    args = parser.parse_args(argv)
    if args.suite and args.emit_prompts:
        from opensora_torch.eval.suites import emit_prompts_csv

        report = {"prompts_written": emit_prompts_csv(args.emit_prompts, suite_dir=args.suite_dir),
                  "path": args.emit_prompts}
        print(json.dumps(report))
        return report
    if not os.path.isdir(args.samples):
        parser.error(f"sample directory not found: {args.samples!r} (pass --samples)")
    device = resolve_device(args.device)
    from opensora_torch.eval.aesthetic import try_load_head
    from opensora_torch.eval.clip_scorer import try_load_scorer
    from opensora_torch.eval.metrics import psnr, ssim_video
    from opensora_torch.eval.vbench import evaluate_videos

    files = sorted(f for f in os.listdir(args.samples) if f.endswith(SAMPLE_EXTENSIONS))
    frames, texts, meta = [], [], []
    for f in files:
        frames.append(load_frames(os.path.join(args.samples, f)))
        stem = os.path.join(args.samples, f.rsplit(".", 1)[0])
        texts.append(_sidecar(stem, ".txt"))
        meta.append(_sidecar(stem, ".json"))
    videos = DeviceVideos(frames, device)
    if not files:
        report = {"error": f"no samples in {args.samples}"}
        print(json.dumps(report))
        return report

    scorer = try_load_scorer(args.clip, device)
    head = try_load_head(args.aesthetic, device)
    if args.suite:
        from opensora_torch.eval.suites import evaluate_suite

        report = evaluate_suite(videos, texts, clip_scorer=scorer, aesthetic_head=head, suite_dir=args.suite_dir,
                                meta=meta)
    else:
        report = evaluate_videos(videos, texts, clip_scorer=scorer, aesthetic_head=head, meta=meta)
    report["num_samples"] = len(videos)

    # paired orig / recn samples (the VAE inference's output) -> reconstruction metrics
    pairs = [(f, f.replace("_orig", "_recn")) for f in files if "_orig" in f and f.replace("_orig", "_recn") in files]
    if pairs:
        ps, ss = [], []
        for a, b in pairs:
            va, vb = videos[files.index(a)], videos[files.index(b)]
            ps.append(psnr(va, vb))
            ss.append(ssim_video(va, vb))
        report["recon_psnr"] = float(np.mean(ps))
        report["recon_ssim"] = float(np.mean(ss))
    print(json.dumps(report, indent=2))
    return report


if __name__ == "__main__":
    main(sys.argv[1:])
