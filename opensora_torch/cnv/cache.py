"""Video latents and text embeddings for the cached training path
(counterpart of scripts/cnv/cache.py).

    python -m opensora_torch.cnv.cache CONFIG --out_dir DIR [--dotted.key value ...] [--device cpu]

The config's dataset, read through its bucket dataloader in order
(``shuffle=False``). The AE, T5 and CLIP are built as the training CLI
builds them (``utils.api.build_encoders``, which ``prepare_models``
calls), each loaded from its ``from_pretrained``: the JAX script encodes
with a random AE whatever the config names (ROADMAP R13). An encoder
without a checkpoint is drawn from ``seed`` (a warning says so); its draws
are not the training CLI's, which come after the MMDiT's. Each clip is encoded as a sample of
its posterior, the noise drawn from a ``torch.Generator`` on the device
seeded with ``seed``, and its text through T5 and CLIP. Written under
``out_dir``: ``lat_/t5_/clip_{n:06d}.npy`` (fp32) and ``cache_meta.csv``
(``latent_path, t5_path, clip_path, text, shape``), which
``datasets.CachedVideoTextDataset`` and ``cached_video=True`` read. Runs
on cuda unless ``--device`` names another device.
"""

from __future__ import annotations

import csv
import logging
import os
import sys
from typing import List, Optional

import numpy as np
import torch

from opensora_torch.utils.logger import LOGGER_NAME

META_COLUMNS = ("latent_path", "t5_path", "clip_path", "text", "shape")


def build_encoders(cfg, device, seed: int):
    """(ae, t5, clip) of the config on ``device`` as ``prepare_models``
    builds them (``utils.api.build_encoders``), the random ones drawn from
    ``seed``."""
    from opensora_torch.utils import api

    for name in ("ae", "t5", "clip"):
        path = cfg[name].get("from_pretrained")
        if not path or not os.path.exists(path):
            logging.getLogger(LOGGER_NAME).warning(
                "%s has no checkpoint on disk (from_pretrained=%r): its outputs come from random weights drawn from "
                "seed %d", name, path, seed)
    with torch.random.fork_rng(devices=[device] if device.type == "cuda" else []):
        torch.manual_seed(seed)
        return api.build_encoders(cfg, device)


@torch.inference_mode()
def main(argv: Optional[List[str]] = None) -> str:
    """Write the cache; returns the path of ``cache_meta.csv``."""
    import opensora_torch.datasets.datasets  # noqa: F401  (registers the datasets)
    from opensora_torch.datasets.dataloader import prepare_dataloader
    from opensora_torch.inference import _pop_flag
    from opensora_torch.registry import DATASETS, build_module
    from opensora_torch.utils.config import ae_spatial_compression, parse_configs
    from opensora_torch.utils.logger import create_logger
    from opensora_torch.utils.misc import resolve_device

    argv = list(sys.argv[1:] if argv is None else argv)
    device = resolve_device(_pop_flag(argv, ("--device",)))
    cfg = parse_configs(argv)
    logger = create_logger()
    out_dir = cfg.get("out_dir", "data/cache")
    os.makedirs(out_dir, exist_ok=True)
    seed = cfg.get("seed", 42)

    dataset = build_module(dict(cfg.dataset), DATASETS)
    dataloader, _ = prepare_dataloader(dataset, bucket_config=cfg.get("bucket_config"),
                                       batch_size=cfg.get("batch_size", 1), shuffle=False, seed=seed,
                                       spatial_compression=ae_spatial_compression(cfg))
    ae, t5, clip = build_encoders(cfg, device, seed)
    gen = torch.Generator(device=device).manual_seed(seed)

    rows, n = [], 0
    for batch in dataloader:
        texts = list(batch["text"])
        x = torch.as_tensor(batch["video"]).to(device, torch.float32)
        # fp32 on disk: numpy has no bfloat16
        latents = ae.encode(x, generator=gen).float().cpu().numpy()
        t5_emb = t5(texts).float().cpu().numpy()
        clip_emb = clip(texts).float().cpu().numpy()
        for i in range(latents.shape[0]):
            paths = [os.path.join(out_dir, f"{kind}_{n:06d}.npy") for kind in ("lat", "t5", "clip")]
            for p, a in zip(paths, (latents[i], t5_emb[i], clip_emb[i])):
                np.save(p, a)
            rows.append([*paths, texts[i], "x".join(str(d) for d in latents[i].shape)])
            n += 1
            if n % 100 == 0:
                logger.info("cached %d samples", n)
    meta = os.path.join(out_dir, "cache_meta.csv")
    with open(meta, "w", newline="") as f:
        writer = csv.writer(f, lineterminator="\n")
        writer.writerow(META_COLUMNS)
        writer.writerows(rows)
    logger.info("done: %d samples -> %s", n, out_dir)
    return meta


if __name__ == "__main__":
    main()
