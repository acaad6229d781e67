"""Latent-statistics CLI of the PyTorch port (counterpart of
scripts/vae/stats.py): an encode-only pass that suggests the AE's
``scale_factor`` and ``shift_factor``.

    python -m opensora_torch.vae_stats configs/vae/inference/hunyuan_vae.py \\
        [--dotted.key value ...] [--device cpu]

The set-up of ``vae_inference.py`` (``eval_setting`` makes the bucket only
where the config has no ``bucket_config``, as in the JAX script), then each
batch encoded, the posterior's noise from the generator seeded with
``seed``; at most ``max_samples`` batches; the closing line gives the
latents' mean and std and the factors they suggest. ``main`` returns its
numbers.
"""

from __future__ import annotations

import sys
import time
from typing import List, Optional

import torch

from opensora_torch.vae_inference import LatentStats, _sync, prepare_vae_eval


@torch.inference_mode()
def main(argv: Optional[List[str]] = None) -> dict:
    argv = list(sys.argv[1:] if argv is None else argv)
    cfg, dataloader, ae, device, gen, logger = prepare_vae_eval(argv, lambda cfg: not cfg.get("bucket_config"))
    stats, seconds, clips, batches = LatentStats(), 0.0, 0, 0
    for i, batch in enumerate(dataloader):
        x = torch.as_tensor(batch["video"]).to(device, torch.float32)
        t0 = time.perf_counter()
        z = ae.encode(x, generator=gen)
        _sync(device)
        seconds += time.perf_counter() - t0
        clips += x.shape[0]
        batches += 1
        stats.add(z)
        if cfg.get("max_samples") and i + 1 >= cfg.max_samples:
            break
    res = dict(n_batches=batches, seconds_per_clip=seconds / max(clips, 1), **stats.result())
    logger.info("latent mean %.6f std %.6f -> scale_factor %.6f shift_factor %.6f; %.3f s per clip",
                res["latent_mean"], res["latent_std"], res["scale_factor"], res["shift_factor"],
                res["seconds_per_clip"])
    return res


if __name__ == "__main__":
    main()
