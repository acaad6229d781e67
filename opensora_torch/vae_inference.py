"""VAE reconstruction CLI of the PyTorch port (counterpart of
scripts/vae/inference.py).

    python -m opensora_torch.vae_inference configs/vae/inference/hunyuan_vae.py \\
        [--dotted.key value ...] [--device cpu]

The same configs and overrides as the JAX script: ``eval_setting`` "TxS"
makes one bucket of T frames at S px (``batch_size`` a batch); the bucketed
dataloader over ``dataset``, in order; the autoencoder of ``model``, loaded
from ``model.from_pretrained`` or random from ``seed``; each batch through
the AE's forward with the posterior's noise from a generator seeded with
``seed`` (one generator for the whole run, drawn batch after batch); PSNR
of each batch (data range 2, the reconstruction clipped to [-1, 1]); the
first ``num_save`` batches' first clip and its reconstruction saved under
``save_dir`` as ``XXXX_orig`` / ``XXXX_recn``; at most ``max_samples``
batches; and the closing line: mean PSNR, the latents' mean and std and
the ``scale_factor`` (1 / std) and ``shift_factor`` (mean) they suggest.
Runs on cuda unless ``--device`` names another device. ``main`` returns
the numbers of the closing line (``vae_stats.py`` shares this module's
set-up and statistics).
"""

from __future__ import annotations

import math
import os
import sys
import time
from typing import List, Optional

import torch

from opensora_torch.inference import _pop_flag


class LatentStats:
    """Running mean and standard deviation of every latent value, summed in
    float64."""

    def __init__(self):
        self.total = self.sq = 0.0
        self.count = 0

    def add(self, z: torch.Tensor) -> None:
        z = z.detach().double()
        self.total += float(z.sum())
        self.sq += float((z * z).sum())
        self.count += z.numel()

    def result(self) -> dict:
        mean = self.total / max(self.count, 1)
        std = math.sqrt(max(self.sq / max(self.count, 1) - mean**2, 0.0))
        return dict(latent_mean=mean, latent_std=std, scale_factor=1.0 / std if std else math.inf,
                    shift_factor=mean, latent_count=self.count)


def psnr(x: torch.Tensor, rec: torch.Tensor, data_range: float = 2.0) -> float:
    """PSNR in dB of ``rec`` clipped to [-1, 1] against ``x``."""
    mse = float(torch.mean((x.double() - rec.float().clamp(-1, 1).double()) ** 2))
    return math.inf if mse == 0 else 10.0 * math.log10(data_range**2 / mse)


def prepare_vae_eval(argv: List[str], bucket_from_eval_setting):
    """(cfg, dataloader, ae, device, generator, logger) of a VAE eval CLI:
    the config, the one-bucket dataloader ``bucket_from_eval_setting(cfg)``
    allows, the AE and the posterior's generator from ``seed``."""
    import opensora_torch.datasets.datasets  # noqa: F401  (registers the datasets)
    from opensora_torch.datasets.dataloader import prepare_dataloader
    from opensora_torch.registry import DATASETS, build_module
    from opensora_torch.utils.ckpt import init_ae
    from opensora_torch.utils.config import ae_spatial_compression, parse_configs
    from opensora_torch.utils.logger import create_logger
    from opensora_torch.utils.misc import resolve_device

    device = resolve_device(_pop_flag(argv, ("--device",)))
    cfg = parse_configs(argv)
    logger = create_logger()
    if cfg.get("eval_setting") and bucket_from_eval_setting(cfg):
        t, s = (int(v) for v in cfg.eval_setting.split("x"))
        cfg["bucket_config"] = {f"{s}px": {t: (1.0, cfg.get("batch_size", 1))}}
    dataset = build_module(dict(cfg.dataset), DATASETS)
    dataloader, _ = prepare_dataloader(dataset, bucket_config=cfg.get("bucket_config"),
                                       batch_size=cfg.get("batch_size", 1), shuffle=False,
                                       spatial_compression=ae_spatial_compression(cfg))
    seed = cfg.get("seed", 42)
    ae = init_ae(dict(cfg.model), device, seed).eval().requires_grad_(False)
    logger.info("AE (%s) %s on %s", cfg.model["type"],
                f"from {cfg.model['from_pretrained']}" if cfg.model.get("from_pretrained") else "random", device)
    return cfg, dataloader, ae, device, torch.Generator(device=device).manual_seed(seed), logger


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@torch.inference_mode()
def main(argv: Optional[List[str]] = None) -> dict:
    """Run the CLI; returns per-batch PSNR, the closing line's numbers and
    the AE's seconds per clip."""
    from opensora_torch.utils.inference import save_sample

    argv = list(sys.argv[1:] if argv is None else argv)
    cfg, dataloader, ae, device, gen, logger = prepare_vae_eval(argv, lambda cfg: True)
    save_dir = cfg.get("save_dir", "samples/vae")
    os.makedirs(save_dir, exist_ok=True)
    stats, psnrs, seconds, clips = LatentStats(), [], 0.0, 0
    for i, batch in enumerate(dataloader):
        x = torch.as_tensor(batch["video"]).to(device, torch.float32)
        t0 = time.perf_counter()
        rec, _, z = ae(x, generator=gen)
        _sync(device)
        seconds += time.perf_counter() - t0
        clips += x.shape[0]
        psnrs.append(psnr(x, rec))
        stats.add(z)
        if i < cfg.get("num_save", 4):
            save_sample(x[0].cpu().numpy(), os.path.join(save_dir, f"{i:04d}_orig"))
            save_sample(rec[0].float().clamp(-1, 1).cpu().numpy(), os.path.join(save_dir, f"{i:04d}_recn"))
        logger.info("sample %d PSNR %.2f dB", i, psnrs[-1])
        if cfg.get("max_samples") and i + 1 >= cfg.max_samples:
            break
    res = dict(psnr=psnrs, psnr_mean=sum(psnrs) / max(len(psnrs), 1), n_batches=len(psnrs),
               seconds_per_clip=seconds / max(clips, 1), **stats.result())
    logger.info("PSNR mean %.3f dB over %d samples; latent mean %.4f std %.4f (suggested scale_factor %.6f, "
                "shift_factor %.6f); %.3f s per clip", res["psnr_mean"], len(psnrs), res["latent_mean"],
                res["latent_std"], res["scale_factor"], res["shift_factor"], res["seconds_per_clip"])
    return res


if __name__ == "__main__":
    main()
