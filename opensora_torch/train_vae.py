"""VAE/GAN training CLI of the PyTorch port (counterpart of
scripts/vae/train.py).

    python -m opensora_torch.train_vae configs/vae/train/video_dc_ae_disc.py \\
        [--dotted.key value ...] [--device cpu]

The same configs and overrides as the JAX script: a bucketed video
dataloader; the autoencoder of ``model`` (``dc_ae``, or ``hunyuan_vae``
with ``--model.type hunyuan_vae``: the HunyuanVAE builder drops the keys it
does not know) with random weights from ``seed`` in fp32 master weights
under the config's compute ``dtype`` (``from_pretrained`` is not ported
and raises); the 3D discriminator with its own AdamW when
``discriminator`` is set; LPIPS only when ``vgg_ckpt`` names a file on
disk; the ``mixed_strategy`` truncations drawn from a numpy
``default_rng(seed)``; the EMA; logging to ``<outputs>/<exp_name>/log.txt``;
a checkpoint every ``ckpt_every`` steps and at the end. Beyond the JAX
script: ``--load <ckpt dir>`` resumes, and ``grad_checkpoint = True``
recomputes the AE in the backward. As in the JAX script, the step takes
its default adversarial weight (0.5): the config's ``disc_weight`` is not
read.

:class:`VAETrainer` holds the models and the train state;
:meth:`VAETrainer.run_batch` is the body of one iteration and what
``chip_smoke.py`` drives on the card. Runs on cuda unless ``--device``
names another device.

The HunyuanVAE maps 4k + 1 frames to k + 1 latent frames and back; at any
other frame count its reconstruction has fewer frames than the input and
the loss fails, as in the JAX package: train it with a (4k + 1)-frame
bucket or ``mixed_strategy = dict(random_truncate=True)``.
"""

from __future__ import annotations

import math
import os
import sys
from typing import Dict, List, Optional

import numpy as np
import torch

from opensora_torch.inference import _pop_flag


class VAETrainer:
    """The autoencoder, discriminator, perceptual loss, train state and the
    per-batch body of the training loop."""

    def __init__(self, cfg, device=None):
        import opensora_torch.models.vae2d.discriminator  # noqa: F401  (registers the discriminator)
        from opensora_torch.registry import MODELS, build_module
        from opensora_torch.training.vae import VAETrainState, ae_parameters, make_vae_train_step
        from opensora_torch.utils.ckpt import init_ae
        from opensora_torch.utils.logger import create_logger
        from opensora_torch.utils.misc import Timers, count_params, format_numel, resolve_device
        from opensora_torch.utils.optimizer import create_optimizer

        self.cfg = cfg
        self.logger = create_logger()
        self.device = resolve_device(device)
        seed = cfg.get("seed", 42)
        # fp32 master weights under the compute dtype, the JAX modules' default
        self.ae = init_ae(dict(cfg.model), self.device, seed,
                          param_dtype=cfg.model.get("param_dtype") or "fp32").train()
        logvar = torch.nn.Parameter(torch.zeros((), device=self.device))
        params = ae_parameters(self.ae, logvar)
        self.logger.info("AE (%s) params: %s on %s", cfg.model["type"], format_numel(count_params(params.values())),
                         self.device)

        self.disc = None
        disc_opt = None
        if cfg.get("discriminator") is not None:
            with torch.random.fork_rng(devices=[self.device] if self.device.type == "cuda" else []):
                torch.manual_seed(seed)
                self.disc = build_module(dict(cfg.discriminator), MODELS, device=self.device)
            disc_opt = create_optimizer(self.disc.parameters(), lr=cfg.get("disc_lr", 1e-5))

        # the perceptual term only when the VGG weights are on disk
        self.lpips = None
        if cfg.get("vgg_ckpt") and os.path.exists(cfg.vgg_ckpt):
            from opensora_torch.models.vae2d.lpips import load_lpips

            self.lpips = load_lpips(cfg.vgg_ckpt, cfg.get("lpips_ckpt"), self.device)
            self.logger.info("LPIPS from %s (heads: %s)", cfg.vgg_ckpt, cfg.get("lpips_ckpt") or "1 / C")

        optimizer = create_optimizer(params.values(), lr=cfg.get("lr", 1e-5))
        self.state = VAETrainState.create(params, optimizer, self.disc, disc_opt, ema=True)
        self.train_step = make_vae_train_step(
            self.ae, self.disc, perceptual_loss_fn=self.lpips,
            kl_loss_weight=cfg.get("kl_loss_weight", 5e-4), gen_start=cfg.get("gen_start", 2001),
            disc_start=cfg.get("disc_start", 2001), disc_loss_type=cfg.get("disc_loss_type", "hinge"),
            use_discriminator=self.disc is not None, grad_checkpoint=cfg.get("grad_checkpoint", False),
        )
        self.gen = torch.Generator(device=self.device).manual_seed(seed)
        self.host_rng = np.random.default_rng(seed)
        self.timers = Timers(sync=self.device.type == "cuda")

    def truncate(self, video):
        """The ``mixed_strategy`` of a (B, C, T, H, W) batch (array or
        tensor): an image-only batch with probability ``image_prob``, else
        (with ``random_truncate``) the first t frames, t = 1 or 1 mod the
        time compression, drawn uniformly."""
        mixed = self.cfg.get("mixed_strategy")
        if not mixed or video.shape[2] <= 1:
            return video
        if self.host_rng.random() < mixed.get("image_prob", 0.0):
            return video[:, :, :1]
        if mixed.get("random_truncate", False):
            tcr = self.ae.config.time_compression_ratio
            choices = [t for t in range(1, video.shape[2] + 1) if t == 1 or (t - 1) % tcr == 0]
            return video[:, :, : int(self.host_rng.choice(choices))]
        return video

    def run_batch(self, batch: Dict) -> Dict[str, torch.Tensor]:
        """One iteration on a collated batch with ``video`` (B, 3, T, H, W)
        in [-1, 1]; returns the step's metrics (0-d tensors on the device)."""
        video = torch.as_tensor(self.truncate(batch["video"])).to(self.device, torch.float32)
        with self.timers("step"):
            return self.train_step(self.state, {"video": video}, self.gen)


def main(argv: Optional[List[str]] = None) -> VAETrainer:
    """Run the CLI; returns the trainer after the last step."""
    import opensora_torch.datasets.datasets  # noqa: F401  (registers the datasets)
    from opensora_torch.datasets.dataloader import prepare_dataloader
    from opensora_torch.registry import DATASETS, build_module
    from opensora_torch.utils.ckpt import CheckpointIO
    from opensora_torch.utils.config import create_experiment_workspace, parse_configs
    from opensora_torch.utils.logger import create_logger

    argv = list(sys.argv[1:] if argv is None else argv)
    device = _pop_flag(argv, ("--device",))
    cfg = parse_configs(argv)
    exp_dir = create_experiment_workspace(cfg)
    logger = create_logger(exp_dir)
    logger.info("experiment dir: %s", exp_dir)

    dataset = build_module(dict(cfg.dataset), DATASETS)
    dataloader, sampler = prepare_dataloader(
        dataset, bucket_config=cfg.get("bucket_config"), batch_size=cfg.get("batch_size"), seed=cfg.get("seed", 42),
    )
    trainer = VAETrainer(cfg, device)
    ckpt_io = CheckpointIO()
    start_epoch = global_step = 0
    if cfg.get("load"):
        _, running, _ = ckpt_io.load(cfg.load, trainer.state)
        start_epoch, global_step = running["epoch"] + 1, running["global_step"]
        logger.info("resumed at epoch %d global_step %d", start_epoch, global_step)

    epochs = cfg.get("epochs", 1)
    log_every, ckpt_every = cfg.get("log_every", 1), cfg.get("ckpt_every", 1000)
    for epoch in range(start_epoch, epochs):
        sampler.set_epoch(epoch)
        for batch in dataloader:
            metrics = trainer.run_batch(batch)
            global_step += 1
            if global_step % log_every == 0:
                loss = float(metrics["loss"])
                if not math.isfinite(loss):
                    logger.warning("non-finite loss at global step %d", global_step)
                logger.info("epoch %d step %d loss %.4f recon %.4f kl %.6f disc %.4f %s", epoch, global_step, loss,
                            float(metrics["recon_loss"]), float(metrics["kl_loss"]), float(metrics["disc_loss"]),
                            trainer.timers.to_dict())
            if global_step % ckpt_every == 0:
                logger.info("checkpoint saved to %s",
                            ckpt_io.save(exp_dir, trainer.state, epoch, global_step, global_step))
    d = ckpt_io.save(exp_dir, trainer.state, epochs - 1, global_step, global_step)
    logger.info("checkpoint saved to %s", d)
    logger.info("done")
    return trainer


if __name__ == "__main__":
    main()
