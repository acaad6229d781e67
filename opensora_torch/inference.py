"""Text/image-to-video generation CLI of the PyTorch port.

    python -m opensora_torch.inference configs/diffusion/inference/256px.py \\
        --prompt "a cat playing piano" [--sampling_option.num_steps N] \\
        [--num-sample k] [--motion-score s] [--refine-prompt] [--device cpu]

Prompts come from ``--prompt`` or from the file at ``dataset.data_path``
(``.csv`` or ``.jsonl``, read as the JAX package's text dataset reads it: a
``text`` column; a ``neg`` column gives a row's negative prompt in place of
the empty one; a ``ref`` column names each row's reference image or video
for the config's ``cond_type``: ``i2v_head``, ``i2v_tail``, ``i2v_loop``
(``head;tail``) or ``v2v_{head,tail}[_easy]``; an empty cell counts as
absent, and within a batch the first row's columns decide). The config's
``dataset.fps`` / ``dataset.motion_score`` suffixes are appended as the JAX
package's text dataset does. A config with ``img_flux`` (t2i2v, e.g.
``t2i2v_256px.py``, ``t2i2v_768px.py``) first makes each prompt's image
with the distilled image model (``sampling_option_t2i``), saves it as
``t2i_XXXX`` and conditions the video on it (``i2v_head``); on a card the
image models wait in host memory while the video is made. Each sample is
saved under ``save_dir`` as ``sample_XXXX`` (png for one frame, else mp4
at ``fps_save``; uint8 frames T, H, W, 3 in ``.npy`` where OpenCV is
absent) with the prompt in ``sample_XXXX.txt``. Runs on cuda unless
``--device`` names another device. A config's ``mesh`` (e.g.
``plugins/sp.py``, 768px.py's ``sp_size=-1``) builds a mesh over the
host's cards only when it has more than one, as the JAX script does; on
one card the run goes without a mesh.
"""

from __future__ import annotations

import logging
import os
import sys
import time
from typing import List, Optional

import torch


logger = logging.getLogger("opensora_torch")


def _pop_flag(argv: List[str], names, default=None):
    """Remove ``--flag value`` from argv and return the value."""
    for flag in names:
        if flag in argv:
            i = argv.index(flag)
            value = argv[i + 1]
            del argv[i:i + 2]
            return value
    return default


def _pop_refine(argv: List[str]) -> bool:
    """``--refine-prompt`` takes an optional true/false value; a following
    path (the config) is never taken as its value."""
    for flag in ("--refine-prompt", "--refine_prompt"):
        if flag in argv:
            i = argv.index(flag)
            nxt = argv[i + 1] if i + 1 < len(argv) else None
            if nxt is not None and nxt.lower() in ("1", "0", "true", "false", "yes", "no"):
                del argv[i:i + 2]
                return nxt.lower() in ("1", "true", "yes")
            del argv[i]
            return True
    return False


def text_dataset(cfg, prompt: Optional[str]):
    """The prompts as the JAX CLI reads them (scripts/diffusion/inference.py
    :79-99): ``--prompt`` as a one-row table with a text column alone, else
    the file at ``dataset.data_path`` (csv or jsonl), through the text
    dataset with the config's ``dataset.fps`` / ``dataset.motion_score``
    suffixes."""
    from opensora_torch.datasets.datasets import Table, TextDataset

    dataset = {k: v for k, v in (cfg.get("dataset", {}) or {}).items() if k != "type"}
    if prompt is not None:
        dataset.update(data_path=None, table=Table([{"text": prompt}], ["text"]))
    elif dataset.get("data_path") is None:
        raise ValueError("no prompts: give --prompt or --dataset.data_path")
    return TextDataset(**dataset)


def prompt_batches(data, batch_size: int):
    """The dataset's items in order, ``batch_size`` at a time, each batch
    collated as the JAX package's loader collates it (opensora_tpu/datasets/
    dataloader.py:26-40): the keys of its first item decide, so a ``ref`` or
    ``neg`` that the first row lacks is dropped for the batch, and a later
    row that lacks one the first row has raises."""
    from opensora_torch.datasets.dataloader import collate_fn_default

    for b0 in range(0, len(data), batch_size):
        items = [data[i] for i in range(b0, min(b0 + batch_size, len(data)))]
        try:
            yield collate_fn_default(items)
        except KeyError as e:
            raise KeyError(f"rows {b0}-{b0 + len(items) - 1} of one batch: row {b0} has {e}, a later row has "
                           f"none (the JAX package's collate fails alike)") from None


DEFAULT_T2I_OPTION = dict(resolution="768px", aspect_ratio="1:1", num_frames=1, method="distill")


def prepare_image_stage(cfg, optional: dict, model_t5, model_clip, patch_size: int = 2):
    """The t2i2v image stage of a config with ``img_flux``: ``(api_fn_img,
    opt_img)``, the distilled image model's ``api_fn`` over the Flux AE (its
    pixels per token edge read from the AE) and the sampling option from
    ``sampling_option_t2i`` (768px 1:1, one frame, distilled by default)."""
    from opensora_torch.utils.api import prepare_api
    from opensora_torch.utils.config import ae_spatial_compression
    from opensora_torch.utils.sampling import SamplingOption, sanitize_sampling_option

    img_ae = optional["img_flux_ae"]
    api_fn_img = prepare_api(optional["img_flux"], img_ae, model_t5, model_clip,
                             spatial_compression=img_ae.spatial_compression_ratio * patch_size)
    # the image's size snaps to the config's compression, as the video's does
    opt_img = sanitize_sampling_option(SamplingOption(**cfg.get("sampling_option_t2i", DEFAULT_T2I_OPTION)),
                                       ae_spatial_compression(cfg))
    return api_fn_img, opt_img


def make_reference_images(api_fn_img, opt_img, texts: List[str], save_dir: str, first_idx: int, channel: int,
                          patch_size: int = 2, timings: Optional[dict] = None) -> List[str]:
    """The t2i2v image stage: one image per prompt from the distilled image
    model's ``api_fn_img``, saved as ``save_dir/t2i_XXXX`` from
    ``first_idx``; returns the paths, the video's references."""
    from opensora_torch.utils.inference import save_sample

    imgs = api_fn_img(opt_img, cond_type="t2v", text=texts, patch_size=patch_size, channel=channel,
                      timings=timings).cpu().numpy()
    return [save_sample(imgs[i], os.path.join(save_dir, f"t2i_{first_idx + i:04d}")) for i in range(len(texts))]


def parks_image_stage(device) -> bool:
    """Whether the t2i2v flow parks its image models in host memory while
    the video is made: on a card, since t2i2v_768px.py runs out of an 80 GB
    H100's memory with every model resident (PERF.md, chip_smoke.py phase
    19). On the CPU the host is the device."""
    return torch.device(device).type == "cuda"


# host memory left to the process after parking (its buffers, the decoded
# videos and the samples it saves)
HOST_MARGIN_BYTES = 4 << 30


class ImageStage:
    """The t2i2v image stage as the CLI runs it for each batch: the image
    models (``img_flux``, ``img_flux_ae``) brought back to their device if
    parked, one image per prompt (``make_reference_images``), then the
    models parked in host memory (``utils.api.offload_to_host``) where
    ``parks_image_stage`` says so and the host has room, so that the video
    stage has the card's memory. ``timings`` receives the image stage's
    times and ``load_s`` / ``park_s``, ``parked_gb`` and
    ``host_available_gb`` (read before parking)."""

    def __init__(self, cfg, optional: dict, model_t5, model_clip, patch_size: int = 2):
        self.api_fn, self.opt = prepare_image_stage(cfg, optional, model_t5, model_clip, patch_size)
        self.models = (optional["img_flux"], optional["img_flux_ae"])
        self.device = next(self.models[0].parameters()).device
        self.channel, self.patch_size = cfg["img_flux"]["in_channels"], patch_size
        self.park, self.parked = parks_image_stage(self.device), False

    def __call__(self, texts: List[str], save_dir: str, first_idx: int, timings: Optional[dict] = None) -> List[str]:
        from opensora_torch.utils.api import load_to_device

        timings = {} if timings is None else timings
        if self.parked:
            t0 = time.perf_counter()
            moved = sum(load_to_device(m, self.device) for m in self.models)
            timings["load_s"] = time.perf_counter() - t0
            self.parked = False
            logger.info("image models back on %s: %.2f GB in %.2f s", self.device, moved / 1e9, timings["load_s"])
        refs = make_reference_images(self.api_fn, self.opt, texts, save_dir, first_idx, self.channel,
                                     self.patch_size, timings)
        if self.park:
            self._park(timings)
        return refs

    def _park(self, timings: dict) -> None:
        from opensora_torch.utils.api import host_available_bytes, offload_to_host

        need = sum(t.numel() * t.element_size() for m in self.models for t in (*m.parameters(), *m.buffers()))
        available = host_available_bytes()
        timings["host_available_gb"] = None if available is None else available / 1e9
        logger.info("host memory available: %s GB; the image models hold %.2f GB",
                    "unknown" if available is None else f"{available / 1e9:.2f}", need / 1e9)
        if available is not None and available < need + HOST_MARGIN_BYTES:
            logger.warning("too little host memory to park the image models: they stay on %s", self.device)
            self.park = False
            return
        t0 = time.perf_counter()
        parked = sum(offload_to_host(m) for m in self.models)
        timings["park_s"], timings["parked_gb"] = time.perf_counter() - t0, parked / 1e9
        self.parked = True
        logger.info("image models parked in host memory: %.2f GB in %.2f s", parked / 1e9, timings["park_s"])


def inference_mesh(cfg, device):
    """The config's ``mesh`` over the host's cards, or None: as the JAX
    script (scripts/diffusion/inference.py:106-112), only where there is
    more than one device; a config that asks for one (768px.py's
    ``sp_size=-1``) runs without a mesh on one card or on the CPU."""
    if cfg.get("mesh") is None:
        return None
    n = torch.cuda.device_count() if torch.device(device).type == "cuda" else 1
    if n <= 1:
        logger.info("config mesh %s: one device, so no mesh", dict(cfg.mesh))
        return None
    from opensora_torch.parallel.mesh import MeshConfig, create_mesh

    mesh = create_mesh(MeshConfig(**cfg.mesh))
    logger.info("inference mesh: %s", mesh)
    return mesh


def main(argv: Optional[List[str]] = None) -> List[str]:
    """Run the CLI; returns the saved sample paths."""
    from opensora_torch.utils.api import prepare_api, prepare_models
    from opensora_torch.utils.config import ae_spatial_compression, parse_configs
    from opensora_torch.utils.inference import add_motion_score_to_text, process_and_save
    from opensora_torch.utils.sampling import SamplingOption, sanitize_sampling_option

    logging.basicConfig(level=logging.INFO, format="[%(asctime)s] %(levelname)s %(message)s")
    argv = list(sys.argv[1:] if argv is None else argv)
    prompt = _pop_flag(argv, ("--prompt",))
    motion_score = _pop_flag(argv, ("--motion-score", "--motion_score"))
    refine = _pop_refine(argv)
    num_sample = int(_pop_flag(argv, ("--num-sample", "--num_sample"), default=1))
    device = _pop_flag(argv, ("--device",))

    cfg = parse_configs(argv)
    data = text_dataset(cfg, prompt)
    model, ae, t5, clip, optional = prepare_models(cfg, device=device, seed=cfg.get("seed", 42))
    model_device = next(model.parameters()).device
    logger.info("models on %s", model_device)
    mesh = inference_mesh(cfg, model_device)
    compression = ae_spatial_compression(cfg)
    api_fn = prepare_api(model, ae, t5, clip, spatial_compression=compression, mesh=mesh)
    opt = sanitize_sampling_option(SamplingOption(**cfg.get("sampling_option", {})), compression)
    cond_type = cfg.get("cond_type", "t2v")
    save_dir = cfg.get("save_dir", "samples")
    patch_size = cfg.get("patch_size", 2)

    image_stage = None
    if "img_flux" in optional:  # t2i2v, as scripts/diffusion/inference.py:120-171
        image_stage = ImageStage(cfg, optional, t5, clip, patch_size)
        cond_type = "i2v_head"

    paths, sample_idx = [], 0
    for batch in prompt_batches(data, cfg.get("batch_size", 1)):
        texts, refs, neg = list(batch["text"]), batch.get("ref"), batch.get("neg")
        if refine:
            logger.info("--refine-prompt: no prompt refiner is available offline; prompts unchanged")
        if motion_score is not None:
            texts = add_motion_score_to_text(texts, motion_score)
        if image_stage is not None and refs is None:
            # one image per batch, made without the batch's neg; --num-sample varies the video's seed
            refs = image_stage(texts, save_dir, sample_idx)
            logger.info("t2i2v reference images: %s", refs)
        base_seed = opt.seed if opt.seed is not None else 42
        for j in range(num_sample):
            t0 = time.perf_counter()
            x = api_fn(opt, cond_type=cond_type, seed=base_seed + j if num_sample > 1 else None, text=texts,
                       neg=neg, patch_size=patch_size, channel=cfg["model"]["in_channels"], ref=refs)
            x = x.cpu().numpy()
            ids = list(range(sample_idx, sample_idx + len(texts)))
            saved = process_and_save(x, ids, save_dir, fps=cfg.get("fps_save", 16), prompts=texts)
            logger.info("generated %s in %.2f s: %s", tuple(x.shape), time.perf_counter() - t0, saved)
            paths += saved
            sample_idx += len(texts)
    return paths


if __name__ == "__main__":
    main()
