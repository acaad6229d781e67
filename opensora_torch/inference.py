"""Text/image-to-video generation CLI of the PyTorch port.

    python -m opensora_torch.inference configs/diffusion/inference/256px.py \\
        --prompt "a cat playing piano" [--sampling_option.num_steps N] \\
        [--num-sample k] [--motion-score s] [--refine-prompt] [--device cpu]

Prompts come from ``--prompt`` or from the CSV at ``dataset.data_path``
(a ``text`` column; a ``ref`` column names each row's reference image or
video for the config's ``cond_type``: ``i2v_head``, ``i2v_tail``,
``i2v_loop`` (``head;tail``) or ``v2v_{head,tail}[_easy]``). The config's
``dataset.fps`` / ``dataset.motion_score`` suffixes are appended as the JAX
package's text dataset does. A config with ``img_flux`` (t2i2v, e.g.
``t2i2v_256px.py``) first makes each prompt's image with the distilled
image model (``sampling_option_t2i``), saves it as ``t2i_XXXX`` and
conditions the video on it (``i2v_head``). Each sample is saved under
``save_dir`` as ``sample_XXXX`` (png for one frame, else mp4 at
``fps_save``; uint8 frames T, H, W, 3 in ``.npy`` where OpenCV is absent)
with the prompt in ``sample_XXXX.txt``. Runs on cuda unless ``--device``
names another device. A config's ``mesh`` (e.g. ``plugins/sp.py``) builds a
mesh over the host's cards only when it has more than one, as the JAX
script does; on one card the run goes without a mesh.
"""

from __future__ import annotations

import csv
import logging
import os
import sys
import time
from typing import List, Optional


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


def read_prompts(cfg, prompt: Optional[str]) -> List[str]:
    """Prompts from ``--prompt`` or the dataset CSV, with the dataset's
    fps / motion-score suffixes."""
    from opensora_torch.utils.inference import add_fps_info_to_text, add_motion_score_to_text

    dataset = cfg.get("dataset", {}) or {}
    if prompt is not None:
        texts = [prompt]
    else:
        with open(dataset["data_path"], newline="") as f:
            texts = [row["text"] for row in csv.DictReader(f)]
    if dataset.get("fps") is not None:
        texts = add_fps_info_to_text(texts, fps=dataset["fps"])
    if dataset.get("motion_score") is not None:
        texts = add_motion_score_to_text(texts, dataset["motion_score"])
    return texts


def read_references(cfg, prompt: Optional[str]) -> List[Optional[str]]:
    """The dataset CSV's ``ref`` column (None where a row has none); [] with
    ``--prompt`` or no CSV."""
    data_path = (cfg.get("dataset", {}) or {}).get("data_path")
    if prompt is not None or data_path is None:
        return []
    with open(data_path, newline="") as f:
        return [row.get("ref") or None for row in csv.DictReader(f)]


DEFAULT_T2I_OPTION = dict(resolution="768px", aspect_ratio="1:1", num_frames=1, method="distill")


def prepare_image_stage(cfg, optional: dict, model_t5, model_clip, patch_size: int = 2):
    """The t2i2v image stage of a config with ``img_flux``: ``(api_fn_img,
    opt_img)``, the distilled image model's ``api_fn`` over the Flux AE (its
    pixels per token edge read from the AE) and the sampling option from
    ``sampling_option_t2i`` (768px 1:1, one frame, distilled by default)."""
    from opensora_torch.utils.api import prepare_api
    from opensora_torch.utils.sampling import SamplingOption, sanitize_sampling_option

    img_ae = optional["img_flux_ae"]
    api_fn_img = prepare_api(optional["img_flux"], img_ae, model_t5, model_clip,
                             spatial_compression=img_ae.spatial_compression_ratio * patch_size)
    opt_img = sanitize_sampling_option(SamplingOption(**cfg.get("sampling_option_t2i", DEFAULT_T2I_OPTION)))
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


def main(argv: Optional[List[str]] = None) -> List[str]:
    """Run the CLI; returns the saved sample paths."""
    import torch

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
    texts_all = read_prompts(cfg, prompt)
    refs_all = read_references(cfg, prompt)
    model, ae, t5, clip, optional = prepare_models(cfg, device=device, seed=cfg.get("seed", 42))
    model_device = next(model.parameters()).device
    logger.info("models on %s", model_device)
    mesh = None
    # as scripts/diffusion/inference.py:106-112: a mesh only over more than one device
    if cfg.get("mesh") is not None and model_device.type == "cuda" and torch.cuda.device_count() > 1:
        from opensora_torch.parallel.mesh import MeshConfig, create_mesh

        mesh = create_mesh(MeshConfig(**cfg.mesh))
        logger.info("inference mesh: %s", mesh)
    api_fn = prepare_api(model, ae, t5, clip, spatial_compression=ae_spatial_compression(cfg), mesh=mesh)
    opt = sanitize_sampling_option(SamplingOption(**cfg.get("sampling_option", {})))
    cond_type = cfg.get("cond_type", "t2v")
    save_dir = cfg.get("save_dir", "samples")
    batch_size = cfg.get("batch_size", 1)
    patch_size = cfg.get("patch_size", 2)

    api_fn_img = None
    if "img_flux" in optional:  # t2i2v, as scripts/diffusion/inference.py:120-171
        api_fn_img, opt_img = prepare_image_stage(cfg, optional, t5, clip, patch_size)
        cond_type = "i2v_head"

    paths, sample_idx = [], 0
    for b0 in range(0, len(texts_all), batch_size):
        texts = texts_all[b0:b0 + batch_size]
        refs = refs_all[b0:b0 + batch_size]
        refs = refs if any(refs) else None
        if refine:
            logger.info("--refine-prompt: no prompt refiner is available offline; prompts unchanged")
        if motion_score is not None:
            texts = add_motion_score_to_text(texts, motion_score)
        if api_fn_img is not None and refs is None:
            # one image per batch; --num-sample varies the video's seed
            refs = make_reference_images(api_fn_img, opt_img, texts, save_dir, sample_idx,
                                         cfg["img_flux"]["in_channels"], patch_size)
            logger.info("t2i2v reference images: %s", refs)
        base_seed = opt.seed if opt.seed is not None else 42
        for j in range(num_sample):
            t0 = time.perf_counter()
            x = api_fn(opt, cond_type=cond_type, seed=base_seed + j if num_sample > 1 else None, text=texts,
                       patch_size=patch_size, channel=cfg["model"]["in_channels"], ref=refs)
            x = x.cpu().numpy()
            ids = list(range(sample_idx, sample_idx + len(texts)))
            saved = process_and_save(x, ids, save_dir, fps=cfg.get("fps_save", 16), prompts=texts)
            logger.info("generated %s in %.2f s: %s", tuple(x.shape), time.perf_counter() - t0, saved)
            paths += saved
            sample_idx += len(texts)
    return paths


if __name__ == "__main__":
    main()
