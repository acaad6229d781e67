"""The port's generation CLI for the conditioned flows on the CPU: t2i2v
end to end at a tiny size (the distilled image stage writes ``t2i_0000.png``,
the video is conditioned on it), an i2v_head run that reads its reference
from the prompt CSV's ``ref`` column, and the t2i2v configs parsed like the
JAX package parses them. Samples are compared as the uint8 frames decoded
from the files the CLI writes.
"""

import csv
import os

import numpy as np
import pytest

from opensora_tpu.utils.config import parse_configs as jparse_configs

from opensora_torch.inference import main, text_dataset
from opensora_torch.utils.api import prepare_api, prepare_models
from opensora_torch.utils.config import ae_spatial_compression, parse_configs
from opensora_torch.utils.inference import process_and_save
from opensora_torch.utils.sampling import SamplingOption, sanitize_sampling_option
from torch_parity_utils import read_frames

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG_DIR = os.path.join(REPO, "configs", "diffusion", "inference")
TINY_DEV = os.path.join(CONFIG_DIR, "tiny_dev.py")

TINY_T2I2V = f"""_base_ = [{TINY_DEV!r}]
cond_type = "i2v_head"
img_flux = dict(type="flux", in_channels=16, vec_in_dim=32, context_in_dim=64, hidden_size=64, mlp_ratio=2.0,
                num_heads=2, depth=1, depth_single_blocks=1, axes_dim=[8, 12, 12], qkv_bias=True,
                guidance_embed=True, ckpt_rope_convention="interleaved", attn_backend="xla", dtype="fp32")
img_flux_ae = dict(type="autoencoder_2d", ch=8, ch_mult=[1, 1, 2, 2], num_res_blocks=1, z_channels=4,
                   dtype="fp32")
sampling_option_t2i = dict(height=48, width=48, num_frames=1, num_steps=2, guidance=4.0, method="distill",
                           seed=0)
"""


def test_t2i2v_cli_writes_the_image_and_the_video_deterministically(tmp_path):
    cfg = tmp_path / "tiny_t2i2v.py"
    cfg.write_text(TINY_T2I2V)
    runs = []
    for r in range(2):
        out = tmp_path / f"run{r}"
        paths = main([str(cfg), "--prompt", "a red panda", "--num-sample", "2", "--device", "cpu",
                      "--save_dir", str(out)])
        assert sorted(os.listdir(out)) == ["sample_0000.mp4", "sample_0000.txt", "sample_0001.mp4",
                                           "sample_0001.txt", "t2i_0000.png"]
        image = read_frames(str(out / "t2i_0000.png"))
        assert image.shape == (1, 48, 48, 3) and image.std() > 0  # the 48x48 image of sampling_option_t2i
        runs.append([image] + [read_frames(p) for p in paths])
    for a, b in zip(*runs):
        np.testing.assert_array_equal(a, b)
    assert runs[0][1].shape == (5, 32, 32, 3)
    assert np.abs(runs[0][1].astype(int) - runs[0][2]).max() > 0  # --num-sample varies the video's seed


def test_i2v_head_cli_reads_the_reference_from_the_csv(tmp_path):
    """The video of an i2v_head run from a CSV row with a ``ref`` equals
    api_fn's video for that reference, and differs from the row's t2v
    video."""
    import cv2

    ref = str(tmp_path / "ref.png")
    cv2.imwrite(ref, np.random.default_rng(0).integers(0, 256, (40, 40, 3), dtype=np.uint8))
    data = tmp_path / "prompts.csv"
    with open(data, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["text", "ref"])
        w.writerows([["a cat", ref], ["a dog", ""]])
    args = [TINY_DEV, "--dataset.data_path", str(data), "--device", "cpu"]
    paths = main(args + ["--cond_type", "i2v_head", "--save_dir", str(tmp_path / "i2v")])
    t2v = main(args + ["--save_dir", str(tmp_path / "t2v")])
    cfg = parse_configs(args[:3] + ["--cond_type", "i2v_head"])
    data = text_dataset(cfg, None)
    assert [data[i].get("ref") for i in range(2)] == [ref, None] and "ref" not in text_dataset(cfg, "x")[0]

    model, ae, t5, clip, optional = prepare_models(cfg, device="cpu", seed=cfg.seed)
    assert optional == {}
    opt = sanitize_sampling_option(SamplingOption(**cfg.sampling_option), ae_spatial_compression(cfg))
    x = prepare_api(model, ae, t5, clip)(opt, "i2v_head", text=["a cat"], channel=16, ref=[ref])
    want = process_and_save(x.numpy(), [0], str(tmp_path / "direct"))
    np.testing.assert_array_equal(read_frames(paths[0]), read_frames(want[0]))
    assert np.abs(read_frames(paths[0]).astype(int) - read_frames(t2v[0])).max() > 0
    # the row without a reference is the same video under either cond type
    np.testing.assert_array_equal(read_frames(paths[1]), read_frames(t2v[1]))


@pytest.mark.parametrize("name", ["t2i2v_256px.py", "t2i2v_768px.py"])
def test_t2i2v_configs_parse_like_jax(name):
    path = os.path.join(CONFIG_DIR, name)
    ours = parse_configs([path])
    assert ours.to_dict() == jparse_configs([path]).to_dict()
    assert ours.cond_type == "i2v_head" and ours.img_flux["ckpt_rope_convention"] == "interleaved"
    assert ours.sampling_option_t2i["method"] == "distill" and ours.img_flux_ae["type"] == "autoencoder_2d"
