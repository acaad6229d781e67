"""The inference CLI's prompt file against the JAX package on the CPU, at
the tiny_dev.py size: a ``neg`` column reaches ``api_fn`` as the negative
prompt (the port's generate with ``neg`` against the JAX denoiser's
``prepare_guidance(neg=...)`` path), ``.csv`` and ``.jsonl`` files read
alike, empty cells count as absent, and a batch's first row decides its
columns, as the JAX text dataset and collate decide them.

Tolerance: 2e-4 of the output's scale against JAX (as
tests/test_torch_pipeline.py); the CLI's samples against ``api_fn``'s,
saved the same way, byte for byte.
"""

import csv
import json
import math
import os

import numpy as np
import pytest

from opensora_tpu.datasets.dataloader import collate_fn_default as jcollate
from opensora_tpu.datasets.datasets import TextDataset as JTextDataset
from opensora_tpu.utils import sampling as JS

from opensora_torch.inference import main, prompt_batches, text_dataset
from opensora_torch.utils import sampling as S
from opensora_torch.utils.api import prepare_api, prepare_models
from opensora_torch.utils.config import ae_spatial_compression, parse_configs
from opensora_torch.utils.inference import process_and_save
from test_torch_pipeline import TOL, _jax_generate, tiny_models  # noqa: F401  (the fixture)
from torch_parity_utils import max_rel_err, read_frames, t

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY_DEV = os.path.join(REPO, "configs", "diffusion", "inference", "tiny_dev.py")
NEG = "blurry, dark, low quality"


def write_prompt_file(path: str, rows) -> str:
    """Rows (dicts) as a .csv (a column for every key, empty where a row has
    none) or a .jsonl (each row's own keys)."""
    if path.endswith(".csv"):
        columns = list(dict.fromkeys(k for r in rows for k in r))
        with open(path, "w", newline="") as f:
            w = csv.writer(f)
            w.writerow(columns)
            w.writerows([[r.get(c, "") for c in columns] for r in rows])
    else:
        with open(path, "w") as f:
            f.write("".join(json.dumps(r) + "\n" for r in rows))
    return path


def write_reference(path: str) -> str:
    import cv2

    cv2.imwrite(path, np.random.default_rng(0).integers(0, 256, (40, 40, 3), dtype=np.uint8))
    return path


@pytest.fixture(scope="module")
def direct():
    """tiny_dev.py's models as the CLI draws them, and api_fn over them."""
    cfg = parse_configs([TINY_DEV])
    model, ae, t5, clip, _ = prepare_models(cfg, device="cpu", seed=cfg.seed)
    opt = S.sanitize_sampling_option(S.SamplingOption(**cfg.sampling_option), ae_spatial_compression(cfg))
    return prepare_api(model, ae, t5, clip), opt


def saved_frames(x, root: str):
    return [read_frames(p) for p in process_and_save(x.numpy(), list(range(x.shape[0])), root)]


def test_neg_prompt_matches_jax(tiny_models):
    """generate with a negative prompt per sample equals the JAX package's
    api_fn body given the same neg; the empty negative gives another
    video."""
    cfg, js, models = tiny_models
    api_fn = prepare_api(**models)
    opt = S.sanitize_sampling_option(S.SamplingOption(**cfg.sampling_option), ae_spatial_compression(cfg))
    jopt = JS.sanitize_sampling_option(JS.SamplingOption(**cfg.sampling_option))
    prompts, negs = ["a cat playing piano", "raining, sea"], [NEG, "cartoon"]
    z = np.random.default_rng(7).standard_normal((2, 4, 2, 4, 4)).astype(np.float32)
    ref = _jax_generate(js, z, prompts, jopt, neg=negs)
    out = api_fn.generate(t(z), prompts, opt, neg=negs).numpy()
    assert max_rel_err(out, ref) <= TOL, max_rel_err(out, ref)
    assert max_rel_err(api_fn.generate(t(z), prompts, opt).numpy(), ref) > 100 * TOL


@pytest.mark.parametrize("ext", ["csv", "jsonl"])
def test_text_dataset_items_equal_jax(tmp_path, ext):
    """The port's text dataset yields the JAX one's items over the same file:
    text with the suffixes, ref and neg only where the cell is not empty."""
    rows = [{"text": "a cat", "neg": NEG, "ref": "a.png"}, {"text": "a dog", "ref": "b.png"}, {"text": "rain, sea"}]
    path = write_prompt_file(str(tmp_path / f"prompts.{ext}"), rows)
    ours = text_dataset(parse_configs([TINY_DEV, "--dataset.data_path", path, "--dataset.fps", "16",
                                       "--dataset.motion_score", "4"]), None)
    theirs = JTextDataset(path, fps=16, motion_score="4")
    assert [ours[i] for i in range(3)] == [theirs[i] for i in range(3)]
    assert ours[0]["text"] == "a cat. 16 FPS. 4 motion score." and "neg" not in ours[1] and "ref" not in ours[2]


@pytest.mark.parametrize("ext", ["csv", "jsonl"])
def test_cli_prompt_file_with_neg_and_ref(tmp_path, direct, ext):
    """An i2v_head run over a file with text / neg / ref columns writes
    api_fn(neg=..., ref=...)'s video; without the neg it would differ."""
    api_fn, opt = direct
    ref = write_reference(str(tmp_path / "ref.png"))
    path = write_prompt_file(str(tmp_path / f"prompts.{ext}"), [{"text": "a cat", "neg": NEG, "ref": ref}])
    paths = main([TINY_DEV, "--dataset.data_path", path, "--cond_type", "i2v_head", "--device", "cpu",
                  "--save_dir", str(tmp_path / "cli")])
    want = saved_frames(api_fn(opt, "i2v_head", text=["a cat"], neg=[NEG], channel=16, ref=[ref]), str(tmp_path / "a"))
    np.testing.assert_array_equal(read_frames(paths[0]), want[0])
    control = saved_frames(api_fn(opt, "i2v_head", text=["a cat"], channel=16, ref=[ref]), str(tmp_path / "b"))
    assert np.abs(control[0].astype(int) - want[0]).max() > 0


def test_batch_of_two_follows_jax_collate(tmp_path, direct):
    """batch_size 2: a neg that the batch's first row lacks is dropped for
    the batch, as the JAX collate drops it (the CLI's videos are api_fn's
    without neg); a row without the first row's neg raises in both."""
    api_fn, opt = direct
    rows = [{"text": "a cat"}, {"text": "a dog", "neg": NEG}]
    path = write_prompt_file(str(tmp_path / "mixed.csv"), rows)
    cfg = parse_configs([TINY_DEV, "--dataset.data_path", path])
    batch, = prompt_batches(text_dataset(cfg, None), 2)
    jbatch = jcollate([JTextDataset(path)[i] for i in range(2)])
    assert batch.keys() == jbatch.keys() == {"text", "index"} and batch["text"] == jbatch["text"]
    paths = main([TINY_DEV, "--dataset.data_path", path, "--batch_size", "2", "--device", "cpu",
                  "--save_dir", str(tmp_path / "cli")])
    want = saved_frames(api_fn(opt, "t2v", text=["a cat", "a dog"], channel=16), str(tmp_path / "direct"))
    for p, w in zip(paths, want):
        np.testing.assert_array_equal(read_frames(p), w)

    path = write_prompt_file(str(tmp_path / "mixed.jsonl"), rows[::-1])
    with pytest.raises(KeyError):
        jcollate([JTextDataset(path)[i] for i in range(2)])
    with pytest.raises(KeyError, match="neg"):
        next(prompt_batches(text_dataset(parse_configs([TINY_DEV, "--dataset.data_path", path]), None), 2))
    # one row a batch: each row keeps its own columns
    singles = list(prompt_batches(text_dataset(parse_configs([TINY_DEV, "--dataset.data_path", path]), None), 1))
    assert [b.get("neg") for b in singles] == [[NEG], None]
    assert not any(isinstance(v, float) and math.isnan(v) for b in singles for v in b["text"])
