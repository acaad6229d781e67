"""The port's evaluation CLI, ``python -m opensora_torch.evaluate``, against
the JAX package's ``scripts/eval.py`` over one sample directory (mp4 and
png samples through OpenCV, prompts, ``.json`` sidecars, an ``_orig`` /
``_recn`` pair, a tiny HF CLIPModel with the CLIP tokenizer's files and a
LAION-layout aesthetic head): the same report keys, ``None`` in the same
places, every number within 1e-5 (fp32 CLIP towers; the float64 metrics
agree far closer), pooled and with ``--suite vbench``. The port also reads
its own ``.npy`` samples (which ``save_sample`` writes where OpenCV is
absent): that directory's report equals the JAX package's
``evaluate_videos`` on the same frames; and an ``.mp4`` without OpenCV
raises and says why.
"""

import json
import os
import runpy
import sys
import unittest.mock

import numpy as np
import pytest
import torch

from torch_parity_utils import one_torch_thread, write_aesthetic_head, write_tiny_clip_model

_one_thread = pytest.fixture(autouse=True)(one_torch_thread)

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), os.pardir))
TOL = 1e-5


def _moving(t=8, h=48, w=64, dx=3, seed=0):
    rng = np.random.default_rng(seed)
    v = np.repeat(rng.uniform(-0.6, 0.2, (3, 1, h, w)), t, axis=1).astype(np.float32)
    for f in range(t):
        x0 = (4 + dx * f) % (w - 16)
        v[:, f, 12:28, x0:x0 + 16] = 0.8
    return v


SAMPLES = [  # (name, video, prompt, sidecar)
    ("sample_0000", _moving(dx=0), "a moving square", None),
    ("sample_0001", _moving(dx=3, seed=1), "a moving square, in the style of Van Gogh", None),
    ("sample_0002", _moving(dx=5, seed=2), "a photo of a dog 4 motion score.", {"scene": "beach"}),
    ("sample_0003", _moving(dx=2, seed=3), "a red car", {"dimension": "color", "color_object": ["red", "car"]}),
    ("sample_0004", _moving(t=1, seed=4), "a photo of the beach", None),
]


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    from opensora_torch.utils.inference import save_sample

    root = tmp_path_factory.mktemp("eval_cli")
    samples = root / "samples"
    npy = root / "npy"
    for d in (samples, npy):
        d.mkdir()
    for name, video, prompt, side in SAMPLES:
        save_sample(video, str(samples / name), fps=8)
        with unittest.mock.patch.dict(sys.modules, {"cv2": None}):
            assert save_sample(video, str(npy / name)).endswith(".npy")
        for d in (samples, npy):
            (d / f"{name}.txt").write_text(prompt)
            if side is not None:
                (d / f"{name}.json").write_text(json.dumps(side))
    v = _moving(seed=5)
    save_sample(v, str(samples / "pair_orig"), fps=8)
    save_sample(np.clip(v + 0.02, -1, 1), str(samples / "pair_recn"), fps=8)
    assert sorted(os.listdir(samples))[0].endswith((".mp4", ".png", ".txt", ".json"))
    clip = write_tiny_clip_model(str(root / "clip"), tokenizer=True)
    aes = write_aesthetic_head(str(root / "aes.pth"))
    return dict(samples=str(samples), npy=str(npy), clip=clip, aes=aes)


def _jax_cli(argv, capsys):
    """scripts/eval.py's main in this process (JAX on the CPU), its JSON."""
    capsys.readouterr()
    with unittest.mock.patch.object(sys, "argv", [os.path.join(REPO, "scripts", "eval.py")] + argv):
        runpy.run_path(os.path.join(REPO, "scripts", "eval.py"), run_name="__main__")
    return json.loads(capsys.readouterr().out)


def _port_cli(argv, capsys=None):
    """The port's CLI: run as ``python -m opensora_torch.evaluate`` runs it
    (``runpy.run_module`` as ``__main__``, in this process) with ``capsys``,
    its printed JSON; else its ``main`` here, the returned report."""
    argv = ["--device", "cpu"] + argv
    if capsys is None:
        from opensora_torch import evaluate

        return json.loads(json.dumps(evaluate.main(argv)))
    capsys.readouterr()
    with unittest.mock.patch.object(sys, "argv", ["opensora_torch.evaluate"] + argv):
        runpy.run_module("opensora_torch.evaluate", run_name="__main__", alter_sys=True)
    return json.loads(capsys.readouterr().out)


def _assert_same(ours, ref):
    assert set(ours) == set(ref)
    for k, r in ref.items():
        if isinstance(r, dict):
            _assert_same(ours[k], r)
        elif r is None or isinstance(r, (bool, int, str)):
            assert ours[k] == r, k
        else:
            assert abs(ours[k] - r) <= TOL * max(1.0, abs(r)), (k, ours[k], r)


@pytest.mark.parametrize("suite", [False, True], ids=["pooled", "suite"])
def test_port_cli_report_equals_the_jax_scripts(files, capsys, suite):
    argv = ["--samples", files["samples"], "--clip", files["clip"], "--aesthetic", files["aes"]]
    argv += ["--suite", "vbench"] if suite else []
    ours, ref = _port_cli(argv, capsys=None if suite else capsys), _jax_cli(argv, capsys)
    if suite:
        # R3: sample 2's prompt carries the --motion-score suffix; only the port matches it (object_class)
        assert ref["object_class"]["n"] == 0 and ours["object_class"]["n"] == 1
        assert ours["_summary"]["samples_matched"] == ref["_summary"]["samples_matched"] + 1
        ref["object_class"], ref["_summary"] = ours["object_class"], ours["_summary"]
        ref_scored = [d for d, r in ref.items() if isinstance(r, dict) and "score" in r and r["score"] is not None]
        assert {"color", "scene"} <= set(ref_scored) and len(ref_scored) < len(ours) - 1  # and some None
    else:
        assert np.isfinite(ours["appearance_style"]) and ours["num_samples"] == 7
        assert ours["recon_psnr"] > 25.0 and 0.0 <= ours["recon_ssim"] <= 1.0
    _assert_same(ours, ref)


def test_port_reads_its_npy_samples(files):
    from opensora_tpu.eval.aesthetic import AestheticHead as JHead
    from opensora_tpu.eval.clip_scorer import CLIPScorer as JScorer
    from opensora_tpu.eval.vbench import evaluate_videos

    ours = _port_cli(["--samples", files["npy"], "--clip", files["clip"], "--aesthetic", files["aes"]])
    names = [n for n, *_ in SAMPLES]
    videos = [np.transpose(np.load(os.path.join(files["npy"], n + ".npy")), (3, 0, 1, 2)).astype(np.float32)
              / 127.5 - 1.0 for n in names]
    meta = [s for *_, s in SAMPLES]
    ref = evaluate_videos(videos, [p for _, _, p, _ in SAMPLES], JScorer.from_pretrained(files["clip"]),
                          JHead.from_pretrained(files["aes"]), meta)
    ref["num_samples"] = len(names)
    _assert_same(ours, ref)


def test_emit_prompts_and_errors(files, capsys, tmp_path):
    from opensora_torch import evaluate

    ours = evaluate.main(["--suite", "vbench", "--emit-prompts", str(tmp_path / "a.csv")])
    ref = _jax_cli(["--suite", "vbench", "--emit-prompts", str(tmp_path / "b.csv")], capsys)
    assert ours["prompts_written"] == ref["prompts_written"] > 1000
    assert (tmp_path / "a.csv").read_text() == (tmp_path / "b.csv").read_text()
    (tmp_path / "empty").mkdir()
    assert "error" in evaluate.main(["--samples", str(tmp_path / "empty"), "--device", "cpu"])
    with pytest.raises(SystemExit):
        evaluate.main(["--samples", str(tmp_path / "missing"), "--device", "cpu"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            evaluate.main(["--samples", files["samples"]])  # cuda unless --device names another
    with unittest.mock.patch.dict(sys.modules, {"cv2": None}):
        with pytest.raises(RuntimeError, match="needs OpenCV"):
            evaluate.load_frames(os.path.join(files["samples"], "sample_0001.mp4"))
