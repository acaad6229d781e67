"""The port's evaluation (``opensora_torch/eval``) against the JAX package
on the CPU, on seeded videos:

- the float64 metrics (temporal consistency, motion magnitude, temporal
  flickering, motion smoothness, the block-matching flow, imaging quality,
  PSNR, SSIM): within 1e-9 of JAX's, relative (float64 on both sides, sums
  in another order). ``dynamic_degree`` is compared on videos whose flow
  magnitude lies at least 0.1 from its 0.5 threshold: nearer, a rounding
  difference in the block errors may pick another displacement and flip
  the vote, so such cases are kept out (and the margin is asserted);
- the CLIP dimensions (clip score, subject / background consistency,
  aesthetic quality, appearance / temporal style, the zero-shot votes),
  with the two packages' scorers read from one tiny HF CLIPModel
  directory: within 1e-5 (fp32 towers); votes equal;
- ``AestheticHead`` against JAX's on the same file: 1e-5;
- ``evaluate_videos`` and ``evaluate_suite``: the same keys, ``None`` in the
  same places and the same numbers within those limits, each video indexed
  once (once per dimension it is scored under, for the suites), as the CLI
  needs to keep the samples on the host; except the R3 pin:
  a sample whose prompt ends in the ``--motion-score`` suffix is scored
  nowhere by the JAX package and under its suite by the port;
- tests/test_eval_calibration.py's rank orders, reproduced by the port.
"""

import collections

import numpy as np
import pytest
import torch

from opensora_torch.eval import metrics as M
from opensora_torch.eval import suites as S
from opensora_torch.eval import vbench as V
from torch_parity_utils import one_torch_thread, write_aesthetic_head, write_tiny_clip_model

_one_thread = pytest.fixture(autouse=True)(one_torch_thread)

F64_TOL = 1e-9
CLIP_TOL = 1e-5


def _scene(t=10, h=48, w=64, dx=0, flicker=0.0, blur=0, noise=0.0, seed=0):
    """tests/test_eval_calibration.py's clip: textured background and a
    translating square, with motion, flicker, blur and noise."""
    rng = np.random.default_rng(seed)
    bg = rng.uniform(-0.5, 0.3, (3, 1, h, w)).astype(np.float32)
    v = np.repeat(bg, t, axis=1)
    for f in range(t):
        x0 = (4 + dx * f) % (w - 16)
        v[:, f, 12:28, x0:x0 + 16] = 0.8
        if flicker:
            v[:, f] += flicker * (1 if f % 2 else -1)
    if noise:
        v += rng.normal(0, noise, v.shape).astype(np.float32)
    for _ in range(blur):
        v = (np.roll(v, 1, axis=2) + np.roll(v, -1, axis=2) + np.roll(v, 1, axis=3) + np.roll(v, -1, axis=3) + v) / 5.0
    return np.clip(v, -1, 1).astype(np.float32)


VIDEOS = {
    "static": _scene(),
    "moving": _scene(dx=3, noise=0.01),
    "fast": _scene(dx=6, seed=1),
    "flicker": _scene(flicker=0.2, seed=2),
    "blurred": _scene(noise=0.05, blur=3, seed=3),
    "noise": np.clip(np.random.default_rng(9).normal(0, 0.5, (3, 10, 48, 64)), -1, 1).astype(np.float32),
    "clipped": np.clip(_scene(seed=4) * 3.0, -1, 1),
    "one_frame": _scene(t=1),
    "two_frames": _scene(t=2, dx=4),
}


def _rel(a, b):
    return abs(a - b) / max(1.0, abs(b))


@pytest.mark.parametrize("name", sorted(VIDEOS))
@pytest.mark.parametrize("fn", ["temporal_consistency", "motion_magnitude", "temporal_flickering",
                                "motion_smoothness", "_block_flow_magnitude", "imaging_quality"])
def test_float64_metrics_match_jax(fn, name):
    from opensora_tpu.eval import vbench as JV

    v = VIDEOS[name]
    assert _rel(getattr(V, fn)(torch.from_numpy(v)), getattr(JV, fn)(v)) <= F64_TOL


@pytest.mark.parametrize("name", ["static", "moving", "fast", "flicker", "noise", "two_frames"])
def test_dynamic_degree_matches_jax_away_from_its_threshold(name):
    from opensora_tpu.eval import vbench as JV

    v = VIDEOS[name]
    assert abs(JV._block_flow_magnitude(v) - 0.5) >= 0.1  # the case is not at the threshold (module docstring)
    assert V.dynamic_degree(torch.from_numpy(v)) == JV.dynamic_degree(v)


@pytest.mark.parametrize("pair", [("moving", "fast"), ("static", "blurred"), ("flicker", "noise")])
def test_psnr_and_ssim_match_jax(pair):
    from opensora_tpu.eval import metrics as JM

    a, b = (VIDEOS[p] for p in pair)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    assert _rel(M.psnr(ta, tb), JM.psnr(a, b)) <= F64_TOL
    assert _rel(M.ssim_video(ta, tb), JM.ssim_video(a, b)) <= F64_TOL
    ga, gb = a.mean(axis=0)[0].astype(np.float64), b.mean(axis=0)[0].astype(np.float64)
    assert _rel(M.ssim_frame(torch.from_numpy(ga), torch.from_numpy(gb)), JM.ssim_frame(ga, gb)) <= F64_TOL
    assert M.psnr(ta, ta) == JM.psnr(a, a) == float("inf")


# ----------------------------------------------------------------------
# the CLIP dimensions
# ----------------------------------------------------------------------


@pytest.fixture(scope="module")
def scorers(tmp_path_factory):
    from opensora_tpu.eval.aesthetic import AestheticHead as JHead
    from opensora_tpu.eval.clip_scorer import CLIPScorer as JScorer

    from opensora_torch.eval.aesthetic import AestheticHead
    from opensora_torch.eval.clip_scorer import CLIPScorer

    root = tmp_path_factory.mktemp("eval")
    d = write_tiny_clip_model(str(root / "clip"), tokenizer=True)
    head = write_aesthetic_head(str(root / "aes.pth"))
    return (CLIPScorer.from_pretrained(d, device="cpu"), AestheticHead.from_pretrained(head),
            JScorer.from_pretrained(d), JHead.from_pretrained(head))


CLIP_CASES = {
    "clip_score": lambda m, v, s, h: m.clip_score(v, "a red square moves right", s),
    "subject_consistency": lambda m, v, s, h: m.subject_consistency(v, s),
    "background_consistency": lambda m, v, s, h: m.background_consistency(v, s, max_frames=4),
    "aesthetic_quality": lambda m, v, s, h: m.aesthetic_quality(v, s, h),
    "appearance_style": lambda m, v, s, h: m.appearance_style(v, "in the style of Van Gogh", s),
    "temporal_style": lambda m, v, s, h: m.temporal_style(v, "camera pans left", s),
    "object_class": lambda m, v, s, h: m.object_class(v, "cat", s),
    "multiple_objects": lambda m, v, s, h: m.multiple_objects(v, "cat", "dog", s),
    "color": lambda m, v, s, h: m.color(v, "red", "car", s),
    "spatial_relationship": lambda m, v, s, h: m.spatial_relationship(v, "cat", "left", "dog", s),
    "scene": lambda m, v, s, h: m.scene(v, "beach", s),
    "human_action": lambda m, v, s, h: m.human_action(v, "dancing", s),
}


@pytest.mark.parametrize("dim", sorted(CLIP_CASES))
def test_clip_dimensions_match_jax(scorers, dim):
    from opensora_tpu.eval import vbench as JV

    scorer, head, jscorer, jhead = scorers
    votes = dim in ("object_class", "multiple_objects", "color", "spatial_relationship", "scene", "human_action")
    for name in ("moving",) if votes else ("moving", "noise"):
        v = VIDEOS[name]
        ours = CLIP_CASES[dim](V, torch.from_numpy(v), scorer, head)
        ref = CLIP_CASES[dim](JV, v, jscorer, jhead)
        assert abs(ours - ref) <= CLIP_TOL, (name, ours, ref)


def test_zero_shot_votes_and_consistency_formula_match_jax(scorers):
    from opensora_tpu.eval import vbench as JV

    scorer, _, jscorer, _ = scorers
    texts = [f"a photo of a {x}" for x in V._OBJECT_VOCAB]
    v = VIDEOS["fast"]
    np.testing.assert_array_equal(V._zero_shot_votes(torch.from_numpy(v), scorer, texts).numpy(),
                                  JV._zero_shot_votes(v, jscorer, texts))
    emb = np.random.default_rng(0).standard_normal((8, 32))
    emb /= np.linalg.norm(emb, axis=1, keepdims=True)
    assert _rel(V._consistency_from_embeddings(torch.from_numpy(emb)), JV._consistency_from_embeddings(emb)) <= 1e-12


def test_aesthetic_head_matches_jax(scorers, tmp_path):
    from opensora_tpu.eval.aesthetic import try_load_head as jax_try

    from opensora_torch.eval.aesthetic import try_load_head

    _, head, _, jhead = scorers
    emb = np.random.default_rng(0).standard_normal((5, 16)).astype(np.float32)
    emb /= np.linalg.norm(emb, axis=-1, keepdims=True)
    with torch.no_grad():
        got = head(torch.from_numpy(emb)).numpy()
    np.testing.assert_allclose(got, jhead(emb), rtol=0, atol=CLIP_TOL)
    assert head.input_dim == jhead.input_dim == 16
    with pytest.raises(ValueError, match="16-d"):
        head(torch.zeros(2, 8))
    # a wrapped state dict, a missing file, a file that is no head
    wrapped = str(tmp_path / "wrapped.pth")
    torch.save({"state_dict": torch.load(write_aesthetic_head(str(tmp_path / "h.pth")), weights_only=True)}, wrapped)
    assert try_load_head(wrapped) is not None and jax_try(wrapped) is not None
    assert try_load_head(str(tmp_path / "none.pth")) is None and jax_try(str(tmp_path / "none.pth")) is None
    torch.save({"other.weight": torch.zeros(2)}, str(tmp_path / "bad.pth"))
    assert try_load_head(str(tmp_path / "bad.pth")) is None and jax_try(str(tmp_path / "bad.pth")) is None


def test_phrase_extractors_match_jax():
    from opensora_tpu.eval import vbench as JV

    texts = ["A photo of a dog", "a video of an elephant.", "a photo of a cat and a dog", "a red car", "a big car",
             "A person is playing guitar", "a cat on the left of a dog", "a cup is on the top of a table",
             "a busy market, zoom in", "a dog runs, camera pans left.", "zoom in on life lessons",
             "a river, in the style of Van Gogh", "a street, oil painting style", "A style icon walks", ""]
    for fn in ("extract_object_class", "extract_multiple_objects", "extract_color_object", "extract_human_action",
               "extract_spatial_relationship", "extract_temporal_style_phrase", "extract_style_phrase"):
        assert [getattr(V, fn)(t) for t in texts] == [getattr(JV, fn)(t) for t in texts], fn


# ----------------------------------------------------------------------
# the reports
# ----------------------------------------------------------------------

SAMPLES = [("moving", "a photo of a dog"), ("noise", "a red car"), ("static", "a river at dawn, in the style of Van Gogh"),
           ("clipped", "a busy market, zoom in"), ("two_frames", "wide shot of rolling waves")]


class _Indexed(collections.abc.Sequence):
    """Videos handed out one index at a time, each index counted."""

    def __init__(self, videos):
        self.videos, self.counts = videos, collections.Counter()

    def __len__(self):
        return len(self.videos)

    def __getitem__(self, i):
        self.counts[i] += 1
        return torch.from_numpy(self.videos[i])


def _assert_reports_match(ours, ref):
    assert set(ours) == set(ref)
    for k, r in ref.items():
        o = ours[k]
        if isinstance(r, dict):
            _assert_reports_match(o, r)
        elif r is None or isinstance(r, (int, bool)):
            assert o == r, k
        else:
            assert abs(o - r) <= CLIP_TOL, (k, o, r)


@pytest.mark.parametrize("with_clip", [True, False], ids=["clip", "no_clip"])
def test_evaluate_videos_matches_jax(scorers, with_clip):
    from opensora_tpu.eval import vbench as JV

    scorer, head, jscorer, jhead = scorers if with_clip else (None,) * 4
    vids = [VIDEOS[n] for n, _ in SAMPLES]
    texts = [t for _, t in SAMPLES]
    meta = [None] * (len(SAMPLES) - 1) + [{"scene": "beach"}]
    indexed = _Indexed(vids)
    ours = V.evaluate_videos(indexed, texts, scorer, head, meta)
    ref = JV.evaluate_videos(vids, texts, jscorer, jhead, meta)
    _assert_reports_match(ours, ref)
    assert indexed.counts == {i: 1 for i in range(len(vids))}
    assert ("scene" in ours) == with_clip


@pytest.mark.parametrize("with_clip", [True, False], ids=["clip", "no_clip"])
def test_evaluate_suite_matches_jax(scorers, with_clip):
    from opensora_tpu.eval import suites as JS

    scorer, head, jscorer, jhead = scorers if with_clip else (None,) * 4
    prompts = ["a photo of a dog", "a red car", "not in any suite", "a static shot of the beach, fixed camera",
               "a video of the beach"]
    vids = [VIDEOS[n] for n in ("moving", "noise", "static", "clipped", "two_frames")]
    meta = [None, None, {"dimension": "imaging_quality"}, None, {"dimension": "not_a_dimension"}]
    indexed = _Indexed(vids)
    ours = S.evaluate_suite(indexed, prompts, scorer, head, meta=meta)
    ref = JS.evaluate_suite(vids, prompts, jscorer, jhead, meta=meta)
    _assert_reports_match(ours, ref)
    assert sum(indexed.counts.values()) <= sum(ours[d]["n"] for d in S.DIMENSIONS)
    nones = {d for d in S.DIMENSIONS if ours[d]["score"] is None}
    assert nones == {d for d in S.DIMENSIONS if ref[d]["score"] is None} and nones


def test_suites_build_emit_and_load_as_jax(tmp_path):
    from opensora_tpu.eval import suites as JS

    assert S.DIMENSIONS == JS.DIMENSIONS and S.load_vocab() == JS.load_vocab()
    for dim in S.DIMENSIONS:
        assert S.load_suite(dim) == JS.load_suite(dim)
    n_ours, n_ref = S.emit_prompts_csv(str(tmp_path / "a.csv")), JS.emit_prompts_csv(str(tmp_path / "b.csv"))
    assert n_ours == n_ref and (tmp_path / "a.csv").read_text() == (tmp_path / "b.csv").read_text()
    (tmp_path / "scene.official.txt").write_text("a photo of the moon\n\n")
    (tmp_path / "vocab.json").write_text((open(S._DEFAULT_DIR + "/vocab.json").read()))
    assert S.load_suite("scene", str(tmp_path)) == JS.load_suite("scene", str(tmp_path)) == [
        ("a photo of the moon", None)]


def test_r3_motion_score_sample_is_scored_under_its_suite(scorers):
    """A generated sample's prompt ends in what ``--motion-score 4`` appends:
    the JAX package matches it to no suite (ROADMAP R3), the port strips
    the suffix and scores it under object_class, as the bare prompt."""
    from opensora_tpu.eval import suites as JS

    scorer, head, jscorer, jhead = scorers
    v = VIDEOS["moving"]
    texts = ["a photo of a dog 4 motion score."]
    ref = JS.evaluate_suite([v], texts, jscorer, jhead)
    ours = S.evaluate_suite([torch.from_numpy(v)], texts, scorer, head)
    bare = S.evaluate_suite([torch.from_numpy(v)], ["a photo of a dog"], scorer, head)
    assert ref["_summary"]["samples_matched"] == 0 and ref["object_class"]["n"] == 0
    assert ours["_summary"]["samples_matched"] == 1 and ours["object_class"]["n"] == 1
    _assert_reports_match(ours, bare)
    assert S._norm("a photo of a dog. 16 FPS. 4 motion score.") == "a photo of a dog. 16 fps"  # one suffix only
    assert S._norm("a photo of a dog 4.5 motion score.") == "a photo of a dog"
    assert S._norm("a photo of a dog, motion score.") == "a photo of a dog, motion score"


# ----------------------------------------------------------------------
# tests/test_eval_calibration.py's rank orders, by the port
# ----------------------------------------------------------------------


def _ranked(metric, clips):
    scores = [metric(torch.from_numpy(c)) for c in clips]
    assert all(a > b for a, b in zip(scores, scores[1:])), scores


def _jitter():
    j = _scene(dx=2)
    for f in range(1, j.shape[1], 2):
        j[:, f] = np.roll(j[:, f], 2, axis=-1)
    return j


CALIBRATION = {
    "temporal_flickering": lambda: _ranked(V.temporal_flickering, [_scene(flicker=0.0), _scene(flicker=0.1),
                                                                   _scene(flicker=0.3)]),
    "temporal_consistency": lambda: _ranked(V.temporal_consistency, [_scene(dx=0, noise=0.01),
                                                                     _scene(dx=2, noise=0.01),
                                                                     _scene(dx=6, noise=0.01)]),
    "motion_smoothness": lambda: _ranked(V.motion_smoothness, [
        _scene(dx=2), np.clip(np.random.default_rng(5).normal(0, 0.5, _scene().shape), -1, 1).astype(np.float32),
        _jitter()]),
    "imaging_quality": lambda: _ranked(V.imaging_quality, [_scene(noise=0.05), _scene(noise=0.05, blur=2),
                                                           _scene(noise=0.05, blur=6)]),
}


@pytest.mark.parametrize("dim", sorted(CALIBRATION))
def test_calibration_rank_orders_reproduced(dim):
    CALIBRATION[dim]()


def test_dynamic_degree_threshold_calibration_reproduced():
    votes = [V.dynamic_degree(torch.from_numpy(_scene(**kw)))
             for kw in (dict(dx=0), dict(dx=0, noise=0.02), dict(dx=3), dict(dx=6))]
    assert votes == [False, False, True, True]
