"""VBench-style evaluation: the 16 dimensions, two diagnostics and the
prompt-slot extractors (counterpart of opensora_tpu/eval/vbench.py, whose
docstring and docs/eval.md give each recipe and its deviation from
official VBench).

Videos are (C, T, H, W) tensors in [-1, 1], on any device; each metric
computes on the video's device, in float64 where the JAX package computes
in float64 (numpy), and returns a Python number. The CLIP dimensions take a
scorer with ``embed_frames(video, max_frames)`` -> unit (N, d) tensor,
``embed_text(text)`` -> unit (d,) tensor and ``__call__(video, text)``
(``eval/clip_scorer.CLIPScorer``). ``evaluate_videos`` gives the JAX
package's report: the same keys, a dimension absent where no sample
applies.
"""

from __future__ import annotations

import math
import re
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch


def _luma(frames: torch.Tensor) -> torch.Tensor:
    """(C, T, H, W) -> (T, H, W) luma."""
    return 0.299 * frames[0] + 0.587 * frames[1] + 0.114 * frames[2]


def temporal_consistency(video: torch.Tensor) -> float:
    """Mean cosine similarity between adjacent frames (1 = static/smooth)."""
    y = _luma(video.double())
    t = y.shape[0]
    if t < 2:
        return 1.0
    flat = y.reshape(t, -1)
    flat = flat - flat.mean(dim=1, keepdim=True)
    norms = torch.linalg.vector_norm(flat, dim=1) + 1e-8
    sims = (flat[:-1] * flat[1:]).sum(dim=1) / (norms[:-1] * norms[1:])
    return float(sims.mean())


def motion_magnitude(video: torch.Tensor) -> float:
    """Mean |frame difference| in [-1, 1] space (0 = static)."""
    v = video.double()
    if v.shape[1] < 2:
        return 0.0
    return float((v[:, 1:] - v[:, :-1]).abs().mean())


def temporal_flickering(video: torch.Tensor) -> float:
    """VBench's temporal flickering: ``1 - MAE/255`` over adjacent frames
    in uint8 units."""
    v = video.double()
    if v.shape[1] < 2:
        return 1.0
    mae = float((v[:, 1:] - v[:, :-1]).abs().mean()) * (255.0 / 2.0)
    return float(1.0 - mae / 255.0)


def clip_score(video: torch.Tensor, text: str, scorer) -> float:
    """Text-video CLIP similarity (the scorer's mean frame-text cosine)."""
    return float(scorer(video, text))


def _consistency_from_embeddings(emb: torch.Tensor) -> float:
    """VBench's consistency formula: each later frame's cosine to the first
    and to the previous frame, averaged, then the mean."""
    if emb.shape[0] < 2:
        return 1.0
    to_first = emb[1:] @ emb[0]
    to_prev = (emb[1:] * emb[:-1]).sum(dim=1)
    return float(((to_first + to_prev) / 2.0).mean())


def subject_consistency(video: torch.Tensor, scorer, max_frames: int = 8) -> float:
    """The consistency formula on CLIP embeddings of the center half of the
    frames."""
    _, _, h, w = video.shape
    ch, cw = max(h // 2, 1), max(w // 2, 1)
    y0, x0 = (h - ch) // 2, (w - cw) // 2
    return _consistency_from_embeddings(scorer.embed_frames(video[:, :, y0:y0 + ch, x0:x0 + cw], max_frames))


def background_consistency(video: torch.Tensor, scorer, max_frames: int = 8) -> float:
    """The consistency formula on CLIP embeddings of the full frames."""
    return _consistency_from_embeddings(scorer.embed_frames(video, max_frames))


def _block_flow_magnitude(video: torch.Tensor, grid: int = 8, search: int = 3, down: int = 2) -> float:
    """Mean over adjacent frame pairs of the 95th-percentile displacement
    (downsampled pixels) of block matching: luma downsampled by ``down``,
    split into a ``grid`` x ``grid`` patch grid, each textured patch matched
    against the next frame shifted by up to +-``search`` pixels; on equal
    errors the smaller displacement wins."""
    y = _luma(video.double())[:, ::down, ::down]
    t, h, w = y.shape
    if t < 2 or h <= 2 * search or w <= 2 * search:
        return 0.0
    ph, pw = max(h // grid, 1), max(w // grid, 1)
    gys = [gy for gy in range(0, h - ph + 1, ph) if gy >= search and gy + ph + search <= h]
    gxs = [gx for gx in range(0, w - pw + 1, pw) if gx >= search and gx + pw + search <= w]
    if not gys or not gxs:
        return 0.0
    rows = torch.tensor(gys, device=y.device)[:, None] + torch.arange(ph, device=y.device)  # (Gy, ph)
    cols = torch.tensor(gxs, device=y.device)[:, None] + torch.arange(pw, device=y.device)  # (Gx, pw)

    def patches(frames, dy=0, dx=0):  # (F, Gy, Gx, ph, pw) at a shift
        return frames[:, rows + dy][:, :, :, cols + dx].permute(0, 1, 3, 2, 4)

    a = patches(y[:-1])
    textured = a.var(dim=(-2, -1), correction=0) >= 1e-4  # (t - 1, Gy, Gx)
    best_err = torch.full(textured.shape, math.inf, dtype=torch.float64, device=y.device)
    best_disp = torch.zeros_like(best_err)
    for dy in range(-search, search + 1):
        for dx in range(-search, search + 1):
            err = ((a - patches(y[1:], dy, dx)) ** 2).mean(dim=(-2, -1))
            d = math.hypot(dy, dx)
            take = (err < best_err) | ((err == best_err) & (d < best_disp))
            best_err = torch.where(take, err, best_err)
            best_disp = torch.where(take, torch.full_like(best_disp, d), best_disp)
    mags = [float(torch.quantile(best_disp[f][textured[f]], 0.95)) for f in range(t - 1) if bool(textured[f].any())]
    return float(np.mean(mags)) if mags else 0.0


def dynamic_degree(video: torch.Tensor, threshold: float = 0.5) -> bool:
    """Is there real motion: the block-matching magnitude above
    ``threshold`` (downsampled pixels a frame)."""
    return bool(_block_flow_magnitude(video) > threshold)


def motion_smoothness(video: torch.Tensor) -> float:
    """How much better linear interpolation of each frame's neighbours
    predicts it than holding the previous frame, on 4 x 4 pooled luma, in
    [0, 1] (1 for a static video)."""
    y = _luma(video.double())
    t, h, w = y.shape
    if t < 3:
        return 1.0
    hp, wp = (h // 4) * 4, (w // 4) * 4
    y = y[:, :hp, :wp].reshape(t, hp // 4, 4, wp // 4, 4).mean(dim=(2, 4))
    interp_err = float((y[1:-1] - (y[:-2] + y[2:]) / 2.0).abs().mean())
    hold_err = float((y[1:-1] - y[:-2]).abs().mean())
    if hold_err < 1e-9:
        return 1.0
    return float(np.clip(1.0 - interp_err / hold_err, 0.0, 1.0))


def imaging_quality(video: torch.Tensor) -> float:
    """Laplacian-energy sharpness (saturating at 0.15) damped by the share
    of pixels at the [-1, 1] rails, in [0, 1]."""
    y = _luma(video.double())
    lap = -4.0 * y[:, 1:-1, 1:-1] + y[:, :-2, 1:-1] + y[:, 2:, 1:-1] + y[:, 1:-1, :-2] + y[:, 1:-1, 2:]
    sharp = float(torch.sqrt((lap**2).mean()))
    sharpness = min(sharp / 0.15, 1.0)
    clipped = float((video.abs() > 0.995).double().mean())
    return float(sharpness * (1.0 - min(4.0 * clipped, 1.0)))


def aesthetic_quality(video: torch.Tensor, scorer, head, max_frames: int = 8) -> float:
    """Mean over sampled frames of the LAION predictor's score on the
    frame's unit CLIP embedding, / 10, clipped to [0, 1]."""
    emb = scorer.embed_frames(video, max_frames)
    return float((head(emb) / 10.0).clamp(0.0, 1.0).mean())


_STYLE_RE = re.compile(
    r"\bin the style of ([^,.;]+)"
    r"|[,;]\s*([A-Za-z][A-Za-z0-9 .'&-]*?)\s+style\b(?=\s*[,.;!?]|\s*$)",
    re.IGNORECASE,
)


def extract_style_phrase(text: str) -> Optional[str]:
    """``"in the style of X"`` or a trailing comma-delimited ``"X style"``
    clause, normalized; None where the prompt has none."""
    m = _STYLE_RE.search(text or "")
    if not m:
        return None
    if m.group(1):
        return f"in the style of {m.group(1).strip()}"
    return f"{m.group(2).strip()} style"


def _frames_vs_text(video: torch.Tensor, text: str, scorer, max_frames: int) -> float:
    return float((scorer.embed_frames(video, max_frames) @ scorer.embed_text(text)).mean())


def appearance_style(video: torch.Tensor, style_text: str, scorer, max_frames: int = 8) -> float:
    """Mean CLIP cosine of the sampled frames against the style phrase."""
    return _frames_vs_text(video, style_text, scorer, max_frames)


_TEMPORAL_STYLES = (
    "camera pans left", "camera pans right", "camera tilts up",
    "camera tilts down", "zoom in", "zoom out", "in super slow motion",
    "racking focus",
)
_TEMPORAL_STYLE_RE = re.compile(
    r"[,;]\s*(" + "|".join(re.escape(s) for s in _TEMPORAL_STYLES) + r")\s*[.!?]?\s*$",
    re.IGNORECASE,
)


def extract_temporal_style_phrase(text: str) -> Optional[str]:
    """The trailing camera-motion / tempo phrase of the temporal-style
    lexicon, lowercased; None where there is none."""
    m = _TEMPORAL_STYLE_RE.search(text or "")
    return m.group(1).strip().lower() if m else None


def temporal_style(video: torch.Tensor, style_text: str, scorer, max_frames: int = 8) -> float:
    """Mean CLIP cosine of the sampled frames against the temporal-style
    phrase."""
    return _frames_vs_text(video, style_text, scorer, max_frames)


# ======================================================
# detection-suite proxies (CLIP zero-shot votes)
# ======================================================

_OBJECT_VOCAB = (
    "person", "cat", "dog", "horse", "sheep", "cow", "elephant", "bear",
    "zebra", "giraffe", "bird", "airplane", "bicycle", "car", "motorcycle",
    "bus", "train", "truck", "boat", "bench", "backpack", "umbrella",
    "suitcase", "frisbee", "skateboard", "surfboard", "bottle", "cup",
    "bowl", "banana", "apple", "sandwich", "orange", "pizza", "cake",
    "chair", "couch", "bed", "laptop", "clock", "vase", "teddy bear",
)
_COLOR_VOCAB = (
    "red", "orange", "yellow", "green", "blue", "purple", "pink",
    "black", "white", "brown", "gray",
)
_SCENE_VOCAB = (
    "alley", "amusement park", "aquarium", "beach", "botanical garden",
    "bridge", "castle", "cliff", "desert", "forest", "fountain", "glacier",
    "harbor", "highway", "lake", "library", "lighthouse", "mountain",
    "ocean", "office", "rainforest", "restaurant", "skyscraper", "street",
    "temple", "tower", "underwater", "valley", "village", "waterfall",
)
_ACTION_VOCAB = (
    "dancing", "running", "swimming", "cooking", "reading a book",
    "playing guitar", "playing piano", "riding a bike", "riding a horse",
    "climbing", "surfing", "skiing", "drinking coffee", "eating",
    "laughing", "painting", "singing", "typing on a keyboard",
    "doing yoga", "playing basketball",
)

_SPATIAL_SWAP = {
    "left": "right", "right": "left",
    "top": "bottom", "bottom": "top",
    "above": "below", "below": "above",
}

_ARTICLE = r"(?:a|an|the)"
_OBJ_WORD = r"[A-Za-z][A-Za-z '-]*?"
_OBJECT_RE = re.compile(rf"^a (?:photo|video) of {_ARTICLE} ({_OBJ_WORD})\s*[.!?]?\s*$", re.IGNORECASE)
_MULTI_RE = re.compile(
    rf"^a (?:photo|video) of {_ARTICLE} ({_OBJ_WORD}) and {_ARTICLE} ({_OBJ_WORD})\s*[.!?]?\s*$", re.IGNORECASE)
_COLOR_RE = re.compile(rf"^a ({'|'.join(_COLOR_VOCAB)}) ({_OBJ_WORD})\s*[.!?]?\s*$", re.IGNORECASE)
_ACTION_RE = re.compile(r"^a person is ([a-z][a-z '-]+?)\s*[.!?]?\s*$", re.IGNORECASE)
_SPATIAL_RE = re.compile(
    rf"^{_ARTICLE} ({_OBJ_WORD}) (?:is )?"
    rf"(?:on|to) the (left|right|top|bottom) (?:side )?of {_ARTICLE} ({_OBJ_WORD})\s*[.!?]?\s*$",
    re.IGNORECASE,
)


def _zero_shot_votes(video, scorer, texts: List[str], max_frames: int = 8) -> torch.Tensor:
    """Per sampled frame, the index of the text whose CLIP embedding is
    nearest (the first on a tie)."""
    emb = scorer.embed_frames(video, max_frames)  # (N, d)
    txt = torch.stack([scorer.embed_text(t) for t in texts])  # (K, d)
    return (emb @ txt.T).argmax(dim=1)


def _vote_fraction(video, scorer, target: str, distractors, template: str, max_frames: int = 8) -> float:
    pool = [target] + [d for d in distractors if d.lower() != target.lower()]
    wins = _zero_shot_votes(video, scorer, [template.format(x) for x in pool], max_frames)
    return float((wins == 0).double().mean())


def object_class(video: torch.Tensor, cls: str, scorer, vocab=_OBJECT_VOCAB, max_frames: int = 8) -> float:
    """Share of sampled frames voting "a photo of a {cls}" over the
    vocabulary."""
    return _vote_fraction(video, scorer, cls, vocab, "a photo of a {}", max_frames)


def multiple_objects(video: torch.Tensor, cls_a: str, cls_b: str, scorer, vocab=_OBJECT_VOCAB,
                     max_frames: int = 8) -> float:
    """Share of sampled frames where each prompted object wins its own
    vocabulary vote."""
    emb = scorer.embed_frames(video, max_frames)
    ok = torch.ones(emb.shape[0], dtype=torch.bool, device=emb.device)
    for cls in (cls_a, cls_b):
        pool = [cls] + [d for d in vocab if d.lower() != cls.lower()]
        txt = torch.stack([scorer.embed_text(f"a photo of a {x}") for x in pool])
        ok &= (emb @ txt.T).argmax(dim=1) == 0
    return float(ok.double().mean())


def color(video: torch.Tensor, color_name: str, obj: str, scorer, vocab=_COLOR_VOCAB, max_frames: int = 8) -> float:
    """The prompted color against the same object in every other color."""
    return _vote_fraction(video, scorer, color_name, vocab, "a {} " + obj, max_frames)


def spatial_relationship(video: torch.Tensor, obj_a: str, relation: str, obj_b: str, scorer,
                         max_frames: int = 8) -> float:
    """The prompted relation phrase against the swapped relation."""
    swapped = _SPATIAL_SWAP[relation.lower()]
    wins = _zero_shot_votes(video, scorer, [f"a {obj_a} on the {relation} of a {obj_b}",
                                            f"a {obj_a} on the {swapped} of a {obj_b}"], max_frames)
    return float((wins == 0).double().mean())


def scene(video: torch.Tensor, scene_name: str, scorer, vocab=_SCENE_VOCAB, max_frames: int = 8) -> float:
    """Zero-shot scene vote against the scene vocabulary."""
    return _vote_fraction(video, scorer, scene_name, vocab, "a photo of the {}", max_frames)


def human_action(video: torch.Tensor, action: str, scorer, vocab=_ACTION_VOCAB, max_frames: int = 8) -> float:
    """Per-frame zero-shot vote for "a person is {action}"."""
    return _vote_fraction(video, scorer, action, vocab, "a person is {}", max_frames)


def extract_object_class(text: str) -> Optional[str]:
    """'a photo of a {cls}' -> cls (the two-object template is not one)."""
    if _MULTI_RE.match(text or ""):
        return None
    m = _OBJECT_RE.match(text or "")
    return m.group(1).strip().lower() if m else None


def extract_multiple_objects(text: str) -> Optional[tuple]:
    """'a photo of a {a} and a {b}' -> (a, b)."""
    m = _MULTI_RE.match(text or "")
    return (m.group(1).strip().lower(), m.group(2).strip().lower()) if m else None


def extract_color_object(text: str) -> Optional[tuple]:
    """'a {color} {obj}' -> (color, obj), the color one of the suite's."""
    m = _COLOR_RE.match(text or "")
    return (m.group(1).lower(), m.group(2).strip().lower()) if m else None


def extract_human_action(text: str) -> Optional[str]:
    """'a person is {action}' -> action."""
    m = _ACTION_RE.match(text or "")
    return m.group(1).strip().lower() if m else None


def extract_spatial_relationship(text: str) -> Optional[tuple]:
    """'a {a} on the {rel} of a {b}' -> (a, rel, b)."""
    m = _SPATIAL_RE.match(text or "")
    if not m:
        return None
    return m.group(1).strip().lower(), m.group(2).lower(), m.group(3).strip().lower()


def evaluate_videos(videos: Sequence[torch.Tensor], texts: List[str], clip_scorer=None, aesthetic_head=None,
                    meta: Optional[List[dict]] = None) -> Dict[str, float]:
    """Pooled metrics over ``videos`` (the JAX package's report). Each video
    is indexed once and scored on every metric before the next one, so a
    sequence that moves a video to the device when it is indexed
    (``evaluate.DeviceVideos``) holds one video there at a time."""
    # each detection dimension over the samples whose prompt has its slot (a ``meta`` entry first)
    def slot(i, key, extractor):
        if meta is not None and i < len(meta) and meta[i] and key in meta[i]:
            return meta[i][key]
        return extractor(texts[i])

    detection = [
        ("object_class", "object", extract_object_class, lambda v, s: object_class(v, s, clip_scorer)),
        ("multiple_objects", "objects", extract_multiple_objects,
         lambda v, s: multiple_objects(v, s[0], s[1], clip_scorer)),
        ("color", "color_object", extract_color_object, lambda v, s: color(v, s[0], s[1], clip_scorer)),
        ("spatial_relationship", "spatial", extract_spatial_relationship,
         lambda v, s: spatial_relationship(v, s[0], s[1], s[2], clip_scorer)),
        ("scene", "scene", lambda t: None, lambda v, s: scene(v, s, clip_scorer)),
        ("human_action", "action", extract_human_action, lambda v, s: human_action(v, s, clip_scorer)),
    ]
    always = ["temporal_consistency", "motion_magnitude", "temporal_flickering", "motion_smoothness",
              "dynamic_degree", "imaging_quality"]
    if clip_scorer is not None:
        always += ["clip_score", "subject_consistency", "background_consistency"]
        always += ["aesthetic_quality"] if aesthetic_head is not None else []
    vals: Dict[str, list] = {k: [] for k in always + ["appearance_style", "temporal_style"] + [d[0] for d in detection]}
    for i in range(len(videos)):
        v, t = videos[i], texts[i]
        vals["temporal_consistency"].append(temporal_consistency(v))
        vals["motion_magnitude"].append(motion_magnitude(v))
        vals["temporal_flickering"].append(temporal_flickering(v))
        vals["motion_smoothness"].append(motion_smoothness(v))
        vals["dynamic_degree"].append(float(dynamic_degree(v)))
        vals["imaging_quality"].append(imaging_quality(v))
        if clip_scorer is None:
            continue
        vals["clip_score"].append(clip_score(v, t, clip_scorer))
        vals["subject_consistency"].append(subject_consistency(v, clip_scorer))
        vals["background_consistency"].append(background_consistency(v, clip_scorer))
        if aesthetic_head is not None:
            vals["aesthetic_quality"].append(aesthetic_quality(v, clip_scorer, aesthetic_head))
        if (s := extract_style_phrase(t)) is not None:
            vals["appearance_style"].append(appearance_style(v, s, clip_scorer))
        if (s := extract_temporal_style_phrase(t)) is not None:
            vals["temporal_style"].append(temporal_style(v, s, clip_scorer))
        for name, key, extractor, fn in detection:
            if (s := slot(i, key, extractor)) is not None:
                vals[name].append(fn(v, s))
    out = {k: float(np.mean(x)) for k, x in vals.items() if k in always or x}
    if clip_scorer is not None:
        out["overall_consistency"] = out["clip_score"]
    return out
