"""Per-dimension VBench-style prompt suites (counterpart of
opensora_tpu/eval/suites.py, whose docstring gives the suites' design).

16 dimensions, each with its prompt list and, for the detection
dimensions, per-prompt meta slots (object / objects / color_object / scene /
action / spatial). The lists are generated deterministically from
``data/vbench_suites/vocab.json`` with the official suites' templates;
``<dimension>.official.txt`` (then ``<dimension>.txt``) in the suite
directory takes precedence, one prompt per line. The files are read, not
imported.

``evaluate_suite`` scores each dimension over the samples of its own suite,
on the port's ``eval/vbench``. A sample belongs to a suite when its prompt,
normalized (``_norm``), is one of the suite's, or its ``meta`` names the
dimension. Unlike the JAX package, ``_norm`` first removes one trailing
``" <n> motion score."`` -- what the generation CLI's ``--motion-score``
appends -- so that such a sample is scored under its prompt's suites
(ROADMAP fault R3; the JAX package matches it nowhere).
"""

from __future__ import annotations

import csv
import json
import os
import re
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

_DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "data", "vbench_suites",
)

# the 16 official VBench dimensions (docs/eval.md carries the per-dimension
# recipe fidelity table)
DIMENSIONS = (
    "subject_consistency", "background_consistency", "temporal_flickering",
    "motion_smoothness", "dynamic_degree", "aesthetic_quality",
    "imaging_quality", "object_class", "multiple_objects", "human_action",
    "color", "spatial_relationship", "scene", "appearance_style",
    "temporal_style", "overall_consistency",
)


def load_vocab(suite_dir: Optional[str] = None) -> dict:
    path = os.path.join(suite_dir or _DEFAULT_DIR, "vocab.json")
    with open(path) as f:
        vocab = json.load(f)
    return vocab


def _article(noun: str) -> str:
    return "an" if noun[0].lower() in "aeiou" else "a"


def _pick(seq, i):
    return seq[i % len(seq)]


def build_suite(dim: str, vocab: dict) -> List[Tuple[str, Optional[dict]]]:
    """Deterministic (prompt, meta) list for one dimension — official
    templates over the vocab tables; index arithmetic instead of RNG so
    the suite is stable across runs and machines."""
    objs = vocab["objects"]
    scenes = vocab["scenes"]
    actions = vocab["actions"]
    colors = vocab["colors"]
    colorable = vocab["colorable_objects"]
    subjects = vocab["subjects"]
    motions = vocab["subject_motions"]
    out: List[Tuple[str, Optional[dict]]] = []

    if dim == "object_class":
        for o in objs:
            out.append((f"a photo of {_article(o)} {o}", {"object": o}))
    elif dim == "multiple_objects":
        n = 82
        for i in range(n):
            a = _pick(objs, i * 3)
            b = _pick(objs, i * 7 + 11)
            if a == b:
                b = _pick(objs, i * 7 + 12)
            out.append((
                f"a photo of {_article(a)} {a} and {_article(b)} {b}",
                {"objects": (a, b)},
            ))
    elif dim == "color":
        n = 85
        for i in range(n):
            c = _pick(colors, i)
            o = _pick(colorable, i // len(colors) * 3 + i)
            out.append((f"a {c} {o}", {"color_object": (c, o)}))
    elif dim == "spatial_relationship":
        rels = vocab["spatial_relations"]
        n = 84
        for i in range(n):
            a = _pick(objs, i * 5 + 2)
            b = _pick(objs, i * 11 + 29)
            if a == b:
                b = _pick(objs, i * 11 + 30)
            r = _pick(rels, i)
            out.append((
                f"{_article(a)} {a} on the {r} of {_article(b)} {b}",
                {"spatial": (a, r, b)},
            ))
    elif dim == "scene":
        for s in scenes:
            out.append((f"a photo of the {s}", {"scene": s}))
    elif dim == "human_action":
        for a in actions:
            out.append((f"a person is {a}", {"action": a}))
    elif dim == "appearance_style":
        styles = vocab["appearance_styles"]
        bases = [f"{s} {m}" for s, m in zip(subjects, motions * 2)][:9]
        for i, style in enumerate(styles):
            for base in bases:
                out.append((f"{base}, {style}", None))
    elif dim == "temporal_style":
        tstyles = vocab["temporal_styles"]
        bases = (
            [f"{s} {_pick(motions, i)}" for i, s in enumerate(subjects[:8])]
            + [f"a video of the {s}" for s in scenes[:4]]
        )
        for style in tstyles:
            for base in bases:
                out.append((f"{base}, {style}", None))
    elif dim == "overall_consistency":
        n = 93
        for i in range(n):
            s = _pick(subjects, i)
            m = _pick(motions, i * 3 + 1)
            sc = _pick(scenes, i * 7 + 5)
            out.append((f"{s} {m} near the {sc}", None))
    elif dim == "subject_consistency":
        n = 72
        for i in range(n):
            s = _pick(subjects, i)
            m = _pick(motions, i // len(subjects) + i)
            out.append((f"{s} {m}", None))
    elif dim == "background_consistency":
        for s in scenes[:65]:
            out.append((f"a video of the {s}", None))
    elif dim == "temporal_flickering":
        # VBench runs this dimension on static-camera prompts
        for s in scenes[:75]:
            out.append((f"a static shot of the {s}, fixed camera", None))
    elif dim in ("motion_smoothness", "dynamic_degree"):
        # the +i//20 phase shift breaks the (i*3 mod 20, i mod 10) period
        # alignment that otherwise collapses the suite to 20 unique prompts
        n = 72
        for i in range(n):
            s = _pick(subjects, i * 3 + i // 20)
            m = _pick(motions, i)
            out.append((f"{s} {m}", None))
    elif dim in ("imaging_quality", "aesthetic_quality"):
        n = 75
        for i in range(n):
            sc = _pick(scenes, i)
            out.append((
                f"a beautiful photograph of the {sc} at "
                f"{_pick(['sunrise', 'noon', 'sunset', 'night'], i)}",
                None,
            ))
    else:
        raise ValueError(f"unknown dimension {dim!r}")
    # dedupe (index arithmetic can collide on small vocab products) —
    # official suites are duplicate-free
    seen, uniq = set(), []
    for p, m in out:
        if p not in seen:
            seen.add(p)
            uniq.append((p, m))
    return uniq


def load_suite(
    dim: str, suite_dir: Optional[str] = None
) -> List[Tuple[str, Optional[dict]]]:
    """(prompt, meta) list for ``dim``: <dim>.official.txt > <dim>.txt >
    generated from vocab.json. File-based suites carry no meta — the
    detection extractors in eval/vbench.py parse the official templates."""
    d = suite_dir or _DEFAULT_DIR
    for name in (f"{dim}.official.txt", f"{dim}.txt"):
        path = os.path.join(d, name)
        if os.path.exists(path):
            with open(path) as f:
                return [
                    (line.strip(), None) for line in f if line.strip()
                ]
    return build_suite(dim, load_vocab(d))


def emit_prompts_csv(
    path: str, dims: Optional[List[str]] = None, suite_dir: Optional[str] = None
) -> int:
    """Write every dimension's prompts to a CSV (columns: text, dimension)
    for generation runs; returns the number of rows."""
    dims = list(dims or DIMENSIONS)
    n = 0
    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["text", "dimension"])
        for dim in dims:
            for prompt, _ in load_suite(dim, suite_dir):
                w.writerow([prompt, dim])
                n += 1
    return n


# what utils.inference.add_motion_score_to_text appends to a prompt
_MOTION_SUFFIX = re.compile(r" \d+(?:\.\d+)? motion score\.$")


def _norm(text: str) -> str:
    """The prompt as suites compare it: one trailing ``" <n> motion
    score."`` suffix removed (the generation CLI's ``--motion-score``; the
    JAX package keeps it and so scores such samples nowhere), lowercased,
    whitespace collapsed, trailing ``.!?`` dropped."""
    text = _MOTION_SUFFIX.sub("", text or "", count=1)
    return " ".join(text.lower().split()).rstrip(".!?")


def evaluate_suite(
    videos: Sequence,
    texts: List[str],
    clip_scorer=None,
    aesthetic_head=None,
    suite_dir: Optional[str] = None,
    meta: Optional[List[dict]] = None,
) -> Dict[str, dict]:
    """Score each dimension over ITS OWN suite (VBench's structure).

    A sample belongs to a dimension when its prompt is in that dimension's
    suite (normalized match) or its ``meta`` sidecar carries
    ``{"dimension": name}``. Detection vocab comes from the suite's
    vocab.json. Returns {dim: {"score": float|None, "n": int}} plus a
    ``_summary`` row with the mean over scored dimensions. ``videos`` is
    indexed once per dimension a sample is scored under (a sequence that
    moves a video to the device when indexed holds one there at a time)."""
    from opensora_torch.eval import vbench as V

    vocab = load_vocab(suite_dir)
    index: Dict[str, List[Tuple[str, Optional[dict]]]] = {}
    for dim in DIMENSIONS:
        index[dim] = [(p, m) for p, m in load_suite(dim, suite_dir)]
    by_dim: Dict[str, List[int]] = {dim: [] for dim in DIMENSIONS}
    slot: Dict[tuple, Optional[dict]] = {}
    norm_index = {
        dim: {_norm(p): m for p, m in entries}
        for dim, entries in index.items()
    }
    matched_idx = set()
    for i, t in enumerate(texts):
        explicit = (meta or [None] * len(texts))[i] or {}
        tn = _norm(t)
        if "dimension" in explicit:
            d = explicit["dimension"]
            if d in by_dim:
                by_dim[d].append(i)
                slot[(i, d)] = explicit
                matched_idx.add(i)
            continue
        # a prompt may belong to SEVERAL suites (VBench reuses prompts
        # across dimensions) — score it under every matching one
        for dim in DIMENSIONS:
            if tn in norm_index[dim]:
                by_dim[dim].append(i)
                slot[(i, dim)] = {**(norm_index[dim][tn] or {}), **explicit}
                matched_idx.add(i)

    def mean_over(idxs, fn):
        vals = [fn(j) for j in idxs]
        vals = [v for v in vals if v is not None]
        return float(np.mean(vals)) if vals else None

    report: Dict[str, dict] = {}
    for dim in DIMENSIONS:
        idxs = by_dim[dim]
        score = None
        if idxs:
            if dim == "temporal_flickering":
                score = mean_over(idxs, lambda j: V.temporal_flickering(videos[j]))
            elif dim == "motion_smoothness":
                score = mean_over(idxs, lambda j: V.motion_smoothness(videos[j]))
            elif dim == "dynamic_degree":
                score = mean_over(
                    idxs, lambda j: float(V.dynamic_degree(videos[j]))
                )
            elif dim == "imaging_quality":
                score = mean_over(idxs, lambda j: V.imaging_quality(videos[j]))
            elif clip_scorer is None:
                score = None  # CLIP-backed dimension without a scorer
            elif dim == "subject_consistency":
                score = mean_over(
                    idxs, lambda j: V.subject_consistency(videos[j], clip_scorer)
                )
            elif dim == "background_consistency":
                score = mean_over(
                    idxs,
                    lambda j: V.background_consistency(videos[j], clip_scorer),
                )
            elif dim == "aesthetic_quality":
                if aesthetic_head is not None:
                    score = mean_over(
                        idxs,
                        lambda j: V.aesthetic_quality(
                            videos[j], clip_scorer, aesthetic_head
                        ),
                    )
            elif dim == "object_class":
                def f(j):
                    s = (slot.get((j, dim)) or {}).get("object") or \
                        V.extract_object_class(texts[j])
                    return None if s is None else V.object_class(
                        videos[j], s, clip_scorer, vocab=vocab["objects"]
                    )
                score = mean_over(idxs, f)
            elif dim == "multiple_objects":
                def f(j):
                    s = (slot.get((j, dim)) or {}).get("objects") or \
                        V.extract_multiple_objects(texts[j])
                    return None if s is None else V.multiple_objects(
                        videos[j], s[0], s[1], clip_scorer,
                        vocab=vocab["objects"],
                    )
                score = mean_over(idxs, f)
            elif dim == "color":
                def f(j):
                    s = (slot.get((j, dim)) or {}).get("color_object") or \
                        V.extract_color_object(texts[j])
                    return None if s is None else V.color(
                        videos[j], s[0], s[1], clip_scorer,
                        vocab=vocab["colors"],
                    )
                score = mean_over(idxs, f)
            elif dim == "spatial_relationship":
                def f(j):
                    s = (slot.get((j, dim)) or {}).get("spatial") or \
                        V.extract_spatial_relationship(texts[j])
                    return None if s is None else V.spatial_relationship(
                        videos[j], s[0], s[1], s[2], clip_scorer
                    )
                score = mean_over(idxs, f)
            elif dim == "scene":
                def f(j):
                    s = (slot.get((j, dim)) or {}).get("scene")
                    if s is None:
                        tn = _norm(texts[j])
                        if tn.startswith("a photo of the "):
                            s = tn[len("a photo of the "):]
                    return None if s is None else V.scene(
                        videos[j], s, clip_scorer, vocab=vocab["scenes"]
                    )
                score = mean_over(idxs, f)
            elif dim == "human_action":
                def f(j):
                    s = (slot.get((j, dim)) or {}).get("action") or \
                        V.extract_human_action(texts[j])
                    return None if s is None else V.human_action(
                        videos[j], s, clip_scorer, vocab=vocab["actions"]
                    )
                score = mean_over(idxs, f)
            elif dim == "appearance_style":
                def f(j):
                    s = V.extract_style_phrase(texts[j])
                    return None if s is None else V.appearance_style(
                        videos[j], s, clip_scorer
                    )
                score = mean_over(idxs, f)
            elif dim == "temporal_style":
                def f(j):
                    s = V.extract_temporal_style_phrase(texts[j])
                    return None if s is None else V.temporal_style(
                        videos[j], s, clip_scorer
                    )
                score = mean_over(idxs, f)
            elif dim == "overall_consistency":
                score = mean_over(
                    idxs, lambda j: V.clip_score(videos[j], texts[j], clip_scorer)
                )
        report[dim] = {"score": score, "n": len(idxs)}
    scored = [r["score"] for r in report.values() if r["score"] is not None]
    matched = len(matched_idx)
    report["_summary"] = {
        "dimensions_scored": len(scored),
        "mean_score": float(np.mean(scored)) if scored else None,
        "samples_matched": matched,
        "samples_total": len(videos),
    }
    return report
