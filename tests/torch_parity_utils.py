"""Shared helpers of the tests that hold the PyTorch port against the JAX
package: seeded parameter trees and numpy conversion."""

import collections
import json
import os

import numpy as np
import torch


def to_numpy(tree):
    """A flax variables/params tree as nested dicts of numpy arrays (shape
    structs from ``jax.eval_shape`` become zeros)."""
    if isinstance(tree, dict) or hasattr(tree, "items"):
        return {k: to_numpy(v) for k, v in tree.items()}
    if not hasattr(tree, "__array__"):
        return np.zeros(tree.shape, tree.dtype)
    return np.asarray(tree)


def randomize(tree, seed: int, scale: float = 0.05):
    """Replace every leaf with seeded random values, so zero-initialized
    biases and projections (cond_in) cannot hide a mapping mistake."""
    rng = np.random.default_rng(seed)

    def walk(node, name=""):
        if isinstance(node, dict):
            return {k: walk(v, k) for k, v in node.items()}
        # uniform with standard deviation ``scale``: drawn five times faster
        # than normal values, which counts at full width
        leaf = rng.random(node.shape, dtype=np.float32)
        leaf -= 0.5
        leaf *= scale * 12**0.5
        # norm gains stay near 1 so normalized activations keep their scale
        if node.ndim == 1 and name in ("scale", "weight"):
            leaf += 1.0
        return leaf.astype(node.dtype, copy=False)

    return walk(to_numpy(tree))


def t(x) -> torch.Tensor:
    """numpy/jax array -> torch tensor (a copy)."""
    return torch.tensor(np.asarray(x))


def read_frames(path: str) -> np.ndarray:
    """A saved sample's uint8 frames (T, H, W, 3), RGB: png and mp4 through
    OpenCV, the port's ``.npy`` as it is."""
    import cv2

    if path.endswith(".npy"):
        return np.load(path)
    if path.endswith(".png"):
        return cv2.cvtColor(cv2.imread(path), cv2.COLOR_BGR2RGB)[None]
    cap = cv2.VideoCapture(path)
    frames = []
    try:
        ok, frame = cap.read()
        while ok:
            frames.append(cv2.cvtColor(frame, cv2.COLOR_BGR2RGB))
            ok, frame = cap.read()
    finally:
        cap.release()
    return np.stack(frames)


def max_rel_err(out, ref) -> float:
    out, ref = np.asarray(out, np.float64), np.asarray(ref, np.float64)
    return float(np.abs(out - ref).max() / max(1.0, np.abs(ref).max()))


# ----------------------------------------------------------------------
# the evaluation's files: CLIP tokenizer, a tiny HF CLIPModel, an aesthetic head
# ----------------------------------------------------------------------

CORPUS = os.path.join(os.path.dirname(os.path.abspath(__file__)), os.pardir, "docs", "eval.md")


def learn_bpe(words, n_merges):
    """Greedy BPE merges (the most frequent pair, ties by the pair) over
    symbol words with ``</w>`` on each word's last symbol."""
    counts = collections.Counter(words)
    seqs = {w: tuple(w[:-1]) + (w[-1] + "</w>",) for w in counts}
    merges = []
    for _ in range(n_merges):
        pairs = collections.Counter()
        for w, c in counts.items():
            for p in zip(seqs[w], seqs[w][1:]):
                pairs[p] += c
        if not pairs:
            break
        best = max(pairs.items(), key=lambda kv: (kv[1], kv[0]))[0]
        merges.append(best)
        for w, s in seqs.items():
            out, i = [], 0
            while i < len(s):
                if i < len(s) - 1 and (s[i], s[i + 1]) == best:
                    out.append(s[i] + s[i + 1])
                    i += 2
                else:
                    out.append(s[i])
                    i += 1
            seqs[w] = tuple(out)
    return merges


def write_clip_tokenizer(directory: str, n_merges: int = 300) -> int:
    """CLIP's ``vocab.json`` + ``merges.txt``: the 256 byte symbols, each
    with ``</w>``, BPE merges learned from docs/eval.md, the two specials
    last. Returns the vocabulary's size (the end token is size - 1)."""
    from opensora_torch.models.text import clip_tokenizer

    be = clip_tokenizer.bytes_to_unicode()
    with open(CORPUS, encoding="utf-8") as f:
        text = f.read()
    words = ["".join(be[b] for b in w.encode("utf-8"))
             for w in clip_tokenizer.split_words(clip_tokenizer.basic_clean(text))]
    merges = learn_bpe(words, n_merges)
    syms = list(be.values())
    vocab = {}
    for v in syms + [s + "</w>" for s in syms] + ["".join(m) for m in merges] + ["<|startoftext|>", "<|endoftext|>"]:
        vocab.setdefault(v, len(vocab))
    os.makedirs(directory, exist_ok=True)
    with open(os.path.join(directory, "vocab.json"), "w", encoding="utf-8") as f:
        json.dump(vocab, f)
    with open(os.path.join(directory, "merges.txt"), "w", encoding="utf-8") as f:
        f.write("#version: 0.2\n" + "\n".join(" ".join(m) for m in merges) + "\n")
    return len(vocab)


def write_tiny_clip_model(directory: str, vocab_size: int = 99, seed: int = 7, tokenizer: bool = False) -> str:
    """A random tiny ``CLIPModel`` checkpoint in HF's layout (text 32 wide,
    2 layers, 77 positions; vision 28 px, patch 14; projection 16), written
    by the port's ``CLIPModel`` and writer: ``model.safetensors`` (with
    ``logit_scale``) and a ``config.json`` in HF's ``CLIPConfig`` layout. The
    JAX package's converters (held against transformers' ``CLIPModel`` by
    tests/test_clip_vision.py) read it, so its names are HF's. With
    ``tokenizer`` the CLIP tokenizer files too, the vocabulary theirs."""
    from opensora_torch.models.text.clip import CLIPModel, CLIPTextConfig, CLIPVisionConfig
    from opensora_torch.utils.safetensors_io import save_file

    if tokenizer:
        vocab_size = write_clip_tokenizer(directory)
    torch.manual_seed(seed)
    model = CLIPModel(CLIPTextConfig(vocab_size=vocab_size, hidden_size=32, intermediate_size=64, num_layers=2,
                                     num_heads=2, max_position_embeddings=77, eos_token_id=vocab_size - 1),
                      CLIPVisionConfig(hidden_size=32, intermediate_size=64, num_layers=2, num_heads=2, image_size=28,
                                       patch_size=14, projection_dim=16))
    with torch.no_grad():  # HF's initializer scale: default-initialized embeddings are N(0, 1)
        for name, p in model.named_parameters():
            if "embedding" in name:
                p.mul_(0.02)
    os.makedirs(directory, exist_ok=True)
    save_file({**model.state_dict(), "logit_scale": torch.tensor(2.6592)}, os.path.join(directory, "model.safetensors"))
    text = dict(vocab_size=vocab_size, hidden_size=32, intermediate_size=64, num_hidden_layers=2,
                num_attention_heads=2, max_position_embeddings=77, eos_token_id=vocab_size - 1,
                hidden_act="quick_gelu", projection_dim=16)
    vision = dict(hidden_size=32, intermediate_size=64, num_hidden_layers=2, num_attention_heads=2, image_size=28,
                  patch_size=14, projection_dim=16, hidden_act="quick_gelu")
    with open(os.path.join(directory, "config.json"), "w") as f:
        json.dump({"architectures": ["CLIPModel"], "projection_dim": 16, "text_config": text,
                   "vision_config": vision}, f)
    return directory


def write_aesthetic_head(path: str, in_dim: int = 16, seed: int = 11) -> str:
    """A LAION-layout MLP state dict (``nn.Sequential`` indices with the
    dropouts at 1, 3, 5, as the published checkpoint) at a tiny width."""
    torch.manual_seed(seed)
    dims = [(in_dim, 24), (24, 8), (8, 4), (4, 2), (2, 1)]
    sd, idx = {}, 0
    for i, (d_in, d_out) in enumerate(dims):
        sd[f"layers.{idx}.weight"] = torch.randn(d_out, d_in) * 0.2
        sd[f"layers.{idx}.bias"] = torch.randn(d_out) * 0.1
        idx += 2 if i < 3 else 1
    torch.save(sd, path)
    return path


def one_torch_thread():
    """A generator for an autouse fixture: torch on one thread while a test
    runs (its tensors are tiny, and the suite's workers share the cores),
    the count restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)
