"""Shared helpers of the tests that hold the PyTorch port against the JAX
package: seeded parameter trees and numpy conversion."""

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
