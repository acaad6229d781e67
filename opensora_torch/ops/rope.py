"""Multi-axis rotary position embeddings (counterpart of
opensora_tpu/ops/rope.py).

Two pairings: "split" (rotate-half, pairs (i, i + D/2); the published
Open-Sora v2 checkpoints' layout) and "interleaved" (Flux original, pairs
(2i, 2i + 1)). Tables are (cos, sin), each (B, L, D/2) fp32. A checkpoint
trained in one pairing serves in the other once its q/k projection rows
are permuted (:func:`permute_qk_weight`): attention is unchanged by the
basis change.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch


def rope_frequencies(pos: torch.Tensor, dim: int, theta: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """cos/sin tables for one axis. pos: (..., L) -> (..., L, dim // 2)."""
    assert dim % 2 == 0
    scale = torch.arange(0, dim, 2, dtype=torch.float32, device=pos.device) / dim
    omega = 1.0 / (theta**scale)
    out = pos.float()[..., None] * omega
    return torch.cos(out), torch.sin(out)


def embed_nd(ids: torch.Tensor, axes_dim: Sequence[int], theta: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """ids: (B, L, n_axes) positions -> (cos, sin) each (B, L, sum(axes_dim) // 2)."""
    assert ids.shape[-1] == len(axes_dim)
    tables = [rope_frequencies(ids[..., i], d, theta) for i, d in enumerate(axes_dim)]
    return torch.cat([c for c, _ in tables], dim=-1), torch.cat([s for _, s in tables], dim=-1)


def apply_rope_split(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """Rotate-half RoPE. x: (B, L, H, D); cos/sin: (B, L, D/2)."""
    half = x.shape[-1] // 2
    c = cos[..., None, :].float()
    s = sin[..., None, :].float()
    x1 = x[..., :half].float()
    x2 = x[..., half:].float()
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1).to(x.dtype)


def apply_rope_interleaved(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """Interleaved RoPE: pairs (2i, 2i + 1) rotate by angle i."""
    xr = x.float().reshape(*x.shape[:-1], -1, 2)
    x0, x1 = xr[..., 0], xr[..., 1]
    c = cos[..., None, :].float()
    s = sin[..., None, :].float()
    return torch.stack([x0 * c - x1 * s, x0 * s + x1 * c], dim=-1).reshape(x.shape).to(x.dtype)


def interleaved_to_split_permutation(dim: int) -> torch.Tensor:
    """perm[d]: the interleaved-layout channel that split-layout channel d
    comes from (d < D/2: 2d, else 2(d - D/2) + 1)."""
    return torch.cat([torch.arange(0, dim, 2), torch.arange(1, dim, 2)])


def permute_qk_weight(w: torch.Tensor, num_heads: int, head_dim: int, dim: int = 0,
                      inverse: bool = False) -> torch.Tensor:
    """A q/k projection's weight (out, in) or bias (out,), its output
    features on ``dim`` laid out as (num_heads, head_dim), from the
    interleaved to the split pairing (``inverse``: back)."""
    perm = interleaved_to_split_permutation(head_dim).to(w.device)
    if inverse:
        perm = torch.argsort(perm)
    w = w.movedim(dim, 0)
    shape = w.shape
    w = w.reshape(num_heads, head_dim, *shape[1:])[:, perm].reshape(shape)
    return w.movedim(0, dim)
