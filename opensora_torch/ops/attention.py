"""Attention entry point: RoPE + attention core with backend dispatch
(counterpart of opensora_tpu/ops/attention.py:86-147, without the
sequence-parallel backends).

Backends: ``None`` runs :func:`flash_attention` (the CUDA kernel for CUDA
tensors, its plain version for CPU tensors); ``"xla"`` runs the plain
version on any device; ``"int8"`` and ``"int8_qk8"`` run the serving-only
:func:`int8_flash_attention` (both products in int8, or only Q K^T),
bidirectional only, with the JAX package's rule
(opensora_tpu/ops/attention.py:66-80): sequences shorter than 128 and head
dims that are not a multiple of 128 take the plain attention.

Layout: q, k, v are (B, L, H, D); the output is (B, L, H * D).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from opensora_torch.ops import rope as rope_ops
from opensora_torch.ops.flash_attention import flash_attention, flash_attention_ref
from opensora_torch.ops.int8_flash import int8_flash_attention


def plain_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal_block: Optional[int] = None
) -> torch.Tensor:
    """O(L^2)-memory fp32 attention over (B, H, L, D), output in q's dtype."""
    return flash_attention_ref(q, k, v, None, causal_block)[0].to(q.dtype)


def scaled_dot_product_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal_block: Optional[int] = None,
    backend: Optional[str] = None,
) -> torch.Tensor:
    """(B, H, L, D) attention core with backend dispatch."""
    if backend is None:
        return flash_attention(q, k, v, causal_block=causal_block)
    if backend == "xla":
        return plain_attention(q, k, v, causal_block)
    if backend in ("int8", "int8_qk8"):
        if causal_block is not None:
            raise ValueError("int8 attention is bidirectional only (causal_block must be None)")
        if min(q.shape[2], k.shape[2]) < 128 or q.shape[-1] % 128:
            return plain_attention(q, k, v)
        return int8_flash_attention(q, k, v, pv_int8=backend == "int8")
    raise ValueError(f"unknown attention backend {backend!r}")


def attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    pe: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    *,
    rope_convention: str = "split",
    backend: Optional[str] = None,
) -> torch.Tensor:
    """MMDiT attention: optional RoPE, attention core, heads merged.

    q, k, v: (B, L, H, D); pe: (cos, sin) each (B, L, D/2) or None.
    """
    if pe is not None:
        cos, sin = pe
        if rope_convention == "split":
            q, k = rope_ops.apply_rope_split(q, cos, sin), rope_ops.apply_rope_split(k, cos, sin)
        elif rope_convention == "interleaved":
            q = rope_ops.apply_rope_interleaved(q, cos, sin)
            k = rope_ops.apply_rope_interleaved(k, cos, sin)
        else:
            raise ValueError(f"unknown rope convention {rope_convention!r}")
    qh, kh, vh = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    out = scaled_dot_product_attention(qh, kh, vh, backend=backend)
    b, h, l, d = out.shape
    return out.transpose(1, 2).reshape(b, l, h * d)
