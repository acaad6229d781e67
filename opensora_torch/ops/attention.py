"""Attention entry point: RoPE + attention core with backend dispatch
(counterpart of opensora_tpu/ops/attention.py:86-147).

Backends: ``None`` runs :func:`flash_attention` (the CUDA kernel for CUDA
tensors, its plain version for CPU tensors); ``"xla"`` runs the plain
version on any device; ``"int8"`` and ``"int8_qk8"`` run the serving-only
:func:`int8_flash_attention` (both products in int8, or only Q K^T),
bidirectional only, with the JAX package's rule
(opensora_tpu/ops/attention.py:66-80): sequences shorter than 128 and head
dims that are not a multiple of 128 take the plain attention.

Sequence-parallel backends, over the mesh set with
``opensora_torch.parallel.context.set_mesh`` (each raises without one, as
the JAX package asserts): ``"ring_rdma"`` runs
:func:`~opensora_torch.ops.ring_flash.ring_flash_attention` (the ring
kernels for CUDA tensors); ``"ring"`` and ``"ulysses"`` run
:mod:`opensora_torch.ops.sp` with the default core, and ``"ring:<inner>"`` /
``"ulysses:<inner>"`` with the backend ``<inner>``.

Layout: q, k, v are (B, L, H, D); the output is (B, L, H * D).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from opensora_torch.ops import rope as rope_ops
from opensora_torch.ops.flash_attention import flash_attention, flash_attention_ref
from opensora_torch.ops.int8_flash import int8_flash_attention
from opensora_torch.ops.ring_flash import ring_flash_attention
from opensora_torch.ops.sp import ring_attention, ulysses_attention
from opensora_torch.parallel.context import get_mesh


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


def _sequence_parallel(q, k, v, backend: str) -> torch.Tensor:
    """(B, L, H, D) -> (B, L, H * D) over the current mesh's 'sp' axis."""
    mesh = get_mesh()
    if mesh is None:
        raise ValueError(f"attention backend {backend!r} needs a mesh (opensora_torch.parallel.context.set_mesh)")
    b, l, h, d = q.shape
    if backend == "ring_rdma":
        out, _ = ring_flash_attention(*(x.transpose(1, 2).contiguous() for x in (q, k, v)), mesh)
        return out.transpose(1, 2).reshape(b, l, h * d)
    name, _, inner = backend.partition(":")
    fn = ulysses_attention if name == "ulysses" else ring_attention
    return fn(q, k, v, mesh, backend=inner or None).reshape(b, l, h * d)


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
    if backend == "ring_rdma" or (isinstance(backend, str) and backend.split(":")[0] in ("ring", "ulysses")):
        return _sequence_parallel(q, k, v, backend)
    qh, kh, vh = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    out = scaled_dot_product_attention(qh, kh, vh, backend=backend)
    b, h, l, d = out.shape
    return out.transpose(1, 2).reshape(b, l, h * d)
