"""Flash-attention forward: the Hopper CUDA kernel, its wrapper and its
plain PyTorch version.

Counterpart of opensora_tpu/ops/flash_attention.py (forward only). The
kernel (``csrc/flash_attention_fwd.cu``) fuses the TPU's two forward
kernels, ``_fwd_kernel`` and ``_fwd_kernel_anchored``: for bidirectional
attention each (b, h) takes the anchored loop when its Cauchy-Schwarz logit
bound A = sm_scale * log2(e) * max|q| * max|k| is below 40, and the
running-max loop otherwise. A is computed here on the device and read by
the kernel, so no call syncs with the host.

Layout (B, H, L, D). The wrapper launches the kernel for CUDA tensors and
raises on anything the kernel does not take (dtype other than bf16, D other
than 128 or 512, non-contiguous input); CPU tensors go to the plain
version, :func:`flash_attention_ref`.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import torch

from opensora_torch.ops import _build

NEG_INF = -1e30
LOG2E = 1.4426950408889634
KERNEL = "flash_attention_fwd"
SUPPORTED_HEAD_DIMS = (128, 512)

_lib = None


def _kernel_lib():
    global _lib
    if _lib is None:
        lib = _build.load(KERNEL)
        vp, i = ctypes.c_void_p, ctypes.c_int
        lib.flash_attention_fwd.argtypes = [
            vp, vp, vp, vp, vp, vp, i, i, i, i, i, ctypes.c_float, i, vp,
        ]
        lib.flash_attention_fwd.restype = ctypes.c_int
        lib.flash_attention_error_string.argtypes = [ctypes.c_int]
        lib.flash_attention_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def flash_attention_ref(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    sm_scale: Optional[float] = None,
    causal_block: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain fp32 attention: (out (B, H, Lq, D) fp32, natural-log lse
    (B, H, Lq) fp32). ``causal_block``: tokens of frame i = idx //
    causal_block see frames <= i."""
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * sm_scale
    if causal_block is not None:
        qf = torch.arange(q.shape[2], device=q.device)[:, None] // causal_block
        kf = torch.arange(k.shape[2], device=q.device)[None, :] // causal_block
        s = s.masked_fill(kf > qf, NEG_INF)
    lse = torch.logsumexp(s, dim=-1)
    p = torch.exp(s - lse[..., None])
    return torch.einsum("bhqk,bhkd->bhqd", p, v.float()), lse


def anchor_log2(q: torch.Tensor, k: torch.Tensor, sm_scale: float) -> torch.Tensor:
    """Per-(b, h) log2-domain bound on the scaled logits, (B, H) fp32
    (opensora_tpu/ops/flash_attention.py:409-413)."""
    qn = torch.linalg.vector_norm(q, dim=-1, dtype=torch.float32).amax(dim=-1)
    kn = torch.linalg.vector_norm(k, dim=-1, dtype=torch.float32).amax(dim=-1)
    return ((sm_scale * LOG2E) * qn * kn).contiguous()


def _check(q, k, v, causal_block):
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.dtype != torch.bfloat16:
            raise TypeError(f"flash_attention kernel takes bf16, got {name}.dtype={x.dtype}")
        if x.dim() != 4:
            raise ValueError(f"{name} must be (B, H, L, D), got shape {tuple(x.shape)}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if x.device != q.device:
            raise ValueError(f"{name} is on {x.device}, q on {q.device}")
    b, h, _, d = q.shape
    if k.shape != v.shape or k.shape[:2] != (b, h) or k.shape[3] != d:
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)}")
    if d not in SUPPORTED_HEAD_DIMS:
        raise ValueError(f"flash_attention kernel takes head dims {SUPPORTED_HEAD_DIMS}, got {d}")
    if causal_block is not None and causal_block <= 0:
        raise ValueError(f"causal_block must be positive, got {causal_block}")


def flash_attention_with_lse(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    sm_scale: Optional[float] = None,
    causal_block: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(out (B, H, Lq, D) in q's dtype, lse (B, H, Lq) fp32)."""
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    if q.device.type == "cpu":
        out, lse = flash_attention_ref(q, k, v, sm_scale, causal_block)
        return out.to(q.dtype), lse
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cuda or cpu tensors, got {q.device}")
    _check(q, k, v, causal_block)
    b, h, lq, d = q.shape
    lk = k.shape[2]
    out = torch.empty_like(q)
    lse = torch.empty((b, h, lq), dtype=torch.float32, device=q.device)
    anchor = anchor_log2(q, k, sm_scale) if causal_block is None else None
    lib = _kernel_lib()
    with torch.cuda.device(q.device):
        err = lib.flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), lse.data_ptr(),
            anchor.data_ptr() if anchor is not None else None,
            b, h, lq, lk, d, sm_scale * LOG2E, causal_block or 0,
            torch.cuda.current_stream(q.device).cuda_stream,
        )
    if err != 0:
        msg = lib.flash_attention_error_string(err).decode()
        raise RuntimeError(f"flash_attention_fwd launch failed: {msg} ({err})")
    _build.LAUNCHES[KERNEL] += 1
    return out, lse


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    sm_scale: Optional[float] = None,
    causal_block: Optional[int] = None,
) -> torch.Tensor:
    """Attention over (B, H, L, D); forward only."""
    return flash_attention_with_lse(q, k, v, sm_scale=sm_scale, causal_block=causal_block)[0]
