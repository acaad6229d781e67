"""Flash attention: the Hopper CUDA kernels, their wrappers, their plain
PyTorch versions and the autograd Function over them.

Counterpart of opensora_tpu/ops/flash_attention.py. The forward kernel
(``csrc/flash_attention_fwd.cu``) fuses the TPU's two forward kernels, ``_fwd_kernel`` and ``_fwd_kernel_anchored``: for bidirectional
attention each (b, h) takes the anchored loop when its Cauchy-Schwarz logit
bound A = sm_scale * log2(e) * max|q| * max|k| is below 40, and the
running-max loop otherwise. A is computed here on the device and read by
the kernel, so no call syncs with the host.

The backward (``csrc/flash_attention_bwd.cu``) is two kernels, ``dkv``
and ``dq``, ports of ``_dkv_kernel`` and ``_dq_kernel``: P is recomputed
from the forward's LSE, delta = rowsum(dO * O) is plain torch (XLA fuses
it beside the TPU kernels). :class:`FlashAttentionFunction` ties forward
and backward together as the JAX package's ``custom_vjp`` does, and every
attention call of the port goes through it.

Layout (B, H, L, D). The wrappers launch the kernels for CUDA tensors and
raise on anything a kernel does not take (dtype other than bf16, a head
dim it was not built for, non-contiguous input); CPU tensors go to the
plain versions, :func:`flash_attention_ref` and
:func:`flash_attention_bwd_ref`. A CUDA call never falls back to them.
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
# the backward's source holds two kernels, each with its own launch count
BWD_SOURCE = "flash_attention_bwd"
KERNEL_DKV = "flash_attention_bwd_dkv"
KERNEL_DQ = "flash_attention_bwd_dq"
BWD_HEAD_DIMS = (128,)

_lib = None
_bwd_lib = None


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


def _kernel_lib_bwd():
    global _bwd_lib
    if _bwd_lib is None:
        lib = _build.load(BWD_SOURCE)
        vp, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.flash_attention_bwd_dkv.argtypes = [vp] * 8 + [i] * 5 + [f, i, vp]
        lib.flash_attention_bwd_dq.argtypes = [vp] * 7 + [i] * 5 + [f, i, vp]
        lib.flash_attention_bwd_dkv.restype = ctypes.c_int
        lib.flash_attention_bwd_dq.restype = ctypes.c_int
        lib.flash_attention_bwd_error_string.argtypes = [ctypes.c_int]
        lib.flash_attention_bwd_error_string.restype = ctypes.c_char_p
        _bwd_lib = lib
    return _bwd_lib


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


def _flash_forward(q, k, v, sm_scale: float, causal_block: Optional[int]):
    """(out in q's dtype, lse fp32): the kernel for CUDA tensors, the plain
    version for CPU tensors."""
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


# ----------------------------------------------------------------------
# backward
# ----------------------------------------------------------------------


def flash_attention_bwd_ref(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    do: torch.Tensor,
    lse: torch.Tensor,
    delta: torch.Tensor,
    sm_scale: Optional[float] = None,
    causal_block: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain fp32 backward given the forward's natural-log LSE and delta =
    rowsum(do * out): (dq, dk, dv), fp32. P is recomputed in the exp2
    domain from the LSE, with fully masked rows (lse <= -5e29) anchored at
    0, as ``_dkv_kernel``/``_dq_kernel`` do (opensora_tpu/ops/
    flash_attention.py:425-547)."""
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    qf, kf, vf, dof = q.float(), k.float(), v.float(), do.float()
    s = torch.einsum("bhqd,bhkd->bhqk", qf, kf)
    lse = lse.float()
    lse_safe = torch.where(lse <= NEG_INF * 0.5, torch.zeros_like(lse), lse) * LOG2E
    p = torch.exp2(s * (sm_scale * LOG2E) - lse_safe[..., None])
    if causal_block is not None:
        qf_idx = torch.arange(q.shape[2], device=q.device)[:, None] // causal_block
        kf_idx = torch.arange(k.shape[2], device=q.device)[None, :] // causal_block
        p = p.masked_fill(kf_idx > qf_idx, 0.0)
    dv = torch.einsum("bhqk,bhqd->bhkd", p, dof)
    dp = torch.einsum("bhqd,bhkd->bhqk", dof, vf)
    ds = p * (dp - delta.float()[..., None])
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, qf) * sm_scale
    dq = torch.einsum("bhqk,bhkd->bhqd", ds, kf) * sm_scale
    return dq, dk, dv


def _check_bwd(q, k, v, do, lse, delta, causal_block):
    _check(q, k, v, causal_block)
    if q.shape[-1] not in BWD_HEAD_DIMS:
        raise ValueError(
            f"the flash-attention backward kernels take head dims {BWD_HEAD_DIMS}, got "
            f"{q.shape[-1]}; D = 512 (the VAE mid-block) waits for the VAE training slice "
            "(ROADMAP Queue 2 item 2)"
        )
    if do.shape != q.shape or do.dtype != torch.bfloat16 or not do.is_contiguous():
        raise ValueError(f"do must be a contiguous bf16 tensor of q's shape, got {tuple(do.shape)} {do.dtype}")
    for name, x in (("lse", lse), ("delta", delta)):
        if x.shape != q.shape[:3] or x.dtype != torch.float32 or not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous fp32 of shape {tuple(q.shape[:3])}")
        if x.device != q.device:
            raise ValueError(f"{name} is on {x.device}, q on {q.device}")


def _launch_bwd(fn_name: str, counter: str, ptrs, q, k, sm_scale, causal_block):
    lib = _kernel_lib_bwd()
    b, h, lq, d = q.shape
    with torch.cuda.device(q.device):
        err = getattr(lib, fn_name)(
            *ptrs, b, h, lq, k.shape[2], d, sm_scale, causal_block or 0,
            torch.cuda.current_stream(q.device).cuda_stream,
        )
    if err != 0:
        msg = lib.flash_attention_bwd_error_string(err).decode()
        raise RuntimeError(f"{fn_name} launch failed: {msg} ({err})")
    _build.LAUNCHES[counter] += 1


def flash_attention_bwd_dkv(q, k, v, do, lse, delta, *, sm_scale: float,
                            causal_block: Optional[int] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dk, dv) by the ``dkv`` kernel; CUDA bf16 tensors only."""
    _check_bwd(q, k, v, do, lse, delta, causal_block)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    ptrs = [x.data_ptr() for x in (q, k, v, do, lse, delta, dk, dv)]
    _launch_bwd("flash_attention_bwd_dkv", KERNEL_DKV, ptrs, q, k, sm_scale, causal_block)
    return dk, dv


def flash_attention_bwd_dq(q, k, v, do, lse, delta, *, sm_scale: float,
                           causal_block: Optional[int] = None) -> torch.Tensor:
    """dq by the ``dq`` kernel; CUDA bf16 tensors only."""
    _check_bwd(q, k, v, do, lse, delta, causal_block)
    dq = torch.empty_like(q)
    ptrs = [x.data_ptr() for x in (q, k, v, do, lse, delta, dq)]
    _launch_bwd("flash_attention_bwd_dq", KERNEL_DQ, ptrs, q, k, sm_scale, causal_block)
    return dq


def partial_flash_backward(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    do: torch.Tensor,
    lse: torch.Tensor,
    delta: torch.Tensor,
    *,
    sm_scale: Optional[float] = None,
    causal_block: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) given an external global LSE and delta = rowsum(do *
    out), in the dtypes of q, k, v: the ring-attention building block
    (opensora_tpu/ops/flash_attention.py:550). Both kernels for CUDA
    tensors, the plain backward for CPU tensors."""
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    if q.device.type == "cpu":
        dq, dk, dv = flash_attention_bwd_ref(q, k, v, do, lse, delta, sm_scale, causal_block)
        return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cuda or cpu tensors, got {q.device}")
    kw = dict(sm_scale=sm_scale, causal_block=causal_block)
    dk, dv = flash_attention_bwd_dkv(q, k, v, do, lse, delta, **kw)
    return flash_attention_bwd_dq(q, k, v, do, lse, delta, **kw), dk, dv


class FlashAttentionFunction(torch.autograd.Function):
    """Differentiable flash attention (the JAX package's ``custom_vjp``,
    opensora_tpu/ops/flash_attention.py:660-702): the forward kernel saves
    q, k, v, out and the LSE; the backward computes delta = rowsum(dO * O)
    in fp32 and runs the two backward kernels. Returns (out, lse); the LSE
    takes no gradient."""

    @staticmethod
    def forward(ctx, q, k, v, sm_scale: float, causal_block: Optional[int]):
        out, lse = _flash_forward(q, k, v, sm_scale, causal_block)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.sm_scale, ctx.causal_block = sm_scale, causal_block
        ctx.mark_non_differentiable(lse)
        return out, lse

    @staticmethod
    def backward(ctx, dout, _dlse):
        q, k, v, out, lse = ctx.saved_tensors
        dout = dout.to(q.dtype).contiguous()
        delta = (dout.float() * out.float()).sum(-1)
        dq, dk, dv = partial_flash_backward(
            q, k, v, dout, lse, delta, sm_scale=ctx.sm_scale, causal_block=ctx.causal_block
        )
        return dq, dk, dv, None, None


def flash_attention_with_lse(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    sm_scale: Optional[float] = None,
    causal_block: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(out (B, H, Lq, D) in q's dtype, lse (B, H, Lq) fp32); differentiable
    in q, k, v."""
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    return FlashAttentionFunction.apply(q, k, v, sm_scale, causal_block)


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    sm_scale: Optional[float] = None,
    causal_block: Optional[int] = None,
) -> torch.Tensor:
    """Attention over (B, H, L, D); differentiable in q, k, v."""
    return flash_attention_with_lse(q, k, v, sm_scale=sm_scale, causal_block=causal_block)[0]
