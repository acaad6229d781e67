"""Flash attention: the Hopper CUDA kernels, their wrappers, their plain
PyTorch versions and the autograd Function over them.

Counterpart of opensora_tpu/ops/flash_attention.py. The forward kernel
(``csrc/flash_attention_fwd.cu``) fuses the TPU's two forward kernels, ``_fwd_kernel`` and ``_fwd_kernel_anchored``: for bidirectional
attention each (b, h) takes the anchored loop when its Cauchy-Schwarz logit
bound A = sm_scale * log2(e) * max|q| * max|k| is below 40, and the
running-max loop otherwise. A is computed here on the device and read by
the kernel, so no call syncs with the host.

The backward ports ``_dkv_kernel`` and ``_dq_kernel`` twice. At D = 128
(the MMDiT) one fused warp-specialised wgmma/TMA kernel computes dK, dV and
an fp32 dQ sum, and a small epilogue kernel scales and rounds dQ
(``csrc/flash_attention_bwd_sm90.cu``). At D = 512 (the VAE mid-block, D
split over blocks) two kernels, ``dkv`` and ``dq``, do
(``csrc/flash_attention_bwd.cu``). P is recomputed from the forward's LSE;
delta = rowsum(dO * O) is plain torch (XLA fuses it beside the TPU
kernels). :class:`FlashAttentionFunction` ties forward
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
# the backward: D = 128 on the fused Hopper kernel and its dQ epilogue,
# D = 512 on the split dkv / dq pair; each kernel has its own launch count
FUSED_SOURCE = "flash_attention_bwd_sm90"
KERNEL_FUSED = "flash_attention_bwd_fused"
KERNEL_DQ_CONVERT = "flash_attention_bwd_dq_convert"
FUSED_HEAD_DIM = 128
FUSED_BLOCK_M = 64  # query rows per tile of the fused kernel (dq_accum's padding)
BWD_SOURCE = "flash_attention_bwd"
KERNEL_DKV = "flash_attention_bwd_dkv"
KERNEL_DQ = "flash_attention_bwd_dq"
SPLIT_HEAD_DIM = 512
BWD_HEAD_DIMS = (FUSED_HEAD_DIM, SPLIT_HEAD_DIM)

_lib = None
_bwd_lib = None
_fused_lib = None


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


def _kernel_lib_fused():
    global _fused_lib
    if _fused_lib is None:
        lib = _build.load(FUSED_SOURCE)
        vp, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.flash_attention_bwd_fused.argtypes = [vp] * 9 + [i] * 5 + [f, i, vp]
        lib.flash_attention_bwd_dq_convert.argtypes = [vp] * 2 + [i] * 4 + [f, vp]
        lib.flash_attention_bwd_fused.restype = ctypes.c_int
        lib.flash_attention_bwd_dq_convert.restype = ctypes.c_int
        lib.flash_attention_bwd_sm90_error_string.argtypes = [ctypes.c_int]
        lib.flash_attention_bwd_sm90_error_string.restype = ctypes.c_char_p
        _fused_lib = lib
    return _fused_lib


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
        raise ValueError(f"the flash-attention backward kernels take head dims {BWD_HEAD_DIMS}, got {q.shape[-1]}")
    if do.shape != q.shape or do.dtype != torch.bfloat16 or not do.is_contiguous():
        raise ValueError(f"do must be a contiguous bf16 tensor of q's shape, got {tuple(do.shape)} {do.dtype}")
    for name, x in (("lse", lse), ("delta", delta)):
        if x.shape != q.shape[:3] or x.dtype != torch.float32 or not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous fp32 of shape {tuple(q.shape[:3])}")
        if x.device != q.device:
            raise ValueError(f"{name} is on {x.device}, q on {q.device}")


def _check_head_dim(q, head_dim: int, kernel: str):
    if q.shape[-1] != head_dim:
        raise ValueError(f"{kernel} takes head dim {head_dim}, got {q.shape[-1]}")


def _launch_bwd(lib, error_string, kernel: str, args, q):
    """Calls the C function ``kernel`` (also its launch counter) on q's
    current stream; raises on a non-zero cudaError_t."""
    with torch.cuda.device(q.device):
        err = getattr(lib, kernel)(*args, torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{kernel} launch failed: {error_string(err).decode()} ({err})")
    _build.LAUNCHES[kernel] += 1


# dq_accum, the fused kernel's fp32 dQ sum: each 64-row query tile of a
# (b, h) is two consumers' 64 x 64 partials, each in the wgmma accumulator
# order [j 0..7][thread 0..127][4], thread t = 32 w + 4 g + q holding rows
# 16 w + g + 8 i and columns 64 c + 8 j + 2 q + e in its float 2 i + e.
# As dims: (B, H, tile, c, j, w, g, q, i, e) -> rows (tile, w, i, g),
# columns (c, j, q, e).
_ACCUM_DIMS = (2, 8, 4, 8, 4, 2, 2)  # c, j, w, g, q, i, e
_ACCUM_TO_ROWS = (0, 1, 2, 5, 8, 6, 3, 4, 7, 9)


def dq_accum_to_rows(dq_accum: torch.Tensor, lq: int) -> torch.Tensor:
    """(B, H, Lq, 128) fp32 rows and columns of a dq_accum."""
    b, h, n_rows, d = dq_accum.shape
    x = dq_accum.reshape(b, h, n_rows // FUSED_BLOCK_M, *_ACCUM_DIMS).permute(_ACCUM_TO_ROWS)
    return x.reshape(b, h, n_rows, d)[:, :, :lq]


def dq_rows_to_accum(dq: torch.Tensor) -> torch.Tensor:
    """The dq_accum (B, H, ceil(Lq / 64) * 64, 128) fp32 that holds dq
    (B, H, Lq, 128): the inverse of :func:`dq_accum_to_rows`."""
    b, h, lq, d = dq.shape
    n_rows = -(-lq // FUSED_BLOCK_M) * FUSED_BLOCK_M
    x = torch.nn.functional.pad(dq.float(), (0, 0, 0, n_rows - lq))
    c, j, w, g, q, i, e = _ACCUM_DIMS
    x = x.reshape(b, h, n_rows // FUSED_BLOCK_M, w, i, g, c, j, q, e)
    inverse = [_ACCUM_TO_ROWS.index(n) for n in range(10)]
    return x.permute(inverse).reshape(b, h, n_rows, d).contiguous()


def flash_attention_bwd_dq_convert_ref(dq_accum: torch.Tensor, lq: int, sm_scale: float) -> torch.Tensor:
    """Plain version of the dQ epilogue kernel: bf16(dq_accum * sm_scale)
    in rows and columns, (B, H, Lq, 128)."""
    return (dq_accum_to_rows(dq_accum, lq) * sm_scale).to(torch.bfloat16)


def _check_fused(q, k, v, do, lse, delta, causal_block):
    _check_bwd(q, k, v, do, lse, delta, causal_block)
    _check_head_dim(q, FUSED_HEAD_DIM, KERNEL_FUSED)
    for name, x in (("q", q), ("k", k), ("v", v), ("do", do)):
        if x.data_ptr() % 16:
            raise ValueError(f"{KERNEL_FUSED}: {name} must be 16-byte aligned (its TMA tensor map)")


def _check_dq_accum(dq_accum, lq):
    if (dq_accum.dim() != 4 or dq_accum.dtype != torch.float32 or not dq_accum.is_contiguous()
            or dq_accum.shape[2:] != (-(-lq // FUSED_BLOCK_M) * FUSED_BLOCK_M, FUSED_HEAD_DIM)):
        raise ValueError(f"dq_accum must be contiguous fp32 (B, H, ceil(Lq / {FUSED_BLOCK_M}) * {FUSED_BLOCK_M}, "
                         f"{FUSED_HEAD_DIM}) for Lq = {lq}, got {tuple(dq_accum.shape)} {dq_accum.dtype}")


def flash_attention_bwd_fused_accum(q, k, v, do, lse, delta, *, sm_scale: float, causal_block: Optional[int] = None
                                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq_accum, dk, dv) at D = 128 by the fused kernel: dK and dV in k's
    dtype and the unscaled fp32 dQ sum, added into a zeroed dq_accum.
    CUDA bf16 tensors launch the kernel (dQ's fp32 sum is taken in an order
    that changes from run to run); CPU tensors take the plain backward."""
    if q.device.type == "cpu":
        dq, dk, dv = flash_attention_bwd_ref(q, k, v, do, lse, delta, sm_scale, causal_block)
        return dq_rows_to_accum(dq / sm_scale), dk.to(k.dtype), dv.to(v.dtype)
    _check_fused(q, k, v, do, lse, delta, causal_block)
    b, h, lq, d = q.shape
    n_rows = -(-lq // FUSED_BLOCK_M) * FUSED_BLOCK_M
    dq_accum = torch.zeros((b, h, n_rows, d), dtype=torch.float32, device=q.device)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    lib = _kernel_lib_fused()
    ptrs = [x.data_ptr() for x in (q, k, v, do, lse, delta, dk, dv, dq_accum)]
    _launch_bwd(lib, lib.flash_attention_bwd_sm90_error_string, KERNEL_FUSED,
                [*ptrs, b, h, lq, k.shape[2], d, sm_scale, causal_block or 0], q)
    return dq_accum, dk, dv


def flash_attention_bwd_dq_convert(dq_accum: torch.Tensor, lq: int, *, sm_scale: float) -> torch.Tensor:
    """dq (B, H, Lq, 128) bf16 = dq_accum * sm_scale by the dQ epilogue
    kernel; CPU tensors take :func:`flash_attention_bwd_dq_convert_ref`."""
    if dq_accum.device.type == "cpu":
        return flash_attention_bwd_dq_convert_ref(dq_accum, lq, sm_scale)
    _check_dq_accum(dq_accum, lq)
    b, h, _, d = dq_accum.shape
    dq = torch.empty((b, h, lq, d), dtype=torch.bfloat16, device=dq_accum.device)
    lib = _kernel_lib_fused()
    _launch_bwd(lib, lib.flash_attention_bwd_sm90_error_string, KERNEL_DQ_CONVERT,
                [dq_accum.data_ptr(), dq.data_ptr(), b, h, lq, d, sm_scale], dq_accum)
    return dq


def flash_attention_bwd_fused(q, k, v, do, lse, delta, *, sm_scale: float,
                              causal_block: Optional[int] = None) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) at D = 128: the fused kernel, then the dQ epilogue."""
    dq_accum, dk, dv = flash_attention_bwd_fused_accum(q, k, v, do, lse, delta, sm_scale=sm_scale,
                                                       causal_block=causal_block)
    return flash_attention_bwd_dq_convert(dq_accum, q.shape[2], sm_scale=sm_scale), dk, dv


def _launch_split(kernel: str, ptrs, q, k, sm_scale, causal_block):
    b, h, lq, d = q.shape
    lib = _kernel_lib_bwd()
    _launch_bwd(lib, lib.flash_attention_bwd_error_string, kernel,
                [*ptrs, b, h, lq, k.shape[2], d, sm_scale, causal_block or 0], q)


def flash_attention_bwd_dkv(q, k, v, do, lse, delta, *, sm_scale: float,
                            causal_block: Optional[int] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dk, dv) by the ``dkv`` kernel at D = 512; CUDA bf16 tensors only."""
    _check_bwd(q, k, v, do, lse, delta, causal_block)
    _check_head_dim(q, SPLIT_HEAD_DIM, KERNEL_DKV)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    ptrs = [x.data_ptr() for x in (q, k, v, do, lse, delta, dk, dv)]
    _launch_split(KERNEL_DKV, ptrs, q, k, sm_scale, causal_block)
    return dk, dv


def flash_attention_bwd_dq(q, k, v, do, lse, delta, *, sm_scale: float,
                           causal_block: Optional[int] = None) -> torch.Tensor:
    """dq by the ``dq`` kernel at D = 512; CUDA bf16 tensors only."""
    _check_bwd(q, k, v, do, lse, delta, causal_block)
    _check_head_dim(q, SPLIT_HEAD_DIM, KERNEL_DQ)
    dq = torch.empty_like(q)
    ptrs = [x.data_ptr() for x in (q, k, v, do, lse, delta, dq)]
    _launch_split(KERNEL_DQ, ptrs, q, k, sm_scale, causal_block)
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
    (opensora_tpu/ops/flash_attention.py:550). CUDA tensors: the fused
    kernel and its dQ epilogue at D = 128, the dkv and dq kernels at D =
    512; CPU tensors: the plain backward."""
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    if q.device.type == "cpu":
        dq, dk, dv = flash_attention_bwd_ref(q, k, v, do, lse, delta, sm_scale, causal_block)
        return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cuda or cpu tensors, got {q.device}")
    kw = dict(sm_scale=sm_scale, causal_block=causal_block)
    if q.shape[-1] == FUSED_HEAD_DIM:
        return flash_attention_bwd_fused(q, k, v, do, lse, delta, **kw)
    dk, dv = flash_attention_bwd_dkv(q, k, v, do, lse, delta, **kw)
    return flash_attention_bwd_dq(q, k, v, do, lse, delta, **kw), dk, dv


class FlashAttentionFunction(torch.autograd.Function):
    """Differentiable flash attention (the JAX package's ``custom_vjp``,
    opensora_tpu/ops/flash_attention.py:660-702): the forward kernel saves
    q, k, v, out and the LSE; the backward computes delta = rowsum(dO * O)
    in fp32 and runs the backward kernels (``partial_flash_backward``).
    Returns (out, lse); the LSE takes no gradient."""

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
