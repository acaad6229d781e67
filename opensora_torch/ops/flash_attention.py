"""Flash attention: the Hopper CUDA kernels, their wrappers, their plain
PyTorch versions and the autograd Function over them.

Counterpart of opensora_tpu/ops/flash_attention.py. The forward ports the
TPU's two forward kernels, ``_fwd_kernel`` and ``_fwd_kernel_anchored``,
and the choice between them: for bidirectional attention each (b, h) takes
the anchored loop when its Cauchy-Schwarz logit bound A = sm_scale *
log2(e) * max|q| * max|k| is below 40, and the running-max loop otherwise.
A is computed here on the device and read by the kernel, so no call syncs
with the host. Both head dims run one warp-specialised wgmma/TMA kernel for
both loops: D = 128 (the MMDiT) ``csrc/flash_attention_fwd_sm90.cu``, D =
512 (the VAE mid-block, 64 query rows x all 512 columns a CTA)
``csrc/flash_attention_fwd_d512_sm90.cu``.

The backward ports ``_dkv_kernel`` and ``_dq_kernel``: one warp-specialised
wgmma/TMA kernel computes dK, dV and an fp32 dQ sum, and a small epilogue
kernel scales and rounds dQ, at D = 128 (``csrc/flash_attention_bwd_sm90.cu``,
the minimal backward's 5 products) and at D = 512
(``csrc/flash_attention_bwd_d512_sm90.cu``, dV CTAs and dK / dQ CTAs side by
side: 6 products). P is recomputed from the forward's LSE; delta =
rowsum(dO * O) is plain torch (XLA fuses it beside the TPU kernels).
:class:`FlashAttentionFunction` ties forward and backward together as the
JAX package's ``custom_vjp`` does, and every attention call of the port
goes through it.

Layout (B, H, L, D). The wrappers launch the kernels for CUDA tensors and
raise on anything a kernel does not take (dtype other than bf16, a head
dim it was not built for, non-contiguous or not 16-byte aligned input);
CPU tensors go to the plain versions, :func:`flash_attention_ref` and
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
SUPPORTED_HEAD_DIMS = (128, 512)
# the forward: one kernel a head dim, each with its own launch count (its C
# entry's name)
FWD_SM90_SOURCE = "flash_attention_fwd_sm90"
KERNEL_FWD_SM90 = "flash_attention_fwd_sm90"
FWD_SM90_HEAD_DIM = 128
FWD_D512_SOURCE = "flash_attention_fwd_d512_sm90"
KERNEL_FWD_D512 = "flash_attention_fwd_d512"
D512_HEAD_DIM = 512
# the backward: a kernel and its dQ epilogue a head dim, each with its own
# launch count
FUSED_SOURCE = "flash_attention_bwd_sm90"
KERNEL_FUSED = "flash_attention_bwd_fused"
KERNEL_DQ_CONVERT = "flash_attention_bwd_dq_convert"
FUSED_HEAD_DIM = 128
FUSED_BLOCK_M = 64  # query rows per tile of the fused kernel (dq_accum's padding)
BWD_D512_SOURCE = "flash_attention_bwd_d512_sm90"
KERNEL_BWD_D512 = "flash_attention_bwd_d512"
KERNEL_BWD_D512_DQ_CONVERT = "flash_attention_bwd_d512_dq_convert"
D512_BLOCK_Q = 32  # query rows per tile of the D = 512 dK / dQ CTAs (dq_accum's padding)
BWD_HEAD_DIMS = (FUSED_HEAD_DIM, D512_HEAD_DIM)

_libs: dict = {}


def _kernel_lib(source: str, entries: dict, error_string: str):
    """The ctypes library of ``source`` with the argument types of its C
    entries set (``entries``: name -> (pointer count, int count, trailing
    types before the stream)); every entry returns a cudaError_t."""
    lib = _libs.get(source)
    if lib is None:
        lib = _build.load(source)
        vp, i = ctypes.c_void_p, ctypes.c_int
        for name, (n_ptr, n_int, tail) in entries.items():
            fn = getattr(lib, name)
            fn.argtypes = [vp] * n_ptr + [i] * n_int + list(tail) + [vp]
            fn.restype = ctypes.c_int
        getattr(lib, error_string).argtypes = [ctypes.c_int]
        getattr(lib, error_string).restype = ctypes.c_char_p
        _libs[source] = lib
    return lib


_F, _I = ctypes.c_float, ctypes.c_int
# head dim -> (source, its C entries, its error-string function)
_FWD_ENTRIES = {
    FWD_SM90_HEAD_DIM: (FWD_SM90_SOURCE, {KERNEL_FWD_SM90: (6, 5, (_F, _I))}, "flash_attention_fwd_sm90_error_string"),
    D512_HEAD_DIM: (FWD_D512_SOURCE, {KERNEL_FWD_D512: (6, 5, (_F, _I))}, "flash_attention_fwd_d512_error_string"),
}
_BWD_ENTRIES = {
    FUSED_HEAD_DIM: (FUSED_SOURCE, {KERNEL_FUSED: (9, 5, (_F, _I)), KERNEL_DQ_CONVERT: (2, 4, (_F,))},
                     "flash_attention_bwd_sm90_error_string"),
    D512_HEAD_DIM: (BWD_D512_SOURCE, {KERNEL_BWD_D512: (9, 5, (_F, _I)), KERNEL_BWD_D512_DQ_CONVERT: (2, 4, (_F,))},
                    "flash_attention_bwd_d512_error_string"),
}


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


def _check_aligned(kernel: str, tensors):
    for name, x in tensors:
        if x.data_ptr() % 16:
            raise ValueError(f"{kernel}: {name} must be 16-byte aligned (its TMA tensor map)")


def _flash_forward(q, k, v, sm_scale: float, causal_block: Optional[int]):
    """(out in q's dtype, lse fp32): the kernel for CUDA tensors (D = 128:
    ``flash_attention_fwd_sm90``; D = 512: ``flash_attention_fwd_d512``),
    the plain version for CPU tensors."""
    if q.device.type == "cpu":
        out, lse = flash_attention_ref(q, k, v, sm_scale, causal_block)
        return out.to(q.dtype), lse
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cuda or cpu tensors, got {q.device}")
    _check(q, k, v, causal_block)
    b, h, lq, d = q.shape
    source, entries, error_string = _FWD_ENTRIES[d]
    name = next(iter(entries))
    _check_aligned(name, (("q", q), ("k", k), ("v", v)))
    out = torch.empty_like(q)
    lse = torch.empty((b, h, lq), dtype=torch.float32, device=q.device)
    anchor = anchor_log2(q, k, sm_scale) if causal_block is None else None
    lib = _kernel_lib(source, entries, error_string)
    args = [q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), lse.data_ptr(),
            anchor.data_ptr() if anchor is not None else None,
            b, h, lq, k.shape[2], d, sm_scale * LOG2E, causal_block or 0]
    with torch.cuda.device(q.device):
        err = getattr(lib, name)(*args, torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: {getattr(lib, error_string)(err).decode()} ({err})")
    _build.LAUNCHES[name] += 1
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


def _launch_bwd(lib, error_string, kernel: str, args, q):
    """Calls the C function ``kernel`` (also its launch counter) on q's
    current stream; raises on a non-zero cudaError_t."""
    with torch.cuda.device(q.device):
        err = getattr(lib, kernel)(*args, torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{kernel} launch failed: {error_string(err).decode()} ({err})")
    _build.LAUNCHES[kernel] += 1


# dq_accum, the backward kernel's fp32 dQ sum, in the order the kernel of
# its head dim adds it.
#
# D = 128 (the fused kernel): each 64-row query tile of a (b, h) is two
# consumers' 64 x 64 partials, each in the wgmma accumulator order [j
# 0..7][thread 0..127][4], thread t = 32 w + 4 g + q holding rows 16 w + g +
# 8 i and columns 64 c + 8 j + 2 q + e in its float 2 i + e. As dims: (B, H,
# tile, c, j, w, g, q, i, e) -> rows (tile, w, i, g), columns (c, j, q, e).
# The plain ring backward keeps the same order at the narrow head dims of
# small models (see _accum_dims).
_ACCUM_TO_ROWS = (0, 1, 2, 5, 8, 6, 3, 4, 7, 9)
# D = 512: each 32-row query tile of a (b, h) holds the two consumers' dQ^T
# blocks, [w 0..1][mb 0..3][j 0..3][thread 0..127][4], thread t = 32 warp +
# 4 g + q holding column 256 w + 64 mb + 16 warp + g + 8 i and row 8 j + 2 q
# + e in its float 2 i + e (the m64n32 accumulator of dQ^T). As dims: (B, H,
# tile, w, mb, j, warp, g, q, i, e) -> rows (tile, j, q, e), columns (w, mb,
# warp, i, g).
_D512_ACCUM_DIMS = (2, 4, 4, 4, 8, 4, 2, 2)
_D512_ACCUM_TO_ROWS = (0, 1, 2, 5, 8, 10, 3, 4, 6, 9, 7)


def _accum_dims(d: int):
    """(c, j, w, g, q, i, e) of a dq_accum of head dim d != 512: (2, 8, 4, 8,
    4, 2, 2) at 128, the kernel's; at other d, 64-column halves c where d
    allows and 8-column groups j where a half allows, else the columns in
    order."""
    c = d // 64 if d % 64 == 0 else 1
    half = d // c
    j, q, e = (half // 8, 4, 2) if half % 8 == 0 else (1, 1, half)
    return c, j, 4, 8, q, 2, e


def dq_accum_rows(lq: int, d: int) -> int:
    """Rows of a dq_accum of head dim d: Lq padded to the kernel's query
    tile (32 rows at D = 512, 64 at the other head dims)."""
    block = D512_BLOCK_Q if d == D512_HEAD_DIM else FUSED_BLOCK_M
    return -(-lq // block) * block


def dq_accum_to_rows(dq_accum: torch.Tensor, lq: int) -> torch.Tensor:
    """(B, H, Lq, D) fp32 rows and columns of a dq_accum."""
    b, h, n_rows, d = dq_accum.shape
    if d == D512_HEAD_DIM:
        x = dq_accum.reshape(b, h, n_rows // D512_BLOCK_Q, *_D512_ACCUM_DIMS).permute(_D512_ACCUM_TO_ROWS)
    else:
        x = dq_accum.reshape(b, h, n_rows // FUSED_BLOCK_M, *_accum_dims(d)).permute(_ACCUM_TO_ROWS)
    return x.reshape(b, h, n_rows, d)[:, :, :lq]


def dq_rows_to_accum(dq: torch.Tensor) -> torch.Tensor:
    """The dq_accum (B, H, dq_accum_rows(Lq, D), D) fp32 that holds dq
    (B, H, Lq, D): the inverse of :func:`dq_accum_to_rows`."""
    b, h, lq, d = dq.shape
    n_rows = dq_accum_rows(lq, d)
    x = torch.nn.functional.pad(dq.float(), (0, 0, 0, n_rows - lq))
    if d == D512_HEAD_DIM:
        w, mb, j, warp, g, q, i, e = _D512_ACCUM_DIMS
        x, order = x.reshape(b, h, n_rows // D512_BLOCK_Q, j, q, e, w, mb, warp, i, g), _D512_ACCUM_TO_ROWS
    else:
        c, j, w, g, q, i, e = _accum_dims(d)
        x, order = x.reshape(b, h, n_rows // FUSED_BLOCK_M, w, i, g, c, j, q, e), _ACCUM_TO_ROWS
    inverse = [order.index(n) for n in range(len(order))]
    return x.permute(inverse).reshape(b, h, n_rows, d).contiguous()


def flash_attention_bwd_dq_convert_ref(dq_accum: torch.Tensor, lq: int, sm_scale: float) -> torch.Tensor:
    """Plain version of the dQ epilogue kernels: bf16(dq_accum * sm_scale)
    in rows and columns, (B, H, Lq, D)."""
    return (dq_accum_to_rows(dq_accum, lq) * sm_scale).to(torch.bfloat16)


def _check_kernel_bwd(q, k, v, do, lse, delta, causal_block):
    _check_bwd(q, k, v, do, lse, delta, causal_block)
    _check_aligned(next(iter(_BWD_ENTRIES[q.shape[-1]][1])), (("q", q), ("k", k), ("v", v), ("do", do)))


def _check_dq_accum(dq_accum, lq):
    d = dq_accum.shape[-1] if dq_accum.dim() == 4 else None
    if (d not in BWD_HEAD_DIMS or dq_accum.dtype != torch.float32 or not dq_accum.is_contiguous()
            or dq_accum.shape[2] != dq_accum_rows(lq, d)):
        raise ValueError(f"dq_accum must be contiguous fp32 (B, H, dq_accum_rows(Lq, D), D), D in {BWD_HEAD_DIMS}, "
                         f"for Lq = {lq}, got {tuple(dq_accum.shape)} {dq_accum.dtype}")


def flash_attention_bwd_accum(q, k, v, do, lse, delta, *, sm_scale: float, causal_block: Optional[int] = None
                              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq_accum, dk, dv) by the backward kernel of q's head dim (D = 128:
    the fused kernel; D = 512: its dV CTAs and dK / dQ CTAs in one launch):
    dK and dV in k's dtype and the unscaled fp32 dQ sum, added into a zeroed
    dq_accum. CUDA bf16 tensors launch the kernel (dQ's fp32 sum is taken in
    an order that changes from run to run); CPU tensors take the plain
    backward."""
    if q.device.type == "cpu":
        dq, dk, dv = flash_attention_bwd_ref(q, k, v, do, lse, delta, sm_scale, causal_block)
        return dq_rows_to_accum(dq / sm_scale), dk.to(k.dtype), dv.to(v.dtype)
    _check_kernel_bwd(q, k, v, do, lse, delta, causal_block)
    b, h, lq, d = q.shape
    dq_accum = torch.zeros((b, h, dq_accum_rows(lq, d), d), dtype=torch.float32, device=q.device)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    source, entries, error_string = _BWD_ENTRIES[d]
    lib = _kernel_lib(source, entries, error_string)
    ptrs = [x.data_ptr() for x in (q, k, v, do, lse, delta, dk, dv, dq_accum)]
    _launch_bwd(lib, getattr(lib, error_string), next(iter(entries)),
                [*ptrs, b, h, lq, k.shape[2], d, sm_scale, causal_block or 0], q)
    return dq_accum, dk, dv


def flash_attention_bwd_dq_convert(dq_accum: torch.Tensor, lq: int, *, sm_scale: float) -> torch.Tensor:
    """dq (B, H, Lq, D) bf16 = dq_accum * sm_scale by the dQ epilogue kernel
    of dq_accum's head dim; CPU tensors take
    :func:`flash_attention_bwd_dq_convert_ref`."""
    if dq_accum.device.type == "cpu":
        return flash_attention_bwd_dq_convert_ref(dq_accum, lq, sm_scale)
    _check_dq_accum(dq_accum, lq)
    b, h, _, d = dq_accum.shape
    dq = torch.empty((b, h, lq, d), dtype=torch.bfloat16, device=dq_accum.device)
    source, entries, error_string = _BWD_ENTRIES[d]
    lib = _kernel_lib(source, entries, error_string)
    _launch_bwd(lib, getattr(lib, error_string), list(entries)[1],
                [dq_accum.data_ptr(), dq.data_ptr(), b, h, lq, d, sm_scale], dq_accum)
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
    (opensora_tpu/ops/flash_attention.py:550). CUDA tensors: the backward
    kernel of the head dim and its dQ epilogue; CPU tensors: the plain
    backward."""
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    if q.device.type == "cpu":
        dq, dk, dv = flash_attention_bwd_ref(q, k, v, do, lse, delta, sm_scale, causal_block)
        return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cuda or cpu tensors, got {q.device}")
    dq_accum, dk, dv = flash_attention_bwd_accum(q, k, v, do, lse, delta, sm_scale=sm_scale,
                                                 causal_block=causal_block)
    return flash_attention_bwd_dq_convert(dq_accum, q.shape[2], sm_scale=sm_scale), dk, dv


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
