"""W8A8 matrix products: the Hopper CUDA kernel, its wrappers and their
plain PyTorch versions.

Counterpart of opensora_tpu/ops/int8_matmul.py. One kernel source,
``csrc/int8_matmul_sm90.cu`` (TMA and int8 wgmma, persistent CTAs),
replaces its two TPU kernels with two instantiations of one main loop:

- :func:`w8a8_matmul` (``_w8a8_kernel``): int8 activations with per-row
  scales, the int8 A tile read by the products through a shared-memory
  descriptor; launch counter ``w8a8_matmul``;
- :func:`w8a8_fusedquant_matmul` (``_w8a8_fq_kernel``): bf16 activations,
  quantized inside the kernel against the per-row reciprocal computed here,
  straight into the products' A fragments; launch counter ``w8a8_fq_matmul``.

Both compute ``out[m, n] = (sum_k x8[m, k] * w[n, k]) * s_a[m] * s_w[n]``
with the int32 sum kept in registers. The weight is (N, K) int8, as torch
holds a linear layer's weight (the JAX package keeps (K, N)). CPU tensors
take the plain versions, which compute the integer sum exactly in float64
and then the kernel's fp32 epilogue, so kernel and plain version agree in
every element. A CUDA call launches the kernel or raises; it never falls
back to them.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from opensora_torch.ops import _build

SOURCE = "int8_matmul_sm90"
KERNEL = "w8a8_matmul"
KERNEL_FQ = "w8a8_fq_matmul"
K_TILE = 64  # the kernel's K step: K must be a multiple of it

_lib = None


def _kernel_lib():
    """The kernel library with its two entry points and error string typed."""
    global _lib
    if _lib is None:
        lib = _build.load(SOURCE)
        vp, i = ctypes.c_void_p, ctypes.c_int
        lib.w8a8_matmul.argtypes = [vp] * 5 + [i] * 4 + [vp]
        lib.w8a8_fq_matmul.argtypes = [vp] * 6 + [i] * 4 + [vp]
        lib.w8a8_matmul.restype = lib.w8a8_fq_matmul.restype = ctypes.c_int
        lib.int8_matmul_sm90_error_string.argtypes = [ctypes.c_int]
        lib.int8_matmul_sm90_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def act_scale(x: torch.Tensor) -> torch.Tensor:
    """Per-row activation scale (M, 1) fp32: max(max|x| / 127, 1e-8), as
    ``QuantDense`` and ``w8a8_fusedquant_matmul`` compute it."""
    return torch.clamp(x.float().abs().amax(dim=-1, keepdim=True) / 127.0, min=1e-8)


def quantize_rows(x: torch.Tensor, s_a: torch.Tensor) -> torch.Tensor:
    """clip(round(x / s_a), -127, 127) as int8 (the XLA path divides)."""
    return torch.clamp(torch.round(x.float() / s_a), -127, 127).to(torch.int8)


def _epilogue(acc: torch.Tensor, s_a: torch.Tensor, s_w: torch.Tensor, out_dtype) -> torch.Tensor:
    return (acc.float() * s_a.reshape(-1, 1).float() * s_w.float()).to(out_dtype)


def w8a8_matmul_ref(x8: torch.Tensor, w: torch.Tensor, s_a: torch.Tensor, s_w: torch.Tensor,
                    out_dtype=torch.bfloat16) -> torch.Tensor:
    """Plain version: the integer product exact in float64 (every partial
    sum is an integer far below 2^53), then float(acc) * s_a * s_w in fp32."""
    acc = x8.double() @ w.double().T
    return _epilogue(acc, s_a, s_w, out_dtype)


def fq_inputs(x: torch.Tensor, s_a: Optional[torch.Tensor] = None):
    """(s_a (M, 1), inv = 1 / s_a (M, 1)) fp32 of the fused-quant kernel;
    ``s_a`` given (a row cut over tp ranks: the whole row's scale), only
    the reciprocal is computed."""
    s_a = act_scale(x) if s_a is None else s_a.reshape(-1, 1)
    return s_a, 1.0 / s_a


def w8a8_fusedquant_matmul_ref(x: torch.Tensor, w: torch.Tensor, s_w: torch.Tensor,
                               out_dtype=torch.bfloat16, s_a: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain version of the fused-quant product: x quantized against the
    reciprocal, clip(round(x * inv), -127, 127), then as w8a8_matmul_ref."""
    s_a, inv = fq_inputs(x, s_a)
    x8 = torch.clamp(torch.round(x.float() * inv), -127, 127)
    return _epilogue(x8.double() @ w.double().T, s_a, s_w, out_dtype)


def _check(x, w, s_w, x_dtype, out_dtype):
    if x.dtype != x_dtype:
        raise TypeError(f"the W8A8 kernel takes {x_dtype} activations here, got {x.dtype}")
    if w.dtype != torch.int8 or s_w.dtype != torch.float32:
        raise TypeError(f"weight must be int8 and s_w fp32, got {w.dtype} and {s_w.dtype}")
    if x.dim() != 2 or w.dim() != 2 or x.shape[1] != w.shape[1] or s_w.shape != (w.shape[0],):
        raise ValueError(f"shapes: x {tuple(x.shape)}, w {tuple(w.shape)}, s_w {tuple(s_w.shape)}; "
                         "expected (M, K), (N, K), (N,)")
    if x.shape[1] % K_TILE:
        raise ValueError(f"K = {x.shape[1]} must be a multiple of the kernel's K tile {K_TILE}")
    if out_dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"out_dtype must be bf16 or fp32, got {out_dtype}")
    for name, t in (("x", x), ("w", w), ("s_w", s_w)):
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    for name, t in (("x", x), ("w", w)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned (the kernel loads its tiles through TMA tensor maps)")


def _launch(kernel, ptrs, x, w, out):
    """Launches entry point KERNEL (also its launch counter's name)."""
    lib = _kernel_lib()
    with torch.cuda.device(x.device):
        err = getattr(lib, kernel)(
            *ptrs, out.data_ptr(), x.shape[0], w.shape[0], x.shape[1], int(out.dtype == torch.float32),
            torch.cuda.current_stream(x.device).cuda_stream,
        )
    if err != 0:
        msg = lib.int8_matmul_sm90_error_string(err).decode()
        raise RuntimeError(f"{kernel} launch failed: {msg} ({err})")
    _build.LAUNCHES[kernel] += 1
    return out


def _on_cuda(x: torch.Tensor) -> bool:
    if x.device.type == "cpu":
        return False
    if x.device.type != "cuda":
        raise ValueError(f"the W8A8 products run on cuda or cpu tensors, got {x.device}")
    return True


def w8a8_matmul(x8: torch.Tensor, w: torch.Tensor, s_a: torch.Tensor, s_w: torch.Tensor,
                out_dtype: Optional[torch.dtype] = torch.bfloat16) -> torch.Tensor:
    """(M, K) int8 x (N, K) int8 weight -> (M, N) in ``out_dtype``, rescaled
    by s_a (M, 1) or (M,) and s_w (N,), fp32."""
    if not _on_cuda(x8):
        return w8a8_matmul_ref(x8, w, s_a, s_w, out_dtype)
    _check(x8, w, s_w, torch.int8, out_dtype)
    s_a = s_a.reshape(-1)
    if s_a.shape != (x8.shape[0],) or s_a.dtype != torch.float32 or not s_a.is_contiguous():
        raise ValueError(f"s_a must be {x8.shape[0]} contiguous fp32 row scales, got {tuple(s_a.shape)}")
    out = torch.empty((x8.shape[0], w.shape[0]), dtype=out_dtype, device=x8.device)
    return _launch(KERNEL, [x8.data_ptr(), w.data_ptr(), s_a.data_ptr(), s_w.data_ptr()],
                   x8, w, out)


def w8a8_fusedquant_matmul(x: torch.Tensor, w: torch.Tensor, s_w: torch.Tensor,
                           out_dtype: Optional[torch.dtype] = torch.bfloat16,
                           s_a: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Dynamic W8A8 product of bf16 activations (M, K), quantized inside the
    kernel: s_a = max(max|x| / 127, 1e-8) per row, x8 = clip(round(x *
    (1 / s_a)), -127, 127). Only the row abs-max is computed outside, or
    given as ``s_a`` (M, 1) fp32 where x holds a tp rank's slice of each
    row and the scale is the whole row's."""
    if not _on_cuda(x):
        return w8a8_fusedquant_matmul_ref(x, w, s_w, out_dtype, s_a)
    _check(x, w, s_w, torch.bfloat16, out_dtype)
    s_a, inv = fq_inputs(x, s_a)
    return fq_kernel(x, w, s_w, s_a.contiguous(), inv.contiguous(), out_dtype=out_dtype)


def fq_kernel(x, w, s_w, s_a, inv, out_dtype=torch.bfloat16) -> torch.Tensor:
    """The fused-quant kernel alone, given the row scales and reciprocals
    of :func:`fq_inputs` (checked inputs on the card)."""
    out = torch.empty((x.shape[0], w.shape[0]), dtype=out_dtype, device=x.device)
    return _launch(KERNEL_FQ, [x.data_ptr(), w.data_ptr(), inv.data_ptr(), s_a.data_ptr(), s_w.data_ptr()], x, w, out)
