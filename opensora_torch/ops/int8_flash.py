"""Int8 flash attention for serving (forward only): the Hopper CUDA kernel,
its quantize preamble, its wrapper and its plain PyTorch version.

Counterpart of opensora_tpu/ops/int8_flash.py, SageAttention-style:

- K is smoothed (k - mean over L; softmax is invariant to the per-row
  constant q . mean k) and quantized to int8 with ONE scale per ``block_k``
  tile; Q per token, its scale carrying sm_scale * log2(e), so that
  int32 Q K^T * sq * sk is the exp2-domain logit.
- "qk8" (``pv_int8=False``): P.V in bf16. "int8" (``pv_int8=True``): V is
  smoothed too (its mean is added back at the end) and quantized per
  channel, P per row against its row max over each quantization tile, and
  P.V runs on int8.
- The softmax denominator is the exact fp32 sum of the unquantized p.

The quantization tile ``block_k`` is part of the function, so the default
is the JAX package's own rule (:func:`default_block_k`, a copy of the bk
rule of ``pick_blocks``). The kernel (``csrc/int8_flash_attention.cu``:
TMA and int8 wgmma, a producer warpgroup and two consumers of 64 query
rows) has two modes, qk8 and pv_int8, with the launch counters
``int8_flash_attention`` and ``int8_flash_attention_pv8``; each CTA
chooses the anchored or the running-max loop for its (b, h) from a device
tensor, so no call syncs with the host.

Layout (B, H, L, D). CPU tensors take :func:`int8_flash_attention_ref`. A
CUDA call launches the kernel (bf16, D = 128, bidirectional) or raises.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch
import torch.nn.functional as F

from opensora_torch.ops import _build

SOURCE = "int8_flash_attention"
KERNEL = "int8_flash_attention"  # the qk8 instantiation's launch counter
KERNEL_PV8 = "int8_flash_attention_pv8"  # the pv_int8 instantiation's
HEAD_DIM = 128
COMPUTE_TILE = 64  # the kernel's smallest key tile; block_k must be a multiple, or cover L
LOG2E = 1.4426950408889634
NEG_INF = -1e30
ANCHOR_MAX_LOG2 = 40.0
# within each 16-key group, v8t position p holds key PERM_16[p]: the keys a
# thread's s32 score fragment holds, in the order of its s8 A fragment
PERM_16 = [8 * ((p % 4) // 2) + 2 * (p // 4) + p % 2 for p in range(16)]

_lib = None


def _kernel_lib():
    global _lib
    if _lib is None:
        lib = _build.load(SOURCE)
        vp, i = ctypes.c_void_p, ctypes.c_int
        lib.int8_flash_attention_fwd.argtypes = [vp] * 8 + [i] * 8 + [vp]
        lib.int8_flash_attention_fwd.restype = ctypes.c_int
        lib.int8_flash_attention_error_string.argtypes = [ctypes.c_int]
        lib.int8_flash_attention_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def default_block_k(kv_len: int, dim: int = HEAD_DIM) -> int:
    """The JAX package's quantization tile for this length: the bk rule of
    ``pick_blocks`` (opensora_tpu/ops/flash_attention.py:105-112), capped
    at kv_len."""
    if kv_len >= 2560:
        bk = 1536
        if dim <= 128 and kv_len % 1536 != 0 and kv_len % 1664 == 0:
            bk = 1664
    elif kv_len >= 2048:
        bk = 1024
    else:
        bk = 512
    return min(bk, kv_len)


def _quantize_rows(x: torch.Tensor, dim: int):
    """(int8, fp32 scale): symmetric int8 along ``dim``, scale = max(max|x|,
    1e-8) / 127."""
    xf = x.float()
    scale = torch.clamp(xf.abs().amax(dim=dim, keepdim=True), min=1e-8) / 127.0
    return torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8), scale


def quantize_inputs(q, k, v, sm_scale: float, block_k: int, pv_int8: bool) -> dict:
    """The quantize preamble (opensora_tpu/ops/int8_flash.py:261-288, 347-351):
    q8, sq (B, H, Lq, 1) with sm_scale * log2(e) folded in; k8 of the
    centred K, sk (B, H, nk, 1) one per block_k tile; v (bf16 in qk8 mode)
    or v8 with sv (B, H, 1, D) and v_mean (pv_int8); a2 (B, H)."""
    b, h, lk, d = k.shape
    q8, sq = _quantize_rows(q, -1)
    sq = sq * (sm_scale * LOG2E)
    kf = k.float() - k.float().mean(dim=2, keepdim=True)
    nk = -(-lk // block_k)
    tiles = F.pad(kf, (0, 0, 0, nk * block_k - lk)).reshape(b, h, nk, block_k * d)
    sk = torch.clamp(tiles.abs().amax(dim=-1, keepdim=True), min=1e-8) / 127.0
    k8 = torch.clamp(torch.round(tiles / sk), -127, 127).to(torch.int8)
    k8 = k8.reshape(b, h, nk * block_k, d)[:, :, :lk].contiguous()
    qn = q.float().square().sum(dim=-1).sqrt().amax(dim=-1)
    kn = kf.square().sum(dim=-1).sqrt().amax(dim=-1)
    out = dict(q8=q8, sq=sq, k8=k8, sk=sk, a2=((sm_scale * LOG2E) * qn * kn).contiguous(),
               block_k=block_k, nk=nk)
    if pv_int8:
        v_mean = v.float().mean(dim=2, keepdim=True)
        out["v8"], out["sv"] = _quantize_rows(v.float() - v_mean, 2)
        out["v_mean"] = v_mean
    else:
        out["v"] = v.to(q.dtype)
    return out


def int8_flash_attention_ref(q, k, v, sm_scale: Optional[float] = None, block_k: Optional[int] = None,
                             pv_int8: bool = True) -> torch.Tensor:
    """Plain version, fp32 output (B, H, Lq, D): the same quantization as
    the kernel, the softmax in fp32 over each whole row. In qk8 mode P is
    rounded to V's dtype (bf16 on the card) before P.V. In pv_int8 mode
    P8 = round(p * 127 / p_scale) per quantization tile, with p anchored at
    a2 where a2 < 40 and otherwise at the running max over tiles, as the
    kernel (and the TPU's two kernels) anchor it."""
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    lk = k.shape[2]
    block_k = min(block_k or default_block_k(lk, q.shape[-1]), lk)
    return attention_from_quantized(quantize_inputs(q, k, v, sm_scale, block_k, pv_int8), pv_int8)


def attention_from_quantized(pre: dict, pv_int8: bool) -> torch.Tensor:
    """The plain version's math on the preamble's output (see
    :func:`int8_flash_attention_ref`), fp32."""
    nk, block_k, lk = pre["nk"], pre["block_k"], pre["k8"].shape[2]
    s32 = pre["q8"].float() @ pre["k8"].float().transpose(-1, -2)  # exact: |sums| < 2^24
    sk_col = pre["sk"][..., 0].repeat_interleave(block_k, dim=-1)[..., :lk]
    s = s32 * (pre["sq"] * sk_col[..., None, :])  # log2-domain logits
    if not pv_int8:
        p = torch.exp2(s - s.amax(dim=-1, keepdim=True))
        vv = pre["v"]
        return (p.to(vv.dtype).float() @ vv.float()) / p.sum(dim=-1, keepdim=True)

    b, h, lq, _ = s.shape
    sp = F.pad(s, (0, nk * block_k - lk), value=NEG_INF).reshape(b, h, lq, nk, block_k)
    tmax = sp.amax(dim=-1)
    m_run = torch.cummax(tmax, dim=-1).values
    m_safe = torch.where(m_run <= NEG_INF * 0.5, torch.zeros_like(m_run), m_run)
    a2 = pre["a2"][..., None, None]
    anc = torch.where(a2 < ANCHOR_MAX_LOG2, a2.expand_as(m_safe), m_safe)
    p = torch.exp2(sp - anc[..., None])
    p_scale = torch.clamp(p.amax(dim=-1), min=1e-8)
    p8 = torch.round(p * (127.0 / p_scale)[..., None])
    v8 = F.pad(pre["v8"].float(), (0, 0, 0, nk * block_k - lk)).reshape(b, h, nk, block_k, -1)
    pv = torch.einsum("bhqtk,bhtkd->bhqtd", p8, v8)
    pv = pv * (p_scale * (1.0 / 127.0))[..., None] * pre["sv"][:, :, None]
    w = torch.exp2(anc - anc[..., -1:])  # each tile's weight at the last anchor
    num = (pv * w[..., None]).sum(dim=-2)
    den = (p.sum(dim=-1) * w).sum(dim=-1, keepdim=True)
    return num / torch.where(den <= 0, torch.ones_like(den), den) + pre["v_mean"]


def _check(q, k, v, block_k):
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.dtype != torch.bfloat16:
            raise TypeError(f"int8_flash_attention kernel takes bf16, got {name}.dtype={x.dtype}")
        if x.dim() != 4:
            raise ValueError(f"{name} must be (B, H, L, D), got shape {tuple(x.shape)}")
        if x.device != q.device:
            raise ValueError(f"{name} is on {x.device}, q on {q.device}")
    b, h, _, d = q.shape
    if k.shape != v.shape or k.shape[:2] != (b, h) or k.shape[3] != d:
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)}")
    if d != HEAD_DIM:
        raise ValueError(f"int8_flash_attention kernel takes head dim {HEAD_DIM}, got {d}")
    if block_k % COMPUTE_TILE and block_k < k.shape[2]:
        raise ValueError(f"block_k {block_k} must be a multiple of {COMPUTE_TILE} or cover kv_len {k.shape[2]}")


def _v8_transposed(v8: torch.Tensor) -> torch.Tensor:
    """(B, H, L, D) int8 -> (B, H, D, Lv) with Lv the multiple of 64 above
    L, zero-padded, keys permuted by PERM_16 in every 16-key group."""
    b, h, lk, d = v8.shape
    lv = -(-lk // COMPUTE_TILE) * COMPUTE_TILE
    vt = F.pad(v8, (0, 0, 0, lv - lk)).transpose(2, 3).reshape(b, h, d, lv // 16, 16)
    perm = torch.tensor(PERM_16, device=v8.device)
    return vt.index_select(-1, perm).reshape(b, h, d, lv).contiguous()


def int8_flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                         sm_scale: Optional[float] = None, block_k: Optional[int] = None,
                         pv_int8: bool = True) -> torch.Tensor:
    """Int8 attention over (B, H, L, D), bidirectional; returns (B, H, Lq, D)
    in q's dtype. ``pv_int8=False`` is the "qk8" mode."""
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    lk = k.shape[2]
    block_k = min(block_k or default_block_k(lk, q.shape[-1]), lk)
    if q.device.type == "cpu":
        return int8_flash_attention_ref(q, k, v, sm_scale, block_k, pv_int8).to(q.dtype)
    if q.device.type != "cuda":
        raise ValueError(f"int8_flash_attention runs on cuda or cpu tensors, got {q.device}")
    _check(q, k, v, block_k)
    pre = kernel_inputs(q, k, v, sm_scale, block_k, pv_int8)
    out = launch(pre, pv_int8)
    if pv_int8:
        out = (out.float() + pre["v_mean"]).to(q.dtype)
    return out


def kernel_inputs(q, k, v, sm_scale: float, block_k: int, pv_int8: bool) -> dict:
    """The preamble's output in the kernel's layouts: V8 transposed and
    key-permuted (pv_int8)."""
    pre = quantize_inputs(q, k, v, sm_scale, block_k, pv_int8)
    pre["vin"] = _v8_transposed(pre["v8"]) if pv_int8 else pre["v"].contiguous()
    return pre


def launch(pre: dict, pv_int8: bool) -> torch.Tensor:
    """The kernel alone on :func:`kernel_inputs`' output: (B, H, Lq, D) bf16,
    without V's mean (pv_int8)."""
    b, h, lq, d = pre["q8"].shape
    lk = pre["k8"].shape[2]
    vin = pre["vin"]
    sv = pre["sv"] if pv_int8 else pre["sq"]  # the kernel reads sv only in pv_int8 mode
    for name, t in (("q8", pre["q8"]), ("k8", pre["k8"]), ("v", vin)):
        if t.data_ptr() % 16 or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous and 16-byte aligned (the kernel's TMA tensor maps)")
    out = torch.empty((b, h, lq, d), dtype=torch.bfloat16, device=vin.device)
    lib = _kernel_lib()
    with torch.cuda.device(vin.device):
        err = lib.int8_flash_attention_fwd(
            pre["q8"].data_ptr(), pre["k8"].data_ptr(), vin.data_ptr(), pre["sq"].data_ptr(),
            pre["sk"].data_ptr(), sv.data_ptr(), pre["a2"].data_ptr(), out.data_ptr(),
            b, h, lq, lk, vin.shape[-1] if pv_int8 else lk, pre["nk"], pre["block_k"], int(pv_int8),
            torch.cuda.current_stream(vin.device).cuda_stream,
        )
    if err != 0:
        msg = lib.int8_flash_attention_error_string(err).decode()
        raise RuntimeError(f"int8_flash_attention_fwd launch failed: {msg} ({err})")
    _build.LAUNCHES[KERNEL_PV8 if pv_int8 else KERNEL] += 1
    return out
