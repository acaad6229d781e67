"""Int8 quantization for serving: weight-only ("w8") and dynamic W8A8
(counterpart of opensora_tpu/ops/quant.py).

- "w8": int8 weights with one fp32 scale per output channel; the product
  runs in the activations' dtype on the dequantized weight, with the scale
  applied in fp32 afterwards (what XLA fuses in the JAX package). Plain
  torch, no kernel.
- "w8a8", "w8a8_pallas", "w8a8_fq": activations are also quantized per
  token (dynamic abs-max) and the product is int8 x int8 with an int32 sum,
  rescaled by act_scale * weight_scale. On the card every such product is
  the hand-written kernel of ``ops/int8_matmul.py``. Below 1024 rows, or
  when the input width is not a multiple of 512, all three quantize outside
  the kernel (f32 abs-max / 127, floor 1e-8, divide, round, clip) and run
  ``w8a8_matmul``, exactly the JAX package's dispatch rule
  (opensora_tpu/ops/quant.py:63-70); above it "w8a8_fq" runs the fused
  kernel, which quantizes inside (multiplying by the reciprocal), and the
  other two keep the quantize outside. The JAX package's "w8a8" (XLA int8
  ``dot_general``) and "w8a8_pallas" compute the same function.

The weight is held as torch holds a linear layer's: ``weight_q`` (out, in)
int8, ``weight_scale`` (out,) fp32, and an optional ``bias``.

Under tensor parallelism (``parallel/sharding.py``) a column-parallel
QuantLinear reads its rank's output channels (int8 rows, scales, bias) and
computes them as the whole layer would. A row-parallel one holds the
int8 columns of its rank's input slice; the dynamic modes quantize each
token against the abs-max of its WHOLE row, as the JAX package's GSPMD
program does, so the ranks first take the max of their slices' maxima
(``parallel/comm.all_reduce_max``); each rank's partial product is then
kept in fp32 (the kernel's fp32 output) and the ranks' partials are summed
in fp32 and rounded once, the bias added once (:meth:`QuantLinear.
tp_row_partials`). The fused-kernel rule reads the layer's whole input
width, as JAX decides it on the global shape.
"""

from __future__ import annotations

import contextlib
from typing import Any, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.nn as nn

from opensora_torch.models.cast_layers import Linear as CastLinear
from opensora_torch.ops.int8_matmul import act_scale, quantize_rows, w8a8_fusedquant_matmul, w8a8_matmul
from opensora_torch.parallel import comm

MODES = ("w8", "w8a8", "w8a8_pallas", "w8a8_fq")
W8A8_MODES = ("w8a8", "w8a8_pallas", "w8a8_fq")
FUSED_MIN_ROWS = 1024
FUSED_K_MULTIPLE = 512


def quant_mode(quantized: Union[bool, str, None]) -> Optional[str]:
    """The mode a config's ``quantized`` names: None for False, "w8" for
    True, else the string itself; an unknown mode raises."""
    if not quantized:
        return None
    mode = quantized if isinstance(quantized, str) else "w8"
    if mode not in MODES:
        raise ValueError(f"unknown quantized mode {quantized!r}; expected one of {MODES} or a bool")
    return mode


def quantize_weight(weight: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(out, in) float weight -> (int8 (out, in), fp32 (out,) scale), the
    arithmetic of :func:`quantize_kernel` on the device the weight is on."""
    w = weight.detach().float()
    absmax = w.abs().amax(dim=1)
    scale = torch.where(absmax > 0, absmax / 127.0, torch.ones_like(absmax))
    return torch.clamp(torch.round(w / scale[:, None]), -127, 127).to(torch.int8), scale


class QuantLinear(nn.Module):
    """``nn.Linear`` over int8 weights and per-output-channel fp32 scales.

    ``forward(x, col_slice=(a, b))`` applies only output channels [a, b)
    (valid because the quantization is per output channel). ``dtype`` is
    the compute and output dtype. Built directly, the weights are zero and
    the scales one, as the JAX package initializes ``QuantDense``; a real
    layer comes from :meth:`from_linear` or a loaded state dict."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True, mode: str = "w8",
                 device=None, dtype: Optional[torch.dtype] = None):
        super().__init__()
        if mode not in MODES:
            raise ValueError(f"unknown quantized mode {mode!r}; expected one of {MODES}")
        self.in_features, self.out_features, self.mode = in_features, out_features, mode
        self.dtype = dtype or torch.get_default_dtype()
        self.register_buffer("weight_q", torch.zeros(out_features, in_features, dtype=torch.int8, device=device))
        self.register_buffer("weight_scale", torch.ones(out_features, dtype=torch.float32, device=device))
        if bias:
            self.bias = nn.Parameter(torch.zeros(out_features, device=device, dtype=self.dtype))
        else:
            self.register_parameter("bias", None)

    @classmethod
    def from_linear(cls, linear: nn.Linear, mode: str) -> "QuantLinear":
        """The quantized twin of ``linear`` (its bias is shared, not copied)."""
        w = linear.weight
        q = cls(linear.in_features, linear.out_features, bias=False, mode=mode, device="meta", dtype=w.dtype)
        q.weight_q, q.weight_scale = quantize_weight(w)
        q.bias = linear.bias
        return q

    def extra_repr(self) -> str:
        return (f"in_features={self.in_features}, out_features={self.out_features}, "
                f"bias={self.bias is not None}, mode={self.mode}")

    def forward(self, x: torch.Tensor, col_slice: Optional[Tuple[int, int]] = None,
                s_a: Optional[torch.Tensor] = None, out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
        """``s_a`` (rows, 1) fp32: the activation scale of the dynamic
        modes, given where ``x`` is a tp rank's slice of each row;
        ``out_dtype`` (default ``dtype``): fp32 for a rank's partial."""
        w, scale, bias = self.weight_q, self.weight_scale, self.bias
        out_dtype = out_dtype or self.dtype
        if col_slice is not None:
            a, b = col_slice
            w, scale = w[a:b], scale[a:b]
            bias = None if bias is None else bias[a:b]
        in_f = x.shape[-1]
        lead = x.shape[:-1]
        x2 = x.reshape(-1, in_f)
        if self.mode == "w8a8_fq" and x2.shape[0] >= FUSED_MIN_ROWS and self.in_features % FUSED_K_MULTIPLE == 0:
            y = w8a8_fusedquant_matmul(x2.to(self.dtype).contiguous(), w, scale, out_dtype=out_dtype, s_a=s_a)
        elif self.mode in W8A8_MODES:
            s_a = act_scale(x2) if s_a is None else s_a
            y = w8a8_matmul(quantize_rows(x2, s_a), w, s_a, scale, out_dtype=out_dtype)
        else:
            # the scale multiply stays fp32: rounding it to bf16 would add
            # ~0.4 % relative error on top of the int8 weights
            y = ((x2.to(self.dtype) @ w.to(self.dtype).T).float() * scale).to(out_dtype)
        if bias is not None:
            y = y + bias.to(out_dtype)
        return y.reshape(*lead, w.shape[0])

    def tp_row_partials(self, g, xs: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        """The tp ranks' fp32 partial products of this row-parallel layer
        over the ranks of ``g`` (``parallel/sharding.RankGroup``), rank t's
        input slice ``xs[t]``: in the dynamic modes each row quantized
        against the whole row's scale, the max over the ranks of their
        slices' scales (across the tp group's processes too, where it spans
        several)."""
        s_a = [None] * len(xs)
        if self.mode in W8A8_MODES:
            s_a = comm.all_reduce_max(g.each(lambda t: act_scale(xs[t].reshape(-1, xs[t].shape[-1]))), g.tp_comm)
        return g.each(lambda t: self(xs[t], s_a=s_a[t], out_dtype=torch.float32))


def dense(quantized: Union[bool, str, None], in_features: int, out_features: int, bias: bool = True,
          **factory) -> nn.Module:
    """A float linear (``models/cast_layers.Linear``: ``nn.Linear`` whose
    parameters are cast to the input's dtype at use) or, when ``quantized``
    names a mode (True = "w8"), a :class:`QuantLinear` of the same shape
    (opensora_tpu/ops/quant.py:170)."""
    mode = quant_mode(quantized)
    if mode is None:
        return CastLinear(in_features, out_features, bias=bias, **factory)
    return QuantLinear(in_features, out_features, bias=bias, mode=mode, **factory)


def quantize_kernel(kernel: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """(..., in, out) float kernel -> (int8 kernel, (out,) fp32 scale):
    per-output-channel abs-max, round half to even, clip to +-127."""
    k = np.asarray(kernel, np.float32)
    absmax = np.max(np.abs(k), axis=tuple(range(k.ndim - 1)))
    scale = np.where(absmax > 0, absmax / 127.0, 1.0).astype(np.float32)
    q = np.clip(np.round(k / scale), -127, 127).astype(np.int8)
    return q, scale


def quantize_params(params: Any, subtrees: Sequence[str] = ("double_blocks", "single_blocks")) -> Any:
    """A JAX-layout numpy parameter tree with every Dense ``kernel`` under
    ``subtrees`` replaced by ``kernel_q`` + ``kernel_scale`` (stacked block
    kernels quantized layer by layer). Biases and norms stay float."""

    def walk(node, inside):
        if not isinstance(node, dict):
            return node
        if inside and "kernel" in node and np.ndim(node["kernel"]) >= 2:
            out = {k: v for k, v in node.items() if k != "kernel"}
            kern = np.asarray(node["kernel"])
            if kern.ndim == 2:
                q, s = quantize_kernel(kern)
            else:
                qs, ss = zip(*(quantize_kernel(kern[i]) for i in range(kern.shape[0])))
                q, s = np.stack(qs), np.stack(ss)
            out["kernel_q"], out["kernel_scale"] = q, s
            return out
        return {k: walk(v, inside or k in subtrees) for k, v in node.items()}

    return walk(params, False)


def _swap_linears_(module: nn.Module, mode: str) -> None:
    """Swap every ``nn.Linear`` under ``module`` for its :class:`QuantLinear`
    in place, holding no reference to a Linear past its swap, so that each
    float weight is freed as soon as its int8 twin exists."""
    parents = [m for m in module.modules() if not isinstance(m, nn.Linear)]
    for parent in parents:
        for name in [n for n, c in parent.named_children() if isinstance(c, nn.Linear)]:
            setattr(parent, name, QuantLinear.from_linear(getattr(parent, name), mode))


@torch.no_grad()
def quantize_model_(model: nn.Module, mode: Union[bool, str] = "w8",
                    subtrees: Sequence[str] = ("double_blocks", "single_blocks")) -> nn.Module:
    """Swap every ``nn.Linear`` under ``model.<subtree>`` for its
    :class:`QuantLinear` in place, layer by layer (what the JAX package does
    to a loaded checkpoint, opensora_tpu/utils/ckpt.py:553-559). Records the
    mode in ``model.config.quantized`` when the model has a config."""
    mode = quant_mode(mode)
    if mode is None:
        raise ValueError("quantize_model_ needs a quantized mode")
    for sub in subtrees:
        _swap_linears_(getattr(model, sub), mode)
    if hasattr(model, "config"):
        model.config.quantized = mode
    return model


@contextlib.contextmanager
def quantize_as_built(quantized: Union[bool, str, None], module_types: Tuple[type, ...]):
    """While open, a module of ``module_types`` has its linears swapped for
    :class:`QuantLinear` (mode ``quantized``; nothing when it is falsy) as it
    is registered in its parent, before the next one is built. A model drawn
    in float from a seed is so quantized block by block: its float weights
    never exist whole (memory peaks at one block's float weights over the
    int8 ones), and since the swap draws no random numbers the result equals
    ``quantize_model_`` of the float model drawn from the same seed."""
    mode = quant_mode(quantized)

    @torch.no_grad()
    def hook(parent, name, sub):
        if isinstance(sub, module_types):
            _swap_linears_(sub, mode)

    handle = nn.modules.module.register_module_module_registration_hook(hook) if mode else None
    try:
        yield
    finally:
        if handle is not None:
            handle.remove()
