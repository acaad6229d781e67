"""Convolutions and linear layers whose parameters are cast to the input's
dtype at use: parameters may be kept in one dtype (fp32 master weights for
training) while the layer computes in another (bf16), as flax's
``param_dtype`` and ``dtype`` do. When the two agree the cast returns the
parameter itself, so such a layer costs nothing more than its ``torch.nn``
parent. State-dict names are the parent's.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F


def _cast(p, x: torch.Tensor):
    return None if p is None else p.to(x.dtype)


class Conv2d(nn.Conv2d):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self._conv_forward(x, _cast(self.weight, x), _cast(self.bias, x))


class Conv3d(nn.Conv3d):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self._conv_forward(x, _cast(self.weight, x), _cast(self.bias, x))


class Linear(nn.Linear):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x, _cast(self.weight, x), _cast(self.bias, x))
