"""Linear layers (port of fastvideo_tpu/layers/linear.py).

The weight is torch's ``[out, in]`` (the JAX kernel is its transpose). The
port runs at tensor-parallel size 1, so the column- and row-parallel
linears are plain linears kept under their JAX names.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


class Linear(nn.Linear):
    """y = x W^T + b, computed in the activation dtype."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = self.weight if self.weight.dtype == x.dtype else self.weight.to(
            x.dtype)
        b = self.bias
        if b is not None and b.dtype != x.dtype:
            b = b.to(x.dtype)
        return F.linear(x, w, b)


ColumnParallelLinear = Linear
RowParallelLinear = Linear
