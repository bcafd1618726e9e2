"""MLP block (port of fastvideo_tpu/layers/mlp.py): fc_in -> act -> fc_out,
a column-parallel linear into a row-parallel one (the hidden features stay
split over tp through the activation; one all-reduce at fc_out)."""

from __future__ import annotations

import torch
from torch import nn

from fastvideo_tpu_torch.layers.activation import get_act_fn
from fastvideo_tpu_torch.layers.linear import (ColumnParallelLinear,
                                               RowParallelLinear)


class MLP(nn.Module):

    def __init__(self, input_dim: int, mlp_hidden_dim: int,
                 output_dim: int | None = None, bias: bool = True,
                 act_type: str = "gelu_pytorch_tanh", *, device=None,
                 dtype=None):
        super().__init__()
        output_dim = output_dim or input_dim
        self.fc_in = ColumnParallelLinear(input_dim, mlp_hidden_dim, bias,
                                          device=device, dtype=dtype)
        self.fc_out = RowParallelLinear(mlp_hidden_dim, output_dim, bias,
                                        device=device, dtype=dtype)
        self.act = get_act_fn(act_type)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc_out(self.act(self.fc_in(x)))
