"""Linear layers with tensor-parallel sharding (port of
fastvideo_tpu/layers/linear.py).

The weight is torch's ``[out, in]`` (the JAX kernel is its transpose). JAX
keeps one logical weight and lets GSPMD split the matmul over the ``tp``
mesh axis; the port builds each rank's share of the weight (the tp size is
read from the mesh when the layer is built) and reduces by hand:

* ``ColumnParallelLinear``: the rank holds out/tp rows of the weight and of
  the bias, so its output is its share of the features.
* ``RowParallelLinear``: the rank holds in/tp columns, takes its share of
  the features in, all-reduces the partial products over tp and adds the
  bias once, after the reduce.
* ``QKVParallelLinear``: a column-parallel fused projection whose rank share
  is its heads' rows of q, of k and of v.

``tp_axes`` names the split dims of each parameter as JAX's ``kernel_axes``
do (in the torch layout), for ``parallel.shard_state`` and the loader. At
tp size 1 each is a plain linear.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from fastvideo_tpu_torch.parallel.collectives import all_reduce
from fastvideo_tpu_torch.parallel.mesh import TP_AXIS, get_tp_size


def tp_split(features: int, tp: int, what: str) -> int:
    if features % tp:
        raise ValueError(f"{what} of {features} does not split over tp={tp}")
    return features // tp


class Linear(nn.Linear):
    """y = x W^T + b, computed in the activation dtype. ``tp_mode`` None
    is replicated, "column" splits the output features over tp, "row" the
    input features."""

    tp_mode: str | None = None

    def __init__(self, in_features: int, out_features: int, bias: bool = True,
                 *, device=None, dtype=None):
        tp = get_tp_size() if self.tp_mode else 1
        if self.tp_mode == "column":
            out_features = tp_split(out_features, tp, "out_features")
        elif self.tp_mode == "row":
            in_features = tp_split(in_features, tp, "in_features")
        super().__init__(in_features, out_features, bias, device=device,
                         dtype=dtype)
        self.tp_size = tp
        if self.tp_mode == "column":
            self.tp_axes = {"weight": (TP_AXIS, None), "bias": (TP_AXIS,)}
        elif self.tp_mode == "row":
            self.tp_axes = {"weight": (None, TP_AXIS), "bias": (None,)}
        else:
            self.tp_axes = {}
        if bias is False:
            self.tp_axes.pop("bias", None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = self.weight if self.weight.dtype == x.dtype else self.weight.to(
            x.dtype)
        b = self.bias
        if b is not None and b.dtype != x.dtype:
            b = b.to(x.dtype)
        if self.tp_mode == "row" and self.tp_size > 1:
            y = all_reduce(F.linear(x, w), TP_AXIS)
            return y if b is None else y + b
        return F.linear(x, w, b)


class ColumnParallelLinear(Linear):
    """Output-dim tp-sharded linear."""

    tp_mode = "column"


class RowParallelLinear(Linear):
    """Input-dim tp-sharded linear: one all-reduce over tp."""

    tp_mode = "row"


class QKVParallelLinear(ColumnParallelLinear):
    """Fused QKV projection, head-sharded over tp: a rank holds its heads'
    rows of each of q, k and v (``tp_segments``), so ``split_qkv`` of its
    output gives its heads of each."""

    def __init__(self, hidden_size: int, head_dim: int, num_heads: int,
                 num_kv_heads: int | None = None, bias: bool = True, *,
                 device=None, dtype=None):
        num_kv_heads = num_kv_heads or num_heads
        tp = get_tp_size()
        q_heads = tp_split(num_heads, tp, "num_heads")
        kv_heads = tp_split(num_kv_heads, tp, "num_kv_heads")
        out = (num_heads + 2 * num_kv_heads) * head_dim
        super().__init__(hidden_size, out, bias, device=device, dtype=dtype)
        self.num_heads, self.num_kv_heads = q_heads, kv_heads
        self.head_dim = head_dim
        segments = (num_heads * head_dim, num_kv_heads * head_dim,
                    num_kv_heads * head_dim)
        self.tp_segments = {name: segments for name in self.tp_axes}

    def split_qkv(self, qkv: torch.Tensor):
        q_size = self.num_heads * self.head_dim
        kv_size = self.num_kv_heads * self.head_dim
        return (qkv[..., :q_size], qkv[..., q_size:q_size + kv_size],
                qkv[..., q_size + kv_size:])
