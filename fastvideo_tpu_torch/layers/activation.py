"""Activation registry (port of fastvideo_tpu/layers/activation.py)."""

from __future__ import annotations

from collections.abc import Callable

import torch
import torch.nn.functional as F

_ACT_FNS: dict[str, Callable[[torch.Tensor], torch.Tensor]] = {
    "gelu": lambda x: F.gelu(x, approximate="none"),
    "gelu_new": lambda x: F.gelu(x, approximate="tanh"),
    "gelu_pytorch_tanh": lambda x: F.gelu(x, approximate="tanh"),
    "silu": F.silu,
    "relu": F.relu,
    "quick_gelu": lambda x: x * torch.sigmoid(1.702 * x),
}


def get_act_fn(name: str) -> Callable[[torch.Tensor], torch.Tensor]:
    try:
        return _ACT_FNS[name]
    except KeyError:
        raise ValueError(f"Unsupported activation: {name!r}. "
                         f"Known: {sorted(_ACT_FNS)}") from None
