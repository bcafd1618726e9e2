"""Attention backend abstraction (port of
fastvideo_tpu/attention/backends/abstract.py): a backend is a light object
with a functional ``forward`` over ``[B, S, H, D]`` tensors."""

from __future__ import annotations

import dataclasses
from typing import Any

import torch


@dataclasses.dataclass
class AttentionMetadata:
    """Per-step metadata threaded through the forward context."""

    current_timestep: int = 0
    extra: dict[str, Any] = dataclasses.field(default_factory=dict)


class AttentionBackend:
    """Base class; subclasses are stateless and cheap to construct."""

    name: str = "ABSTRACT"
    # sparse backends work on (t, h, w) tiles and need the token grid
    needs_grid: bool = False
    # True when the backend takes tokens already in tile-major order
    supports_pre_tiled: bool = False

    def __init__(self, num_heads: int, head_size: int,
                 softmax_scale: float | None = None, causal: bool = False,
                 **extra: Any):
        self.num_heads = num_heads
        self.head_size = head_size
        self.softmax_scale = (softmax_scale if softmax_scale is not None else
                              head_size**-0.5)
        self.causal = causal
        self.extra = extra

    def forward(self, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                metadata: AttentionMetadata | None = None, *,
                kv_valid: int | None = None) -> torch.Tensor:
        raise NotImplementedError
