"""Attention layers (port of fastvideo_tpu/attention/layer.py).

The port runs at sequence-parallel size 1: ``DistributedAttention`` applies
RoPE and calls its backend directly, with no all-to-all exchange.
"""

from __future__ import annotations

import torch
from torch import nn

from fastvideo_tpu_torch.attention.selector import get_attn_backend
from fastvideo_tpu_torch.forward_context import get_forward_context
from fastvideo_tpu_torch.layers.rotary import apply_rotary_emb


def _metadata():
    ctx = get_forward_context()
    return ctx.attn_metadata if ctx is not None else None


class LocalAttention(nn.Module):
    """Attention with no sequence exchange (cross-attention)."""

    def __init__(self, num_heads: int, head_size: int,
                 softmax_scale: float | None = None, causal: bool = False,
                 supported_backends: tuple[str, ...] | None = None, **extra):
        super().__init__()
        self.num_heads = num_heads
        self.head_size = head_size
        self.backend = get_attn_backend(num_heads, head_size,
                                        softmax_scale=softmax_scale,
                                        causal=causal,
                                        supported=supported_backends, **extra)

    def forward(self, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                kv_valid: int | None = None) -> torch.Tensor:
        return self.backend.forward(q, k, v, _metadata(), kv_valid=kv_valid)


class DistributedAttention(nn.Module):
    """Full-sequence self-attention (sequence-parallel size 1)."""

    def __init__(self, num_heads: int, head_size: int,
                 softmax_scale: float | None = None, causal: bool = False,
                 supported_backends: tuple[str, ...] | None = None, **extra):
        super().__init__()
        self.num_heads = num_heads
        self.head_size = head_size
        self.backend = get_attn_backend(num_heads, head_size,
                                        softmax_scale=softmax_scale,
                                        causal=causal,
                                        supported=supported_backends, **extra)

    def forward(self, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                freqs_cis: tuple[torch.Tensor, torch.Tensor] | None = None,
                kv_valid: int | None = None,
                grid: tuple[int, int, int] | None = None,
                gate: torch.Tensor | None = None,
                pre_tiled: bool = False) -> torch.Tensor:
        """q/k/v [B, S, H, D]; ``freqs_cis`` (cos, sin) follow the token
        order of q/k; ``grid`` feeds the backends that work on (t, h, w) tiles
        (VSA, STA), ``gate`` and ``pre_tiled`` feed VSA."""
        if freqs_cis is not None:
            cos, sin = freqs_cis
            q = apply_rotary_emb(q, cos, sin)
            k = apply_rotary_emb(k, cos, sin)
        kwargs = {}
        if self.backend.needs_grid:
            kwargs["grid"] = grid
            if gate is not None:
                kwargs["gate"] = gate
        if pre_tiled:
            if not self.backend.supports_pre_tiled:
                raise ValueError(
                    f"{self.backend.name} cannot take pre-tiled tokens")
            kwargs["pre_tiled"] = True
        return self.backend.forward(q, k, v, _metadata(), kv_valid=kv_valid,
                                    **kwargs)
