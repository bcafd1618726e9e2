"""FLASH_ATTN backend: ops.flash_attention (K1 on CUDA)."""

from __future__ import annotations

import torch

from fastvideo_tpu_torch.attention.backends.abstract import (AttentionBackend,
                                                             AttentionMetadata)
from fastvideo_tpu_torch.ops.flash_attention import flash_attention


class FlashAttentionBackend(AttentionBackend):
    name = "FLASH_ATTN"

    def forward(self, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                metadata: AttentionMetadata | None = None, *,
                kv_valid: int | None = None) -> torch.Tensor:
        return flash_attention(q, k, v, scale=self.softmax_scale,
                               causal=self.causal, kv_valid=kv_valid)
