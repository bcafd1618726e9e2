"""TORCH_SDPA backend (port of fastvideo_tpu/attention/backends/sdpa.py).

JAX's portable backend is XLA's ``jax.nn.dot_product_attention``; here it
is PyTorch's ``scaled_dot_product_attention``, with the same ``kv_valid``
key mask and top-left causal mask.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from fastvideo_tpu_torch.attention.backends.abstract import (AttentionBackend,
                                                             AttentionMetadata)


class SDPABackend(AttentionBackend):
    name = "TORCH_SDPA"

    def forward(self, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                metadata: AttentionMetadata | None = None, *,
                kv_valid: int | None = None) -> torch.Tensor:
        s, t = q.shape[1], k.shape[1]
        mask = None
        if kv_valid is not None and kv_valid < t:
            mask = (torch.arange(t, device=q.device) < kv_valid).expand(s, t)
        if self.causal and mask is not None:
            mask = mask & torch.ones(s, t, dtype=torch.bool,
                                     device=q.device).tril()
        out = F.scaled_dot_product_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            attn_mask=mask, is_causal=self.causal and mask is None,
            scale=self.softmax_scale)
        return out.transpose(1, 2)
