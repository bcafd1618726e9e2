"""SLA_ATTN backend (port of fastvideo_tpu/attention/backends/sla.py).

Metadata keys (``AttentionMetadata.extra``):
- ``sla_topk_ratio``: key-block keep ratio (default 0.1)
- ``sla_feature_map``: softmax | elu | relu
- ``sla_proj_weight`` / ``sla_proj_bias``: the fine-tuned combiner
  parameters (zero, their initial value, when absent).
"""

from __future__ import annotations

import torch

from fastvideo_tpu_torch.attention.backends.abstract import (AttentionBackend,
                                                             AttentionMetadata)
from fastvideo_tpu_torch.ops.sla import sla_attention


class SLAAttentionBackend(AttentionBackend):
    name = "SLA_ATTN"

    def forward(self, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                metadata: AttentionMetadata | None = None, *,
                kv_valid: int | None = None, **_: object) -> torch.Tensor:
        extra = metadata.extra if metadata is not None else {}
        return sla_attention(
            q, k, v,
            topk_ratio=float(extra.get("sla_topk_ratio", 0.1)),
            feature_map=str(extra.get("sla_feature_map", "softmax")),
            proj_weight=extra.get("sla_proj_weight"),
            proj_bias=extra.get("sla_proj_bias"),
            scale=self.softmax_scale)
