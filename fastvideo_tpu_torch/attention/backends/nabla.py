"""NABLA_ATTN backend (port of fastvideo_tpu/attention/backends/nabla.py).

Metadata keys (``AttentionMetadata.extra``):
- ``nabla_sta_mask``: an optional [B?, H?, nB, nB] block-level STA window
  mask OR'd into the adaptive map;
- ``nabla_P``: the cumulative-probability threshold (default 0.9).

NABLA takes the tokens in the order they come (raster order on the Wan
path) in 64-token blocks, so S must be a multiple of 64.
"""

from __future__ import annotations

import torch

from fastvideo_tpu_torch.attention.backends.abstract import (AttentionBackend,
                                                             AttentionMetadata)
from fastvideo_tpu_torch.ops.nabla import nabla_attention


class NablaAttentionBackend(AttentionBackend):
    name = "NABLA_ATTN"

    def forward(self, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                metadata: AttentionMetadata | None = None, *,
                kv_valid: int | None = None, **_: object) -> torch.Tensor:
        extra = metadata.extra if metadata is not None else {}
        return nabla_attention(q, k, v, sta_mask=extra.get("nabla_sta_mask"),
                               thr=float(extra.get("nabla_P", 0.9)),
                               scale=self.softmax_scale)
