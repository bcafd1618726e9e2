"""ATTN_QAT_TRAIN backend (port of
fastvideo_tpu/attention/backends/attn_qat.py): fake-quantized attention
with straight-through gradients, for a training forward. Metadata keys
(``extra``): ``qat_quant_p`` (default True), ``qat_smooth_k`` (default
False). ``kv_valid`` is not applied, as in JAX."""

from __future__ import annotations

import torch

from fastvideo_tpu_torch.attention.backends.abstract import (AttentionBackend,
                                                             AttentionMetadata)
from fastvideo_tpu_torch.ops.attn_qat import qat_attention


class AttnQatTrainBackend(AttentionBackend):
    name = "ATTN_QAT_TRAIN"

    def forward(self, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                metadata: AttentionMetadata | None = None, *,
                kv_valid: int | None = None, **_: object) -> torch.Tensor:
        extra = metadata.extra if metadata is not None else {}
        return qat_attention(q, k, v, scale=self.softmax_scale,
                             quant_p=bool(extra.get("qat_quant_p", True)),
                             smooth_k=bool(extra.get("qat_smooth_k", False)))
