"""VMOBA_ATTN backend (port of fastvideo_tpu/attention/backends/vmoba.py).

Metadata keys (``extra``): ``vmoba_chunk_size`` (int | (ch, cw) |
(ct, ch, cw)), ``vmoba_topk``, ``vmoba_select_mode`` (topk | threshold),
``vmoba_threshold``.
"""

from __future__ import annotations

import torch

from fastvideo_tpu_torch.attention.backends.abstract import (AttentionBackend,
                                                             AttentionMetadata)
from fastvideo_tpu_torch.ops.vmoba import vmoba_attention


class VMOBAAttentionBackend(AttentionBackend):
    name = "VMOBA_ATTN"
    needs_grid = True

    def forward(self, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                metadata: AttentionMetadata | None = None, *,
                kv_valid: int | None = None,
                grid: tuple[int, int, int] | None = None,
                gate: torch.Tensor | None = None) -> torch.Tensor:
        if grid is None:
            raise ValueError("VMOBA needs the (t, h, w) token grid")
        extra = metadata.extra if metadata is not None else {}
        chunk_size = extra.get("vmoba_chunk_size", 1)
        if isinstance(chunk_size, list):
            chunk_size = tuple(chunk_size)
        dit_shape = tuple(int(g) for g in grid)
        s_tokens = dit_shape[0] * dit_shape[1] * dit_shape[2]
        s_in = q.shape[1]
        out = vmoba_attention(
            q[:, :s_tokens], k[:, :s_tokens], v[:, :s_tokens],
            patch_resolution=dit_shape, chunk_size=chunk_size,
            topk=int(extra.get("vmoba_topk", 4)),
            select_mode=str(extra.get("vmoba_select_mode", "threshold")),
            threshold=float(extra.get("vmoba_threshold", 0.25)),
            scale=self.softmax_scale)
        if s_in > s_tokens:
            out = torch.nn.functional.pad(out,
                                          (0, 0, 0, 0, 0, s_in - s_tokens))
        return out
