"""BSA_ATTN backend (port of fastvideo_tpu/attention/backends/bsa.py).

Training-free: query pruning and key-tile selection at inference on any
full-attention checkpoint. Metadata keys (``extra``):
``bsa_query_keep_ratio`` (default 0.5), ``bsa_cumulative_threshold``
(default 0.9), ``bsa_min_kv_blocks`` (default 1).

Given the (t, h, w) grid, the backend reorders the tokens into the default
(4, 4, 4) VSA tiles (``tile_tokens``; a grid with no exact tile is padded
with zero tokens, which take part as keys), and back; without a grid the
tokens must come tile-ordered.
"""

from __future__ import annotations

import torch

from fastvideo_tpu_torch.attention.backends.abstract import (AttentionBackend,
                                                             AttentionMetadata)
from fastvideo_tpu_torch.ops.bsa import bsa_attention
from fastvideo_tpu_torch.ops.vsa import tile_tokens, untile_tokens


class BSAAttentionBackend(AttentionBackend):
    name = "BSA_ATTN"
    needs_grid = True

    def forward(self, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                metadata: AttentionMetadata | None = None, *,
                kv_valid: int | None = None,
                grid: tuple[int, int, int] | None = None,
                gate: torch.Tensor | None = None) -> torch.Tensor:
        extra = metadata.extra if metadata is not None else {}
        kwargs = dict(
            query_keep_ratio=float(extra.get("bsa_query_keep_ratio", 0.5)),
            kv_cumulative_threshold=float(
                extra.get("bsa_cumulative_threshold", 0.9)),
            min_kv_blocks=int(extra.get("bsa_min_kv_blocks", 1)),
            scale=self.softmax_scale)
        if grid is None:
            return bsa_attention(q, k, v, **kwargs)
        dit_shape = tuple(int(g) for g in grid)
        s_tokens = dit_shape[0] * dit_shape[1] * dit_shape[2]
        s_in = q.shape[1]
        qt, kt, vt = (tile_tokens(x[:, :s_tokens], dit_shape)
                      for x in (q, k, v))
        out = untile_tokens(bsa_attention(qt, kt, vt, **kwargs), dit_shape)
        if s_in > s_tokens:
            out = torch.nn.functional.pad(out,
                                          (0, 0, 0, 0, 0, s_in - s_tokens))
        return out
