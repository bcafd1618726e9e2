"""SLIDING_TILE_ATTN backend (port of
fastvideo_tpu/attention/backends/sta.py). Window sizes come from the
metadata (``STA_window`` in tiles, one tuple or one per head; ``STA_tile``
the tile geometry)."""

from __future__ import annotations

import torch

from fastvideo_tpu_torch.attention.backends.abstract import (AttentionBackend,
                                                             AttentionMetadata)
from fastvideo_tpu_torch.ops.sta import sliding_tile_attention

DEFAULT_WINDOW = (3, 3, 3)  # tiles
DEFAULT_TILE = (4, 8, 8)


class SlidingTileAttentionBackend(AttentionBackend):
    name = "SLIDING_TILE_ATTN"
    needs_grid = True

    def forward(self, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                metadata: AttentionMetadata | None = None, *,
                kv_valid: int | None = None,
                grid: tuple[int, int, int] | None = None,
                gate: torch.Tensor | None = None) -> torch.Tensor:
        if grid is None:
            raise ValueError("STA needs the (t, h, w) token grid")
        dit_shape = tuple(int(g) for g in grid)
        s_tokens = dit_shape[0] * dit_shape[1] * dit_shape[2]
        s_in = q.shape[1]
        extra = metadata.extra if metadata is not None else {}
        window = extra.get("STA_window", DEFAULT_WINDOW)
        tile = extra.get("STA_tile", DEFAULT_TILE)
        if isinstance(window[0], int):
            windows = tuple(tuple(window) for _ in range(q.shape[2]))
        else:
            windows = tuple(tuple(w) for w in window)
        out = sliding_tile_attention(q[:, :s_tokens], k[:, :s_tokens],
                                     v[:, :s_tokens], dit_shape, windows,
                                     tile, scale=self.softmax_scale)
        if s_in > s_tokens:
            out = torch.nn.functional.pad(out,
                                          (0, 0, 0, 0, 0, s_in - s_tokens))
        return out
