"""Sliding Tile Attention (port of fastvideo_tpu/ops/sta.py).

3-D local-window attention over (t, h, w) video tiles with per-head window
sizes. The key tiles a query tile may see are fixed by (grid, tile,
windows), so STA is the padded block-sparse kernel
(:func:`fastvideo_tpu_torch.ops.vsa.block_sparse_attention`) with index rows
computed on the host; ragged windows at the grid's edges are padded with
``-1`` slots, which the kernel skips.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from fastvideo_tpu_torch.ops.vsa import (block_sparse_attention, tile_layout,
                                         tile_tables, tile_tokens,
                                         untile_tokens)


@functools.lru_cache(maxsize=32)
def sta_window_indices(
    dit_seq_shape: tuple[int, int, int],
    tile_size: tuple[int, int, int],
    window_sizes: tuple[tuple[int, int, int], ...],
) -> np.ndarray:
    """[H, nQ, K_max] int32 key-tile indices per head; -1 pads ragged rows.

    ``window_sizes[h]`` = (wt, wh, ww) window, in TILES, centered on the
    query tile and clamped at the grid's edges.
    """
    _, _, _, (nt, nh, nw), _ = tile_layout(dit_seq_shape, tile_size)
    rows: list[list[list[int]]] = []
    for wt, wh, ww in window_sizes:
        head_rows = []
        for t in range(nt):
            for y in range(nh):
                for x in range(nw):
                    head_rows.append([
                        (tt * nh + yy) * nw + xx
                        for tt in range(max(0, t - wt // 2),
                                        min(nt, t - wt // 2 + wt))
                        for yy in range(max(0, y - wh // 2),
                                        min(nh, y - wh // 2 + wh))
                        for xx in range(max(0, x - ww // 2),
                                        min(nw, x - ww // 2 + ww))])
        rows.append(head_rows)
    k_max = max(len(r) for head in rows for r in head)
    out = np.full((len(rows), nt * nh * nw, k_max), -1, dtype=np.int32)
    for h, head_rows in enumerate(rows):
        for qi, sel in enumerate(head_rows):
            out[h, qi, :len(sel)] = sel
    return out


@functools.lru_cache(maxsize=32)
def _window_indices_on(dit_seq_shape, tile_size, window_sizes,
                       device: torch.device) -> torch.Tensor:
    """:func:`sta_window_indices` on ``device``, copied once per key."""
    return torch.as_tensor(
        sta_window_indices(dit_seq_shape, tile_size, window_sizes),
        device=device)


def sliding_tile_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    dit_seq_shape: tuple[int, int, int],
    window_sizes: tuple[tuple[int, int, int], ...],
    tile_size: tuple[int, int, int] = (4, 8, 8),
    *,
    scale: float | None = None,
) -> torch.Tensor:
    """STA over [B, S, H, D] tensors in ORIGINAL token order: tokens are
    permuted into tiles, attended within per-head 3-D windows, and
    restored."""
    b, _, _, d = q.shape
    dit_seq_shape, tile_size = tuple(dit_seq_shape), tuple(tile_size)
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    _, block_sizes, _ = tile_tables(dit_seq_shape, tile_size, q.device)

    def prep(x):
        return tile_tokens(x, dit_seq_shape, tile_size).transpose(1, 2)

    idx = _window_indices_on(dit_seq_shape, tile_size,
                             tuple(tuple(w) for w in window_sizes), q.device)
    out = block_sparse_attention(
        prep(q), prep(k), prep(v), idx[None].expand(b, *idx.shape),
        block_sizes, scale=scale, tile_elems=math.prod(tile_size))
    return untile_tokens(out.transpose(1, 2), dit_seq_shape, tile_size)
