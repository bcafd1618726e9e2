"""VIDEO_SPARSE_ATTN backend (port of fastvideo_tpu/attention/backends/vsa.py).

Tiles tokens into video cubes, runs the VSA composition and restores token
order. The tile geometry is chosen per grid (``select_vsa_tile``): an exact
tile makes the permutation a reshape and lets K2 run on full tiles; grids
with no exact tile use padded (4, 8, 8) tiles and the padded-tile kernel.
With ``pre_tiled`` the model already runs in tile-major order and the
backend permutes nothing. ``FASTVIDEO_VSA_TILE`` and
``FASTVIDEO_VSA_QGROUP`` override the geometry and the query grouping; both
are read at every call.
"""

from __future__ import annotations

import torch

from fastvideo_tpu_torch import envs
from fastvideo_tpu_torch.attention.backends.abstract import (AttentionBackend,
                                                             AttentionMetadata)
from fastvideo_tpu_torch.ops.vsa import (select_vsa_tile, tile_tables,
                                         tile_tokens, tile_tokens_exact,
                                         untile_tokens, untile_tokens_exact,
                                         video_sparse_attn)

# tiles for grids with no exact-divide geometry
VSA_PADDED_TILE = (4, 8, 8)


def resolve_vsa_tile(grid: tuple[int, int, int]
                     ) -> tuple[tuple[int, int, int], bool]:
    """(tile geometry, exact?) for a token grid.

    ``FASTVIDEO_VSA_TILE=t,h,w`` forces a geometry; one that does not divide
    the grid takes the padded route."""
    forced = envs.FASTVIDEO_VSA_TILE
    if forced:
        tile = tuple(int(x) for x in forced.split(","))
        if len(tile) != 3 or min(tile) < 1:
            raise ValueError(
                f"FASTVIDEO_VSA_TILE must be t,h,w of positive ints, got "
                f"{forced!r}")
        return tile, all(g % t == 0 for g, t in zip(grid, tile))
    tile = select_vsa_tile(grid)
    if tile is not None:
        return tile, True
    return VSA_PADDED_TILE, False


def q_group(nb: int, tile_elems: int, exact: bool) -> int:
    """Query tiles sharing one top-k set: up to 4 tiles and 1280 rows per
    group on exact grids (3 tiles of 280 rows at 480p).
    ``FASTVIDEO_VSA_QGROUP=N`` forces N where it divides the tile count
    (1 restores per-tile selection)."""
    if not exact:
        return 1
    forced = int(envs.FASTVIDEO_VSA_QGROUP or 0)
    if forced > 0:
        return forced if nb % forced == 0 else 1
    for g in (4, 3, 2):
        if nb % g == 0 and g * tile_elems <= 1280:
            return g
    return 1


def vsa_topk(sparsity: float, nb: int) -> int:
    """Key tiles kept per query group: ceil((1 - sparsity) * nB)."""
    return max(1, min(nb, int(-(-((1.0 - sparsity) * nb) // 1))))


class VideoSparseAttentionBackend(AttentionBackend):
    name = "VIDEO_SPARSE_ATTN"
    needs_grid = True
    supports_pre_tiled = True

    def forward(self, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                metadata: AttentionMetadata | None = None, *,
                kv_valid: int | None = None,
                grid: tuple[int, int, int] | None = None,
                gate: torch.Tensor | None = None,
                pre_tiled: bool = False) -> torch.Tensor:
        if grid is None:
            raise ValueError("VSA needs the (t, h, w) token grid")
        dit_shape = tuple(int(g) for g in grid)
        s_tokens = dit_shape[0] * dit_shape[1] * dit_shape[2]
        s_in = q.shape[1]
        sparsity = 0.0
        if metadata is not None:
            sparsity = float(metadata.extra.get("VSA_sparsity", 0.0))

        tile, exact = resolve_vsa_tile(dit_shape)
        tile_elems = tile[0] * tile[1] * tile[2]
        # an exact tiling has full tiles and no padded slot
        _, block_sizes, mask = tile_tables(dit_shape, tile, q.device)
        nb = block_sizes.numel()
        padded = nb * tile_elems
        topk = vsa_topk(sparsity, nb)

        if pre_tiled and exact:
            def prep(x):
                return x[:, :padded].transpose(1, 2)
        elif pre_tiled:
            # tile-pad slots carry garbage after the first block: zero them
            # before they enter the block means and the key reads
            def prep(x):
                xm = x[:, :padded] * mask[None, :, None, None].to(x.dtype)
                return xm.transpose(1, 2)
        elif exact:
            def prep(x):
                return tile_tokens_exact(x[:, :s_tokens], dit_shape,
                                         tile).transpose(1, 2)
        else:
            def prep(x):
                return tile_tokens(x[:, :s_tokens], dit_shape,
                                   tile).transpose(1, 2)

        out = video_sparse_attn(
            prep(q), prep(k), prep(v), block_sizes, topk,
            gate_compress=prep(gate) if gate is not None else None,
            scale=self.softmax_scale, tile_elems=tile_elems,
            full_tiles=exact, q_group=q_group(nb, tile_elems, exact))
        out = out.transpose(1, 2)
        if not pre_tiled:
            out = (untile_tokens_exact(out, dit_shape, tile) if exact else
                   untile_tokens(out, dit_shape, tile))
        n_real = padded if pre_tiled else s_tokens
        if s_in > n_real:
            out = torch.nn.functional.pad(out, (0, 0, 0, 0, 0, s_in - n_real))
        return out
