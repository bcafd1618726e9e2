"""Rotary embeddings for (t, h, w) video token grids (port of
fastvideo_tpu/layers/rotary.py).

Per-axis tables are built in float64 on the host and concatenated to a
[S, head_dim] (cos, sin) pair, each frequency repeated for its interleaved
pair. The rotation is applied directly on the pairs:
out[2i] = x[2i] cos - x[2i+1] sin, out[2i+1] = x[2i+1] cos + x[2i] sin,
in fp32, cast back to the input dtype.
"""

from __future__ import annotations

import functools

import numpy as np
import torch


@functools.lru_cache(maxsize=32)
def get_nd_rotary_pos_embed(rope_dim_list: tuple[int, ...],
                            rope_sizes: tuple[int, ...],
                            theta: float = 10000.0, start_frame: int = 0
                            ) -> tuple[np.ndarray, np.ndarray]:
    """Per-axis rope tables concatenated to [prod(sizes), sum(dims)] (fp32),
    tokens axis-0-major like the patch-embed flatten. ``start_frame``
    offsets axis 0, so a block of a stream takes its absolute positions."""
    grids = list(np.meshgrid(
        *[np.arange(s, dtype=np.float64) for s in rope_sizes], indexing="ij"))
    if start_frame:
        grids[0] = grids[0] + start_frame
    cos_parts, sin_parts = [], []
    for dim, grid in zip(rope_dim_list, grids, strict=True):
        freqs = 1.0 / (theta**(np.arange(0, dim, 2, dtype=np.float64)[:dim // 2]
                               / dim))
        angles = np.outer(grid.reshape(-1), freqs)
        cos_parts.append(np.repeat(np.cos(angles), 2, axis=-1))
        sin_parts.append(np.repeat(np.sin(angles), 2, axis=-1))
    cos = np.concatenate(cos_parts, axis=-1).astype(np.float32)
    sin = np.concatenate(sin_parts, axis=-1).astype(np.float32)
    return cos, sin


def wan_rope_dim_list(head_dim: int) -> tuple[int, int, int]:
    """Wan's (t, h, w) split of the head dim."""
    d = head_dim
    return (d - 4 * (d // 6), 2 * (d // 6), 2 * (d // 6))


def get_rotary_pos_embed_wan(grid_thw: tuple[int, int, int], head_dim: int,
                             theta: float = 10000.0, start_frame: int = 0, *,
                             device=None
                             ) -> tuple[torch.Tensor, torch.Tensor]:
    cos, sin = get_nd_rotary_pos_embed(wan_rope_dim_list(head_dim),
                                       tuple(grid_thw), theta,
                                       start_frame=start_frame)
    return (torch.as_tensor(cos, device=device),
            torch.as_tensor(sin, device=device))


def apply_rotary_emb(x: torch.Tensor, cos: torch.Tensor,
                     sin: torch.Tensor) -> torch.Tensor:
    """Interleaved rope: x [..., S, H, D], cos/sin [S, D]."""
    xf = x.float()
    pairs = xf.unflatten(-1, (-1, 2))
    x_rot = torch.stack([-pairs[..., 1], pairs[..., 0]], dim=-1).flatten(-2)
    return (xf * cos[:, None, :].float() +
            x_rot * sin[:, None, :].float()).to(x.dtype)
