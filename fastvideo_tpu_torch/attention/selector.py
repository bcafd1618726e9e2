"""Attention backend selection (port of fastvideo_tpu/attention/selector.py).

Resolution order: explicit request > ``FASTVIDEO_ATTENTION_BACKEND`` >
default (FLASH_ATTN); unknown names fail. The port has FLASH_ATTN,
VIDEO_SPARSE_ATTN, SLIDING_TILE_ATTN and SLA_ATTN.
"""

from __future__ import annotations

from fastvideo_tpu_torch import envs
from fastvideo_tpu_torch.attention.backends.abstract import AttentionBackend
from fastvideo_tpu_torch.attention.backends.flash import FlashAttentionBackend
from fastvideo_tpu_torch.attention.backends.sla import SLAAttentionBackend
from fastvideo_tpu_torch.attention.backends.sta import (
    SlidingTileAttentionBackend)
from fastvideo_tpu_torch.attention.backends.vsa import (
    VideoSparseAttentionBackend)

_BACKENDS: dict[str, type[AttentionBackend]] = {
    cls.name: cls
    for cls in (FlashAttentionBackend, VideoSparseAttentionBackend,
                SlidingTileAttentionBackend, SLAAttentionBackend)
}

_ALIASES = {
    "FLASH_ATTN_2": "FLASH_ATTN",
    "FLASH_ATTN_3": "FLASH_ATTN",
    "PALLAS_FLASH": "FLASH_ATTN",
    "SLA": "SLA_ATTN",
}

DEFAULT_BACKEND = "FLASH_ATTN"


def resolve_backend_name(requested: str | None = None) -> str:
    name = requested or envs.FASTVIDEO_ATTENTION_BACKEND or DEFAULT_BACKEND
    name = _ALIASES.get(name, name)
    if name not in _BACKENDS:
        raise ValueError(
            f"Unknown attention backend {name!r}. Known: {sorted(_BACKENDS)}")
    return name


def get_attn_backend(num_heads: int, head_size: int, *,
                     softmax_scale: float | None = None, causal: bool = False,
                     requested: str | None = None,
                     supported: tuple[str, ...] | None = None,
                     **extra) -> AttentionBackend:
    name = resolve_backend_name(requested)
    if supported and name not in supported and requested is None:
        # the selected backend does not serve this layer: take the first
        # supported one the port has
        name = next(c for c in supported if c in _BACKENDS)
    return _BACKENDS[name](num_heads, head_size, softmax_scale, causal,
                           **extra)
