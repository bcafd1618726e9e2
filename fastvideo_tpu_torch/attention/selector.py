"""Attention backend selection (port of fastvideo_tpu/attention/selector.py).

Resolution order: explicit request > ``FASTVIDEO_ATTENTION_BACKEND`` >
default (FLASH_ATTN); unknown names fail. The port takes every backend
name and alias the JAX selector takes.
"""

from __future__ import annotations

from fastvideo_tpu_torch import envs
from fastvideo_tpu_torch.attention.backends.abstract import AttentionBackend
from fastvideo_tpu_torch.attention.backends.attn_qat import AttnQatTrainBackend
from fastvideo_tpu_torch.attention.backends.bsa import BSAAttentionBackend
from fastvideo_tpu_torch.attention.backends.flash import FlashAttentionBackend
from fastvideo_tpu_torch.attention.backends.nabla import NablaAttentionBackend
from fastvideo_tpu_torch.attention.backends.sage import SageAttentionBackend
from fastvideo_tpu_torch.attention.backends.sdpa import SDPABackend
from fastvideo_tpu_torch.attention.backends.sla import SLAAttentionBackend
from fastvideo_tpu_torch.attention.backends.sta import (
    SlidingTileAttentionBackend)
from fastvideo_tpu_torch.attention.backends.vmoba import VMOBAAttentionBackend
from fastvideo_tpu_torch.attention.backends.vsa import (
    VideoSparseAttentionBackend)

_BACKENDS: dict[str, type[AttentionBackend]] = {
    cls.name: cls
    for cls in (SDPABackend, FlashAttentionBackend,
                VideoSparseAttentionBackend, SlidingTileAttentionBackend,
                SageAttentionBackend, NablaAttentionBackend,
                SLAAttentionBackend, BSAAttentionBackend,
                VMOBAAttentionBackend, AttnQatTrainBackend)
}

# the JAX selector's aliases (fastvideo_tpu/attention/selector.py:75-88)
_ALIASES = {
    "SDPA": "TORCH_SDPA",
    "FLASH_ATTN_2": "FLASH_ATTN",
    "FLASH_ATTN_3": "FLASH_ATTN",
    "PALLAS_FLASH": "FLASH_ATTN",
    "SAGE_ATTN_THREE": "SAGE_ATTN",
    "ATTN_QAT": "SAGE_ATTN",  # serving-side int8 (train side: ATTN_QAT_TRAIN)
    "NABLA": "NABLA_ATTN",
    "VMOBA": "VMOBA_ATTN",
    "BSA": "BSA_ATTN",
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
