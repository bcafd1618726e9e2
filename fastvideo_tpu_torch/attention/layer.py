"""Attention layers (port of fastvideo_tpu/attention/layer.py).

``DistributedAttention`` applies RoPE before the Ulysses exchange, on the
rank's own tokens (rope is per token, so it commutes with the exchange),
then runs its backend over the whole sequence with the rank's heads
(``parallel.ulysses_attention``). ``LocalAttention`` (cross-attention)
needs no exchange: under tensor parallelism it runs on the rank's heads,
which its column-parallel projections made.
"""

from __future__ import annotations

import torch
from torch import nn

from fastvideo_tpu_torch.attention.selector import get_attn_backend
from fastvideo_tpu_torch.forward_context import get_forward_context
from fastvideo_tpu_torch.layers.rotary import apply_rotary_emb
from fastvideo_tpu_torch.parallel import (SP_AXIS, get_sp_size, get_tp_size,
                                          ulysses_attention)
from fastvideo_tpu_torch.parallel.collectives import all_gather
from fastvideo_tpu_torch.parallel.mesh import axis_group, axis_index
from fastvideo_tpu_torch.parallel.ulysses import (heads_to_seq, local_heads,
                                                  seq_to_heads)


def _metadata():
    ctx = get_forward_context()
    return ctx.attn_metadata if ctx is not None else None


class LocalAttention(nn.Module):
    """Attention with no sequence exchange (cross-attention)."""

    def __init__(self, num_heads: int, head_size: int,
                 softmax_scale: float | None = None, causal: bool = False,
                 supported_backends: tuple[str, ...] | None = None, **extra):
        super().__init__()
        self.num_heads = num_heads
        self.head_size = head_size
        self.backend = get_attn_backend(num_heads, head_size,
                                        softmax_scale=softmax_scale,
                                        causal=causal,
                                        supported=supported_backends, **extra)

    def forward(self, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                kv_valid: int | None = None) -> torch.Tensor:
        """q/k/v hold the rank's tp share of the heads (JAX's
        ``local_head_parallel_attention``, a ``shard_map`` there, is this
        direct call)."""
        return self.backend.forward(q, k, v, _metadata(), kv_valid=kv_valid)


class DistributedAttention(nn.Module):
    """Full-sequence self-attention over sp-sharded tokens."""

    def __init__(self, num_heads: int, head_size: int,
                 softmax_scale: float | None = None, causal: bool = False,
                 supported_backends: tuple[str, ...] | None = None, **extra):
        super().__init__()
        self.num_heads = num_heads
        self.head_size = head_size
        self.backend = get_attn_backend(num_heads, head_size,
                                        softmax_scale=softmax_scale,
                                        causal=causal,
                                        supported=supported_backends, **extra)

    def forward(self, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                freqs_cis: tuple[torch.Tensor, torch.Tensor] | None = None,
                kv_valid: int | None = None,
                grid: tuple[int, int, int] | None = None,
                gate: torch.Tensor | None = None,
                pre_tiled: bool = False) -> torch.Tensor:
        """q/k/v [B, S, H, D]: the rank's tokens (S/sp of the padded
        sequence) and its tp share of the heads. ``freqs_cis`` (cos, sin)
        follow the token order of q/k, the rank's rows; ``kv_valid`` counts
        the real tokens of the whole sequence (its sp padding is masked);
        ``grid`` feeds the backends that work on (t, h, w) tiles (VSA,
        STA), ``gate`` (every head) and ``pre_tiled`` feed VSA."""
        if freqs_cis is not None:
            cos, sin = freqs_cis
            q = apply_rotary_emb(q, cos, sin)
            k = apply_rotary_emb(k, cos, sin)
        kwargs = {}
        if self.backend.needs_grid:
            kwargs["grid"] = grid
        else:
            gate = None
        if pre_tiled:
            if not self.backend.supports_pre_tiled:
                raise ValueError(
                    f"{self.backend.name} cannot take pre-tiled tokens")
            kwargs["pre_tiled"] = True
        metadata = _metadata()

        def local_attn(q, k, v, g=None):
            if g is not None:
                kwargs["gate"] = g
            return self.backend.forward(q, k, v, metadata, kv_valid=kv_valid,
                                        **kwargs)

        if get_sp_size() == 1 and get_tp_size() == 1:
            return local_attn(q, k, v, gate)
        extra = None if gate is None else local_heads(gate)
        return ulysses_attention(local_attn, q, k, v, extra=extra)

    def joint_forward(
        self,
        q: torch.Tensor,
        k: torch.Tensor,
        v: torch.Tensor,
        replicated_q: torch.Tensor,
        replicated_k: torch.Tensor,
        replicated_v: torch.Tensor,
        *,
        freqs_cis: tuple[torch.Tensor, torch.Tensor] | None = None,
        kv_valid: int | None = None,
    ) -> tuple[torch.Tensor, torch.Tensor]:
        """Joint image+text attention.

        Image q/k/v are the rank's tokens; the text (replicated_*) tokens
        are whole on every sp rank. Both hold the rank's tp heads. RoPE
        applies to the image tokens only. Returns (image out, the rank's
        tokens; text out, whole)."""
        if freqs_cis is not None:
            cos, sin = freqs_cis
            q = apply_rotary_emb(q, cos, sin)
            k = apply_rotary_emb(k, cos, sin)
        metadata = _metadata()
        txt_len = replicated_q.shape[1]

        def attend(q_, k_, v_, rq, rk, rv):
            # text first: kv_valid counts a valid prefix, and the sp zero
            # pad sits at the end of the image tokens, so [text | real
            # image] is exactly the valid set
            qq = torch.cat([rq.to(q_.dtype), q_], dim=1)
            kk = torch.cat([rk.to(k_.dtype), k_], dim=1)
            vv = torch.cat([rv.to(v_.dtype), v_], dim=1)
            kvv = None if kv_valid is None else txt_len + kv_valid
            out = self.backend.forward(qq, kk, vv, metadata, kv_valid=kvv)
            return out[:, txt_len:], out[:, :txt_len]

        sp = get_sp_size()
        if sp == 1:
            return attend(q, k, v, replicated_q, replicated_k, replicated_v)
        group = axis_group(SP_AXIS)
        q, k, v = (seq_to_heads(t, group) for t in (q, k, v))
        per = replicated_q.shape[2] // sp
        first = axis_index(SP_AXIS) * per
        rq, rk, rv = (t[:, :, first:first + per]
                      for t in (replicated_q, replicated_k, replicated_v))
        img_out, txt_out = attend(q, k, v, rq, rk, rv)
        return heads_to_seq(img_out, group), all_gather(txt_out, SP_AXIS, 2)
