"""SAGE_ATTN backend (port of fastvideo_tpu/attention/backends/sage.py).

SageAttention's int8 QK^T: K smoothed by its per-head mean over tokens
(softmax is invariant to that shift), per-token int8 Q and K with fp32
scales, an exact int32 product (``int8_mm``: ``torch._int_mm`` on the card,
an exact fp64 product on the CPU), fp32 softmax, P rounded to V's dtype
before P @ V. JAX materialises the [B, H, S, T] scores; here the queries
go in slabs so that the card holds them, with the same arithmetic.
"""

from __future__ import annotations

import torch

from fastvideo_tpu_torch.attention.backends.abstract import (AttentionBackend,
                                                             AttentionMetadata)
from fastvideo_tpu_torch.layers.quantization.int8 import int8_mm

# query rows of one score slab: about 256 MiB of fp32 scores at 32k keys
_SLAB = 2**26


def quantize_per_token(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """[B, S, H, D] -> int8 values and per-(B, S, H) fp32 scales."""
    xf = x.float()
    amax = xf.abs().amax(dim=-1, keepdim=True)
    scale = torch.where(amax == 0, torch.ones_like(amax), amax / 127.0)
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return q, scale


class SageAttentionBackend(AttentionBackend):
    name = "SAGE_ATTN"

    def forward(self, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                metadata: AttentionMetadata | None = None, *,
                kv_valid: int | None = None) -> torch.Tensor:
        b, s, h, _ = q.shape
        t = k.shape[1]
        k_smooth = k.float() - k.float().mean(dim=1, keepdim=True)
        q_i8, q_scale = quantize_per_token(q)
        k_i8, k_scale = quantize_per_token(k_smooth)
        cols = torch.arange(t, device=q.device)
        rows = max(1, _SLAB // t)
        out = torch.empty_like(q)
        for bi in range(b):
            for hi in range(h):
                kq, ks = k_i8[bi, :, hi], k_scale[bi, :, hi, 0]
                for r0 in range(0, s, rows):
                    r1 = min(s, r0 + rows)
                    sc = int8_mm(q_i8[bi, r0:r1, hi], kq).float()
                    sc = sc * q_scale[bi, r0:r1, hi] * ks * self.softmax_scale
                    if kv_valid is not None and kv_valid < t:
                        sc = sc.masked_fill(cols >= kv_valid, float("-inf"))
                    if self.causal:
                        row = torch.arange(r0, r1, device=q.device)[:, None]
                        sc = sc.masked_fill(cols > row, float("-inf"))
                    p = torch.softmax(sc, dim=-1)
                    out[bi, r0:r1, hi] = torch.matmul(
                        p.to(v.dtype), v[bi, :, hi]).to(q.dtype)
        return out
