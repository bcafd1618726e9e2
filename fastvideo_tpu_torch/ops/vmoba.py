"""VMOBA, Video Mixture-of-Block Attention (port of
fastvideo_tpu/ops/vmoba.py).

Keys are chunked (temporal, spatial or spatio-temporal layouts); a gate
(mean-pooled chunk keys against each query) picks chunks per (head, query
token), top-k or by cumulative softmax mass, and each token attends its own
chunk plus its selected chunks, in a running softmax over the chunks
(exact, never an S x S matrix, but no fewer FLOPs than dense). It is XLA in
JAX, so it is plain PyTorch here; orderings copy JAX's (``top_k`` takes the
lower index among equals, argsorts are stable).
"""

from __future__ import annotations

import math

import torch


def chunk_reorder(x: torch.Tensor, patch_resolution: tuple[int, int, int],
                  chunk_size) -> tuple[torch.Tensor, int]:
    """Reorder [B, S, H, D] tokens chunk-contiguously: int -> temporal
    chunks (t-major already), (ch, cw) -> spatial chunks spanning all
    frames, (ct, ch, cw) -> 3-D chunks. Returns (tokens, chunk length)."""
    t, h, w = patch_resolution
    b, s, nh, d = x.shape
    if s != t * h * w:
        raise ValueError(f"{s} tokens do not fill the grid {patch_resolution}")
    if isinstance(chunk_size, (int, float)):
        return x, int(chunk_size * h * w)
    if len(chunk_size) == 2:
        ch, cw = chunk_size
        y = x.reshape(b, t, h // ch, ch, w // cw, cw, nh, d)
        y = y.permute(0, 2, 4, 1, 3, 5, 6, 7)
        return y.reshape(b, s, nh, d), t * ch * cw
    ct, ch, cw = chunk_size
    y = x.reshape(b, t // ct, ct, h // ch, ch, w // cw, cw, nh, d)
    y = y.permute(0, 1, 3, 5, 2, 4, 6, 7, 8)
    return y.reshape(b, s, nh, d), ct * ch * cw


def chunk_restore(x: torch.Tensor, patch_resolution: tuple[int, int, int],
                  chunk_size) -> torch.Tensor:
    """Inverse of :func:`chunk_reorder`."""
    t, h, w = patch_resolution
    b, s, nh, d = x.shape
    if isinstance(chunk_size, (int, float)):
        return x
    if len(chunk_size) == 2:
        ch, cw = chunk_size
        y = x.reshape(b, h // ch, w // cw, t, ch, cw, nh, d)
        y = y.permute(0, 3, 1, 4, 2, 5, 6, 7)
        return y.reshape(b, s, nh, d)
    ct, ch, cw = chunk_size
    y = x.reshape(b, t // ct, h // ch, w // cw, ct, ch, cw, nh, d)
    y = y.permute(0, 1, 4, 2, 5, 3, 6, 7, 8)
    return y.reshape(b, s, nh, d)


def vmoba_gate_mask(q: torch.Tensor, k: torch.Tensor, chunk_len: int,
                    topk: int, select_mode: str = "threshold",
                    threshold: float = 0.25) -> torch.Tensor:
    """bool [B, H, S, nC]: the chunks each query token attends, its own
    chunk included."""
    b, s, h, d = q.shape
    nc = s // chunk_len
    key_gate = k.float().reshape(b, nc, chunk_len, h, d).mean(dim=2)
    gate = torch.einsum("bshd,bchd->bhsc", q.float(), key_gate)
    tok_chunk = torch.arange(s, device=q.device) // chunk_len
    self_mask = tok_chunk[:, None] == torch.arange(nc, device=q.device)
    if select_mode == "topk":
        # the own chunk amplified so that it always ranks in the top-k
        amp = torch.where(self_mask, 1e9, 0.0)
        order = torch.sort(gate + amp, dim=-1, descending=True,
                           stable=True).indices[..., :min(topk, nc)]
        mask = torch.zeros(gate.shape, dtype=torch.bool, device=q.device)
        mask.scatter_(-1, order, True)
    elif select_mode == "threshold":
        # the smallest prefix of the sorted gates whose softmax mass
        # reaches the threshold
        p = torch.softmax(gate, dim=-1)
        order = torch.argsort(-p, dim=-1, stable=True)
        cs = torch.cumsum(torch.gather(p, -1, order), dim=-1)
        first = torch.ones_like(cs[..., :1], dtype=torch.bool)
        keep_sorted = torch.cat([first, cs[..., :-1] < threshold], dim=-1)
        mask = torch.empty_like(keep_sorted).scatter_(-1, order, keep_sorted)
    else:
        raise ValueError(f"Invalid select_mode: {select_mode}")
    return mask | self_mask


def vmoba_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    patch_resolution: tuple[int, int, int], chunk_size,
                    topk: int = 4, select_mode: str = "threshold",
                    threshold: float = 0.25,
                    scale: float | None = None) -> torch.Tensor:
    """Full VMOBA forward on raster-ordered [B, S, H, D]."""
    b, s, h, d = q.shape
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    qc, chunk_len = chunk_reorder(q, patch_resolution, chunk_size)
    kc, _ = chunk_reorder(k, patch_resolution, chunk_size)
    vc, _ = chunk_reorder(v, patch_resolution, chunk_size)
    if s % chunk_len:
        raise ValueError(f"{s} tokens do not split into chunks of "
                         f"{chunk_len}")
    nc = s // chunk_len
    mask = vmoba_gate_mask(qc, kc, chunk_len, topk, select_mode, threshold)

    qt = qc.transpose(1, 2).float()  # [B, H, S, D]
    kch = kc.transpose(1, 2).reshape(b, h, nc, chunk_len, d).float()
    vch = vc.transpose(1, 2).reshape(b, h, nc, chunk_len, d).float()
    neg_inf = torch.tensor(float("-inf"), device=q.device)
    m = torch.full((b, h, s, 1), float("-inf"), device=q.device)
    l = torch.zeros((b, h, s, 1), device=q.device)
    acc = torch.zeros((b, h, s, d), device=q.device)
    for c in range(nc):
        sres = torch.matmul(qt, kch[:, :, c].transpose(-1, -2)) * scale
        sres = torch.where(mask[..., c, None], sres, neg_inf)
        m_next = torch.maximum(m, sres.amax(dim=-1, keepdim=True))
        # chunks masked out contribute exp(-inf) = 0; the -inf carry is
        # guarded as in JAX
        alpha = torch.exp(torch.where(m == neg_inf, neg_inf, m - m_next))
        alpha = torch.where(torch.isnan(alpha), 0.0, alpha)
        p = torch.exp(torch.where(sres == neg_inf, neg_inf, sres - m_next))
        p = torch.where(torch.isnan(p), 0.0, p)
        l = alpha * l + p.sum(dim=-1, keepdim=True)
        acc = acc * alpha + torch.matmul(p, vch[:, :, c])
        m = m_next
    out = (acc / torch.clamp(l, min=1e-20)).to(q.dtype).transpose(1, 2)
    return chunk_restore(out, patch_resolution, chunk_size)
