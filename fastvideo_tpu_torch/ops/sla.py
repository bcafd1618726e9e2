"""SLA, Sparse-Linear Attention (port of fastvideo_tpu/ops/sla.py).

Top-k block-sparse attention (block map from mean-pooled Q and smooth-K
pooled K) plus a linear-attention branch over feature-mapped q/k, combined
through a per-head-dim projection. The sparse branch is the padded
block-sparse kernel (:func:`fastvideo_tpu_torch.ops.vsa.block_sparse_attention`)
with the top-k table as its index array; pooling, top-k, the feature maps
and the two small products are plain PyTorch, as they are plain XLA in the
JAX package. Query and key blocks are both the kernel's 64-token tile.
"""

from __future__ import annotations

import math

import torch

from fastvideo_tpu_torch.ops.vsa import TILE_ELEMS, block_sparse_attention


def _mean_pool_blocks(x: torch.Tensor, blk: int) -> torch.Tensor:
    """[B, H, L, D] -> [B, H, L/blk, D]."""
    b, h, s, d = x.shape
    return x.reshape(b, h, s // blk, blk, d).mean(dim=3)


def sla_block_map(q: torch.Tensor, k: torch.Tensor, topk_ratio: float,
                  blk: int = TILE_ELEMS) -> tuple[torch.Tensor, int]:
    """Top-k key-block table per query block. q/k: [B, H, L, D]. Returns
    (lut [B, H, nQ, topk] int32, topk)."""
    k_smooth = k - k.mean(dim=-2, keepdim=True)
    pq = _mean_pool_blocks(q.float(), blk)
    pk = _mean_pool_blocks(k_smooth.float(), blk)
    score = torch.matmul(pq, pk.transpose(-1, -2))
    nk = score.shape[-1]
    topk = max(1, min(nk, int(topk_ratio * nk)))
    return torch.topk(score, topk, dim=-1).indices.to(torch.int32), topk


def linear_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     feature_map: str = "softmax") -> torch.Tensor:
    """(phi(Q) @ phi(K)^T V) / normalizer; q/k/v [B, H, L, D]."""
    qf, kf = q.float(), k.float()
    if feature_map == "softmax":
        fq, fk = torch.softmax(qf, dim=-1), torch.softmax(kf, dim=-1)
    elif feature_map == "elu":
        fq = torch.nn.functional.elu(qf) + 1
        fk = torch.nn.functional.elu(kf) + 1
    elif feature_map == "relu":
        fq, fk = torch.relu(qf), torch.relu(kf)
    else:
        raise ValueError(f"Unknown feature map: {feature_map}")
    kvsum = torch.matmul(fk.transpose(-1, -2), v.float())  # [B, H, D, D]
    ksum = fk.sum(dim=-2, keepdim=True)
    num = torch.matmul(fq, kvsum)
    den = 1e-5 + (fq * ksum).sum(dim=-1, keepdim=True)
    return (num / den).to(v.dtype)


def sla_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  topk_ratio: float = 0.1, feature_map: str = "softmax",
                  proj_weight: torch.Tensor | None = None,
                  proj_bias: torch.Tensor | None = None,
                  scale: float | None = None) -> torch.Tensor:
    """Full SLA forward on [B, S, H, D]; S % 64 == 0.

    ``proj_weight``/``proj_bias`` are the fine-tuned combiner parameters
    ([D, D] / [D]); when omitted they are zero (their initial value), which
    leaves the sparse branch alone.
    """
    s, d = q.shape[1], q.shape[3]
    if s % TILE_ELEMS:
        raise ValueError(f"SLA needs S divisible by {TILE_ELEMS}, got {s}")
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)

    lut, _ = sla_block_map(qt, kt, topk_ratio)
    sizes = torch.full((s // TILE_ELEMS,), TILE_ELEMS, dtype=torch.int32,
                       device=q.device)
    o_s = block_sparse_attention(qt, kt, vt, lut, sizes, scale=scale)
    if proj_weight is None:
        return o_s.transpose(1, 2)

    o_l = torch.matmul(linear_attention(qt, kt, vt, feature_map).float(),
                       proj_weight.float())
    if proj_bias is not None:
        o_l = o_l + proj_bias.float()
    return (o_s + o_l.to(v.dtype).to(o_s.dtype)).transpose(1, 2)
