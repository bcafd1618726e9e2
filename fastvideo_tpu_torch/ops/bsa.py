"""BSA, Bidirectional Sparse Attention (port of fastvideo_tpu/ops/bsa.py).

Both sides are sparsified: each 64-token tile keeps the queries least
similar to its centre token (:func:`prune_queries`), each query tile keeps
the key tiles that hold ``kv_cumulative_threshold`` of its pooled block
softmax (:func:`select_kv_blocks`, a variable count, at least
``min_kv_blocks``), the kept queries attend the kept tiles, and every
pruned position takes the output of its nearest kept query
(:func:`reconstruct_pruned`).

The attention is K9b, the count-driven kernel with a query tile of
``q_rows`` rows (:func:`_masked_sparse_qtile`, ``csrc/dyn_sparse_fwd.cu``
entry ``fvt_dyn_sparse_qtile_fwd`` on a CUDA tensor, its plain version on a
CPU tensor; ``ops/nabla.py`` holds both). Pruning, selection and the
nearest fill are plain PyTorch, as they are XLA in JAX, and copy JAX's
orderings: ``top_k`` ranks the NaN similarities of zero padding slots above
every number and takes the lower index among equals
(:func:`top_k_indices`), and every argsort is stable.
"""

from __future__ import annotations

import math

import torch

from fastvideo_tpu_torch.ops.nabla import dyn_sparse_attention, mask_indices
from fastvideo_tpu_torch.ops.vsa import TILE_ELEMS


def top_k_indices(x: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the ``k`` largest entries along the last axis, largest
    first, the lower index first among equals, and NaN ABOVE every number.

    That is ``jax.lax.top_k`` (a total order: -NaN < -inf < ... < +inf <
    +NaN) on the NaNs that BSA's pruning meets on the CPU: a zero row's
    similarity is 0/0, a NaN with the sign bit set, and ``-sim`` clears it.
    The port ranks every NaN so, whatever its sign, because a CUDA 0/0 is a
    NaN without the sign bit; ``torch.topk`` does not order equals by
    index."""
    x = torch.where(torch.isnan(x), torch.full_like(x, float("inf")), x)
    return torch.sort(x, dim=-1, descending=True, stable=True).indices[
        ..., :k]


def prune_queries(q_blocks: torch.Tensor, keep_ratio: float
                  ) -> tuple[torch.Tensor, torch.Tensor, int]:
    """[B, H, N, S, D] -> the ``keep_ratio * S`` tokens of each tile LEAST
    similar to its centre (ascending positions), their positions and the
    count. As in JAX, a zero row (a padding slot) has a NaN similarity and
    is kept before any real token, and a zero centre makes the whole tile
    NaN, so it keeps its first ``keep`` slots."""
    b, h, n, s, d = q_blocks.shape
    keep = max(1, int(s * keep_ratio))
    if keep >= s:
        idx = torch.arange(s, dtype=torch.int32, device=q_blocks.device)
        return q_blocks, idx.expand(b, h, n, s), s
    center = q_blocks[:, :, :, s // 2:s // 2 + 1]
    qn = q_blocks / torch.linalg.vector_norm(q_blocks, dim=-1, keepdim=True)
    cn = center / torch.linalg.vector_norm(center, dim=-1, keepdim=True)
    sim = (qn * cn).sum(dim=-1)  # [B, H, N, S]
    idx = torch.sort(top_k_indices(-sim, keep), dim=-1).values
    sparse_q = torch.gather(q_blocks, 3,
                            idx[..., None].expand(-1, -1, -1, -1, d))
    return sparse_q, idx.to(torch.int32), keep


def select_kv_blocks(sparse_q: torch.Tensor, k_blocks: torch.Tensor,
                     cumulative_threshold: float,
                     min_kv_blocks: int) -> torch.Tensor:
    """bool [B, H, N, N]: per query tile, the key tiles in descending order
    of the pooled block softmax while the mass before each is below the
    threshold (the first always), and the ``min_kv_blocks`` largest."""
    d = sparse_q.shape[-1]
    n = k_blocks.shape[2]
    q_repr = sparse_q.float().mean(dim=3)
    k_repr = k_blocks.float().mean(dim=3)
    scores = torch.matmul(q_repr, k_repr.transpose(-1, -2)) / math.sqrt(d)
    block_attn = torch.softmax(scores, dim=-1)
    order = torch.argsort(-block_attn, dim=-1, stable=True)
    cumsum = torch.cumsum(torch.gather(block_attn, -1, order), dim=-1)
    first = torch.ones_like(cumsum[..., :1], dtype=torch.bool)
    keep_sorted = torch.cat([first, cumsum[..., :-1] < cumulative_threshold],
                            dim=-1)
    keep_sorted = keep_sorted | (torch.arange(n, device=scores.device) <
                                 min(min_kv_blocks, n))
    return torch.empty_like(keep_sorted).scatter_(-1, order, keep_sorted)


def reconstruct_pruned(sparse_out: torch.Tensor, keep_idx: torch.Tensor,
                       block_size: int) -> torch.Tensor:
    """[B, H, N, keep, D] -> [B, H, N, block_size, D]: every position takes
    the output of its NEAREST kept token, the lower kept position where two
    are as near (``argmin`` takes the first)."""
    keep, d = sparse_out.shape[3], sparse_out.shape[4]
    if keep >= block_size:
        return sparse_out
    pos = torch.arange(block_size, device=sparse_out.device)
    dists = (pos[:, None] - keep_idx[..., None, :].long()).abs()
    nearest = torch.argmin(dists, dim=-1)  # [B, H, N, block_size]
    return torch.gather(sparse_out, 3,
                        nearest[..., None].expand(-1, -1, -1, -1, d))


def _masked_sparse_qtile(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         mask: torch.Tensor, block_sizes: torch.Tensor,
                         q_rows: int, *, scale: float,
                         tile_elems: int = TILE_ELEMS) -> torch.Tensor:
    """K9b: count-driven attention with a query tile of ``q_rows`` rows
    (q: [B, H, nQ * q_rows, D]) over ``tile_elems``-token key tiles under a
    bool [B, H, nQ, nK] mask."""
    idx, counts = mask_indices(mask)
    return dyn_sparse_attention(q, k, v, idx, counts, block_sizes,
                                scale=scale, tile_elems=tile_elems,
                                q_rows=q_rows)


def bsa_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  query_keep_ratio: float = 0.5,
                  kv_cumulative_threshold: float = 0.9,
                  min_kv_blocks: int = 1,
                  scale: float | None = None) -> torch.Tensor:
    """Full BSA forward on TILE-ORDERED [B, S, H, D]; S % 64 == 0. Zero
    padding tokens take part as keys (scores of 0), as in JAX."""
    b, s, h, d = q.shape
    if s % TILE_ELEMS:
        raise ValueError(f"BSA needs S divisible by {TILE_ELEMS}, got {s}")
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    n = s // TILE_ELEMS
    qb = q.transpose(1, 2).reshape(b, h, n, TILE_ELEMS, d)
    kb = k.transpose(1, 2).reshape(b, h, n, TILE_ELEMS, d)

    sparse_q, keep_idx, keep = prune_queries(qb, query_keep_ratio)
    kv_mask = select_kv_blocks(sparse_q, kb, kv_cumulative_threshold,
                               min_kv_blocks)
    # the kernel's query tiles are multiples of 8 rows (JAX: Mosaic's)
    keep_pad = max(8, math.ceil(keep / 8) * 8)
    if keep_pad != keep:
        sparse_q = torch.nn.functional.pad(sparse_q,
                                           (0, 0, 0, keep_pad - keep))
    sizes = torch.full((n,), TILE_ELEMS, dtype=torch.int32, device=q.device)
    out = _masked_sparse_qtile(sparse_q.reshape(b, h, n * keep_pad, d),
                               kb.reshape(b, h, s, d), v.transpose(1, 2),
                               kv_mask, sizes, keep_pad, scale=scale)
    out = out.reshape(b, h, n, keep_pad, d)[:, :, :, :keep]
    full = reconstruct_pruned(out, keep_idx, TILE_ELEMS)
    return full.reshape(b, h, s, d).transpose(1, 2)
