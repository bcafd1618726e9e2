"""NABLA adaptive block-sparse attention (port of fastvideo_tpu/ops/nabla.py).

Mean-pooled 64-token blocks of q and k give a block map; its softmax over
key blocks keeps, per query block, the smallest set of key blocks whose
mass reaches ``thr``, OR'd with an optional STA block mask; attention then
runs under that mask.

The attention is K9, a count-driven gather: the mask becomes ascending key
tile ids per query tile with ``-1`` past a per-row count
(:func:`mask_indices`), and the kernel loops exactly that count. On a CUDA
tensor :func:`dyn_sparse_attention` launches ``csrc/dyn_sparse_fwd.cu``:
entry ``fvt_dyn_sparse_fwd`` (K9a, a query tile is a key tile, NABLA) or
``fvt_dyn_sparse_qtile_fwd`` (K9b, a query tile of ``q_rows`` rows, BSA's
pruned queries, ``ops/bsa.py``), both replacing the Pallas
``_dyn_sparse_kernel``, or with a bf16 head of 64 or 128 their Hopper
entries (``..._sm90``, ``ops/sparse_schedule.py``): there the query tiles
run in groups of ``sparse_schedule.query_group(rows)`` (two of K9a's
64-row tiles, four of K9b's 32-row tiles in a block of 128 rows) that walk
the union of their lists, each row masking the key tiles its own tile does
not keep. On a CPU tensor it runs
:func:`dyn_sparse_attention_plain`; there is no fallback between the two.
JAX has no VJP for the kernel, so on CUDA it raises under grad. The mask,
the pooling and the index table are plain PyTorch, as they are XLA in JAX.
"""

from __future__ import annotations

import math

import torch

from fastvideo_tpu_torch.ops import _build
from fastvideo_tpu_torch.ops.sparse_schedule import (grouped_lists,
                                                     heaviest_first,
                                                     kept_mask, mask_indices,
                                                     sparse_schedule)
from fastvideo_tpu_torch.ops.vsa import TILE_ELEMS, sparse_cuda_operands

NAME = "dyn_sparse_fwd"
QTILE_NAME = "dyn_sparse_qtile_fwd"
NABLA_BLOCK = 64
# query rows of the plain version's score slab: bounds its memory at about
# 1 GiB of fp32 scores for the longest key axis of the main paths
_PLAIN_SLAB = 2**28


def nabla_block_mask(q: torch.Tensor, k: torch.Tensor,
                     sta_mask: torch.Tensor | None,
                     thr: float = 0.9) -> torch.Tensor:
    """[B, S, H, D] q/k -> bool block mask [B, H, nB, nB]: the pooled block
    map's softmax over key blocks, sorted ascending (stably, as
    ``jnp.argsort``), keeps the blocks where the running fp32 sum reaches
    ``1 - thr``."""
    b, s, h, d = q.shape
    nb = s // NABLA_BLOCK

    def pool(x):  # fp32 block means in the input dtype, as jnp.mean gives
        m = x.float().reshape(b, nb, NABLA_BLOCK, h, d).mean(dim=2)
        return m.to(x.dtype).permute(0, 2, 1, 3).float()

    amap = torch.softmax(torch.matmul(pool(q), pool(k).transpose(-1, -2)) /
                         math.sqrt(d), dim=-1)
    vals, order = torch.sort(amap, dim=-1, stable=True)
    keep_sorted = torch.cumsum(vals, dim=-1) >= (1.0 - thr)
    mask = torch.empty_like(keep_sorted).scatter_(-1, order, keep_sorted)
    if sta_mask is not None:
        mask = mask | sta_mask.to(device=mask.device, dtype=torch.bool)
    return mask


def dyn_sparse_attention_plain(q: torch.Tensor, k: torch.Tensor,
                               v: torch.Tensor, indices: torch.Tensor,
                               counts: torch.Tensor,
                               block_sizes: torch.Tensor, *, scale: float,
                               tile_elems: int = TILE_ELEMS,
                               q_rows: int | None = None) -> torch.Tensor:
    """Plain PyTorch version of K9a (``q_rows`` None: a query tile is a key
    tile) and K9b (a query tile of ``q_rows`` rows). Query tile qi attends
    the keys below ``block_sizes[t]`` of the tiles t in the first
    ``counts[qi]`` slots of ``indices[qi]``; scores in fp32, p rounded to
    the input dtype before p @ v; a row with no key gives 0. Works per head
    over slabs of query tiles, never an S x S matrix of every head."""
    rows = tile_elems if q_rows is None else q_rows
    _build.count_plain(NAME if q_rows is None else QTILE_NAME)
    b, h, sq, d = q.shape
    skv, nk = k.shape[2], k.shape[2] // tile_elems
    nq = sq // rows
    sel = kept_mask(indices.to(q.device), counts.to(q.device), nk)
    col_ok = (torch.arange(skv, device=q.device) % tile_elems <
              block_sizes.to(q.device).repeat_interleave(tile_elems))
    per = max(1, _PLAIN_SLAB // (rows * skv))
    out = torch.empty_like(q)
    for bi in range(b):
        for hi in range(h):
            kh, vh = k[bi, hi].float(), v[bi, hi]
            for t0 in range(0, nq, per):
                t1 = min(nq, t0 + per)
                qs = q[bi, hi, t0 * rows:t1 * rows].float()
                sc = torch.matmul(qs, kh.T) * scale
                ok = sel[bi, hi, t0:t1].repeat_interleave(tile_elems, dim=-1)
                ok = ok.repeat_interleave(rows, dim=0) & col_ok
                sc = sc.masked_fill(~ok, float("-inf"))
                m = sc.amax(dim=-1, keepdim=True)
                m = torch.where(torch.isinf(m), torch.zeros_like(m), m)
                p = torch.exp(sc - m)
                l = p.sum(dim=-1, keepdim=True)
                o = torch.matmul(p.to(v.dtype).float(), vh.float())
                o = torch.where(l == 0, torch.zeros_like(o), o / l)
                out[bi, hi, t0 * rows:t1 * rows] = o.to(q.dtype)
    return out


def _dyn_sparse_cuda(name, q, k, v, indices, counts, block_sizes, scale,
                     tile_elems, q_rows):
    _build.refuse_grad(name, q, k, v)
    q, k, v, idx, out, st = sparse_cuda_operands(name, q, k, v, indices)
    b, h, sq, d = q.shape
    cnt = counts.to(device=q.device, dtype=torch.int32).contiguous()
    sizes = block_sizes.to(device=q.device, dtype=torch.int32).contiguous()
    dims = (b, h, sq, k.shape[2], d, tile_elems)
    qtile = () if q_rows is None else (q_rows,)
    entry = "fvt_dyn_sparse_fwd" if q_rows is None else \
        "fvt_dyn_sparse_qtile_fwd"
    if sparse_schedule(q.dtype, d) == "sm90":
        # groups of query tiles walking the union of their lists, the
        # longest unions first
        lists, lens, bits, group = grouped_lists(
            idx, cnt, k.shape[2] // tile_elems, q_rows or tile_elems)
        order = heaviest_first(lens)
        _build.launch(name, entry + "_sm90", q.data_ptr(), k.data_ptr(),
                      v.data_ptr(), out.data_ptr(), lists.data_ptr(),
                      lens.data_ptr(), bits.data_ptr(), order.data_ptr(),
                      sizes.data_ptr(), *dims, *qtile, group, *st,
                      float(scale), _build.stream_ptr(q))
    else:
        _build.launch(name, entry, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                      out.data_ptr(), idx.data_ptr(), cnt.data_ptr(),
                      sizes.data_ptr(), *dims, *qtile, idx.shape[-1], *st,
                      float(scale), _build.stream_ptr(q))
    return out


def dyn_sparse_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         indices: torch.Tensor, counts: torch.Tensor,
                         block_sizes: torch.Tensor, *, scale: float,
                         tile_elems: int = TILE_ELEMS,
                         q_rows: int | None = None) -> torch.Tensor:
    """K9a (``q_rows`` None) or K9b: count-driven block-sparse attention.

    q: [B, H, nQ * rows, D] (rows = ``tile_elems``, or ``q_rows``, a
    multiple of 8 up to 64); k/v: [B, H, nK * tile_elems, D] tile-major;
    indices: [B, H, nQ, slots] key-tile ids, ascending, -1 past the count;
    counts: [B, H, nQ]; block_sizes: [nK] valid tokens per key tile.
    Returns [B, H, nQ * rows, D]. Forward only: on CUDA it raises for
    operands that require grad."""
    name = NAME if q_rows is None else QTILE_NAME
    rows = tile_elems if q_rows is None else q_rows
    b, h, sq, _ = q.shape
    if (sq % rows or k.shape[2] % tile_elems or
            tuple(indices.shape[:3]) != (b, h, sq // rows) or
            tuple(counts.shape) != (b, h, sq // rows) or
            block_sizes.shape[0] != k.shape[2] // tile_elems or
            (q_rows is not None and (q_rows % 8 or not 0 < q_rows <= 64))):
        raise ValueError(
            f"{name}: q {tuple(q.shape)}, k {tuple(k.shape)}, indices "
            f"{tuple(indices.shape)}, counts {tuple(counts.shape)} and "
            f"block_sizes {tuple(block_sizes.shape)} do not describe "
            f"{rows}-row query tiles over {tile_elems}-token key tiles")
    if q.is_cuda:
        return _dyn_sparse_cuda(name, q, k, v, indices, counts, block_sizes,
                                scale, tile_elems, q_rows)
    if q.device.type == "cpu":
        return dyn_sparse_attention_plain(q, k, v, indices, counts,
                                          block_sizes, scale=scale,
                                          tile_elems=tile_elems,
                                          q_rows=q_rows)
    raise _build.KernelError(f"{name}: unsupported device {q.device}")


def masked_block_sparse_attention(q: torch.Tensor, k: torch.Tensor,
                                  v: torch.Tensor, mask: torch.Tensor,
                                  block_sizes: torch.Tensor, *,
                                  scale: float | None = None,
                                  tile_elems: int = TILE_ELEMS
                                  ) -> torch.Tensor:
    """Attention under a boolean key-block mask with per-row counts (K9a).

    q/k/v: [B, H, nB * E, D] tile-major; mask: [B, H, nQ, nK] bool;
    block_sizes: [nK] int32 valid token counts per tile."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    idx, counts = mask_indices(mask)
    return dyn_sparse_attention(q, k, v, idx, counts, block_sizes,
                                scale=scale, tile_elems=tile_elems)


def nabla_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    sta_mask: torch.Tensor | None = None, thr: float = 0.9,
                    scale: float | None = None) -> torch.Tensor:
    """Full NABLA forward on [B, S, H, D] tensors; S % 64 == 0 (the model
    orders the tokens upstream)."""
    b, s, h, d = q.shape
    if s % NABLA_BLOCK:
        raise ValueError(f"NABLA needs S divisible by {NABLA_BLOCK}, got {s}")
    mask = nabla_block_mask(q, k, sta_mask, thr)
    sizes = torch.full((s // NABLA_BLOCK,), NABLA_BLOCK, dtype=torch.int32,
                       device=q.device)
    out = masked_block_sparse_attention(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), mask, sizes,
        scale=scale, tile_elems=NABLA_BLOCK)
    return out.transpose(1, 2)
