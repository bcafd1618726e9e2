"""Ulysses sequence parallelism (port of fastvideo_tpu/parallel/ulysses.py).

The DiT's tokens are split over the sp ranks after the patch embedding,
padded to a multiple of sp. Attention exchanges heads for tokens with one
all-to-all on the sp group (each rank then holds the whole sequence for
its share of the heads), attends, and exchanges back. Under tensor
parallelism the heads are already this tp rank's share (the column-parallel
projections made them), and sp exchanges within it. The batch is split
over dp where JAX's specs put dp on it, under sp (``shard_seq``), and
only where dp divides it; else each dp rank keeps it whole, as at sp 1.
``unshard_seq`` gathers a split batch back, so a model returns the whole
batch on every rank.
"""

from __future__ import annotations

from collections.abc import Callable

import torch
import torch.nn.functional as F

from fastvideo_tpu_torch.parallel.collectives import (all_gather,
                                                      all_to_all_group)
from fastvideo_tpu_torch.parallel.mesh import (DP_AXIS, SP_AXIS, TP_AXIS,
                                               axis_group, axis_index,
                                               axis_size, get_sp_size,
                                               get_tp_size)


def pad_to_multiple(x: torch.Tensor, multiple: int,
                    axis: int) -> tuple[torch.Tensor, int]:
    """Zero-pad ``axis`` of ``x`` up to a multiple; returns (padded, orig)."""
    size = x.shape[axis]
    if multiple <= 1 or size % multiple == 0:
        return x, size
    widths = [0] * (2 * x.ndim)
    widths[2 * (x.ndim - 1 - axis) + 1] = multiple - size % multiple
    return F.pad(x, widths), size


def pad_rope_to(cos: torch.Tensor, sin: torch.Tensor,
                seq_len: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Pad [S, D] rope tables to the (sp-padded) token length: cos with
    1.0 / sin with 0.0 so padded tokens rotate by identity."""
    if cos.shape[0] != seq_len:
        pad = seq_len - cos.shape[0]
        cos = F.pad(cos, (0, 0, 0, pad), value=1.0)
        sin = F.pad(sin, (0, 0, 0, pad))
    return cos, sin


def pad_tokens_to(t: torch.Tensor | None, seq_len: int,
                  axis: int = 1) -> torch.Tensor | None:
    """Zero-pad a per-token tensor (modulation, temb, masks) on its token
    axis to the (sp-padded) length."""
    if t is None or t.shape[axis] == seq_len:
        return t
    widths = [0] * (2 * t.ndim)
    widths[2 * (t.ndim - 1 - axis) + 1] = seq_len - t.shape[axis]
    return F.pad(t, widths)


def _piece(x: torch.Tensor, axis: str, dim: int) -> torch.Tensor:
    """This rank's contiguous piece of ``dim`` along mesh ``axis``."""
    n = axis_size(axis)
    if n == 1:
        return x
    if x.shape[dim] % n:
        raise ValueError(f"dim {dim} of {tuple(x.shape)} does not split "
                         f"over {axis}={n}")
    step = x.shape[dim] // n
    return x.narrow(dim, axis_index(axis) * step, step)


def splits_batch(batch: int) -> bool:
    """Whether a batch of ``batch`` splits over dp: under sp, where JAX's
    ``shard_seq`` puts dp on it, and where dp divides it."""
    dp = axis_size(DP_AXIS)
    return get_sp_size() > 1 and dp > 1 and batch % dp == 0


def shard_batch(x: torch.Tensor | None) -> torch.Tensor | None:
    """This dp rank's share of the batch (dim 0), where it splits; else
    the whole batch."""
    if x is None or not splits_batch(x.shape[0]):
        return x
    return _piece(x, DP_AXIS, 0)


def sp_slice(x: torch.Tensor, axis: int = 1) -> torch.Tensor:
    """This sp rank's share of an (sp-padded) token axis."""
    return _piece(x, SP_AXIS, axis)


def local_heads(x: torch.Tensor, axis: int = 2) -> torch.Tensor:
    """This tp rank's share of a tensor that holds every head."""
    return _piece(x, TP_AXIS, axis)


def shard_seq(x: torch.Tensor, axis: int = 1) -> tuple[torch.Tensor, int]:
    """Pad the token dim to a multiple of sp and keep this rank's
    contiguous slice of it, and of the batch over dp where it splits
    (``shard_batch``). Returns (local tensor, original sequence length)."""
    x, orig = pad_to_multiple(x, get_sp_size(), axis)
    return sp_slice(shard_batch(x), axis), orig


def unshard_seq(x: torch.Tensor, original_len: int, axis: int = 1, *,
                batch: int | None = None) -> torch.Tensor:
    """All-gather the token dim over sp, and the batch over dp where
    ``shard_seq`` split a batch of ``batch`` (None: it was not split), and
    strip the padding."""
    x = all_gather(x, SP_AXIS, axis)
    if batch is not None and splits_batch(batch):
        x = all_gather(x, DP_AXIS, 0)
    if x.shape[axis] != original_len:
        x = x.narrow(axis, 0, original_len)
    return x


def seq_to_heads(x: torch.Tensor, group) -> torch.Tensor:
    """[B, S/n, H, D] on each of the group's n ranks -> [B, S, H/n, D]."""
    return all_to_all_group(x, group, split_dim=2, concat_dim=1)


def heads_to_seq(x: torch.Tensor, group) -> torch.Tensor:
    """[B, S, H/n, D] -> [B, S/n, H, D], the inverse of ``seq_to_heads``."""
    return all_to_all_group(x, group, split_dim=1, concat_dim=2)


def ulysses_attention(
    local_attn: Callable[..., torch.Tensor],
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    kv_replicated: bool = False,
    extra: torch.Tensor | None = None,
) -> torch.Tensor:
    """Run full-sequence attention over sp-sharded q/k/v.

    Args:
      local_attn: attention ``(q, k, v[, extra]) -> o`` on ``[B, S, H, D]``
        tensors (the full sequence, this rank's heads).
      q, k, v: ``[B, S/sp, H/tp, D]``: this rank's tokens and this tp rank's
        heads. With ``kv_replicated`` k/v hold a context every sp rank has
        whole (cross-attention), and the rank takes its heads' slice of it
        instead of an exchange.
      extra: a per-token tensor exchanged as q is (VSA's gate).

    Scatter heads, gather the sequence; reversed on the output."""
    sp, tp = get_sp_size(), get_tp_size()
    operands = (q, k, v) if extra is None else (q, k, v, extra)
    if sp == 1 and tp == 1:
        return local_attn(*operands)
    heads = q.shape[2] * tp
    if heads % (sp * tp) != 0:
        raise ValueError(
            f"num_heads={heads} must be divisible by sp*tp={sp * tp}")
    if sp == 1:
        return local_attn(*operands)
    group = axis_group(SP_AXIS)
    q = seq_to_heads(q, group)
    if kv_replicated:
        per = k.shape[2] // sp
        first = axis_index(SP_AXIS) * per
        k, v = k[:, :, first:first + per], v[:, :, first:first + per]
    else:
        k, v = seq_to_heads(k, group), seq_to_heads(v, group)
    operands = (q, k, v)
    if extra is not None:
        operands += (seq_to_heads(extra, group),)
    return heads_to_seq(local_attn(*operands), group)


def local_head_parallel_attention(
    local_attn: Callable[..., torch.Tensor],
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    q_seq_sharded: bool | None = None,
) -> torch.Tensor:
    """Head-parallel (tp) attention with no token exchange
    (cross-attention): each rank attends its local q tokens (sp-sharded or
    not) over the whole context, with its tp share of the heads, which the
    column-parallel projections already gave q, k and v. JAX needs a
    ``shard_map`` here to keep its kernel on local shards; in the port the
    tensors are local already."""
    del q_seq_sharded
    return local_attn(q, k, v)
