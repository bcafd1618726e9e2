"""Collectives over one mesh axis.

JAX writes these as ``jax.lax.all_to_all`` / ``all_gather`` / ``psum``
inside ``shard_map`` (or lets GSPMD insert them); the port calls
``torch.distributed`` on the axis's process group. Each is the identity
on an axis of size 1, as the JAX collectives are. ``all_to_all_group``
runs the exchange on any group, a group of one included (the card's
check of the Ulysses exchange at world size 1).

They carry no gradient: the port's parallel paths serve, and training
stays on one card.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from fastvideo_tpu_torch.parallel.mesh import axis_group, axis_size


def all_to_all_group(x: torch.Tensor, group, split_dim: int,
                     concat_dim: int) -> torch.Tensor:
    """``jax.lax.all_to_all(tiled=True)`` over ``group``: ``x`` is cut
    into one piece a rank along ``split_dim``; piece j goes to the group's
    rank j, and the pieces received are joined along ``concat_dim`` in
    the senders' order."""
    n = dist.get_world_size(group)
    if x.shape[split_dim] % n:
        raise ValueError(f"dim {split_dim} of {tuple(x.shape)} does not "
                         f"split over {n} ranks")
    send = torch.stack(x.chunk(n, dim=split_dim))
    recv = torch.empty_like(send)
    dist.all_to_all_single(recv, send, group=group)
    return torch.cat(recv.unbind(0), dim=concat_dim)


def _gather_into(out: torch.Tensor, x: torch.Tensor, group) -> None:
    gather = getattr(dist, "all_gather_single", None)
    if gather is None:  # releases before all_gather_single
        gather = dist.all_gather_into_tensor
    gather(out, x, group=group)


def all_gather(x: torch.Tensor, axis: str, dim: int) -> torch.Tensor:
    """``jax.lax.all_gather(tiled=True)``: the axis's pieces joined along
    ``dim`` in rank order."""
    n = axis_size(axis)
    if n == 1:
        return x
    x = x.movedim(dim, 0).contiguous()
    out = x.new_empty((n * x.shape[0],) + tuple(x.shape[1:]))
    _gather_into(out, x, axis_group(axis))
    return out.movedim(0, dim)


def all_reduce(x: torch.Tensor, axis: str,
               op: dist.ReduceOp = dist.ReduceOp.SUM) -> torch.Tensor:
    """``jax.lax.psum`` (or ``pmax`` with ``op=MAX``) over ``axis``."""
    if axis_size(axis) == 1:
        return x
    x = x.contiguous()
    dist.all_reduce(x, op=op, group=axis_group(axis))
    return x


def world_all_gather(x: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """``all_gather`` over every rank of the mesh (the world group)."""
    from fastvideo_tpu_torch.parallel.mesh import get_mesh

    mesh = get_mesh()
    if mesh.size == 1:
        return x
    x = x.movedim(dim, 0).contiguous()
    out = x.new_empty((mesh.size * x.shape[0],) + tuple(x.shape[1:]))
    _gather_into(out, x, mesh.world_group)
    return out.movedim(0, dim)
