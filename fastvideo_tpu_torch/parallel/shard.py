"""Metadata-driven parameter sharding, TP and FSDP (port of
fastvideo_tpu/parallel/shard.py).

The layers declare which dims of their parameters split over the mesh: a
module's ``tp_axes`` maps a parameter name to one axis name (or None) per
dim of the parameter, in the port's torch layout (a column-parallel
Linear's weight [out, in] is ``("tp", None)``, JAX's kernel [in, out] is
``(None, "tp")``). ``param_spec`` turns that into a spec by JAX's rule,
and ``shard_state`` takes this rank's slice of each tensor of a full state
dict (from ``models/loader/jax_params.py`` or a safetensors checkpoint).

Combination rule per parameter:

* dims named by ``tp_axes`` are sharded on those mesh axes (usually ``tp``);
* if an ``fsdp_axis`` is given, the largest remaining dim whose size divides
  the axis is additionally sharded (ZeRO-3-style) when the parameter is big
  enough to be worth it;
* everything else is replicated.

A fused parameter whose split dim is made of segments (the q, k and v rows
of ``QKVParallelLinear``) names them in its module's ``tp_segments``: each
segment splits on its own, and a rank's slice is its piece of each, in
order.
"""

from __future__ import annotations

from collections.abc import Mapping
from typing import Any

import torch
from torch import nn

from fastvideo_tpu_torch.parallel.mesh import TP_AXIS, Mesh

__all__ = ["param_spec", "state_specs", "shard_state", "shard_tensor",
           "tp_axes_of", "tp_segments_of"]


def param_spec(shape: tuple[int, ...], tp_axes: tuple[str | None, ...] | None,
               mesh: Mesh, fsdp_axis: str | None = None,
               min_fsdp_size: int = 2**16) -> tuple[Any, ...]:
    """The spec (one axis name or None a dim) for one parameter from its
    declared metadata and the FSDP rule."""
    ndim = len(shape)
    size = 1
    for s in shape:
        size *= s
    spec: list[Any] = [None] * ndim
    if tp_axes:
        for d, ax in enumerate(tp_axes[:ndim]):
            if ax is None:
                continue
            ax_size = mesh.shape.get(ax, 1)
            if ax_size > 1 and shape[d] % ax_size == 0:
                spec[d] = ax
    if fsdp_axis is not None and mesh.shape.get(fsdp_axis, 1) > 1 \
            and size >= min_fsdp_size:
        fsdp_size = mesh.shape[fsdp_axis]
        for d in sorted(range(ndim), key=lambda d: -shape[d]):
            if spec[d] is None and shape[d] % fsdp_size == 0:
                spec[d] = fsdp_axis
                break
    return tuple(spec)


def tp_axes_of(model: nn.Module) -> dict[str, tuple]:
    """{state-dict name: tp_axes} of every tensor a module declares."""
    out = {}
    for prefix, module in model.named_modules():
        for name, axes in getattr(module, "tp_axes", {}).items():
            out[f"{prefix}.{name}" if prefix else name] = tuple(axes)
    return out


def tp_segments_of(model: nn.Module) -> dict[str, tuple[int, ...]]:
    """{state-dict name: segment sizes} of the fused parameters."""
    out = {}
    for prefix, module in model.named_modules():
        for name, segs in getattr(module, "tp_segments", {}).items():
            out[f"{prefix}.{name}" if prefix else name] = tuple(segs)
    return out


def shard_tensor(value: torch.Tensor, spec: tuple, mesh: Mesh,
                 segments: tuple[int, ...] | None = None) -> torch.Tensor:
    """This rank's slice of ``value`` by ``spec``: on each named dim, the
    piece at this rank's index on that axis (of each segment of the tp
    dim, with ``segments``)."""
    for d, ax in enumerate(spec):
        if ax is None:
            continue
        n, i = mesh.shape[ax], mesh.coords[ax]
        segs = (segments if segments and ax == TP_AXIS else
                (value.shape[d],))
        pieces, start = [], 0
        for seg in segs:
            if seg % n:
                raise ValueError(f"a segment of {seg} along dim {d} does not "
                                 f"split over {ax}={n}")
            pieces.append(value.narrow(d, start + i * (seg // n), seg // n))
            start += seg
        value = pieces[0] if len(pieces) == 1 else torch.cat(pieces, dim=d)
    return value.contiguous()


def state_specs(state: Mapping[str, torch.Tensor], mesh: Mesh,
                fsdp_axis: str | None = None, min_fsdp_size: int = 2**16, *,
                axes: Mapping[str, tuple] | None = None
                ) -> dict[str, tuple]:
    """{name: spec} matching ``state``; ``axes`` gives each tensor's
    tp_axes (``tp_axes_of(model)``), the rest replicate (FSDP aside)."""
    axes = axes or {}
    return {name: param_spec(tuple(t.shape), axes.get(name), mesh, fsdp_axis,
                             min_fsdp_size)
            for name, t in state.items()}


def shard_state(state: Mapping[str, torch.Tensor], mesh: Mesh,
                fsdp_axis: str | None = None, min_fsdp_size: int = 2**16, *,
                axes: Mapping[str, tuple] | None = None,
                segments: Mapping[str, tuple[int, ...]] | None = None
                ) -> dict[str, torch.Tensor]:
    """This rank's slice of every tensor of a full state dict."""
    specs = state_specs(state, mesh, fsdp_axis, min_fsdp_size, axes=axes)
    segments = segments or {}
    return {name: shard_tensor(t, specs[name], mesh, segments.get(name))
            for name, t in state.items()}
