"""Forward context (port of fastvideo_tpu/forward_context.py): a context
var carrying (current_timestep, attn_metadata, forward_batch) to the
attention layers."""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
from typing import Any

from fastvideo_tpu_torch.attention.backends.abstract import AttentionMetadata

__all__ = ["ForwardContext", "get_forward_context", "set_forward_context",
           "bind_forward_context", "AttentionMetadata"]


@dataclasses.dataclass
class ForwardContext:
    current_timestep: int = 0
    attn_metadata: AttentionMetadata | None = None
    forward_batch: Any = None


_forward_context: contextvars.ContextVar[ForwardContext | None] = (
    contextvars.ContextVar("forward_context", default=None))


def get_forward_context() -> ForwardContext | None:
    return _forward_context.get()


@contextlib.contextmanager
def set_forward_context(current_timestep: int = 0,
                        attn_metadata: AttentionMetadata | None = None,
                        forward_batch: Any = None):
    token = _forward_context.set(
        ForwardContext(current_timestep, attn_metadata, forward_batch))
    try:
        yield
    finally:
        _forward_context.reset(token)


def bind_forward_context(fn):
    """``fn`` run under the forward context that is current now, wherever
    it is called later. A block under activation checkpointing runs its
    forward again inside the backward, and on CUDA autograd runs that on a
    thread of its own, which does not see the caller's context: bound, the
    recompute reads the same attention metadata (the same VSA sparsity, so
    the same tiles) as the forward."""
    ctx = _forward_context.get()

    def bound(*args, **kwargs):
        token = _forward_context.set(ctx)
        try:
            return fn(*args, **kwargs)
        finally:
            _forward_context.reset(token)

    return bound
