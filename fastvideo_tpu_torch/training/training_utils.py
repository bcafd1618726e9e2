"""Training utilities (port of fastvideo_tpu/training/training_utils.py):
timestep-density sampling, sigmas, the global gradient norm and clipping,
and the activation checkpointing that ``selective_checkpointing`` names.

Random draws come from a ``torch.Generator`` where JAX takes a key; the two
give different numbers from one seed, so the tests hand both the same
draws.
"""

from __future__ import annotations

import math
from collections.abc import Iterable

import torch


def compute_density_for_timestep_sampling(
    weighting_scheme: str,
    batch_size: int,
    generator: torch.Generator,
    logit_mean: float = 0.0,
    logit_std: float = 1.0,
    mode_scale: float = 1.29,
) -> torch.Tensor:
    """SD3-style u in [0, 1], fp32 [batch_size] on the generator's device."""
    kw = dict(generator=generator, device=generator.device,
              dtype=torch.float32)
    if weighting_scheme == "logit_normal":
        u = logit_mean + logit_std * torch.randn((batch_size,), **kw)
        return torch.sigmoid(u)
    u = torch.rand((batch_size,), **kw)
    if weighting_scheme == "mode":
        return 1 - u - mode_scale * (torch.cos(math.pi * u / 2)**2 - 1 + u)
    return u


def get_sigmas(scheduler, timesteps: torch.Tensor, n_dim: int
               ) -> torch.Tensor:
    """Per-sample sigma from the scheduler's tables (the nearest timestep),
    shaped to broadcast against a tensor of rank ``n_dim``."""
    sched_ts = torch.as_tensor(scheduler.timesteps, dtype=torch.float32,
                               device=timesteps.device)
    sched_sigmas = torch.as_tensor(scheduler.sigmas, dtype=torch.float32,
                                   device=timesteps.device)
    idx = torch.argmin((sched_ts[None, :] - timesteps[:, None]).abs(), dim=1)
    sigmas = sched_sigmas[idx]
    return sigmas.reshape(sigmas.shape[0], *([1] * (n_dim - 1)))


def global_grad_norm(grads: Iterable[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares of every gradient, in fp32."""
    sq = [g.float().square().sum() for g in grads]
    return torch.stack(sq).sum().sqrt()


def clip_grad_norm(params: Iterable[torch.nn.Parameter], max_norm: float
                   ) -> torch.Tensor:
    """Scale the ``.grad`` of ``params`` in place by JAX's factor
    ``min(1, max_norm / max(norm, 1e-12))`` (not
    ``torch.nn.utils.clip_grad_norm_``'s ``max_norm / (norm + 1e-6)``).
    Returns the norm before clipping."""
    grads = [p.grad for p in params if p.grad is not None]
    norm = global_grad_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-12), max=1.0)
    for g in grads:
        g.mul_(scale.to(g.dtype))
    return norm


def set_activation_checkpointing(model: torch.nn.Module, mode: str) -> None:
    """``selective_checkpointing`` on a DiT, as the JAX trainer sets it:
    "full" recomputes each block in the backward; "ops" also keeps the
    matmul outputs where the model has a remat policy
    (``gradient_checkpointing_policy``: the Wan DiT's forward; the causal
    Wan's block-causal passes recompute whole blocks, as JAX's do); any
    other value checkpoints nothing."""
    model.gradient_checkpointing = mode in ("full", "ops")
    if hasattr(model, "gradient_checkpointing_policy"):
        model.gradient_checkpointing_policy = "ops" if mode == "ops" else None
