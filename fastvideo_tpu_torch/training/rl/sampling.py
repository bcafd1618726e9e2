"""Few-step flow-matching sampling for the RL training methods (port of
fastvideo_tpu/training/rl/sampling.py).

The sampler works on the DiT module directly: a Python loop over the
schedule's steps, without grad (JAX compiles the whole trajectory into one
program). ``trajectory="ode"`` is Euler on the velocity; ``"sde_reflow"``
takes each step's x0 estimate and re-noises it to the next sigma with fresh
noise, which the caller draws (the trainer's CPU ``torch.Generator``).
Scalars are combined in fp32, as JAX's traced schedule combines them.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Sequence

import numpy as np
import torch

_SCHEDULERS = {"flow_match_euler", "model_default"}
_TRAJECTORIES = {"ode", "sde_reflow"}


@dataclasses.dataclass(frozen=True)
class SamplingConfig:
    """The ``method_config.sampling`` knobs."""

    num_steps: int = 25
    scheduler: str = "model_default"
    trajectory: str = "ode"
    flow_shift: float | None = None
    timesteps: tuple[float, ...] | None = None
    sigmas: tuple[float, ...] | None = None

    @classmethod
    def from_mapping(cls, raw: dict[str, Any] | None) -> "SamplingConfig":
        if raw is None:
            return cls()
        if not isinstance(raw, dict):
            raise ValueError("method.sampling must be a mapping, got "
                             f"{type(raw).__name__}")
        supported = {"flow_shift", "num_steps", "scheduler", "sigmas",
                     "timesteps", "trajectory"}
        unknown = sorted(set(raw) - supported)
        if unknown:
            raise ValueError(f"Unsupported method.sampling key(s): {unknown}."
                             f" Supported keys: {sorted(supported)}")
        scheduler = str(raw.get("scheduler") or "model_default").lower()
        if scheduler not in _SCHEDULERS:
            raise ValueError("method.sampling.scheduler must be one of "
                             f"{sorted(_SCHEDULERS)}, got {scheduler!r}")
        trajectory = str(raw.get("trajectory") or "ode").lower()
        if trajectory not in _TRAJECTORIES:
            raise ValueError("method.sampling.trajectory must be one of "
                             f"{sorted(_TRAJECTORIES)}, got {trajectory!r}")
        timesteps = raw.get("timesteps")
        sigmas = raw.get("sigmas")
        if timesteps is not None:
            if not isinstance(timesteps, list) or not timesteps:
                raise ValueError(
                    "method.sampling.timesteps must be a non-empty list")
            timesteps = tuple(float(t) for t in timesteps)
        if sigmas is not None:
            if not isinstance(sigmas, list) or not sigmas:
                raise ValueError(
                    "method.sampling.sigmas must be a non-empty list")
            sigmas = tuple(float(s) for s in sigmas)
        if (timesteps is not None and sigmas is not None
                and len(timesteps) != len(sigmas)):
            raise ValueError("method.sampling.timesteps and sigmas must "
                             "have the same length")
        num_steps = int(raw.get("num_steps", 25) or 25)
        if num_steps <= 0:
            raise ValueError("method.sampling.num_steps must be positive")
        shift = raw.get("flow_shift")
        return cls(num_steps=num_steps, scheduler=scheduler,
                   trajectory=trajectory,
                   flow_shift=None if shift in (None, "inherit")
                   else float(shift),
                   timesteps=timesteps, sigmas=sigmas)


@dataclasses.dataclass
class SamplingResult:
    latents: torch.Tensor   # [B, ...] clean samples, fp32
    timesteps: np.ndarray   # [num_steps] schedule used
    sigmas: np.ndarray      # [num_steps + 1]


class DiffusionSampler:
    """Few-step flow-matching sampler over a DiT module."""

    def __init__(self, config: SamplingConfig,
                 num_train_timesteps: int = 1000):
        self.config = config
        self.num_train = num_train_timesteps

    @property
    def stochastic(self) -> bool:
        return self.config.trajectory == "sde_reflow"

    def schedule(self) -> tuple[np.ndarray, np.ndarray]:
        """(timesteps [n], sigmas [n + 1]): the explicit sigmas or
        timesteps, else n sigmas from 1 down to 1/n shifted by
        ``s sigma / (1 + (s - 1) sigma)``; then a final 0."""
        cfg = self.config
        if cfg.sigmas is not None:
            sig = np.asarray(cfg.sigmas, np.float32)
        elif cfg.timesteps is not None:
            sig = np.asarray(cfg.timesteps, np.float32) / self.num_train
        else:
            sig = np.linspace(1.0, 1.0 / cfg.num_steps, cfg.num_steps,
                              dtype=np.float32)
            shift = cfg.flow_shift
            if shift is not None and shift != 1.0:
                sig = shift * sig / (1.0 + (shift - 1.0) * sig)
        sigmas = np.concatenate([sig, [0.0]]).astype(np.float32)
        timesteps = (sigmas[:-1] * self.num_train).astype(np.float32)
        return timesteps, sigmas

    @torch.no_grad()
    def sample(self, model: torch.nn.Module, noise: torch.Tensor,
               embeds: torch.Tensor,
               fresh: Sequence[torch.Tensor] = ()) -> SamplingResult:
        """Run the schedule from ``noise`` (fp32) with the DiT in bf16;
        ``fresh``: one noise tensor a step for ``sde_reflow`` (unused by
        ``ode``)."""
        timesteps, sigmas = self.schedule()
        if self.stochastic and len(fresh) < len(timesteps):
            raise ValueError(f"sde_reflow needs {len(timesteps)} fresh "
                             f"noise tensors, got {len(fresh)}")
        x = noise.float()
        emb = embeds.to(torch.bfloat16)
        for i, t_val in enumerate(timesteps):
            t = torch.full((x.shape[0],), float(t_val), dtype=torch.float32,
                           device=x.device)
            v = model(x.to(torch.bfloat16), emb, t).float()
            sig, nsig = sigmas[i], sigmas[i + 1]
            if self.stochastic:
                x0 = x - float(sig) * v
                x = float(np.float32(1) - nsig) * x0 + float(nsig) * \
                    fresh[i].to(x.device, torch.float32)
            else:
                x = x + float(nsig - sig) * v
        return SamplingResult(latents=x, timesteps=timesteps, sigmas=sigmas)
