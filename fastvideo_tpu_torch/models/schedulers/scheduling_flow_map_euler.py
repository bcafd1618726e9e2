"""Flow-map any-step Euler scheduler, AnyFlow's (port of
fastvideo_tpu/models/schedulers/scheduling_flow_map_euler.py).

The model predicts the AVERAGE velocity u(x_t, t, r) from t back to r, so
one Euler step ``x_r = x_t - ((t - r) / T) u`` is valid for any step size.
With the AnyFlow training helpers: the shift transform and the uniform /
gaussian / beta08 per-timestep loss weights. The timestep table is numpy on
the host, as in JAX; the per-sample math is PyTorch on the latents' device.
"""

from __future__ import annotations

import numpy as np
import torch

from fastvideo_tpu_torch.models.schedulers.base import (BaseScheduler,
                                                        SchedulerOutput)


def _view(x: torch.Tensor, ndim: int) -> torch.Tensor:
    return x.reshape((-1,) + (1,) * (ndim - 1))


class FlowMapEulerDiscreteScheduler(BaseScheduler):
    order = 1

    def __init__(self, *, num_train_timesteps: int = 1000,
                 shift: float = 1.0):
        self.num_train_timesteps = int(num_train_timesteps)
        self.shift = float(shift)
        self.timesteps = np.empty(0, np.float32)
        self.sigmas = np.empty(0, np.float32)

    def set_shift(self, shift: float) -> None:
        self.shift = float(shift)

    def apply_shift(self, t, *, shift: float | None = None):
        """s t / (1 + (s - 1) t) of a normalized time (tensor or array)."""
        s = self.shift if shift is None else float(shift)
        if s == 1.0:
            return t
        return s * t / (1.0 + (s - 1.0) * t)

    def get_train_weight(self, t: torch.Tensor, *,
                         weight_type: str = "beta08") -> torch.Tensor:
        """Per-sample loss weights of timesteps ``t`` (in [0, T], or already
        normalized when none exceeds 1), scaled to sum to T."""
        t_f = torch.as_tensor(t).to(torch.float32)
        t_norm = torch.where(t_f.max() > 1.0 + 1e-6,
                             t_f / self.num_train_timesteps, t_f)
        t_norm = torch.clamp(t_norm, 0.0, 1.0)
        if weight_type == "uniform":
            w = torch.ones_like(t_norm)
        elif weight_type == "gaussian":
            w = torch.exp(-0.5 * ((t_norm - 0.5) / 0.2) ** 2)
        elif weight_type == "beta08":
            w = t_norm * torch.sqrt(torch.clamp(1.0 - t_norm, min=0.0))
        else:
            raise ValueError(f"Unknown weight_type: {weight_type!r}")
        return w * (float(self.num_train_timesteps) /
                    torch.clamp(torch.sum(w), min=1e-8))

    def set_timesteps(self, num_inference_steps: int | None = None,
                      custom_timesteps=None, **kwargs) -> None:
        if custom_timesteps is not None:
            ts = np.asarray(custom_timesteps, np.float32)
            if not np.all(ts[:-1] >= ts[1:]):
                raise ValueError("custom_timesteps must be descending")
        else:
            if not num_inference_steps or num_inference_steps <= 0:
                raise ValueError("num_inference_steps must be positive")
            ts_norm = np.linspace(1.0, 0.0, num_inference_steps + 1,
                                  dtype=np.float32)
            ts = np.asarray(self.apply_shift(ts_norm),
                            np.float32) * self.num_train_timesteps
        self.timesteps = ts
        self.sigmas = ts / self.num_train_timesteps

    def step(self, model_output: torch.Tensor, timestep,
             sample: torch.Tensor, r_timestep=None,
             **kwargs) -> SchedulerOutput:
        if r_timestep is None:
            raise ValueError("flow-map step requires r_timestep")
        dev = sample.device
        t = torch.as_tensor(timestep, dtype=torch.float32,
                            device=dev).reshape(-1)
        r = torch.as_tensor(r_timestep, dtype=torch.float32,
                            device=dev).reshape(-1)
        dt = _view((t - r) / float(self.num_train_timesteps), sample.ndim)
        prev = sample.float() - dt * model_output.float()
        return SchedulerOutput(prev_sample=prev.to(sample.dtype))

    def add_noise(self, original_samples: torch.Tensor, noise: torch.Tensor,
                  timestep) -> torch.Tensor:
        sigma = _view(torch.as_tensor(
            timestep, dtype=torch.float32, device=original_samples.device) /
            float(self.num_train_timesteps), original_samples.ndim)
        return (1.0 - sigma) * original_samples + sigma * noise


EntryClass = FlowMapEulerDiscreteScheduler
