"""rCM scheduler: 1-4 step distilled sampling of TurboDiffusion (port of
fastvideo_tpu/models/schedulers/scheduling_rcm.py).

The TrigFlow timesteps ``[atan(sigma_max), *mid_timesteps, 0]`` map to
RectifiedFlow ones by ``t = sin(t) / (cos(t) + sin(t))``; a step is the
SDE update ``x = (1 - t_next) * (x - t_cur * v) + t_next * noise`` in fp32
with fresh noise from a CPU generator seeded ``_noise_seed + step_index +
1``. As in the JAX package nothing calls ``set_noise_seed``, so that seed is
0 whatever the request's seed: the port copies this.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from fastvideo_tpu_torch.models.schedulers.base import (BaseScheduler,
                                                        SchedulerOutput)


class RCMScheduler(BaseScheduler):
    order = 1

    def __init__(self, num_train_timesteps: int = 1000,
                 sigma_max: float = 80.0,
                 mid_timesteps: list[float] | None = None):
        self.num_train_timesteps = num_train_timesteps
        self.sigma_max = sigma_max
        self._mid_timesteps = list(mid_timesteps if mid_timesteps is not None
                                   else [1.5, 1.4, 1.0])
        self.sigmas = np.array([1.0, 0.0], dtype=np.float64)
        self.timesteps = self.sigmas * 1000.0
        self._step_index: int | None = None
        self._noise_seed = 0

    @property
    def init_noise_sigma(self) -> float:
        return float(self.sigmas[0])

    def set_shift(self, shift: float) -> None:
        """rCM has no shift."""

    def set_noise_seed(self, seed: int) -> None:
        """Base seed of the per-step SDE noise."""
        self._noise_seed = int(seed)

    def set_timesteps(self, num_inference_steps: int | None = None,
                      sigma_max: float | None = None, **kwargs) -> None:
        num_inference_steps = num_inference_steps or 4
        if sigma_max is not None:
            self.sigma_max = sigma_max
        mid = self._mid_timesteps[:num_inference_steps - 1]
        t_steps = np.array([math.atan(self.sigma_max), *mid, 0.0],
                           dtype=np.float64)
        # TrigFlow -> RectifiedFlow
        t_steps = np.sin(t_steps) / (np.cos(t_steps) + np.sin(t_steps))
        self.sigmas = t_steps
        self.timesteps = t_steps[:-1] * 1000.0
        self.num_inference_steps = num_inference_steps
        self._step_index = None

    def scale_noise(self, noise: torch.Tensor) -> torch.Tensor:
        return noise.float() * float(self.sigmas[0])

    def _index_for(self, timestep) -> int:
        return int(np.argmin(np.abs(self.timesteps - float(timestep))))

    def step(self, model_output: torch.Tensor, timestep, sample: torch.Tensor,
             **kwargs) -> SchedulerOutput:
        from fastvideo_tpu_torch.pipelines.stages.latent_preparation import (
            randn_like_reference)

        if self._step_index is None:
            self._step_index = self._index_for(timestep)
        t_cur = float(self.sigmas[self._step_index])
        t_next = (float(self.sigmas[self._step_index + 1])
                  if self._step_index + 1 < len(self.sigmas) else 0.0)
        x0 = sample.float() - t_cur * model_output.float()
        if t_next > 0:
            noise = randn_like_reference(
                tuple(sample.shape),
                [self._noise_seed + self._step_index + 1]).to(sample.device)
            prev = (1.0 - t_next) * x0 + t_next * noise
        else:
            prev = x0
        self._step_index += 1
        return SchedulerOutput(prev_sample=prev.to(model_output.dtype))

    def __len__(self) -> int:
        return self.num_train_timesteps
