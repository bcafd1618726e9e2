"""Self-forcing flow-match scheduler (port of
fastvideo_tpu/models/schedulers/scheduling_self_forcing_flow_match.py): a
linspace sigma schedule warped by ``shift s / (1 + (shift - 1) s)``
(optionally one step longer, inverted or reversed), the nearest-timestep
Euler step ``x + (s' - s) v``, forward corruption at per-sample timesteps,
the Gaussian training weights and the high-noise alpha / beta corruption
of causal distillation.

The tables are numpy on the host, as in the JAX package (the training
weights in float64, then float32); the per-sample math is PyTorch on the
latents' device.
"""

from __future__ import annotations

import numpy as np
import torch

from fastvideo_tpu_torch.models.schedulers.base import (BaseScheduler,
                                                        SchedulerOutput)


class SelfForcingFlowMatchScheduler(BaseScheduler):
    order = 1

    def __init__(self, num_inference_steps: int = 100,
                 num_train_timesteps: int = 1000, shift: float = 3.0,
                 sigma_max: float = 1.0,
                 sigma_min: float = 0.003 / 1.002,
                 inverse_timesteps: bool = False,
                 extra_one_step: bool = False,
                 reverse_sigmas: bool = False, training: bool = False):
        self.num_train_timesteps = num_train_timesteps
        self.shift = shift
        self.sigma_max = sigma_max
        self.sigma_min = sigma_min
        self.inverse_timesteps = inverse_timesteps
        self.extra_one_step = extra_one_step
        self.reverse_sigmas = reverse_sigmas
        self.set_timesteps(num_inference_steps, training=training)

    def set_shift(self, shift: float) -> None:
        self.shift = shift

    def set_timesteps(self, num_inference_steps: int = 100,
                      denoising_strength: float = 1.0,
                      training: bool = False, **kwargs) -> None:
        sigma_start = self.sigma_min + (
            self.sigma_max - self.sigma_min) * denoising_strength
        if self.extra_one_step:
            sigmas = np.linspace(sigma_start, self.sigma_min,
                                 num_inference_steps + 1)[:-1]
        else:
            sigmas = np.linspace(sigma_start, self.sigma_min,
                                 num_inference_steps)
        if self.inverse_timesteps:
            sigmas = sigmas[::-1].copy()
        sigmas = self.shift * sigmas / (1 + (self.shift - 1) * sigmas)
        if self.reverse_sigmas:
            sigmas = 1 - sigmas
        self.sigmas = sigmas.astype(np.float32)
        self.timesteps = (sigmas * self.num_train_timesteps).astype(
            np.float32)
        if training:
            # float64: at few steps a float32 exp underflows to all zeros
            # and the normalisation gives NaN weights
            x = self.timesteps.astype(np.float64)
            y = np.exp(-2 * ((x - num_inference_steps / 2) /
                             num_inference_steps)**2)
            y_shifted = y - y.min()
            denom = y_shifted.sum()
            weights = (np.ones_like(y_shifted) if denom <= 0 else
                       y_shifted * (num_inference_steps / denom))
            self.linear_timesteps_weights = weights.astype(np.float32)

    def _table(self, values: np.ndarray, like: torch.Tensor) -> torch.Tensor:
        return torch.from_numpy(values).to(like.device)

    def _timestep_id(self, timestep) -> torch.Tensor:
        """The index of the nearest table timestep, one per sample (the
        first on a tie)."""
        t = torch.as_tensor(timestep).to(torch.float32).reshape(-1)
        ts = self._table(self.timesteps, t)
        return torch.argmin(torch.abs(ts[None] - t[:, None]), dim=1)

    def _sigma_at(self, tid: torch.Tensor, ndim: int) -> torch.Tensor:
        return self._table(self.sigmas, tid)[tid].reshape(
            (-1,) + (1,) * (ndim - 1))

    def step(self, model_output: torch.Tensor, timestep,
             sample: torch.Tensor, to_final: bool = False,
             **kwargs) -> SchedulerOutput:
        tid = self._timestep_id(timestep).to(sample.device)
        sigma = self._sigma_at(tid, sample.ndim)
        terminal = 1.0 if (self.inverse_timesteps
                           or self.reverse_sigmas) else 0.0
        at_end = bool((tid + 1 >= len(self.timesteps)).any())
        if to_final or at_end:
            sigma_next = terminal
        else:
            sigma_next = self._sigma_at(tid + 1, sample.ndim)
        prev = sample.float() + model_output.float() * (sigma_next - sigma)
        return SchedulerOutput(prev_sample=prev.to(sample.dtype))

    @staticmethod
    def calculate_alpha_beta_high(sigma, sigma_bound):
        alpha = (1 - sigma) / (1 - sigma_bound)
        beta = torch.sqrt(sigma**2 - (alpha * sigma_bound)**2)
        return alpha, beta

    def add_noise(self, original_samples: torch.Tensor, noise: torch.Tensor,
                  timestep) -> torch.Tensor:
        tid = self._timestep_id(timestep).to(noise.device)
        sigma = self._sigma_at(tid, original_samples.ndim)
        return ((1 - sigma) * original_samples.float() +
                sigma * noise.float()).to(noise.dtype)

    def add_noise_high(self, original_samples: torch.Tensor,
                       noise: torch.Tensor, timestep,
                       boundary_timestep) -> torch.Tensor:
        ndim = original_samples.ndim
        sigma = self._sigma_at(
            self._timestep_id(timestep).to(noise.device), ndim)
        sigma_b = self._sigma_at(
            self._timestep_id(boundary_timestep).to(noise.device), ndim)
        alpha, beta = self.calculate_alpha_beta_high(sigma, sigma_b)
        return (alpha * original_samples.float() +
                beta * noise.float()).to(noise.dtype)

    def training_target(self, sample: torch.Tensor, noise: torch.Tensor,
                        timestep) -> torch.Tensor:
        return noise - sample

    def training_weight(self, timestep) -> torch.Tensor:
        tid = self._timestep_id(timestep)
        return self._table(self.linear_timesteps_weights, tid)[tid]


EntryClass = SelfForcingFlowMatchScheduler
