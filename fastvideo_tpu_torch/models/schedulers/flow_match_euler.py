"""Flow-match Euler discrete scheduler (port of
fastvideo_tpu/models/schedulers/flow_match_euler.py), the causal Wan's
sampler: sigmas t/T warped by the static or dynamic (mu) shift, optionally
stretched to a terminal sigma or replaced by a Karras ramp; the Euler update
``x + (s_next - s) * v`` in fp32 on the sample's device; per-token
timesteps; stochastic sampling (x0 renoised to the next sigma); the terminal
sigma 0 appended. The schedule is numpy on the host, as in the JAX package.

The per-token branch takes ``dt = s - s_next``, the opposite sign of the
scalar branch, and both add ``dt * v``: the JAX package copies the reference
literally, and so does the port.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from fastvideo_tpu_torch.models.schedulers.base import (BaseScheduler,
                                                        SchedulerOutput)


class FlowMatchEulerDiscreteScheduler(BaseScheduler):

    def __init__(self, num_train_timesteps: int = 1000, shift: float = 1.0,
                 use_dynamic_shifting: bool = False,
                 base_shift: float = 0.5, max_shift: float = 1.15,
                 base_image_seq_len: int = 256,
                 max_image_seq_len: int = 4096,
                 shift_terminal: float | None = None,
                 time_shift_type: str = "exponential",
                 stochastic_sampling: bool = False,
                 final_sigmas_type: str = "sigma_min",
                 sigma_min: float | None = None,
                 sigma_max: float | None = None,
                 use_karras_sigmas: bool = False,
                 sigma_data: float | None = None, **kwargs):
        self.num_train_timesteps = num_train_timesteps
        self._shift = shift
        self.use_dynamic_shifting = use_dynamic_shifting
        self.base_shift = base_shift
        self.max_shift = max_shift
        self.base_image_seq_len = base_image_seq_len
        self.max_image_seq_len = max_image_seq_len
        self.shift_terminal = shift_terminal
        self.time_shift_type = time_shift_type
        self.stochastic_sampling = stochastic_sampling
        self.final_sigmas_type = final_sigmas_type
        self.use_karras_sigmas = use_karras_sigmas
        self.sigma_data = sigma_data if sigma_data is not None else 1.0

        timesteps = np.linspace(1, num_train_timesteps, num_train_timesteps,
                                dtype=np.float32)[::-1].copy()
        sigmas = timesteps / num_train_timesteps
        if not use_dynamic_shifting:
            sigmas = shift * sigmas / (1 + (shift - 1) * sigmas)
        self.timesteps = sigmas * num_train_timesteps
        self.sigmas = sigmas
        self.sigma_min = (sigma_min
                          if sigma_min is not None else float(sigmas[-1]))
        self.sigma_max = (sigma_max
                          if sigma_max is not None else float(sigmas[0]))
        self._step_index: int | None = None
        self._begin_index: int | None = None
        self.num_inference_steps: int | None = None

    @property
    def shift(self) -> float:
        return self._shift

    def set_shift(self, shift: float) -> None:
        self._shift = shift

    @property
    def step_index(self) -> int | None:
        return self._step_index

    def set_begin_index(self, begin_index: int = 0) -> None:
        self._begin_index = begin_index

    def time_shift(self, mu: float, sigma: float, t: np.ndarray) -> np.ndarray:
        if self.time_shift_type == "exponential":
            return math.exp(mu) / (math.exp(mu) + (1 / t - 1)**sigma)
        return mu / (mu + (1 / t - 1)**sigma)

    def stretch_shift_to_terminal(self, t: np.ndarray) -> np.ndarray:
        one_minus_z = 1 - t
        scale_factor = one_minus_z[-1] / (1 - self.shift_terminal)
        return 1 - (one_minus_z / scale_factor)

    def set_timesteps(self, num_inference_steps: int | None = None,
                      sigmas: np.ndarray | None = None,
                      mu: float | None = None,
                      timesteps: np.ndarray | None = None,
                      shift: float | None = None, **kwargs) -> None:
        """``shift`` overrides the configured shift for this schedule only
        (the DMD path passes 1.0)."""
        if self.use_dynamic_shifting and mu is None:
            raise ValueError("`mu` required with use_dynamic_shifting")
        eff_shift = self.shift if shift is None else float(shift)
        if num_inference_steps is None:
            num_inference_steps = (len(sigmas) if sigmas is not None else
                                   len(timesteps))
        self.num_inference_steps = num_inference_steps
        is_ts_provided = timesteps is not None
        if sigmas is None:
            if timesteps is None:
                t_max = self.sigma_max * self.num_train_timesteps
                t_min = self.sigma_min * self.num_train_timesteps
                timesteps = np.linspace(t_max, t_min, num_inference_steps)
            sigmas = np.asarray(timesteps) / self.num_train_timesteps
        else:
            sigmas = np.asarray(sigmas, dtype=np.float32)
        if self.use_dynamic_shifting:
            sigmas = self.time_shift(mu, 1.0, sigmas)
        else:
            sigmas = eff_shift * sigmas / (1 + (eff_shift - 1) * sigmas)
        if self.shift_terminal:
            sigmas = self.stretch_shift_to_terminal(sigmas)
        if self.use_karras_sigmas:
            # Karras et al. (2022): a rho = 7 ramp from sigma_max to sigma_min
            rho = 7.0
            ramp = np.linspace(0, 1, num_inference_steps)
            min_inv = self.sigma_min**(1 / rho)
            max_inv = self.sigma_max**(1 / rho)
            sigmas = (max_inv + ramp * (min_inv - max_inv))**rho
        sigmas = sigmas.astype(np.float32)
        if not is_ts_provided or self.use_karras_sigmas:
            timesteps = sigmas * self.num_train_timesteps
        self.timesteps = np.asarray(timesteps, dtype=np.float32)
        self.sigmas = np.concatenate([sigmas, [0.0]]).astype(np.float32)
        self._step_index = None
        self._begin_index = None

    def index_for_timestep(self, timestep) -> int:
        indices = np.nonzero(self.timesteps == float(timestep))[0]
        pos = 1 if len(indices) > 1 else 0
        return int(indices[pos])

    def step(self, model_output: torch.Tensor, timestep, sample: torch.Tensor,
             per_token_timesteps: torch.Tensor | None = None,
             noise: torch.Tensor | None = None, **kwargs) -> SchedulerOutput:
        if self._step_index is None:
            if self._begin_index is not None:
                self._step_index = self._begin_index
            else:
                self._step_index = self.index_for_timestep(timestep)
        orig_dtype = sample.dtype
        sample = sample.float()
        model_output = model_output.float()

        if per_token_timesteps is not None:
            per_token_sigmas = (per_token_timesteps.float() /
                                self.num_train_timesteps)
            sig = torch.as_tensor(self.sigmas, device=sample.device)[:, None,
                                                                     None]
            lower_mask = sig < per_token_sigmas[None] - 1e-6
            lower_sigmas = (lower_mask * sig).amax(dim=0)
            current_sigma = per_token_sigmas[..., None]
            next_sigma = lower_sigmas[..., None]
            dt = current_sigma - next_sigma
        else:
            current_sigma = float(self.sigmas[self._step_index])
            next_sigma = float(self.sigmas[self._step_index + 1])
            dt = next_sigma - current_sigma

        if self.stochastic_sampling:
            if noise is None:
                raise ValueError("stochastic_sampling requires noise")
            x0 = sample - current_sigma * model_output
            prev_sample = (1.0 - next_sigma) * x0 + next_sigma * noise
        else:
            prev_sample = sample + dt * model_output

        self._step_index += 1
        if per_token_timesteps is None:
            prev_sample = prev_sample.to(orig_dtype)
        return SchedulerOutput(prev_sample=prev_sample)

    def add_noise(self, original_samples: torch.Tensor, noise: torch.Tensor,
                  timesteps) -> torch.Tensor:
        sigmas = torch.as_tensor(timesteps, dtype=torch.float32,
                                 device=original_samples.device) / \
            self.num_train_timesteps
        while sigmas.ndim < original_samples.ndim:
            sigmas = sigmas[..., None]
        return (1.0 - sigmas) * original_samples + sigmas * noise

    def scale_noise(self, sample: torch.Tensor, timestep,
                    noise: torch.Tensor) -> torch.Tensor:
        """The forward process in sigma space (diffusers' scale_noise)."""
        sigma = float(self.sigmas[self.index_for_timestep(timestep)])
        return sigma * noise + (1.0 - sigma) * sample


EntryClass = FlowMatchEulerDiscreteScheduler
