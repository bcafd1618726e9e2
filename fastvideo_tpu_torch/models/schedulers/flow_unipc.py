"""Flow-matching UniPC scheduler (port of
fastvideo_tpu/models/schedulers/flow_unipc.py), the part the DMD sampler
uses: the shifted flow sigmas, ``set_shift``, ``set_timesteps`` (also with
explicit sigmas) and ``timesteps``. The multistep predictor-corrector
``step`` of the 50-step sampler is not ported yet.
"""

from __future__ import annotations

import numpy as np

from fastvideo_tpu_torch.models.schedulers.base import BaseScheduler


class FlowUniPCMultistepScheduler(BaseScheduler):

    def __init__(self, num_train_timesteps: int = 1000, solver_order: int = 2,
                 shift: float = 1.0, use_dynamic_shifting: bool = False,
                 final_sigmas_type: str = "zero", **kwargs):
        del kwargs
        self.num_train_timesteps = num_train_timesteps
        self.solver_order = solver_order
        self.shift = shift
        self.use_dynamic_shifting = use_dynamic_shifting
        self.final_sigmas_type = final_sigmas_type
        alphas = np.linspace(1, 1 / num_train_timesteps,
                             num_train_timesteps)[::-1].copy()
        sigmas = (1.0 - alphas).astype(np.float32)
        if not use_dynamic_shifting:
            sigmas = shift * sigmas / (1 + (shift - 1) * sigmas)
        self.sigmas = sigmas
        self.timesteps = sigmas * num_train_timesteps
        self.sigma_min = float(sigmas[-1])
        self.sigma_max = float(sigmas[0])
        self.num_inference_steps: int | None = None

    def set_shift(self, shift: float) -> None:
        self.shift = shift

    def set_timesteps(self, num_inference_steps: int | None = None,
                      sigmas: np.ndarray | None = None,
                      shift: float | None = None, **kwargs) -> None:
        if self.use_dynamic_shifting:
            raise NotImplementedError("dynamic shifting is not ported")
        if sigmas is None:
            if num_inference_steps is None:
                raise ValueError("set_timesteps needs steps or sigmas")
            sigmas = np.linspace(self.sigma_max, self.sigma_min,
                                 num_inference_steps + 1)[:-1]
        shift = self.shift if shift is None else shift
        sigmas = shift * sigmas / (1 + (shift - 1) * sigmas)
        if self.final_sigmas_type == "zero":
            sigma_last = 0.0
        elif self.final_sigmas_type == "sigma_min":
            sigma_last = self.sigma_min
        else:
            raise ValueError(self.final_sigmas_type)
        self.timesteps = (np.asarray(sigmas) *
                          self.num_train_timesteps).astype(np.int64)
        self.sigmas = np.concatenate([sigmas, [sigma_last]]).astype(
            np.float32)
        self.num_inference_steps = len(self.timesteps)

    def step(self, model_output, timestep, sample, **kwargs):
        raise NotImplementedError(
            "FlowUniPC multistep step is not ported yet: the port runs the "
            "DMD sampler, which needs only the timesteps")
