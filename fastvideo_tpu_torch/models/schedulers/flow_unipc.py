"""Flow-matching UniPC multistep scheduler, predictor-corrector (port of
fastvideo_tpu/models/schedulers/flow_unipc.py), the Wan sampler: flow sigmas
``linspace(sigma_max, sigma_min)`` with the ``shift*s/(1+(shift-1)s)`` warp,
x0-prediction, B(h) solver (bh2), corrector applied from the second step,
lower-order warm-up and final step. The scalar solver coefficients are
computed on the host; the latent updates are tensor expressions on the
sample's device and in its dtype (the denoising stage passes fp32). The
multistep state (model-output history, last sample, step index) lives on the
scheduler object and is reset by ``set_timesteps``.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from fastvideo_tpu_torch.models.schedulers.base import (BaseScheduler,
                                                        SchedulerOutput)

Array = torch.Tensor


class FlowUniPCMultistepScheduler(BaseScheduler):

    def __init__(self, num_train_timesteps: int = 1000, solver_order: int = 2,
                 shift: float = 1.0, use_dynamic_shifting: bool = False,
                 predict_x0: bool = True, solver_type: str = "bh2",
                 lower_order_final: bool = True,
                 disable_corrector: tuple = (),
                 final_sigmas_type: str = "zero", **kwargs):
        if solver_type in ("midpoint", "heun", "logrho"):
            solver_type = "bh2"
        if solver_type not in ("bh1", "bh2"):
            raise ValueError(f"unknown solver_type {solver_type!r}")
        self.num_train_timesteps = num_train_timesteps
        self.solver_order = solver_order
        self.shift = shift
        self.use_dynamic_shifting = use_dynamic_shifting
        self.predict_x0 = predict_x0
        self.solver_type = solver_type
        self.lower_order_final = lower_order_final
        self.disable_corrector = list(disable_corrector)
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
        self._reset_state()

    def _reset_state(self) -> None:
        self.model_outputs: list[Array | None] = [None] * self.solver_order
        self.timestep_list: list = [None] * self.solver_order
        self.lower_order_nums = 0
        self.last_sample: Array | None = None
        self._step_index: int | None = None

    @property
    def step_index(self) -> int | None:
        return self._step_index

    def set_shift(self, shift: float) -> None:
        self.shift = shift

    def time_shift(self, mu: float, sigma: float, t: np.ndarray) -> np.ndarray:
        return math.exp(mu) / (math.exp(mu) + (1 / t - 1)**sigma)

    def set_timesteps(self, num_inference_steps: int | None = None,
                      sigmas: np.ndarray | None = None,
                      mu: float | None = None, shift: float | None = None,
                      **kwargs) -> None:
        if self.use_dynamic_shifting and mu is None:
            raise ValueError("`mu` required with use_dynamic_shifting")
        if sigmas is None:
            if num_inference_steps is None:
                raise ValueError("set_timesteps needs steps or sigmas")
            sigmas = np.linspace(self.sigma_max, self.sigma_min,
                                 num_inference_steps + 1)[:-1]
        if self.use_dynamic_shifting:
            sigmas = self.time_shift(mu, 1.0, sigmas)
        else:
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
        self._reset_state()

    # -- internals ---------------------------------------------------------

    @staticmethod
    def _alpha_sigma(sigma: float) -> tuple[float, float]:
        return 1.0 - sigma, sigma

    @staticmethod
    def _lam(sigma: float) -> float:
        eps = 1e-12
        a, s = max(1.0 - sigma, eps), max(sigma, eps)
        return math.log(a) - math.log(s)

    def convert_model_output(self, model_output: Array,
                             sample: Array) -> Array:
        sigma_t = float(self.sigmas[self._step_index])
        if self.predict_x0:
            return sample - sigma_t * model_output
        return sample - (1 - sigma_t) * model_output

    def _bh_coeffs(self, h: float, rks: list[float], order: int):
        hh = -h if self.predict_x0 else h
        h_phi_1 = math.expm1(hh)
        h_phi_k = h_phi_1 / hh - 1
        B_h = hh if self.solver_type == "bh1" else math.expm1(hh)
        R, b = [], []
        factorial_i = 1
        rks_arr = np.asarray(rks, dtype=np.float64)
        for i in range(1, order + 1):
            R.append(np.power(rks_arr, i - 1))
            b.append(h_phi_k * factorial_i / B_h)
            factorial_i *= i + 1
            h_phi_k = h_phi_k / hh - 1 / factorial_i
        return np.stack(R), np.asarray(b), h_phi_1, B_h

    def multistep_uni_p_bh_update(self, sample: Array, order: int) -> Array:
        m0 = self.model_outputs[-1]
        x = sample
        sigma_t = float(self.sigmas[self._step_index + 1])
        sigma_s0 = float(self.sigmas[self._step_index])
        alpha_t, sigma_t = self._alpha_sigma(sigma_t)
        alpha_s0, sigma_s0 = self._alpha_sigma(sigma_s0)
        h = self._lam(sigma_t) - self._lam(sigma_s0)

        rks, D1s = [], []
        for i in range(1, order):
            si = self._step_index - i
            mi = self.model_outputs[-(i + 1)]
            rk = (self._lam(float(self.sigmas[si])) -
                  self._lam(sigma_s0)) / h
            rks.append(rk)
            D1s.append((mi - m0) / rk)
        rks.append(1.0)
        R, b, h_phi_1, B_h = self._bh_coeffs(h, rks, order)

        if D1s:
            if order == 2:
                rhos_p = np.asarray([0.5])
            else:
                rhos_p = np.linalg.solve(R[:-1, :-1], b[:-1])
            pred_res = sum(
                float(r) * d for r, d in zip(rhos_p, D1s, strict=True))
        else:
            pred_res = 0.0

        if self.predict_x0:
            x_t = (sigma_t / sigma_s0 * x - alpha_t * h_phi_1 * m0 -
                   alpha_t * B_h * pred_res)
        else:
            x_t = (alpha_t / alpha_s0 * x - sigma_t * h_phi_1 * m0 -
                   sigma_t * B_h * pred_res)
        return x_t.to(x.dtype)

    def multistep_uni_c_bh_update(self, this_model_output: Array,
                                  last_sample: Array, this_sample: Array,
                                  order: int) -> Array:
        m0 = self.model_outputs[-1]
        x = last_sample
        model_t = this_model_output
        sigma_t = float(self.sigmas[self._step_index])
        sigma_s0 = float(self.sigmas[self._step_index - 1])
        alpha_t, sigma_t = self._alpha_sigma(sigma_t)
        alpha_s0, sigma_s0 = self._alpha_sigma(sigma_s0)
        h = self._lam(sigma_t) - self._lam(sigma_s0)

        rks, D1s = [], []
        for i in range(1, order):
            si = self._step_index - (i + 1)
            mi = self.model_outputs[-(i + 1)]
            rk = (self._lam(float(self.sigmas[si])) -
                  self._lam(sigma_s0)) / h
            rks.append(rk)
            D1s.append((mi - m0) / rk)
        rks.append(1.0)
        R, b, h_phi_1, B_h = self._bh_coeffs(h, rks, order)

        if order == 1:
            rhos_c = np.asarray([0.5])
        else:
            rhos_c = np.linalg.solve(R, b)
        corr_res = (sum(
            float(r) * d
            for r, d in zip(rhos_c[:-1], D1s, strict=True)) if D1s else 0.0)
        D1_t = model_t - m0
        if self.predict_x0:
            x_t = (sigma_t / sigma_s0 * x - alpha_t * h_phi_1 * m0 -
                   alpha_t * B_h * (corr_res + float(rhos_c[-1]) * D1_t))
        else:
            x_t = (alpha_t / alpha_s0 * x - sigma_t * h_phi_1 * m0 -
                   sigma_t * B_h * (corr_res + float(rhos_c[-1]) * D1_t))
        return x_t.to(x.dtype)

    def index_for_timestep(self, timestep) -> int:
        indices = np.nonzero(self.timesteps == int(timestep))[0]
        pos = 1 if len(indices) > 1 else 0
        return int(indices[pos])

    def step(self, model_output: Array, timestep, sample: Array,
             **kwargs) -> SchedulerOutput:
        if self.num_inference_steps is None:
            raise ValueError("call set_timesteps first")
        if self._step_index is None:
            self._step_index = self.index_for_timestep(timestep)

        use_corrector = (self._step_index > 0 and
                         self._step_index - 1 not in self.disable_corrector
                         and self.last_sample is not None)
        model_output_convert = self.convert_model_output(model_output, sample)
        if use_corrector:
            sample = self.multistep_uni_c_bh_update(
                this_model_output=model_output_convert,
                last_sample=self.last_sample, this_sample=sample,
                order=self.this_order)

        self.model_outputs = self.model_outputs[1:] + [model_output_convert]
        self.timestep_list = self.timestep_list[1:] + [timestep]

        if self.lower_order_final:
            this_order = min(self.solver_order,
                             len(self.timesteps) - self._step_index)
        else:
            this_order = self.solver_order
        self.this_order = min(this_order, self.lower_order_nums + 1)

        self.last_sample = sample
        prev_sample = self.multistep_uni_p_bh_update(sample=sample,
                                                     order=self.this_order)
        if self.lower_order_nums < self.solver_order:
            self.lower_order_nums += 1
        self._step_index += 1
        return SchedulerOutput(prev_sample=prev_sample)

    def add_noise(self, original_samples: Array, noise: Array,
                  timesteps) -> Array:
        """x_t = (1 - sigma) x_0 + sigma n at the nearest scheduler timestep
        (``self.timesteps`` is descending, so an exact nearest lookup)."""
        sched_ts = np.asarray(self.timesteps, np.float32)
        ts = np.atleast_1d(np.asarray(timesteps, np.float32))
        idx = np.argmin(np.abs(sched_ts[None, :] - ts[:, None]), axis=1)
        sigmas = torch.as_tensor(np.asarray(self.sigmas, np.float32)[idx],
                                 device=original_samples.device)
        while sigmas.ndim < original_samples.ndim:
            sigmas = sigmas[..., None]
        return (1.0 - sigmas) * original_samples + sigmas * noise
