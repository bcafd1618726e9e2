"""AnyFlow pretrain: flow-map central-difference training, stage 1 (port of
fastvideo_tpu/training/methods/anyflow_pretrain.py).

One student ``u(x_t, t, r)`` (the Wan DiT with its dual-timestep
``r_embedder``) learns the average velocity from t back to r with the
central-difference target

    target = (eps - x0) - ((t - r) / T) dF/dt,
    dF/dt ~= [u(x_{t+d}, t+d, r) - u(x_{t-d}, t-d, r)] / (2 d),

both finite-difference forwards under ``torch.no_grad`` (JAX's
``stop_gradient``), the sample moved along the true flow by the same step.
(t, r) is the max and min of two uniforms; by index the first
``int(diffusion_ratio B)`` samples take r = t (diffusion) and the next
``int(consistency_ratio B)`` r = 0 (consistency), the rest keep theirs
(free). Both times are shifted, each sample's loss is weighted by its
timestep, and the non-diffusion samples are rescaled (stop-grad) onto the
diffusion branch's mean. The draws (two uniforms a sample, then the noise)
come from the trainer's CPU generator in :meth:`draw`.
"""

from __future__ import annotations

import os

import torch

from fastvideo_tpu_torch.models.dits.wan import init_delta_from_time
from fastvideo_tpu_torch.models.loader.safetensors_io import (
    find_safetensors_files, tensor_names)
from fastvideo_tpu_torch.training.methods.base import (PipelineMethod,
                                                       register_method)
from fastvideo_tpu_torch.training.run_config import (ModelSpec,
                                                     TrainRunConfig,
                                                     build_training_args,
                                                     build_transformer)
from fastvideo_tpu_torch.training.training_pipeline import (TrainingPipeline,
                                                            resolve_device)


def r_embedder_overrides(mc: dict) -> dict:
    """The arch overrides that grow the dual-timestep branch, from a
    ``method_config``."""
    return {
        "r_embedder": True,
        "r_embedder_fusion": mc.get("r_embedder_fusion", "additive"),
        "r_embedder_gate_value": float(mc.get("r_embedder_gate_value",
                                              0.25)),
        "r_embedder_deltatime_type": mc.get("r_embedder_deltatime_type",
                                            "r"),
    }


def checkpoint_has_delta(spec: ModelSpec) -> bool:
    """Whether the checkpoint's transformer holds delta_embedder weights."""
    tdir = os.path.join(spec.pretrained_model_path, "transformer")
    return any("delta_embedder" in k for p in find_safetensors_files(tdir)
               for k in tensor_names(p))


def build_flow_map_transformer(spec: ModelSpec, device, mc: dict):
    """The DiT with the branch grown; without delta weights in the
    checkpoint, ``delta_embedder`` starts as a copy of ``time_embedder``."""
    model = build_transformer(spec, device=device,
                              arch_overrides=r_embedder_overrides(mc))
    if not checkpoint_has_delta(spec):
        init_delta_from_time(model)
    return model


class AnyFlowPretrainPipeline(TrainingPipeline):
    """Flow-map central-difference SFT."""

    def __init__(self, transformer, scheduler, training_args, *,
                 diffusion_ratio: float = 0.5,
                 consistency_ratio: float = 0.25,
                 fd_epsilon: float = 5.0, weight_type: str = "beta08"):
        if diffusion_ratio < 0 or consistency_ratio < 0:
            raise ValueError("ratios must be non-negative")
        if diffusion_ratio + consistency_ratio > 1.0:
            raise ValueError(
                "diffusion_ratio + consistency_ratio must be <= 1, got "
                f"{diffusion_ratio} + {consistency_ratio}")
        if fd_epsilon <= 0:
            raise ValueError("fd_epsilon must be positive")
        if weight_type not in ("uniform", "gaussian", "beta08"):
            raise ValueError(f"unknown weight_type {weight_type!r}")
        if transformer.condition_embedder.delta_embedder is None:
            raise ValueError(
                "anyflow_pretrain needs a transformer built with "
                "r_embedder=True (arch_overrides)")
        self.diffusion_ratio = float(diffusion_ratio)
        self.consistency_ratio = float(consistency_ratio)
        self.fd_epsilon = float(fd_epsilon)
        self.weight_type = weight_type
        super().__init__(transformer, scheduler, training_args)

    def draw(self, latents_shape: tuple[int, ...]
             ) -> tuple[torch.Tensor, torch.Tensor]:
        """u [2, B] uniforms in [0, 1) for (t, r), then fp32 noise of the
        latents' shape."""
        u = torch.rand((2, latents_shape[0]), generator=self.generator,
                       dtype=torch.float32)
        noise = torch.randn(latents_shape, generator=self.generator,
                            dtype=torch.float32)
        return u, noise

    def loss(self, latents: torch.Tensor, embeds: torch.Tensor,
             u: torch.Tensor, noise: torch.Tensor) -> torch.Tensor:
        sched = self.scheduler
        n_train = float(sched.num_train_timesteps)
        delta = self.fd_epsilon
        dev = latents.device
        b = latents.shape[0]
        u = u.to(dev)
        t_norm = torch.maximum(u[0], u[1])
        r_norm = torch.minimum(u[0], u[1])
        n_diff = int(self.diffusion_ratio * b)
        n_cons = int(self.consistency_ratio * b)
        idx = torch.arange(b, device=dev)
        is_diff = idx < n_diff
        is_cons = (idx >= n_diff) & (idx < n_diff + n_cons)
        r_norm = torch.where(is_diff, t_norm, r_norm)
        r_norm = torch.where(is_cons, torch.zeros_like(r_norm), r_norm)
        t = sched.apply_shift(t_norm).float() * n_train
        r = sched.apply_shift(r_norm).float() * n_train

        noise = noise.to(dev)
        noisy = sched.add_noise(latents, noise, t)
        embeds_b = embeds.to(torch.bfloat16)

        def fwd(x, tt):
            return self.transformer(x.to(torch.bfloat16), embeds_b, tt,
                                    r_timestep=r).float()

        pred = fwd(noisy, t)
        v_true = (noise - latents).float()
        dx = delta / n_train
        with torch.no_grad():
            f_plus = fwd(noisy + v_true * dx, t + delta)
            f_minus = fwd(noisy - v_true * dx, t - delta)
        df_dt = (f_plus - f_minus) / (2.0 * delta)
        view = (b,) + (1,) * (latents.ndim - 1)
        target = v_true - (t - r).reshape(view) * df_dt

        per_sample = torch.mean(torch.square(pred - target).reshape(b, -1),
                                dim=-1)
        per_sample = per_sample * sched.get_train_weight(
            t, weight_type=self.weight_type)
        ps_sg = per_sample.detach()
        n_d = torch.clamp(is_diff.sum(), min=1)
        diff_mean = torch.where(
            is_diff.any(), torch.where(is_diff, ps_sg, 0.0).sum() / n_d,
            ps_sg.mean())
        scale = diff_mean / (ps_sg + 1e-5)
        per_sample = torch.where(is_diff, per_sample, per_sample * scale)
        return per_sample.mean()


@register_method
class AnyFlowPretrainMethod(PipelineMethod):
    """AnyFlow stage-1 pretrain.

    ``method_config`` keys: ``diffusion_ratio`` (0.5), ``consistency_ratio``
    (0.25), ``epsilon`` (5.0), ``weight_type`` (beta08), ``shift`` (when
    ``model.flow_shift`` is unset) and the ``r_embedder_*`` fields."""

    name = "anyflow_pretrain"

    @classmethod
    def from_config(cls, cfg: TrainRunConfig) -> "AnyFlowPretrainMethod":
        from fastvideo_tpu_torch.models.schedulers import (
            scheduling_flow_map_euler as flow_map)

        targs = build_training_args(cfg)
        mc = cfg.method_config
        shift = float(cfg.model.flow_shift or mc.get("shift", 1.0))
        transformer = build_flow_map_transformer(
            cfg.model, resolve_device(targs), mc)
        return cls(AnyFlowPretrainPipeline(
            transformer, flow_map.FlowMapEulerDiscreteScheduler(shift=shift),
            targs,
            diffusion_ratio=float(mc.get("diffusion_ratio", 0.5)),
            consistency_ratio=float(mc.get("consistency_ratio", 0.25)),
            fd_epsilon=float(mc.get("epsilon", 5.0)),
            weight_type=str(mc.get("weight_type", "beta08")).lower()))
