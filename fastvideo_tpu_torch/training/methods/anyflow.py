"""AnyFlow on-policy distillation: stage-2 DMD over a flow-map rollout (port
of fastvideo_tpu/training/methods/anyflow.py).

The student is rolled out for ``student_sample_steps`` Euler-flow steps
from pure noise (mean-velocity sampling: r = t_next when the generator has
the dual-timestep branch); exactly one step, drawn from [0, n), carries the
gradient, and the others run under ``torch.no_grad`` (JAX's
``stop_gradient``, with the same values and no saved activations). The DMD
loss with the fake score and the alternating student / critic updates are
DMD2's. No forward context is set, as in DMD2: VSA runs at sparsity 0.

An update's draws come from the pipeline's CPU generator: the grad step,
then DMD2's timestep integer and target noise.
"""

from __future__ import annotations

import dataclasses

import torch

from fastvideo_tpu_torch.models.dits.wan import init_delta_from_time
from fastvideo_tpu_torch.training.distillation_pipeline import (
    DMD2DistillationPipeline, UpdateDraws)
from fastvideo_tpu_torch.training.methods.anyflow_pretrain import (
    checkpoint_has_delta, r_embedder_overrides)
from fastvideo_tpu_torch.training.methods.base import (PipelineMethod,
                                                       register_method)
from fastvideo_tpu_torch.training.methods.distribution_matching import (
    _dmd_config)
from fastvideo_tpu_torch.training.run_config import (TrainRunConfig,
                                                     build_training_args,
                                                     build_transformer)
from fastvideo_tpu_torch.training.training_pipeline import resolve_device


@dataclasses.dataclass
class FlowMapDraws(UpdateDraws):
    """An AnyFlow update's draws: no rollout noise, the grad step."""
    grad_step: int = 0


class AnyFlowDistillationPipeline(DMD2DistillationPipeline):
    """DMD2 with a multi-step on-policy Euler-flow rollout."""

    label = "anyflow"

    def __init__(self, *args, student_sample_steps: int = 4,
                 t_list_override: list[float] | None = None, **kwargs):
        generator = args[0] if args else kwargs.get("generator")
        self._has_r = bool(generator is not None and getattr(
            generator.config, "r_embedder", False))
        self.student_sample_steps = int(student_sample_steps)
        if self.student_sample_steps <= 0:
            raise ValueError("student_sample_steps must be positive")
        self.t_list_override = None
        if t_list_override is not None:
            t_list = [float(x) for x in t_list_override]
            if any(a < b for a, b in zip(t_list, t_list[1:])):
                raise ValueError("t_list_override must be descending")
            self.t_list_override = t_list
        super().__init__(*args, **kwargs)

    def _rollout_schedule(self) -> list[float]:
        """The descending t schedule, steps + 1 boundaries (a 0 appended to
        ``dmd_denoising_steps`` when they do not end at 0)."""
        if self.t_list_override is not None:
            return list(self.t_list_override)
        steps = [float(t) for t in self.dmd.dmd_denoising_steps]
        if steps[-1] != 0.0:
            steps = steps + [0.0]
        return steps

    def _update_draws(self, shape: tuple[int, ...]) -> FlowMapDraws:
        g = self.rng
        n = len(self._rollout_schedule()) - 1
        grad_step = int(torch.randint(0, n, (1,), generator=g))
        t_int = int(torch.randint(0, self.dmd.num_train_timestep, (1,),
                                  generator=g))
        noise = torch.randn(shape, generator=g, dtype=torch.float32)
        return FlowMapDraws([], t_int, noise, grad_step)

    def _update_rollout(self, noise: torch.Tensor, embeds: torch.Tensor,
                        draws: FlowMapDraws) -> torch.Tensor:
        """The Euler-flow rollout x <- x - ((t - t_next) / T) u; where grad
        is on, it flows through step ``draws.grad_step`` alone."""
        t_list = self._rollout_schedule()
        num_train = self.dmd.num_train_timestep
        b = noise.shape[0]
        grad = torch.is_grad_enabled()
        x = noise.float()
        e = embeds.to(torch.bfloat16)
        for i in range(len(t_list) - 1):
            t, t_next = float(t_list[i]), float(t_list[i + 1])
            kw = ({"r_timestep": self._full_t(t_next, b)} if self._has_r
                  else {})
            with torch.set_grad_enabled(grad and i == draws.grad_step):
                v = self.generator(x.to(torch.bfloat16), e,
                                   self._full_t(t, b), **kw).float()
            x = x - (t - t_next) / num_train * v
        return x


@register_method
class AnyFlowMethod(PipelineMethod):
    """AnyFlow on-policy distillation (a multi-step flow-map rollout).

    ``method_config`` keys: ``student_sample_steps`` (4),
    ``t_list_override``, ``use_mean_velocity`` (true: the branch is grown
    on all three roles; the scores never get r) and the ``r_embedder_*``
    fields; the ``dmd`` section as DMD2's."""

    name = "anyflow"

    @classmethod
    def from_config(cls, cfg: TrainRunConfig) -> "AnyFlowMethod":
        targs = build_training_args(cfg)
        device = resolve_device(targs)
        mc = cfg.method_config
        overrides = (r_embedder_overrides(mc)
                     if bool(mc.get("use_mean_velocity", True)) else None)
        roles = [build_transformer(cfg.model, device=device,
                                   arch_overrides=overrides)
                 for _ in range(3)]
        if overrides is not None and not checkpoint_has_delta(cfg.model):
            for model in roles:
                init_delta_from_time(model)
        return cls(AnyFlowDistillationPipeline(
            *roles, targs, _dmd_config(cfg),
            student_sample_steps=int(mc.get("student_sample_steps", 4)),
            t_list_override=mc.get("t_list_override")))
