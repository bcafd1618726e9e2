"""Causal consistency distillation (port of
fastvideo_tpu/training/methods/causal_cd.py).

A student is distilled against a frozen CFG teacher on the discrete
N-point sigma grid of a ``SelfForcingFlowMatchScheduler`` built with
``extra_one_step=True``: at a grid index drawn from [0, N - 1), the
teacher's guided flow takes one Euler step ``x_{t+1} = x_t - dt v_cfg``,
and the student's x0 at t is matched to the x0 of a frozen EMA model at
t_next. The EMA starts as a copy of the student and tracks it with
``ema_decay`` from ``ema_start_step`` on. There is no gradient clipping.
Every forward is the model's full forward (``model(x, embeds, t)``, the
self-attention of the selected backend: K1 and K6 under FLASH_ATTN), in
bf16 on fp32 master weights; ``selective_checkpointing="full"`` (or "ops")
runs the student's blocks under ``torch.utils.checkpoint``.

The draws (the grid index, then the noise) come from the pipeline's CPU
``torch.Generator`` in :meth:`CausalCDPipeline.draw` alone, so a test can
hand the port JAX's draws.
"""

from __future__ import annotations

import copy
import dataclasses
import logging
import os
import time
from typing import Any

import numpy as np
import torch

from fastvideo_tpu_torch.fastvideo_args import TrainingArgs
from fastvideo_tpu_torch.models.schedulers.scheduling_self_forcing_flow_match import (  # noqa: E501
    SelfForcingFlowMatchScheduler)
from fastvideo_tpu_torch.training.methods.base import (PipelineMethod,
                                                       register_method)
from fastvideo_tpu_torch.training.run_config import (TrainRunConfig,
                                                     build_training_args,
                                                     build_transformer)
from fastvideo_tpu_torch.training.trackers import initialize_trackers
from fastvideo_tpu_torch.training.training_pipeline import (
    build_lr_schedule, build_optimizer, resolve_device)
from fastvideo_tpu_torch.training.training_utils import (
    global_grad_norm, set_activation_checkpointing)

logger = logging.getLogger(__name__)


class CausalCDPipeline:
    """Student / teacher / EMA consistency distillation over a sigma
    grid."""

    def __init__(self, student: torch.nn.Module, teacher: torch.nn.Module,
                 training_args: TrainingArgs, discrete_cd_n: int = 48,
                 guidance_scale: float = 3.0, ema_decay: float = 0.99,
                 ema_start_step: int = 200, flow_shift: float = 5.0):
        if discrete_cd_n < 2:
            raise ValueError("discrete_cd_N must be >= 2")
        args = training_args
        self.args = args
        self.device = resolve_device(args)
        self.student = student.to(self.device).train()
        set_activation_checkpointing(self.student,
                                     args.selective_checkpointing)
        self.teacher = teacher.to(self.device).eval()
        self.teacher.requires_grad_(False)
        # the EMA starts from the student
        self.ema = copy.deepcopy(self.student).eval()
        self.ema.requires_grad_(False)
        self.ema.gradient_checkpointing = False
        self.params = [p for p in self.student.parameters()
                       if p.requires_grad]
        if not self.params:
            raise ValueError("the student has no trainable parameter (load "
                             "it with trainable=True)")
        self.guidance_scale = float(guidance_scale)
        self.ema_decay = float(ema_decay)
        self.ema_start_step = int(ema_start_step)
        self.num_train = 1000.0
        sched = SelfForcingFlowMatchScheduler(
            num_inference_steps=int(discrete_cd_n),
            num_train_timesteps=1000, shift=float(flow_shift),
            sigma_min=0.0, sigma_max=1.0, extra_one_step=True,
            training=False)
        self.sigmas = sched.sigmas
        self.timesteps = sched.timesteps
        self.n = int(discrete_cd_n)
        self.optimizer = build_optimizer(self.params, args)
        self.lr_schedule = build_lr_schedule(args)
        self.rng = torch.Generator("cpu").manual_seed(int(args.seed))
        self.step = 0
        names = list(args.trackers or ())
        if not names and args.tracker_project_name:
            names = ["jsonl"]
        self.tracker = initialize_trackers(
            names, args.tracker_project_name or "fastvideo_tpu_torch",
            config=dataclasses.asdict(args),
            log_dir=os.path.join(args.output_dir or ".", "tracker"),
            run_name=args.wandb_run_name)

    def draw(self, shape: tuple[int, ...]) -> dict[str, Any]:
        """A step's draws: the grid index in [0, N - 1), then the noise."""
        idx = int(torch.randint(0, self.n - 1, (1,), generator=self.rng))
        noise = torch.randn(shape, generator=self.rng, dtype=torch.float32)
        return {"idx": idx, "noise": noise}

    def _flow(self, model: torch.nn.Module, x: torch.Tensor,
              embeds: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
        return model(x.to(torch.bfloat16), embeds.to(torch.bfloat16),
                     t).float()

    def loss(self, clean: torch.Tensor, embeds: torch.Tensor,
             null_embeds: torch.Tensor, draws: dict) -> torch.Tensor:
        """The consistency loss ``mean (x0_t - x0_{t_next})^2``, with
        autograd through the student alone."""
        idx = draws["idx"]
        t, t_next = self.timesteps[idx], self.timesteps[idx + 1]
        sigma_t, sigma_next = (float(self.sigmas[idx]),
                               float(self.sigmas[idx + 1]))
        # in fp32, as JAX computes it
        dt = float(np.float32(t - t_next) / np.float32(self.num_train))
        b = clean.shape[0]
        t_arr = torch.full((b,), float(t), dtype=torch.float32,
                           device=self.device)
        t_next_arr = torch.full((b,), float(t_next), dtype=torch.float32,
                                device=self.device)
        noise = draws["noise"].to(self.device)
        latent_t = (1.0 - sigma_t) * clean + sigma_t * noise
        with torch.no_grad():
            # the teacher's CFG Euler step
            v_cond = self._flow(self.teacher, latent_t, embeds, t_arr)
            v_uncond = self._flow(self.teacher, latent_t, null_embeds, t_arr)
            v_pred = v_uncond + self.guidance_scale * (v_cond - v_uncond)
            del v_cond, v_uncond
            latent_next = latent_t - dt * v_pred
            del v_pred
        x0_t = latent_t - sigma_t * self._flow(self.student, latent_t,
                                               embeds, t_arr)
        with torch.no_grad():
            x0_next = latent_next - sigma_next * self._flow(
                self.ema, latent_next, embeds, t_next_arr)
        return torch.mean(torch.square(x0_t - x0_next))

    def train_one_step(self, latents, embeds) -> dict[str, Any]:
        """latents [accum, B, C, T, H, W], embeds [accum, B, L, D] (numpy
        or tensors); the accumulation axis folds into the batch."""
        lat = torch.as_tensor(latents, dtype=torch.float32).to(self.device)
        lat = lat.reshape(-1, *lat.shape[2:])
        emb = torch.as_tensor(embeds, dtype=torch.float32).to(self.device)
        emb = emb.reshape(-1, *emb.shape[2:])
        draws = self.draw(tuple(lat.shape))
        loss = self.loss(lat, emb, torch.zeros_like(emb), draws)
        loss.backward()
        norm = global_grad_norm([p.grad for p in self.params
                                 if p.grad is not None])
        lr = self.lr_schedule(self.step)
        for group in self.optimizer.param_groups:
            group["lr"] = lr
        self.optimizer.step()
        self.optimizer.zero_grad(set_to_none=True)
        if self.step >= self.ema_start_step:
            decay = self.ema_decay
            with torch.no_grad():
                for e, p in zip(self.ema.parameters(),
                                self.student.parameters()):
                    e.mul_(decay).add_(p.detach(), alpha=1.0 - decay)
        self.step += 1
        value = float(loss.detach())
        return {"loss": value, "causal_cd_loss": value,
                "grad_norm": float(norm), "grid_index": draws["idx"],
                "step": self.step}

    def train(self, dataloader, max_steps: int | None = None,
              log_every: int = 10, callbacks=None) -> None:
        """The loop over a (latents, embeds) dataloader; ``callbacks`` are
        dispatched at train start, after each step and at train end."""
        from fastvideo_tpu_torch.training.callbacks import normalize_callbacks

        callbacks = normalize_callbacks(callbacks)
        self._callbacks = callbacks
        max_steps = max_steps or self.args.max_train_steps
        if callbacks is not None:
            callbacks.dispatch("on_train_start", self, self.step)
        it = iter(dataloader)
        t0 = time.perf_counter()
        while self.step < max_steps:
            try:
                latents, embeds = next(it)
            except StopIteration:
                it = iter(dataloader)
                latents, embeds = next(it)
            metrics = self.train_one_step(latents, embeds)
            self.tracker.log(metrics, self.step)
            if callbacks is not None:
                callbacks.dispatch("on_training_step_end", self, metrics,
                                   self.step)
            if self.step % log_every == 0:
                dt = time.perf_counter() - t0
                logger.info("causal_cd step %d loss %.4f (%.2fs/it)",
                            self.step, metrics["loss"], dt / log_every)
                t0 = time.perf_counter()
        if callbacks is not None:
            callbacks.dispatch("on_train_end", self, self.step)


@register_method
class CausalCDMethod(PipelineMethod):
    """Causal consistency distillation (student / teacher / EMA).

    ``method_config`` keys: ``discrete_cd_N`` (48), ``guidance_scale``
    (3.0), ``ema_decay`` (0.99), ``ema_start_step`` (200), ``flow_shift``
    (5.0)."""

    name = "causal_cd"

    @classmethod
    def from_config(cls, cfg: TrainRunConfig) -> "CausalCDMethod":
        targs = build_training_args(cfg)
        device = resolve_device(targs)
        student, teacher = (build_transformer(cfg.model, device=device)
                            for _ in range(2))
        mcfg = cfg.method_config
        return cls(CausalCDPipeline(
            student, teacher, targs,
            discrete_cd_n=int(mcfg.get("discrete_cd_N", 48)),
            guidance_scale=float(mcfg.get("guidance_scale", 3.0)),
            ema_decay=float(mcfg.get("ema_decay", 0.99)),
            ema_start_step=int(mcfg.get("ema_start_step", 200)),
            flow_shift=float(mcfg.get("flow_shift", 5.0))))
