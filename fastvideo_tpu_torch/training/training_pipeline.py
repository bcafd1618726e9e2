"""Flow-matching SFT training of a DiT (port of
fastvideo_tpu/training/training_pipeline.py).

Each step samples timesteps by the configured density, mixes noise into the
clean latents, runs the DiT on the noisy latents in bf16 (the parameters
stay fp32 masters: the linears cast them to the input's dtype) and takes
the velocity MSE ``mean((pred - (noise - latents))^2)`` in fp32; then the
global gradient norm, JAX's clipping, the LR schedule and AdamW. Gradient
accumulation averages grads and loss over the micro-batches of a step.

Where JAX differs by construction:
  * random draws: JAX splits ``jax.random`` keys; the port draws from one
    CPU ``torch.Generator`` seeded from ``args.seed``, in :meth:`draw`
    alone, so a test can hand it JAX's draws. Same seed, other numbers.
  * the VSA metadata: JAX compiles one step per sparsity level; here the
    forward context carries ``VSA_sparsity`` into the attention layers.
    Under activation checkpointing the blocks' forwards run again in the
    backward, on autograd's own thread on CUDA: the model binds each
    checkpointed block to the forward's context, so the recompute picks
    the same tiles.
  * the LR schedule is a function of the update count before the update
    (optax evaluates it there): with warm-up the first step's LR is 0. Each
    param group's ``lr`` is set before ``optimizer.step()``.
  * AdamW: ``torch.optim.AdamW`` with eps 1e-8 and decoupled decay gives
    optax.adamw's update in exact arithmetic; the moments take the
    parameters' dtype, as optax's do.
"""

from __future__ import annotations

import dataclasses
import logging
import math
import os
import time
from typing import Any, Callable

import numpy as np
import torch

from fastvideo_tpu_torch.attention.backends.abstract import AttentionMetadata
from fastvideo_tpu_torch.fastvideo_args import TrainingArgs
from fastvideo_tpu_torch.forward_context import set_forward_context
from fastvideo_tpu_torch.training.checkpoint import CheckpointManager
from fastvideo_tpu_torch.training.trackers import initialize_trackers
from fastvideo_tpu_torch.training.training_utils import (
    clip_grad_norm, compute_density_for_timestep_sampling,
    set_activation_checkpointing)

logger = logging.getLogger(__name__)


def build_lr_schedule(args: TrainingArgs) -> Callable[[int], float]:
    """The LR as a function of the update count before the update, equal to
    the optax schedule the JAX trainer builds."""
    base = float(args.learning_rate)
    warmup = int(args.lr_warmup_steps)
    total = int(args.max_train_steps)

    def linear(init: float, end: float, steps: int):
        # optax.linear_schedule: held at init when steps <= 0
        if steps <= 0:
            return lambda count: init
        return lambda count: (init - end) * (
            1 - min(max(count, 0), steps) / steps) + end

    if args.lr_scheduler == "constant":
        return linear(0.0, base, warmup) if warmup else (lambda count: base)
    if args.lr_scheduler == "linear":
        return linear(base, 0.0, total)
    if args.lr_scheduler == "cosine":
        # optax.warmup_cosine_decay_schedule(0, base, warmup, total)
        decay = total - warmup
        if decay <= 0:
            raise ValueError("the cosine schedule needs max_train_steps > "
                             f"lr_warmup_steps, got {total} and {warmup}")
        ramp = linear(0.0, base, warmup)

        def cosine(count: int) -> float:
            if count < warmup:
                return ramp(count)
            c = min(count - warmup, decay)
            return base * 0.5 * (1 + math.cos(math.pi * c / decay))

        return cosine
    raise ValueError(f"unknown lr scheduler {args.lr_scheduler}")


def build_optimizer(params, args: TrainingArgs) -> torch.optim.AdamW:
    """AdamW as optax.adamw: eps 1e-8, eps_root 0, decoupled weight decay;
    the LR is set per step from :func:`build_lr_schedule`."""
    return torch.optim.AdamW(params, lr=float(args.learning_rate),
                             betas=tuple(args.betas), eps=1e-8,
                             weight_decay=float(args.weight_decay))


def resolve_device(args: TrainingArgs) -> torch.device:
    """The card unless the caller asks for the CPU."""
    return torch.device(args.device or "cuda")


class TrainingPipeline:
    """SFT on a DiT with the flow-matching velocity loss."""

    def __init__(self, transformer: torch.nn.Module, scheduler,
                 training_args: TrainingArgs):
        args = training_args
        self.args = args
        self.device = resolve_device(args)
        self.transformer = transformer.to(self.device).train()
        self.scheduler = scheduler
        set_activation_checkpointing(transformer,
                                     args.selective_checkpointing)
        self.params = [p for p in transformer.parameters() if p.requires_grad]
        if not self.params:
            raise ValueError("the transformer has no trainable parameter "
                             "(load it with trainable=True)")
        self.optimizer = build_optimizer(self.params, args)
        self.lr_schedule = build_lr_schedule(args)
        self.generator = torch.Generator("cpu").manual_seed(int(args.seed))
        self.step = 0
        self.sched_timesteps = torch.as_tensor(
            np.asarray(scheduler.timesteps), dtype=torch.float32)
        self.sched_sigmas = torch.as_tensor(np.asarray(scheduler.sigmas),
                                            dtype=torch.float32)
        self.checkpoint_manager = (CheckpointManager(args.output_dir)
                                   if args.output_dir else None)
        names = list(args.trackers or ())
        if not names and args.tracker_project_name:
            names = ["jsonl"]
        self.tracker = initialize_trackers(
            names, args.tracker_project_name or "fastvideo_tpu_torch",
            config=dataclasses.asdict(args),
            log_dir=os.path.join(args.output_dir or ".", "tracker"),
            run_name=args.wandb_run_name)

    # -- one step ----------------------------------------------------------

    def draw(self, latents_shape: tuple[int, ...]
             ) -> tuple[torch.Tensor, torch.Tensor]:
        """The step's random numbers for one micro-batch: u [B] in [0, 1)
        for the timesteps (by ``weighting_scheme``) and fp32 noise of the
        latents' shape, from the pipeline's CPU generator. :meth:`loss`
        takes them after the batch; a subclass that replaces the one
        replaces the other."""
        a = self.args
        u = compute_density_for_timestep_sampling(
            a.weighting_scheme, latents_shape[0], self.generator,
            a.logit_mean, a.logit_std, a.mode_scale)
        noise = torch.randn(latents_shape, generator=self.generator,
                            dtype=torch.float32)
        return u, noise

    def loss(self, latents: torch.Tensor, embeds: torch.Tensor,
             u: torch.Tensor, noise: torch.Tensor) -> torch.Tensor:
        """Velocity MSE of one micro-batch (JAX ``loss_fn``)."""
        n = self.sched_timesteps.shape[0]
        idx = torch.clamp((u * self.scheduler.num_train_timesteps).to(
            torch.int32), 0, n - 1).long()
        timesteps = self.sched_timesteps[idx].to(self.device)
        sig = self.sched_sigmas[idx].to(self.device).reshape(
            -1, *([1] * (latents.ndim - 1)))
        noise = noise.to(self.device)
        noisy = (1.0 - sig) * latents + sig * noise
        pred = self.transformer(noisy.to(torch.bfloat16),
                                embeds.to(torch.bfloat16), timesteps)
        target = noise - latents
        return torch.mean(torch.square(pred.float() - target.float()))

    def _context(self, vsa_sparsity: float | None):
        md = (None if vsa_sparsity is None else AttentionMetadata(
            extra={"VSA_sparsity": float(vsa_sparsity)}))
        return set_forward_context(attn_metadata=md)

    def train_one_step(self, latents, embeds,
                       vsa_sparsity: float | None = None) -> dict[str, Any]:
        """latents [accum, B, C, T, H, W]; embeds [accum, B, L, D] (numpy
        or tensors). ``vsa_sparsity``: this step's VSA sparsity (the ramp),
        None for no VSA metadata."""
        latents = torch.as_tensor(latents, dtype=torch.float32).to(
            self.device)
        embeds = torch.as_tensor(embeds, dtype=torch.float32).to(self.device)
        accum = latents.shape[0]
        total = torch.zeros((), dtype=torch.float32, device=self.device)
        for i in range(accum):
            draws = self.draw(tuple(latents[i].shape))
            with self._context(vsa_sparsity):
                loss = self.loss(latents[i], embeds[i], *draws)
            (loss / accum if accum > 1 else loss).backward()
            total += loss.detach() / accum
        grad_norm = clip_grad_norm(self.params, self.args.max_grad_norm)
        lr = self.lr_schedule(self.step)
        for group in self.optimizer.param_groups:
            group["lr"] = lr
        self.optimizer.step()
        self.optimizer.zero_grad(set_to_none=True)
        self.step += 1
        out = {"loss": float(total), "grad_norm": float(grad_norm),
               "step": self.step, "lr": lr}
        if vsa_sparsity is not None:
            out["vsa_sparsity"] = float(vsa_sparsity)
        return out

    def current_vsa_sparsity(self, step: int) -> float | None:
        """The VSA sparsity ramp: grows by ``VSA_decay_rate`` every
        ``VSA_decay_interval_steps`` until ``VSA_sparsity``. None: no VSA
        metadata (dense attention, other backends)."""
        target = float(self.args.VSA_sparsity or 0.0)
        if target <= 0.0:
            return None
        rate = float(self.args.VSA_decay_rate or 0.0)
        interval = int(self.args.VSA_decay_interval_steps or 0)
        if rate <= 0.0 or interval <= 0:
            return target
        decay_times = min(step // interval, target // rate)
        return round(decay_times * rate, 6)

    # -- the loop ------------------------------------------------------------

    def train(self, dataloader, max_steps: int | None = None,
              log_every: int = 10, validation_callback=None,
              callbacks=None) -> None:
        """``validation_callback(pipeline, step) -> dict | None`` runs every
        ``args.validation_steps`` steps; its metrics go to the tracker.
        ``callbacks`` (a ``CallbackDict`` or a raw ``{name: cfg}`` mapping,
        ``training/callbacks.py``) are dispatched at train start, before
        each step, after each step and at train end."""
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
            if callbacks is not None:
                callbacks.dispatch("on_before_optimizer_step", self,
                                   self.step)
            metrics = self.train_one_step(
                latents, embeds,
                vsa_sparsity=self.current_vsa_sparsity(self.step + 1))
            self.tracker.log(metrics, self.step)
            if callbacks is not None:
                callbacks.dispatch("on_training_step_end", self, metrics,
                                   self.step)
            if self.step % log_every == 0:
                dt = time.perf_counter() - t0
                logger.info("step %d loss %.4f grad_norm %.3f (%.2fs/it)",
                            metrics["step"], metrics["loss"],
                            metrics["grad_norm"], dt / log_every)
                t0 = time.perf_counter()
            if (validation_callback is not None
                    and self.args.validation_steps
                    and self.step % self.args.validation_steps == 0):
                val = validation_callback(self, self.step)
                if val:
                    self.tracker.log({f"validation/{k}": v
                                      for k, v in val.items()}, self.step)
            if (self.checkpoint_manager is not None
                    and self.args.checkpointing_steps
                    and self.step % self.args.checkpointing_steps == 0):
                self.save_checkpoint()
        if callbacks is not None:
            callbacks.dispatch("on_train_end", self, self.step)

    @torch.no_grad()
    def validation_sample(self, embeds, latent_shape: tuple[int, ...],
                          dmd_denoising_steps=(1000, 757, 522),
                          seed: int = 0) -> torch.Tensor:
        """Few-step sampling with the current parameters; returns fp32
        latents. Noise per seed as the inference path draws it."""
        from fastvideo_tpu_torch.pipelines.stages.latent_preparation import (
            randn_like_reference)

        latents = randn_like_reference(tuple(latent_shape), [seed]).to(
            self.device)
        steps = list(dmd_denoising_steps)
        sigmas = [t / 1000.0 for t in steps] + [0.0]
        embeds = torch.as_tensor(embeds, dtype=torch.float32).to(self.device)
        for i, t in enumerate(steps):
            t_arr = torch.full((latents.shape[0],), float(t),
                               dtype=torch.float32, device=self.device)
            v = self.transformer(latents.to(torch.bfloat16),
                                 embeds.to(torch.bfloat16), t_arr).float()
            x0 = latents - sigmas[i] * v
            if sigmas[i + 1] > 0:
                noise = randn_like_reference(tuple(latents.shape),
                                             [seed + i + 1]).to(self.device)
                latents = (1 - sigmas[i + 1]) * x0 + sigmas[i + 1] * noise
            else:
                latents = x0
        return latents

    # -- checkpoints -----------------------------------------------------------

    def checkpoint_state(self) -> dict[str, torch.Tensor]:
        """The tensors a checkpoint holds and a resume restores in place:
        the whole model (LoRA training keeps only its adapters)."""
        return self.transformer.state_dict()

    def save_checkpoint(self) -> None:
        if self.checkpoint_manager is None:
            raise ValueError("no output_dir: checkpoints are off")
        self.checkpoint_manager.save(self.step, self.checkpoint_state(),
                                     self.optimizer.state_dict(),
                                     self.generator.get_state())

    def resume_from_checkpoint(self, step: int | None = None) -> None:
        """Parameters, AdamW state and step of ``step`` (default: the
        latest); the random generator's state last."""
        if self.checkpoint_manager is None:
            raise ValueError("no output_dir: checkpoints are off")
        model_state, opt_state, rng, meta = self.checkpoint_manager.restore(
            step)
        with torch.no_grad():
            for name, t in self.checkpoint_state().items():
                t.copy_(model_state[name])
        self.optimizer.load_state_dict(opt_state)
        self.step = int(meta["step"])
        self.generator.set_state(rng)
