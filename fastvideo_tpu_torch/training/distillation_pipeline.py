"""DMD2 distillation: generator, real-score teacher and fake-score critic
(port of fastvideo_tpu/training/distillation_pipeline.py).

* generator update: the few-step rollout (no gradient through the steps
  before the last), then the DMD gradient
  ``(x0_fake - x0_real_cfg) / mean|x0_gen - x0_real|`` applied as
  ``0.5 * mse(x0_gen, detach(x0_gen - grad))``;
* critic update: the flow-matching loss of the fake score on (detached)
  generator outputs;
* a generator update on the steps where ``step % dfake_gen_update_ratio ==
  0``, a critic update on every step, after the generator's.

The three roles are ``nn.Module``s of one architecture; the generator and
the fake score each have an AdamW (optax.adamw's update, the LR schedule
counted per optimizer as optax counts it) and JAX's clipping; the teacher
has no gradient and no optimizer. Every forward runs the DiT in bf16 on
fp32 master weights. Under ``selective_checkpointing="full"`` (or "ops",
which also keeps the linears' outputs) the trained roles run each block
under ``torch.utils.checkpoint``, which leaves the numbers as they are.

No forward context is set, as in JAX: VSA runs at sparsity 0, every key
tile of every query tile.

Random numbers: JAX splits ``jax.random`` keys; the port draws them from one
CPU ``torch.Generator`` seeded from ``args.seed``, in :meth:`draw` alone,
so a test can hand it JAX's draws. Same seed, other numbers.
"""

from __future__ import annotations

import dataclasses
import logging
import os
import time
from typing import Any

import numpy as np
import torch

from fastvideo_tpu_torch.fastvideo_args import TrainingArgs
from fastvideo_tpu_torch.training.trackers import initialize_trackers
from fastvideo_tpu_torch.training.training_pipeline import (
    build_lr_schedule, build_optimizer, resolve_device)
from fastvideo_tpu_torch.training.training_utils import (
    clip_grad_norm, set_activation_checkpointing)

logger = logging.getLogger(__name__)


@dataclasses.dataclass
class DMDConfig:
    dmd_denoising_steps: tuple[int, ...] = (1000, 757, 522)
    real_score_guidance_scale: float = 3.5
    dfake_gen_update_ratio: int = 5
    min_timestep_ratio: float = 0.02
    max_timestep_ratio: float = 0.98
    timestep_shift: float = 8.0
    num_train_timestep: int = 1000
    simulate_generator_forward: bool = True
    # EMA of the generator: 0 disables (e.g. 0.995)
    ema_decay: float = 0.0
    ema_start_step: int = 0


def shift_timestep(t: torch.Tensor, shift: float,
                   num_train: float) -> torch.Tensor:
    """t' = shift t / (1 + (shift - 1) t / T), in fp32."""
    u = torch.as_tensor(t).to(torch.float32) / num_train
    u = shift * u / (1 + (shift - 1) * u)
    return u * num_train


@dataclasses.dataclass
class UpdateDraws:
    """The random numbers of one update: the rollout's fresh noises (one a
    step before the last), the timestep integer in [0, T) and the noise of
    the DMD / critic target."""
    rollout: list[torch.Tensor]
    t_int: int
    noise: torch.Tensor


class DMD2DistillationPipeline:
    # the method's name in the training log
    label = "dmd2"

    def __init__(self, generator: torch.nn.Module,
                 real_score: torch.nn.Module, fake_score: torch.nn.Module,
                 training_args: TrainingArgs,
                 dmd_config: DMDConfig | None = None):
        args = training_args
        self.args = args
        self.dmd = dmd_config or DMDConfig()
        self.device = resolve_device(args)
        self.generator = generator.to(self.device).train()
        self.fake_score = fake_score.to(self.device).train()
        self.real_score = real_score.to(self.device).eval()
        self.real_score.requires_grad_(False)
        for m in (self.generator, self.fake_score):
            set_activation_checkpointing(m, args.selective_checkpointing)
        self.gen_params = [p for p in self.generator.parameters()
                           if p.requires_grad]
        self.fake_params = [p for p in self.fake_score.parameters()
                            if p.requires_grad]
        if not self.gen_params or not self.fake_params:
            raise ValueError("the generator and the fake score need "
                             "trainable parameters (load with "
                             "trainable=True)")
        self.gen_opt = build_optimizer(self.gen_params, args)
        self.fake_opt = build_optimizer(self.fake_params, args)
        self.lr_schedule = build_lr_schedule(args)
        self.gen_updates = 0
        self.fake_updates = 0
        self.rng = torch.Generator("cpu").manual_seed(int(args.seed))
        self.step = 0
        self.ema_params = ([p.detach().clone() for p in self.gen_params]
                           if self.dmd.ema_decay else None)
        names = list(args.trackers or ())
        if not names and args.tracker_project_name:
            names = ["jsonl"]
        self.tracker = initialize_trackers(
            names, args.tracker_project_name or "fastvideo_tpu_torch",
            config=dataclasses.asdict(args),
            log_dir=os.path.join(args.output_dir or ".", "tracker"),
            run_name=args.wandb_run_name)

    # -- random numbers -------------------------------------------------------

    def _update_draws(self, shape: tuple[int, ...]) -> UpdateDraws:
        steps = list(self.dmd.dmd_denoising_steps)
        n_roll = (len(steps) - 1 if self.dmd.simulate_generator_forward
                  else 0)
        g = self.rng
        rollout = [torch.randn(shape, generator=g, dtype=torch.float32)
                   for _ in range(n_roll)]
        t_int = int(torch.randint(0, self.dmd.num_train_timestep, (1,),
                                  generator=g))
        noise = torch.randn(shape, generator=g, dtype=torch.float32)
        return UpdateDraws(rollout, t_int, noise)

    def draw(self, latent_shape: tuple[int, ...], generator_update: bool
             ) -> dict[str, Any]:
        """The step's random numbers, from the pipeline's CPU generator:
        ``noise`` (the rollouts' start), then ``generator`` (when this step
        updates it) and ``critic`` (:class:`UpdateDraws`)."""
        out: dict[str, Any] = {"noise": torch.randn(
            latent_shape, generator=self.rng, dtype=torch.float32)}
        if generator_update:
            out["generator"] = self._update_draws(latent_shape)
        out["critic"] = self._update_draws(latent_shape)
        return out

    # -- shared pieces --------------------------------------------------------

    def _sigma(self, t: torch.Tensor, ndim: int) -> torch.Tensor:
        return (t / self.dmd.num_train_timestep).reshape(
            -1, *([1] * (ndim - 1)))

    def _pred_x0(self, model: torch.nn.Module, noisy: torch.Tensor,
                 embeds: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
        """Flow model: x0 = x_t - sigma v, the DiT in bf16."""
        v = model(noisy.to(torch.bfloat16), embeds.to(torch.bfloat16),
                  t).float()
        return noisy.float() - self._sigma(t, noisy.ndim) * v

    def _full_t(self, value: float, batch: int) -> torch.Tensor:
        return torch.full((batch,), float(value), dtype=torch.float32,
                          device=self.device)

    def _rollout(self, noise: torch.Tensor, embeds: torch.Tensor,
                 fresh: list[torch.Tensor]) -> torch.Tensor:
        """The generator's few-step simulation; the gradient, where grad is
        on, flows through the last step only."""
        steps = list(self.dmd.dmd_denoising_steps)
        num_train = self.dmd.num_train_timestep
        b = noise.shape[0]
        x = noise
        if self.dmd.simulate_generator_forward and len(steps) > 1:
            with torch.no_grad():
                for i, t_int in enumerate(steps[:-1]):
                    x0 = self._pred_x0(self.generator, x, embeds,
                                       self._full_t(t_int, b))
                    nxt = steps[i + 1] / num_train
                    x = (1 - nxt) * x0 + nxt * fresh[i].to(self.device)
        return self._pred_x0(self.generator, x, embeds,
                             self._full_t(steps[-1], b))

    def _update_rollout(self, noise: torch.Tensor, embeds: torch.Tensor,
                        draws: UpdateDraws) -> torch.Tensor:
        """An update's rollout from its draws (a subclass with other
        rollout draws replaces this and :meth:`_update_draws`)."""
        return self._rollout(noise, embeds, draws.rollout)

    def _dmd_timestep(self, t_int: int, batch: int) -> torch.Tensor:
        """The generator's timestep: shifted, then clipped to [min, max]
        of T; one value over the batch."""
        num_train = self.dmd.num_train_timestep
        t = shift_timestep(torch.tensor([float(t_int)]),
                           self.dmd.timestep_shift, num_train)
        t = torch.clamp(t, self.dmd.min_timestep_ratio * num_train,
                        self.dmd.max_timestep_ratio * num_train)
        return t.expand(batch).to(self.device)

    def _critic_timestep(self, t_int: int, batch: int) -> torch.Tensor:
        """The critic's timestep: shifted and not clipped, as in JAX."""
        t = shift_timestep(torch.tensor([float(t_int)]),
                           self.dmd.timestep_shift,
                           self.dmd.num_train_timestep)
        return t.expand(batch).to(self.device)

    # -- the losses -----------------------------------------------------------

    def generator_loss(self, noise: torch.Tensor, embeds: torch.Tensor,
                       neg_embeds: torch.Tensor,
                       draws: UpdateDraws) -> torch.Tensor:
        dmd = self.dmd
        x0_gen = self._update_rollout(noise, embeds, draws)
        t = self._dmd_timestep(draws.t_int, noise.shape[0])
        sigma = self._sigma(t, noise.ndim)
        n = draws.noise.to(self.device)
        with torch.no_grad():
            noisy = (1 - sigma) * x0_gen + sigma * n
            x0_fake = self._pred_x0(self.fake_score, noisy, embeds, t)
            x0_real_c = self._pred_x0(self.real_score, noisy, embeds, t)
            x0_real_u = self._pred_x0(self.real_score, noisy, neg_embeds, t)
            x0_real = x0_real_c + (
                x0_real_c - x0_real_u) * dmd.real_score_guidance_scale
            normalizer = torch.mean(torch.abs(x0_gen - x0_real))
            grad = (x0_fake - x0_real) / torch.clamp(normalizer, min=1e-6)
            target = x0_gen - torch.nan_to_num(grad)
        return 0.5 * torch.mean(torch.square(x0_gen - target))

    def critic_loss(self, noise: torch.Tensor, embeds: torch.Tensor,
                    draws: UpdateDraws) -> torch.Tensor:
        with torch.no_grad():
            x0_gen = self._update_rollout(noise, embeds, draws)
        t = self._critic_timestep(draws.t_int, noise.shape[0])
        sigma = self._sigma(t, noise.ndim)
        n = draws.noise.to(self.device)
        noisy = (1 - sigma) * x0_gen + sigma * n
        v_pred = self.fake_score(noisy.to(torch.bfloat16),
                                 embeds.to(torch.bfloat16), t).float()
        return torch.mean(torch.square(v_pred - (n - x0_gen)))

    def _update(self, loss: torch.Tensor, params, optimizer,
                count: int) -> float:
        """Backward, clip, AdamW at the schedule's LR of ``count``; the
        gradients are freed before the other role's backward. A parameter
        the loss does not reach (a fake score's AnyFlow delta_embedder,
        which never sees r) gets a zero gradient, as JAX's does: AdamW
        still decays it and its moments."""
        loss.backward()
        for p in params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        norm = clip_grad_norm(params, self.args.max_grad_norm)
        lr = self.lr_schedule(count)
        for group in optimizer.param_groups:
            group["lr"] = lr
        optimizer.step()
        optimizer.zero_grad(set_to_none=True)
        return float(norm)

    # -- public ---------------------------------------------------------------

    def train_one_step(self, embeds, neg_embeds,
                       latent_shape: tuple[int, ...]) -> dict[str, Any]:
        """The alternating DMD2 update; ``embeds`` / ``neg_embeds`` [B, L,
        D] (numpy or tensors), ``latent_shape`` the noise's [B, C, T, H, W]."""
        embeds = torch.as_tensor(embeds, dtype=torch.float32).to(self.device)
        neg_embeds = torch.as_tensor(neg_embeds, dtype=torch.float32).to(
            self.device)
        gen_update = self.step % self.dmd.dfake_gen_update_ratio == 0
        draws = self.draw(tuple(latent_shape), gen_update)
        noise = draws["noise"].to(self.device)
        metrics: dict[str, Any] = {}
        if gen_update:
            loss = self.generator_loss(noise, embeds, neg_embeds,
                                       draws["generator"])
            metrics["generator_grad_norm"] = self._update(
                loss, self.gen_params, self.gen_opt, self.gen_updates)
            metrics["generator_loss"] = float(loss.detach())
            self.gen_updates += 1
            if (self.ema_params is not None
                    and self.step >= self.dmd.ema_start_step):
                decay = float(self.dmd.ema_decay)
                with torch.no_grad():
                    for e, p in zip(self.ema_params, self.gen_params):
                        e.mul_(decay).add_(p.detach(), alpha=1.0 - decay)
        loss = self.critic_loss(noise, embeds, draws["critic"])
        metrics["critic_grad_norm"] = self._update(
            loss, self.fake_params, self.fake_opt, self.fake_updates)
        metrics["critic_loss"] = float(loss.detach())
        self.fake_updates += 1
        self.step += 1
        metrics["step"] = self.step
        return metrics

    def train(self, dataloader, max_steps: int | None = None,
              log_every: int = 10, callbacks=None) -> None:
        """The alternating loop over a (latents, embeds) dataloader of
        [accum, B, ...] batches: micro-batch 0's embeddings, zero
        embeddings as the unconditional branch; the latents fix the noise's
        shape only (the generator simulates its own forward). ``callbacks``
        are dispatched at train start, after each step and at train end."""
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
            emb = np.asarray(embeds)[0]
            metrics = self.train_one_step(emb, np.zeros_like(emb),
                                          tuple(np.asarray(latents)[0].shape))
            self.tracker.log(metrics, self.step)
            if callbacks is not None:
                callbacks.dispatch("on_training_step_end", self, metrics,
                                   self.step)
            if self.step % log_every == 0:
                dt = time.perf_counter() - t0
                logger.info("%s step %d %s (%.2fs/it)", self.label, self.step,
                            {k: round(v, 4) for k, v in metrics.items()
                             if isinstance(v, float)}, dt / log_every)
                t0 = time.perf_counter()
        if callbacks is not None:
            callbacks.dispatch("on_train_end", self, self.step)
