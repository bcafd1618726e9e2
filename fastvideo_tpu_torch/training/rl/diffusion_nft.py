"""DiffusionNFT multi-reward policy optimization, RL post-training of a DiT
(port of fastvideo_tpu/training/rl/diffusion_nft.py).

One outer step: sample with the old policy, decode (``decode_fn``), score
with the multi-reward scorer, group-relative advantages per prompt, then
one NFT update of the student against the old policy and the frozen
reference over ``int(n * timestep_fraction)`` timesteps of the sampling
schedule (the positive and negative x0 losses with their detached weights,
KL to the reference) ending in ONE clip and ONE AdamW step; then the old
policy moves toward the student by the ``return_decay`` schedule, and the
EMA (with ``ema_decay``) by its decay.

The roles are ``nn.Module``s: the student (fp32 master weights, bf16
forwards, ``selective_checkpointing`` as the other trainers take it), and
old, ref and EMA as frozen copies of it.

Where JAX differs by construction:
  * JAX sums the per-timestep losses inside one compiled program and takes
    one gradient; the port calls backward once a timestep on ``loss_t / n``
    and accumulates: the same gradient, with one timestep's graph alive at
    a time.
  * random draws: JAX splits ``jax.random`` keys (the start noise, the
    sampler's keys, one key a trained timestep); the port draws them from
    one CPU ``torch.Generator`` seeded from ``args.seed``, in :meth:`draw`
    alone, so a test can hand it JAX's draws. Same seed, other numbers.
  * no forward context is set, as in JAX: VSA runs at sparsity 0.
"""

from __future__ import annotations

import copy
import dataclasses
import logging
import time
from collections import defaultdict
from typing import Callable, Sequence

import numpy as np
import torch

from fastvideo_tpu_torch.fastvideo_args import TrainingArgs
from fastvideo_tpu_torch.training.rl.rewards import MultiRewardScorer
from fastvideo_tpu_torch.training.rl.sampling import (DiffusionSampler,
                                                      SamplingConfig)
from fastvideo_tpu_torch.training.training_pipeline import (
    build_lr_schedule, build_optimizer, resolve_device)
from fastvideo_tpu_torch.training.training_utils import (
    clip_grad_norm, set_activation_checkpointing)

logger = logging.getLogger(__name__)

_ADV_MODES = {"all", "positive_only", "negative_only", "one_only", "binary"}


@dataclasses.dataclass(frozen=True)
class DiffusionNFTConfig:
    """The method's knobs."""

    num_video_per_prompt: int = 4
    adv_clip_max: float = 5.0
    timestep_fraction: float = 0.99
    kl_beta: float = 1e-4
    nft_beta: float = 0.1
    decay_type: int = 1
    adv_mode: str = "all"
    num_train_timesteps: int = 1000
    ema_decay: float = 0.0

    def __post_init__(self):
        if self.adv_mode not in _ADV_MODES:
            raise ValueError(f"adv_mode must be one of {sorted(_ADV_MODES)},"
                             f" got {self.adv_mode!r}")
        if self.decay_type not in (0, 1, 2):
            raise ValueError(f"Unsupported decay_type: {self.decay_type}")


def return_decay(step: int, decay_type: int) -> float:
    """The old policy's sync decay at outer step ``step``."""
    if decay_type == 0:
        flat, uprate, uphold = 0, 0.0, 0.0
    elif decay_type == 1:
        flat, uprate, uphold = 0, 0.001, 0.5
    elif decay_type == 2:
        flat, uprate, uphold = 75, 0.0075, 0.999
    else:
        raise ValueError(f"Unsupported decay_type: {decay_type}")
    if step < flat:
        return 0.0
    return min((step - flat) * uprate, uphold)


def compute_group_advantages(prompts: Sequence[str], rewards: np.ndarray,
                             eps: float = 1e-4) -> np.ndarray:
    """GRPO group-relative advantages: (r - mean) / (std + eps) over the
    samples of each prompt."""
    rewards = np.asarray(rewards, np.float64)
    adv = np.empty_like(rewards)
    groups: dict[str, list[int]] = defaultdict(list)
    for i, p in enumerate(prompts):
        groups[p].append(i)
    for idx in groups.values():
        g = rewards[idx]
        adv[idx] = (g - g.mean()) / (g.std() + eps)
    return adv.astype(np.float32)


@dataclasses.dataclass
class NFTDraws:
    """An outer step's random numbers: the sampler's start noise
    [n, *latent_shape], its fresh noise a step (``sde_reflow`` only) and
    the noise of each trained timestep."""

    noise: torch.Tensor
    fresh: list[torch.Tensor]
    t_noise: list[torch.Tensor]


@torch.no_grad()
def lerp_(dst: Sequence[torch.Tensor], src: Sequence[torch.Tensor],
          decay: float) -> None:
    """dst = dst * decay + src * (1 - decay) in place, each in fp32 (JAX's
    traced decay: 1 - decay too)."""
    d = np.float32(decay)
    keep, take = float(d), float(np.float32(1) - d)
    for o, s in zip(dst, src):
        o.mul_(keep).add_(s.detach() * take)


class DiffusionNFTPipeline:
    """Sample, score, then the NFT update: one outer step a call."""

    def __init__(self, student: torch.nn.Module,
                 training_args: TrainingArgs,
                 reward_scorer: MultiRewardScorer,
                 nft_config: DiffusionNFTConfig | None = None,
                 sampling: SamplingConfig | None = None,
                 decode_fn: Callable[[torch.Tensor], np.ndarray] | None = None):
        args = training_args
        self.args = args
        self.cfg = nft_config or DiffusionNFTConfig()
        self.device = resolve_device(args)
        self.reward_scorer = reward_scorer
        # media for scoring: the raw latents when no decoder is attached
        self.decode_fn = decode_fn or (
            lambda lat: lat.detach().float().cpu().numpy())

        self.student = student.to(self.device).train()
        set_activation_checkpointing(self.student,
                                     args.selective_checkpointing)
        self.params = [p for p in self.student.parameters()
                       if p.requires_grad]
        if not self.params:
            raise ValueError("the student has no trainable parameter (load "
                             "it with trainable=True)")
        self.old = self._frozen_copy()
        self.ref = self._frozen_copy()
        self.ema = self._frozen_copy() if self.cfg.ema_decay else None

        self.optimizer = build_optimizer(self.params, args)
        self.lr_schedule = build_lr_schedule(args)
        self.sampler = DiffusionSampler(
            sampling or SamplingConfig(num_steps=4),
            num_train_timesteps=self.cfg.num_train_timesteps)
        self.generator = torch.Generator("cpu").manual_seed(int(args.seed))
        self.step = 0
        # seconds of the last outer step: sample, decode, score, update
        self.stage_seconds: dict[str, float] = {}

    def _frozen_copy(self) -> torch.nn.Module:
        model = copy.deepcopy(self.student).eval().requires_grad_(False)
        model.gradient_checkpointing = False
        return model

    # -- draws and the inner objective ---------------------------------------

    def num_train_timesteps(self) -> int:
        n = len(self.sampler.schedule()[0])
        return max(1, min(n, int(n * self.cfg.timestep_fraction)))

    def draw(self, n: int, latent_shape: tuple[int, ...]) -> NFTDraws:
        """The step's random numbers from the pipeline's CPU generator."""
        shape = (n, *latent_shape)

        def randn():
            return torch.randn(shape, generator=self.generator,
                               dtype=torch.float32)

        steps = len(self.sampler.schedule()[0])
        return NFTDraws(
            noise=randn(),
            fresh=[randn() for _ in range(steps)]
            if self.sampler.stochastic else [],
            t_noise=[randn() for _ in range(self.num_train_timesteps())])

    def shape_advantages(self, adv: torch.Tensor) -> torch.Tensor:
        """Clip, the ``adv_mode`` transform, then r in [0, 1]."""
        cmax = self.cfg.adv_clip_max
        a = torch.clamp(adv, -cmax, cmax)
        mode = self.cfg.adv_mode
        if mode == "positive_only":
            a = torch.clamp(a, 0, cmax)
        elif mode == "negative_only":
            a = torch.clamp(a, -cmax, 0)
        elif mode == "one_only":
            a = torch.where(a > 0, 1.0, 0.0)
        elif mode == "binary":
            a = torch.sign(a)
        return torch.clamp((a / cmax) / 2.0 + 0.5, 0.0, 1.0)

    def timestep_loss(self, x0: torch.Tensor, embeds: torch.Tensor,
                      r: torch.Tensor, t_val: float, noise: torch.Tensor
                      ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """(loss, policy loss, KL) of one trained timestep."""
        beta, cmax = self.cfg.nft_beta, self.cfg.adv_clip_max
        t = torch.full((x0.shape[0],), t_val, dtype=torch.float32,
                       device=x0.device)
        te = (t / self.cfg.num_train_timesteps).reshape(
            -1, *([1] * (x0.ndim - 1)))
        xt = (1 - te) * x0 + te * noise
        xt_b, emb_b = xt.to(torch.bfloat16), embeds.to(torch.bfloat16)
        with torch.no_grad():
            old_pred = self.old(xt_b, emb_b, t).float()
            ref_pred = self.ref(xt_b, emb_b, t).float()
        pred = self.student(xt_b, emb_b, t).float()

        pos_pred = beta * pred + (1 - beta) * old_pred
        neg_pred = (1 + beta) * old_pred - beta * pred
        dims = tuple(range(1, x0.ndim))

        def x0_loss(v):
            err = xt - te * v - x0
            w = torch.clamp(err.abs().mean(dim=dims, keepdim=True),
                            min=1e-5).detach()
            return (err.square() / w).mean(dim=dims)

        ori = r * x0_loss(pos_pred) / beta + (1 - r) * x0_loss(
            neg_pred) / beta
        policy = torch.mean(ori * cmax)
        kl = torch.mean(torch.square(pred - ref_pred))
        return policy + self.cfg.kl_beta * kl, policy, kl

    def nft_update(self, x0: torch.Tensor, embeds: torch.Tensor,
                   adv: torch.Tensor, timesteps: np.ndarray,
                   t_noise: Sequence[torch.Tensor]) -> dict[str, float]:
        """The NFT loss over ``timesteps`` (its gradient accumulated a
        timestep at a time), one clip and one AdamW step."""
        n = len(timesteps)
        r = self.shape_advantages(adv).reshape(-1)
        total = torch.zeros(3, dtype=torch.float32, device=x0.device)
        for i in range(n):
            loss, policy, kl = self.timestep_loss(
                x0, embeds, r, float(timesteps[i]),
                t_noise[i].to(x0.device, torch.float32))
            (loss / n).backward()
            total += torch.stack([loss, policy, kl]).detach() / n
        grad_norm = clip_grad_norm(self.params, self.args.max_grad_norm)
        lr = self.lr_schedule(self.step)
        for group in self.optimizer.param_groups:
            group["lr"] = lr
        self.optimizer.step()
        self.optimizer.zero_grad(set_to_none=True)
        loss, policy, kl = total.tolist()
        return {"total_loss": loss, "policy_loss": policy,
                "kl_div_loss": kl, "grad_norm": float(grad_norm)}

    # -- the outer step ------------------------------------------------------

    def _sync(self) -> float:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return time.perf_counter()

    def train_one_step(self, prompts: Sequence[str], embeds: np.ndarray,
                       latent_shape: tuple[int, ...]) -> dict:
        """One outer NFT step on a prompt batch: ``prompts`` [P],
        ``embeds`` [P, L, D] text embeddings, ``latent_shape`` one sample's
        latent shape (C, ...). Each prompt is repeated
        ``num_video_per_prompt`` times for its group's advantages."""
        k = self.cfg.num_video_per_prompt
        rep_prompts = [p for p in prompts for _ in range(k)]
        rep_embeds = torch.as_tensor(
            np.repeat(np.asarray(embeds, np.float32), k, axis=0)).to(
                self.device)
        draws = self.draw(len(rep_prompts), tuple(latent_shape))

        t0 = self._sync()
        result = self.sampler.sample(
            self.old, draws.noise.to(self.device), rep_embeds, draws.fresh)
        t1 = self._sync()
        media = self.decode_fn(result.latents)
        t2 = time.perf_counter()
        rewards = self.reward_scorer(media, rep_prompts)
        adv = compute_group_advantages(rep_prompts, rewards["avg"])
        t3 = time.perf_counter()

        n_t = self.num_train_timesteps()
        metrics = self.nft_update(
            result.latents, rep_embeds,
            torch.as_tensor(adv, device=self.device),
            result.timesteps[:n_t], draws.t_noise)
        decay = return_decay(self.step, self.cfg.decay_type)
        students = list(self.student.parameters())
        lerp_(list(self.old.parameters()), students, decay)
        if self.ema is not None:
            lerp_(list(self.ema.parameters()), students, self.cfg.ema_decay)
        t4 = self._sync()
        self.stage_seconds = {"sample": t1 - t0, "decode": t2 - t1,
                              "score": t3 - t2, "update": t4 - t3}

        self.step += 1
        metrics = {"step": self.step, **metrics, "old_decay": decay}
        for name, vals in rewards.items():
            metrics[f"reward/{name}"] = float(np.mean(vals))
        return metrics

    def train(self, dataloader, max_steps: int | None = None,
              log_every: int = 10, callbacks=None) -> None:
        """The outer loop over (prompts, embeds, latent_shape) batches;
        ``callbacks`` are dispatched at train start, after each step and at
        train end. A (latents, embeds) batch of the Parquet loader raises,
        as in JAX."""
        from fastvideo_tpu_torch.training.callbacks import normalize_callbacks

        callbacks = normalize_callbacks(callbacks)
        max_steps = max_steps or self.args.max_train_steps
        if callbacks is not None:
            callbacks.dispatch("on_train_start", self, self.step)
        it = iter(dataloader)
        while self.step < max_steps:
            try:
                batch = next(it)
            except StopIteration:
                it = iter(dataloader)
                batch = next(it)
            prompts, embeds, latent_shape = batch
            metrics = self.train_one_step(prompts, embeds,
                                          tuple(latent_shape))
            if callbacks is not None:
                callbacks.dispatch("on_training_step_end", self, metrics,
                                   self.step)
            if self.step % log_every == 0:
                logger.info("diffusion_nft step %d %s", self.step,
                            {k: round(v, 4) for k, v in metrics.items()
                             if isinstance(v, float)})
        if callbacks is not None:
            callbacks.dispatch("on_train_end", self, self.step)
