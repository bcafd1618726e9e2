"""Knowledge distillation onto teacher ODE trajectories, ``kd`` (port of
fastvideo_tpu/training/methods/knowledge_distillation.py).

Each step picks a random student timestep from ``t_list``, takes the
teacher's trajectory latent at it, turns the student's velocity into a
predicted clean video ``x - sigma v`` and regresses it onto the teacher's
final x0 with ``0.5 * MSE``; then JAX's clipping, the LR schedule and
AdamW. The teacher's rollout over ``t_list`` runs under ``torch.no_grad``:
its trajectory holds the input at each t, and each step re-noises its x0
with a fresh draw.

The teacher is ``teacher_model_path``'s DiT, else a frozen copy of the
student's initial weights, else none once the cache is ``COMPLETE``. The
cache (``teacher_path_cache``) is one ``.npz`` a sample with the keys
``trajectory`` [S, B, C, T, H, W], ``real`` [B, C, T, H, W],
``text_embedding`` [B, L, D] and ``t_list`` [S], all fp32 but ``t_list``,
and a ``COMPLETE`` sentinel; its generation resumes where it stopped, and
either package reads the other's. Without a cache the rollouts run on the
fly. Each loader batch gives its first micro-batch (``[0]``), as in JAX.
Each step's metrics go to the tracker, as the port's other trainers'.

No forward context is set, as in JAX: VSA runs at sparsity 0. Under
``selective_checkpointing="full"`` (or "ops") the student's blocks are
recomputed in the backward, which leaves the numbers as they are.

Random numbers: JAX splits ``jax.random`` keys; the port draws from one CPU
``torch.Generator`` seeded from ``args.seed`` in :meth:`KDMethod.draw`
(a cache sample's rollout from a generator seeded with the sample's index,
as JAX keys it by the index), so a test can hand it JAX's draws.
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

from fastvideo_tpu_torch.training.methods.base import (TrainingMethod,
                                                       register_method)
from fastvideo_tpu_torch.training.run_config import (TrainRunConfig,
                                                     build_training_args,
                                                     build_transformer)
from fastvideo_tpu_torch.training.trackers import initialize_trackers
from fastvideo_tpu_torch.training.training_pipeline import (
    build_lr_schedule, build_optimizer, resolve_device)
from fastvideo_tpu_torch.training.training_utils import (
    clip_grad_norm, set_activation_checkpointing)

logger = logging.getLogger(__name__)

SENTINEL = "COMPLETE"


@dataclasses.dataclass
class RolloutDraws:
    """A teacher rollout's draws: the starting noise and one fresh noise a
    step before the last."""
    noise: torch.Tensor
    fresh: list[torch.Tensor]


@register_method
class KDMethod(TrainingMethod):
    name = "kd"

    def __init__(self, student: torch.nn.Module, training_args,
                 teacher: torch.nn.Module | None = None,
                 t_list: tuple[int, ...] = (999, 937, 833, 624),
                 num_train_timesteps: int = 1000,
                 teacher_path_cache: str | None = None):
        self._args = args = training_args
        self.device = resolve_device(args)
        self.t_list = tuple(int(t) for t in t_list)
        self.num_train_timesteps = num_train_timesteps
        self.teacher_path_cache = teacher_path_cache
        self.student = student.to(self.device).train()
        set_activation_checkpointing(student, args.selective_checkpointing)
        self.teacher = teacher  # frozen; None: cache only
        if teacher is not None:
            self.teacher = teacher.to(self.device).eval().requires_grad_(
                False)
        self.params = [p for p in student.parameters() if p.requires_grad]
        if not self.params:
            raise ValueError("the student has no trainable parameter "
                             "(load it with trainable=True)")
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

    @property
    def args(self) -> Any:
        return self._args

    @classmethod
    def from_config(cls, cfg: TrainRunConfig) -> "KDMethod":
        mc = dict(cfg.method_config)
        targs = build_training_args(cfg)
        device = resolve_device(targs)
        student = build_transformer(cfg.model, device=device)
        teacher = None
        teacher_path = mc.get("teacher_model_path")
        cache = mc.get("teacher_path_cache")
        cache_complete = bool(cache) and os.path.exists(
            os.path.join(str(cache), SENTINEL))
        if teacher_path:
            teacher = build_transformer(dataclasses.replace(
                cfg.model, pretrained_model_path=teacher_path),
                device=device)
        elif not cache_complete:
            # self-distillation from the student's initial weights; the
            # teacher may be left out only once the cache is complete
            teacher = copy.deepcopy(student)
        return cls(student, targs, teacher,
                   t_list=tuple(mc.get("t_list", (999, 937, 833, 624))),
                   teacher_path_cache=cache)

    # -- random numbers ------------------------------------------------------

    def draw(self, shape: tuple[int, ...] | None = None,
             sample: int | None = None) -> RolloutDraws | int:
        """With ``shape``: a teacher rollout's draws of latents that shape,
        from the step generator, or with ``sample`` from a generator seeded
        with that cache index. Without: a step's index into ``t_list``."""
        if shape is None:
            return int(torch.randint(0, len(self.t_list), (1,),
                                     generator=self.rng))
        g = (self.rng if sample is None else
             torch.Generator("cpu").manual_seed(int(sample)))
        noise = torch.randn(shape, generator=g, dtype=torch.float32)
        fresh = [torch.randn(shape, generator=g, dtype=torch.float32)
                 for _ in self.t_list[1:]]
        return RolloutDraws(noise, fresh)

    # -- the pieces ----------------------------------------------------------

    def _pred_x0(self, model: torch.nn.Module, noisy: torch.Tensor,
                 embeds: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
        """x0 = x - sigma v, the DiT in bf16, the rest in fp32."""
        v = model(noisy.to(torch.bfloat16), embeds.to(torch.bfloat16),
                  t).float()
        sigma = (t / self.num_train_timesteps).reshape(
            -1, *([1] * (noisy.ndim - 1)))
        return noisy.float() - sigma * v

    @torch.no_grad()
    def teacher_rollout(self, embeds: torch.Tensor, draws: RolloutDraws
                        ) -> tuple[torch.Tensor, torch.Tensor]:
        """The teacher's ODE over ``t_list``: (trajectory [S, B, ...], whose
        entry i is the latent AT ``t_list[i]``, and the final x0)."""
        if self.teacher is None:
            raise ValueError("no teacher: the cache is complete, or give "
                             "teacher_model_path")
        embeds = torch.as_tensor(embeds, dtype=torch.float32).to(self.device)
        lat = draws.noise.to(self.device)
        n = self.num_train_timesteps
        traj = []
        for i, t_int in enumerate(self.t_list):
            traj.append(lat)
            t = torch.full((lat.shape[0],), float(t_int),
                           dtype=torch.float32, device=self.device)
            x0 = self._pred_x0(self.teacher, lat, embeds, t)
            if i + 1 < len(self.t_list):
                nxt = self.t_list[i + 1] / n
                lat = (1 - nxt) * x0 + nxt * draws.fresh[i].to(self.device)
            else:
                lat = x0
        return torch.stack(traj), lat

    def loss(self, trajectory: torch.Tensor, embeds: torch.Tensor,
             real: torch.Tensor, step_i: int) -> torch.Tensor:
        noisy = trajectory[step_i]
        t = torch.full((noisy.shape[0],), float(self.t_list[step_i]),
                       dtype=torch.float32, device=self.device)
        pred_x0 = self._pred_x0(self.student, noisy, embeds, t)
        return 0.5 * torch.mean(torch.square(pred_x0 - real.float()))

    def train_one_step(self, trajectory, embeds, real) -> dict[str, Any]:
        """trajectory [S, B, C, T, H, W], embeds [B, L, D], real [B, C, T,
        H, W] (numpy or tensors)."""
        trajectory, embeds, real = (
            torch.as_tensor(x, dtype=torch.float32).to(self.device)
            for x in (trajectory, embeds, real))
        step_i = self.draw()
        loss = self.loss(trajectory, embeds, real, step_i)
        loss.backward()
        grad_norm = clip_grad_norm(self.params, self._args.max_grad_norm)
        lr = self.lr_schedule(self.step)
        for group in self.optimizer.param_groups:
            group["lr"] = lr
        self.optimizer.step()
        self.optimizer.zero_grad(set_to_none=True)
        self.step += 1
        return {"kd_loss": float(loss.detach()),
                "grad_norm": float(grad_norm), "kd_step_idx": float(step_i),
                "step": self.step}

    # -- the cache -----------------------------------------------------------

    def generate_cache(self, dataloader, max_samples: int) -> None:
        """Roll the teacher out over the dataloader, one ``.npz`` a sample
        (a sample already written is kept), then the sentinel."""
        cache = self.teacher_path_cache
        assert cache and self.teacher is not None
        os.makedirs(cache, exist_ok=True)
        sentinel = os.path.join(cache, SENTINEL)
        if os.path.exists(sentinel):
            return
        for i, (latents, embeds) in enumerate(dataloader):
            if i >= max_samples:
                break
            path = os.path.join(cache, f"{i:08d}.npz")
            if os.path.exists(path):
                continue
            lat = np.asarray(latents, np.float32)[0]
            emb = np.asarray(embeds, np.float32)[0]
            traj, real = self.teacher_rollout(
                emb, self.draw(lat.shape, sample=i))
            tmp = path[:-len(".npz")] + ".tmp.npz"
            np.savez(tmp, trajectory=traj.cpu().numpy(),
                     real=real.cpu().numpy(), text_embedding=emb,
                     t_list=np.asarray(self.t_list))
            os.replace(tmp, path)
        with open(sentinel, "w") as fh:
            fh.write("ok")

    def iter_cache(self):
        """(trajectory, text_embedding, real) of each cached sample, in
        file order."""
        files = sorted(f for f in os.listdir(self.teacher_path_cache)
                       if f.endswith(".npz") and not f.endswith(".tmp.npz"))
        for f in files:
            with np.load(os.path.join(self.teacher_path_cache, f)) as d:
                yield d["trajectory"], d["text_embedding"], d["real"]

    # -- the loop -------------------------------------------------------------

    def train(self, dataloader, max_steps: int | None = None,
              log_every: int = 10, callbacks=None) -> None:
        """The teacher's cache first (with ``teacher_path_cache``), then
        steps from the cache or from fresh rollouts. ``callbacks`` are
        taken and not dispatched: JAX's kd takes them in ``**kwargs`` and
        dispatches none."""
        if callbacks:
            logger.warning("kd dispatches no training callbacks, as the "
                           "JAX kd; ignoring them")
        max_steps = max_steps or self._args.max_train_steps
        use_cache = bool(self.teacher_path_cache)
        if use_cache and self.teacher is not None:
            self.generate_cache(dataloader, max_samples=max_steps)

        def batches():
            while True:
                if use_cache:
                    yield from self.iter_cache()
                    continue
                for latents, embeds in dataloader:
                    lat = np.asarray(latents, np.float32)[0]
                    emb = np.asarray(embeds, np.float32)[0]
                    traj, real = self.teacher_rollout(emb,
                                                      self.draw(lat.shape))
                    yield traj, emb, real

        t0 = time.perf_counter()
        for traj, emb, real in batches():
            if self.step >= max_steps:
                break
            metrics = self.train_one_step(traj, emb, real)
            self.tracker.log(metrics, self.step)
            if self.step % log_every == 0:
                logger.info("kd step %d loss %.4f (t idx %d, %.2fs/it)",
                            self.step, metrics["kd_loss"],
                            int(metrics["kd_step_idx"]),
                            (time.perf_counter() - t0) / log_every)
                t0 = time.perf_counter()
