"""Fine-tuning methods (port of fastvideo_tpu/training/methods/fine_tuning.py).

``sft`` is flow-matching supervised fine-tuning. ``dfsft`` is
diffusion-forcing SFT of a causal student (``CausalWanTransformer3DModel``):
per-chunk timesteps under the blockwise-causal mask (the model's
``train_forward``, K1 struct and K6 struct on the card), with Gaussian
timestep weighting. ``tfsft`` is its teacher-forcing form: the noisy chunks
also attend a clean copy of all strictly earlier chunks.

As in SFT, the draws come from the pipeline's CPU ``torch.Generator`` in
``draw`` alone (a timestep index per chunk, then the noise), not from JAX
keys: the same seed gives other numbers than JAX, and the tests hand the
port JAX's draws.
"""

from __future__ import annotations

import numpy as np
import torch

from fastvideo_tpu_torch.training.methods.base import (PipelineMethod,
                                                       register_method)
from fastvideo_tpu_torch.training.run_config import (TrainRunConfig,
                                                     build_training_args,
                                                     build_transformer)
from fastvideo_tpu_torch.training.training_pipeline import (TrainingPipeline,
                                                            resolve_device)


@register_method
class SFTMethod(PipelineMethod):
    """Flow-matching supervised fine-tuning."""

    name = "sft"

    @classmethod
    def from_config(cls, cfg: TrainRunConfig) -> "SFTMethod":
        from fastvideo_tpu_torch.models.schedulers.flow_match_euler import (
            FlowMatchEulerDiscreteScheduler)

        targs = build_training_args(cfg)
        scheduler = FlowMatchEulerDiscreteScheduler(
            shift=cfg.model.flow_shift)
        scheduler.set_timesteps(1000)
        transformer = build_transformer(cfg.model,
                                        device=resolve_device(targs))
        return cls(TrainingPipeline(transformer, scheduler, targs))


def gaussian_timestep_weights(n: int) -> np.ndarray:
    """Weights of the n scheduler timesteps that stress mid noise and damp
    the extremes, averaging 1."""
    x = np.arange(n, dtype=np.float32)
    y = np.exp(-2.0 * ((x - n / 2) / n) ** 2)
    y = y - y.min()
    return y * (n / y.sum())


class DiffusionForcingPipeline(TrainingPipeline):
    """SFT of a causal DiT with per-chunk timesteps.

    A step draws one timestep index per (batch, chunk) in
    [:meth:`_timestep_index_range`), expands it to the chunk's frames, adds
    flow noise frame by frame, runs the blockwise-causal ``train_forward``
    (with the clean latents as context under ``teacher_forcing``) and takes
    the Gaussian-weighted per-frame x0 MSE (``precondition_outputs``) or
    velocity MSE.
    """

    def __init__(self, transformer, scheduler, training_args, *,
                 chunk_size: int | None = None,
                 min_timestep_ratio: float = 0.0,
                 max_timestep_ratio: float = 1.0,
                 precondition_outputs: bool = True,
                 teacher_forcing: bool = False):
        expected = getattr(transformer.config, "num_frames_per_block", None)
        if chunk_size is None:
            chunk_size = int(expected or 3)
        if expected is not None and int(expected) != int(chunk_size):
            raise ValueError(
                "DFSFT chunk_size must match transformer."
                f"num_frames_per_block (got {chunk_size}, expected "
                f"{expected})")
        self.chunk_size = int(chunk_size)
        self.min_timestep_ratio = float(min_timestep_ratio)
        self.max_timestep_ratio = float(max_timestep_ratio)
        self.precondition_outputs = bool(precondition_outputs)
        self.teacher_forcing = bool(teacher_forcing)
        super().__init__(transformer, scheduler, training_args)
        self.weights = torch.as_tensor(
            gaussian_timestep_weights(self.sched_timesteps.shape[0]))

    def _timestep_index_range(self) -> tuple[int, int]:
        """[low, high) indices into the scheduler's timesteps."""
        n = len(self.scheduler.timesteps)
        lo = max(0, min(int(self.min_timestep_ratio * n), n - 1))
        hi = max(0, min(int(self.max_timestep_ratio * n), n - 1))
        if hi <= lo:
            hi = min(n - 1, lo + 1)
        return lo, hi + 1

    def draw(self, latents_shape: tuple[int, ...]
             ) -> tuple[torch.Tensor, torch.Tensor]:
        """One micro-batch's draws from the CPU generator: a timestep index
        per (batch, chunk) [B, ceil(T / chunk)] in the index range, then
        fp32 noise of the latents' shape [B, C, T, H, W]."""
        b, t = latents_shape[0], latents_shape[2]
        lo, hi = self._timestep_index_range()
        idx = torch.randint(lo, hi, (b, -(-t // self.chunk_size)),
                            generator=self.generator)
        noise = torch.randn(latents_shape, generator=self.generator,
                            dtype=torch.float32)
        return idx, noise

    def loss(self, latents: torch.Tensor, embeds: torch.Tensor,
             idx_chunk: torch.Tensor, noise: torch.Tensor) -> torch.Tensor:
        """The Gaussian-weighted per-frame loss of one micro-batch (JAX
        ``loss_fn``)."""
        t = latents.shape[2]
        idx = idx_chunk.long().repeat_interleave(self.chunk_size,
                                                 dim=1)[:, :t]  # [B, T]
        t_inhom = self.sched_timesteps[idx].to(self.device)
        sig = self.sched_sigmas[idx].to(self.device)[:, None, :, None, None]
        noise = noise.to(self.device)
        noisy = (1.0 - sig) * latents + sig * noise
        clean_x = latents.to(torch.bfloat16) if self.teacher_forcing else None
        pred = self.transformer.train_forward(
            noisy.to(torch.bfloat16), embeds.to(torch.bfloat16), t_inhom,
            clean_x=clean_x).float()
        if self.precondition_outputs:
            pred_x0 = noisy.float() - pred * sig
            err = pred_x0 - latents.float()
        else:
            err = pred - (noise - latents).float()
        per_frame = torch.mean(torch.square(err), dim=(1, 3, 4))  # [B, T]
        return torch.mean(per_frame * self.weights[idx].to(self.device))


def _build_df_pipeline(cfg: TrainRunConfig,
                       teacher_forcing: bool) -> DiffusionForcingPipeline:
    from fastvideo_tpu_torch.models.schedulers.flow_match_euler import (
        FlowMatchEulerDiscreteScheduler)

    targs = build_training_args(cfg)
    scheduler = FlowMatchEulerDiscreteScheduler(shift=cfg.model.flow_shift)
    scheduler.set_timesteps(1000)
    transformer = build_transformer(cfg.model, device=resolve_device(targs))
    mc = cfg.method_config
    return DiffusionForcingPipeline(
        transformer, scheduler, targs,
        chunk_size=mc.get("chunk_size"),
        min_timestep_ratio=float(mc.get("min_timestep_ratio", 0.0)),
        max_timestep_ratio=float(mc.get("max_timestep_ratio", 1.0)),
        precondition_outputs=bool(mc.get("precondition_outputs", True)),
        teacher_forcing=teacher_forcing)


@register_method
class DiffusionForcingSFTMethod(PipelineMethod):
    """Diffusion-forcing SFT of a causal student."""

    name = "dfsft"

    @classmethod
    def from_config(cls, cfg: TrainRunConfig) -> "DiffusionForcingSFTMethod":
        return cls(_build_df_pipeline(cfg, teacher_forcing=False))


@register_method
class TeacherForcingSFTMethod(PipelineMethod):
    """Teacher-forcing SFT: the noisy chunks also see a clean copy of the
    earlier chunks."""

    name = "tfsft"

    @classmethod
    def from_config(cls, cfg: TrainRunConfig) -> "TeacherForcingSFTMethod":
        return cls(_build_df_pipeline(cfg, teacher_forcing=True))
