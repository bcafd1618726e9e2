"""ForwardBatch: the data passed between stages (port of
fastvideo_tpu/pipelines/batch.py, the fields of the Wan T2V path)."""

from __future__ import annotations

import dataclasses
import time
from typing import Any

import torch


@dataclasses.dataclass
class PipelineLoggingInfo:
    """Per-stage wall times in seconds, keyed by stage class name."""

    stage_times: dict[str, float] = dataclasses.field(default_factory=dict)

    def record(self, stage: str, seconds: float) -> None:
        self.stage_times[stage] = self.stage_times.get(stage, 0.0) + seconds


@dataclasses.dataclass
class ForwardBatch:
    prompt: str | list[str] | None = None
    negative_prompt: str | list[str] | None = None

    # one entry per text encoder
    prompt_embeds: list[torch.Tensor] = dataclasses.field(default_factory=list)
    negative_prompt_embeds: list[torch.Tensor] = dataclasses.field(
        default_factory=list)
    do_classifier_free_guidance: bool = False

    latents: torch.Tensor | None = None

    timesteps: Any = None
    num_inference_steps: int = 50

    height: int | None = None
    width: int | None = None
    num_frames: int = 1

    seed: int | None = None
    seeds: list[int] | None = None
    guidance_scale: float = 1.0
    guidance_rescale: float = 0.0

    output: torch.Tensor | None = None
    return_trajectory_latents: bool = False
    # [B, steps, C, T, H, W] latents after each step, and their timesteps
    trajectory_latents: torch.Tensor | None = None
    trajectory_timesteps: list | None = None
    dmd_denoising_steps: list[int] | None = None

    extra: dict[str, Any] = dataclasses.field(default_factory=dict)
    logging_info: PipelineLoggingInfo = dataclasses.field(
        default_factory=PipelineLoggingInfo)

    # per-request VSA sparsity; 0 leaves FastVideoArgs.VSA_sparsity in force
    VSA_sparsity: float = 0.0

    def __post_init__(self) -> None:
        if self.seed is not None and self.seeds is None:
            self.seeds = [self.seed]


class timed_stage:
    """Records a stage's wall time into the batch; on a CUDA device it
    synchronizes first, so the time covers the stage's device work."""

    def __init__(self, batch: ForwardBatch, name: str, device: torch.device):
        self.batch = batch
        self.name = name
        self.device = device

    def __enter__(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.batch.logging_info.record(self.name,
                                       time.perf_counter() - self.t0)
        return False
