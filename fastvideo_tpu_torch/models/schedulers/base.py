"""Scheduler base types (port of fastvideo_tpu/models/schedulers/base.py)."""

from __future__ import annotations

import dataclasses
from typing import Any

import torch


@dataclasses.dataclass
class SchedulerOutput:
    prev_sample: torch.Tensor


class BaseScheduler:
    """Minimal diffusers-like surface: set_timesteps / step."""

    order = 1

    def set_timesteps(self, num_inference_steps: int, **kwargs) -> None:
        raise NotImplementedError

    def step(self, model_output: torch.Tensor, timestep: Any,
             sample: torch.Tensor, **kwargs) -> SchedulerOutput:
        raise NotImplementedError
