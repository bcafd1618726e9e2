"""PipelineConfig (port of fastvideo_tpu/configs/pipelines/base.py): the
component model configs plus the denoising and precision knobs."""

from __future__ import annotations

import dataclasses
from collections.abc import Callable

from fastvideo_tpu_torch.configs.models.base import ModelConfig


@dataclasses.dataclass
class PipelineConfig:
    model_path: str = ""

    dit_config: ModelConfig | None = None
    vae_config: ModelConfig | None = None
    text_encoder_configs: tuple[ModelConfig, ...] = ()
    postprocess_text_funcs: tuple[Callable, ...] = ()

    flow_shift: float | None = None
    dmd_denoising_steps: list[int] | None = None

    precision: str = "bf16"
    vae_precision: str = "fp32"
    vae_decode_precision: str = "bf16"
    text_encoder_precisions: tuple[str, ...] = ("fp32",)
