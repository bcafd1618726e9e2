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
    image_encoder_config: ModelConfig | None = None
    postprocess_text_funcs: tuple[Callable, ...] = ()

    flow_shift: float | None = None
    dmd_denoising_steps: list[int] | None = None

    precision: str = "bf16"
    vae_precision: str = "fp32"
    vae_decode_precision: str = "bf16"
    text_encoder_precisions: tuple[str, ...] = ("fp32",)

    # Wan2.2 TI2V-5B: the request's image replaces latent frame 0, and its
    # tokens take timestep 0
    ti2v_task: bool = False
    # Lucy Edit (the Wan2.2 5B editing model): [noise | video] on the
    # channels and per-token (uniform) timesteps
    lucy_edit_task: bool = False
    # Wan2.2 MoE: the boundary (a share of the training timesteps) at which
    # the high-noise expert hands over to the low-noise one (None: one
    # expert)
    boundary_ratio: float | None = None
