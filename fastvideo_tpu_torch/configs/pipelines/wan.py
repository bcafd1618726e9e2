"""Wan pipeline configs (port of fastvideo_tpu/configs/pipelines/wan.py):
the FastWan 3-step DMD config, the TurboDiffusion T2V config and their Wan
T2V base."""

from __future__ import annotations

import dataclasses

import torch

from fastvideo_tpu_torch.configs.models.dits.wan import WanVideoConfig
from fastvideo_tpu_torch.configs.models.encoders.t5 import T5Config
from fastvideo_tpu_torch.configs.models.vaes.wan import WanVAEConfig
from fastvideo_tpu_torch.configs.pipelines.base import PipelineConfig

TEXT_LEN = 512


def t5_postprocess_text(outputs) -> torch.Tensor:
    """Zero the padded positions and pad/trim to 512 tokens."""
    hidden = outputs.last_hidden_state
    mask = outputs.attention_mask
    if mask is not None:
        hidden = hidden * (mask[..., None] > 0).to(hidden.dtype)
    s = hidden.shape[1]
    if s < TEXT_LEN:
        return torch.nn.functional.pad(hidden, (0, 0, 0, TEXT_LEN - s))
    return hidden[:, :TEXT_LEN]


@dataclasses.dataclass
class WanT2V480PConfig(PipelineConfig):
    dit_config: WanVideoConfig = dataclasses.field(
        default_factory=WanVideoConfig)
    vae_config: WanVAEConfig = dataclasses.field(default_factory=WanVAEConfig)
    text_encoder_configs: tuple = dataclasses.field(
        default_factory=lambda: (T5Config(),))
    postprocess_text_funcs: tuple = dataclasses.field(
        default_factory=lambda: (t5_postprocess_text,))
    flow_shift: float | None = 3.0
    precision: str = "bf16"
    vae_precision: str = "fp32"
    vae_decode_precision: str = "bf16"
    text_encoder_precisions: tuple = ("fp32",)


@dataclasses.dataclass
class FastWanT2V480PConfig(WanT2V480PConfig):
    """FastWan 3-step DMD distilled sampling, bf16 text encoding."""

    flow_shift: float | None = 8.0
    dmd_denoising_steps: list[int] | None = dataclasses.field(
        default_factory=lambda: [1000, 757, 522])
    text_encoder_precisions: tuple = ("bf16",)


@dataclasses.dataclass
class TurboDiffusionT2VConfig(WanT2V480PConfig):
    """TurboDiffusion 1-4 step rCM sampling; the pipeline installs the rCM
    scheduler."""

    flow_shift: float | None = 3.0
