"""Wan pipeline configs (port of fastvideo_tpu/configs/pipelines/wan.py):
the Wan T2V base and its 720p (T2V 14B) form, FastWan's 3-step DMD config,
the I2V (480p, 720p) and V2V configs, the Wan2.2 family (TI2V-5B, the
T2V-A14B's two experts, Lucy Edit), and TurboDiffusion's T2V (1.3B, 14B)
and I2V configs."""

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
class WanT2V720PConfig(WanT2V480PConfig):
    flow_shift: float | None = 5.0


@dataclasses.dataclass
class WanI2V480PConfig(WanT2V480PConfig):
    pass


@dataclasses.dataclass
class WanI2V720PConfig(WanI2V480PConfig):
    flow_shift: float | None = 5.0


@dataclasses.dataclass
class WanV2VConfig(WanT2V480PConfig):
    """Wan video-to-video: the DiT's input is [noise | video_latent |
    zeros] on the channels, the control clip a seeded posterior sample."""

    flow_shift: float | None = 5.0


@dataclasses.dataclass
class FastWanT2V480PConfig(WanT2V480PConfig):
    """FastWan 3-step DMD distilled sampling, bf16 text encoding."""

    flow_shift: float | None = 8.0
    dmd_denoising_steps: list[int] | None = dataclasses.field(
        default_factory=lambda: [1000, 757, 522])
    text_encoder_precisions: tuple = ("bf16",)


@dataclasses.dataclass
class Wan2_2_TI2V_5B_Config(WanT2V480PConfig):
    """Wan2.2 TI2V-5B: a request's image becomes latent frame 0."""

    flow_shift: float | None = 5.0
    ti2v_task: bool = True


@dataclasses.dataclass
class LucyEditDevConfig(WanT2V480PConfig):
    """Lucy Edit (the Wan2.2 5B editing model): [noise | video] on the
    channels (the checkpoint declares in_channels 2 z_dim), the control
    clip's posterior mode, per-token timesteps."""

    flow_shift: float | None = 5.0
    lucy_edit_task: bool = True

    def __post_init__(self) -> None:
        assert not (self.ti2v_task and self.lucy_edit_task)


@dataclasses.dataclass
class Wan2_2_T2V_A14B_Config(WanT2V480PConfig):
    """Wan2.2 MoE: two experts switched at a timestep boundary."""

    flow_shift: float | None = 12.0
    boundary_ratio: float | None = 0.875


@dataclasses.dataclass
class TurboDiffusionT2VConfig(WanT2V480PConfig):
    """TurboDiffusion 1-4 step rCM sampling; the pipeline installs the rCM
    scheduler."""

    flow_shift: float | None = 3.0


@dataclasses.dataclass
class TurboDiffusionT2V14BConfig(TurboDiffusionT2VConfig):
    flow_shift: float | None = 5.0


@dataclasses.dataclass
class TurboDiffusionI2VConfig(WanI2V480PConfig):
    """TurboDiffusion I2V rCM sampling (sigma_max 200, in the pipeline)."""

    flow_shift: float | None = 5.0
