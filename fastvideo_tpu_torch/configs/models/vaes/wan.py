"""Wan VAE architecture config (port of
fastvideo_tpu/configs/models/vaes/wan.py; Wan2.1 defaults)."""

from __future__ import annotations

import dataclasses

import numpy as np

from fastvideo_tpu_torch.configs.models.base import ModelConfig, VAEArchConfig

# diffusers nests WanResample's spatial conv in a Sequential (`resample.1`)
WAN_VAE_PARAM_NAMES_MAPPING: dict[str, str] = {
    r"^(.*)\.resample\.1\.(weight|bias)$": r"\1.resample_conv.\2",
}


@dataclasses.dataclass
class WanVAEArchConfig(VAEArchConfig):
    base_dim: int = 96
    decoder_base_dim: int | None = None
    z_dim: int = 16
    dim_mult: tuple[int, ...] = (1, 2, 4, 4)
    num_res_blocks: int = 2
    attn_scales: tuple[float, ...] = ()
    temperal_downsample: tuple[bool, ...] = (False, True, True)
    dropout: float = 0.0
    latents_mean: tuple[float, ...] = (
        -0.7571, -0.7089, -0.9113, 0.1075, -0.1745, 0.9653, -0.1517, 1.5508,
        0.4134, -0.0715, 0.5517, -0.3632, -0.1922, -0.9497, 0.2503, -0.2921)
    latents_std: tuple[float, ...] = (
        2.8184, 1.4541, 2.3275, 2.6558, 1.2196, 1.7708, 2.6052, 2.0743,
        3.2687, 2.1526, 2.8652, 1.5579, 1.6382, 1.1253, 2.8251, 1.9160)
    is_residual: bool = False
    in_channels: int = 3
    out_channels: int = 3
    patch_size: int | None = None
    scale_factor_temporal: int = 4
    scale_factor_spatial: int = 8
    clip_output: bool = True

    @property
    def spatial_compression_ratio(self) -> int:
        return self.scale_factor_spatial

    def latents_mean_arr(self) -> np.ndarray:
        return np.asarray(self.latents_mean, dtype=np.float32)

    def latents_std_arr(self) -> np.ndarray:
        return np.asarray(self.latents_std, dtype=np.float32)


@dataclasses.dataclass
class WanVAEConfig(ModelConfig):
    arch_config: WanVAEArchConfig = dataclasses.field(
        default_factory=WanVAEArchConfig)
    param_names_mapping: dict[str, str] = dataclasses.field(
        default_factory=lambda: dict(WAN_VAE_PARAM_NAMES_MAPPING))
