"""CLIP encoder configs (port of fastvideo_tpu/configs/models/encoders/clip.py
and of the text config in fastvideo_tpu/models/encoders/clip.py).

The vision tower (``CLIPVisionModel`` and ``CLIPVisionModelWithProjection``,
which load as the same module: it takes no visual projection) and the text
tower (``CLIPTextModel``; ``CLIPTextModelWithProjection`` when
``projection_dim`` is set: a bias-free ``text_projection`` of the pooled
token). Fields are filled from the HF config.json.
"""

from __future__ import annotations

import dataclasses

from fastvideo_tpu_torch.configs.models.base import (EncoderArchConfig,
                                                     ModelConfig)

# HF checkpoint names -> the port's module paths (mostly identity)
CLIP_VISION_PARAM_NAMES_MAPPING: dict[str, str] = {
    r"^vision_model\.encoder\.layers\.(.*)$": r"vision_model.layers.\1",
    r"^vision_model\.(.*)$": r"vision_model.\1",
}
CLIP_TEXT_PARAM_NAMES_MAPPING: dict[str, str] = {
    r"^text_model\.encoder\.layers\.(.*)$": r"text_model.layers.\1",
    r"^text_model\.(.*)$": r"text_model.\1",
}


@dataclasses.dataclass
class CLIPVisionArchConfig(EncoderArchConfig):
    hidden_size: int = 1280
    intermediate_size: int = 5120
    num_hidden_layers: int = 32
    num_attention_heads: int = 16
    image_size: int = 224
    patch_size: int = 14
    num_channels: int = 3
    hidden_act: str = "gelu"
    layer_norm_eps: float = 1e-5
    projection_dim: int = 1024

    # preprocessing
    image_mean: tuple[float, ...] = (0.48145466, 0.4578275, 0.40821073)
    image_std: tuple[float, ...] = (0.26862954, 0.26130258, 0.27577711)


@dataclasses.dataclass
class CLIPVisionConfig(ModelConfig):
    arch_config: CLIPVisionArchConfig = dataclasses.field(
        default_factory=CLIPVisionArchConfig)
    param_names_mapping: dict[str, str] = dataclasses.field(
        default_factory=lambda: dict(CLIP_VISION_PARAM_NAMES_MAPPING))


@dataclasses.dataclass
class CLIPTextArchConfig(EncoderArchConfig):
    vocab_size: int = 49408
    hidden_size: int = 768
    intermediate_size: int = 3072
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    max_position_embeddings: int = 77
    hidden_act: str = "quick_gelu"
    layer_norm_eps: float = 1e-5
    eos_token_id: int = 49407
    text_len: int = 77
    # non-zero: CLIPTextModelWithProjection (a bias-free text_projection)
    projection_dim: int = 0


@dataclasses.dataclass
class CLIPTextConfig(ModelConfig):
    arch_config: CLIPTextArchConfig = dataclasses.field(
        default_factory=CLIPTextArchConfig)
    param_names_mapping: dict[str, str] = dataclasses.field(
        default_factory=lambda: dict(CLIP_TEXT_PARAM_NAMES_MAPPING))
