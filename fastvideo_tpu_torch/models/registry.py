"""Checkpoint class names -> (module class, arch config class), and
scheduler class names -> scheduler class."""

from __future__ import annotations

from fastvideo_tpu_torch.configs.models.dits.wan import WanArchConfig
from fastvideo_tpu_torch.configs.models.encoders.clip import (
    CLIPTextArchConfig, CLIPVisionArchConfig)
from fastvideo_tpu_torch.configs.models.encoders.t5 import T5ArchConfig
from fastvideo_tpu_torch.configs.models.vaes.wan import WanVAEArchConfig


def resolve_model_cls(class_name: str):
    if class_name == "WanTransformer3DModel":
        from fastvideo_tpu_torch.models.dits.wan import WanTransformer3DModel

        return WanTransformer3DModel, WanArchConfig
    if class_name == "CausalWanTransformer3DModel":
        from fastvideo_tpu_torch.models.dits.causal_wan import (
            CausalWanTransformer3DModel)

        return CausalWanTransformer3DModel, WanArchConfig
    if class_name == "AutoencoderKLWan":
        from fastvideo_tpu_torch.models.vaes.wan import AutoencoderKLWan

        return AutoencoderKLWan, WanVAEArchConfig
    if class_name in ("UMT5EncoderModel", "T5EncoderModel"):
        from fastvideo_tpu_torch.models.encoders.t5 import T5EncoderModel

        return T5EncoderModel, T5ArchConfig
    # a CLIPVisionModelWithProjection loads without its visual projection
    if class_name in ("CLIPVisionModel", "CLIPVisionModelWithProjection"):
        from fastvideo_tpu_torch.models.encoders.clip import CLIPVisionModel

        return CLIPVisionModel, CLIPVisionArchConfig
    if class_name in ("CLIPTextModel", "CLIPTextModelWithProjection"):
        from fastvideo_tpu_torch.models.encoders.clip import CLIPTextModel

        return CLIPTextModel, CLIPTextArchConfig
    raise ValueError(f"No model registered for {class_name!r} in the port")


def resolve_scheduler_cls(class_name: str):
    """The scheduler a ``scheduler_config.json`` names; ``None`` for a name
    the port does not have."""
    if class_name in ("UniPCMultistepScheduler",
                      "FlowUniPCMultistepScheduler"):
        from fastvideo_tpu_torch.models.schedulers.flow_unipc import (
            FlowUniPCMultistepScheduler)

        return FlowUniPCMultistepScheduler
    if class_name == "FlowMatchEulerDiscreteScheduler":
        from fastvideo_tpu_torch.models.schedulers.flow_match_euler import (
            FlowMatchEulerDiscreteScheduler)

        return FlowMatchEulerDiscreteScheduler
    if class_name == "RCMScheduler":
        from fastvideo_tpu_torch.models.schedulers.scheduling_rcm import (
            RCMScheduler)

        return RCMScheduler
    return None
