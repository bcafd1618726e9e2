"""model_index ``_class_name`` -> pipeline class (port of
fastvideo_tpu/pipelines/pipeline_registry.py, the Wan, causal Wan and
TurboDiffusion T2V entries)."""

from __future__ import annotations

from fastvideo_tpu_torch.pipelines.basic.turbodiffusion import (
    turbodiffusion_pipeline as turbo)
from fastvideo_tpu_torch.pipelines.basic.wan.wan_pipeline import (
    WanCausalDMDPipeline, WanDMDPipeline, WanPipeline)

_PIPELINES = {
    "WanPipeline": WanPipeline,
    "WanDMDPipeline": WanDMDPipeline,
    "WanCausalDMDPipeline": WanCausalDMDPipeline,
    "CausalWanPipeline": WanCausalDMDPipeline,
    "TurboDiffusionPipeline": turbo.TurboDiffusionPipeline,
}


def resolve_pipeline_cls(class_name: str, dmd: bool = False):
    if dmd and class_name == "WanPipeline":
        class_name = "WanDMDPipeline"
    if class_name not in _PIPELINES:
        raise ValueError(f"No pipeline registered for {class_name!r} in the "
                         f"port; known: {sorted(_PIPELINES)}")
    return _PIPELINES[class_name]
