"""model_index ``_class_name`` -> pipeline class (port of
fastvideo_tpu/pipelines/pipeline_registry.py, the Wan T2V, I2V, V2V and Lucy
Edit, causal Wan and TurboDiffusion entries)."""

from __future__ import annotations

from fastvideo_tpu_torch.pipelines.basic.turbodiffusion import (
    turbodiffusion_pipeline as turbo)
from fastvideo_tpu_torch.pipelines.basic.wan import wan_v2v_pipeline as v2v
from fastvideo_tpu_torch.pipelines.basic.wan.wan_pipeline import (
    WanCausalDMDPipeline, WanDMDPipeline, WanImageToVideoPipeline,
    WanPipeline)

_PIPELINES = {
    "WanPipeline": WanPipeline,
    "WanImageToVideoPipeline": WanImageToVideoPipeline,
    "WanDMDPipeline": WanDMDPipeline,
    "WanCausalDMDPipeline": WanCausalDMDPipeline,
    "CausalWanPipeline": WanCausalDMDPipeline,
    "WanVideoToVideoPipeline": v2v.WanVideoToVideoPipeline,
    "LucyEditPipeline": v2v.LucyEditPipeline,
    "TurboDiffusionPipeline": turbo.TurboDiffusionPipeline,
    "TurboDiffusionI2VPipeline": turbo.TurboDiffusionI2VPipeline,
}


def resolve_pipeline_cls(class_name: str, dmd: bool = False):
    if dmd and class_name == "WanPipeline":
        class_name = "WanDMDPipeline"
    if class_name not in _PIPELINES:
        raise ValueError(f"No pipeline registered for {class_name!r} in the "
                         f"port; known: {sorted(_PIPELINES)}")
    return _PIPELINES[class_name]
