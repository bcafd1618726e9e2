"""Model path -> PipelineConfig class (port of fastvideo_tpu/registry.py).

Name fragments are matched in the JAX registry's priority order. The port
has the Wan T2V 480p configs (FastWan, the 50-step base and TurboDiffusion
T2V), Wan I2V (480p, 720p), Wan V2V and TurboDiffusion I2V; a name that the
JAX registry resolves to a Wan-family config the port lacks (Wan2.2, the
T2V 14B, Lucy Edit, TurboDiffusion 14B) raises instead of falling through
to T2V.
"""

from __future__ import annotations

import os

from fastvideo_tpu_torch.configs.pipelines import wan as wan_cfg
from fastvideo_tpu_torch.configs.pipelines.base import PipelineConfig

# (required name fragments, config class or None where the port has none),
# highest priority first
_REGISTRY: list[tuple[tuple[str, ...], type[PipelineConfig] | None]] = [
    (("turbodiffusion", "i2v"), wan_cfg.TurboDiffusionI2VConfig),
    (("turbodiffusion", "14b"), None),
    (("turbodiffusion",), wan_cfg.TurboDiffusionT2VConfig),
    (("fastwan2.1", "t2v"), wan_cfg.FastWanT2V480PConfig),
    (("lucy-edit",), None),
    (("fastwan",), wan_cfg.FastWanT2V480PConfig),
    (("wan", "v2v"), wan_cfg.WanV2VConfig),
    (("wan2.2", "ti2v"), None),
    (("wan2.2", "t2v"), None),
    (("wan", "i2v", "720"), wan_cfg.WanI2V720PConfig),
    (("wan", "i2v"), wan_cfg.WanI2V480PConfig),
    (("wan", "t2v", "14b"), None),
    (("wan",), wan_cfg.WanT2V480PConfig),
]


def get_pipeline_config_cls_for_name(
        model_path: str) -> type[PipelineConfig] | None:
    name = os.path.basename(os.path.normpath(model_path)) or model_path
    for frags, cls in _REGISTRY:
        for candidate in (name.lower(), model_path.lower()):
            if all(f in candidate for f in frags):
                if cls is None:
                    raise NotImplementedError(
                        f"{model_path!r} names a pipeline config "
                        f"({' + '.join(frags)}) that is not ported (Wan2.2, "
                        "the T2V 14B, Lucy Edit and TurboDiffusion 14B: "
                        "ROADMAP Queue 1); the port has Wan2.1 T2V 480p, "
                        "FastWan, TurboDiffusion T2V and I2V, Wan2.1 I2V and "
                        "V2V")
                return cls
    return None
