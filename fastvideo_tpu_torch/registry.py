"""Model path -> PipelineConfig class (port of fastvideo_tpu/registry.py).

Name fragments are matched in the JAX registry's priority order, over the
Wan-family configs: FastWan, the Wan T2V base (480p, and the T2V 14B's
720p form), Wan I2V (480p, 720p), Wan V2V, the Wan2.2 family (TI2V-5B,
T2V-A14B, Lucy Edit) and TurboDiffusion (T2V 1.3B and 14B, I2V). As in JAX,
"FastWan2.2-TI2V-5B" takes the FastWan config ("fastwan" outranks "wan2.2"
with "ti2v"), which has no TI2V task.
"""

from __future__ import annotations

import os

from fastvideo_tpu_torch.configs.pipelines import wan as wan_cfg
from fastvideo_tpu_torch.configs.pipelines.base import PipelineConfig

# (required name fragments, config class), highest priority first
_REGISTRY: list[tuple[tuple[str, ...], type[PipelineConfig]]] = [
    (("turbodiffusion", "i2v"), wan_cfg.TurboDiffusionI2VConfig),
    (("turbodiffusion", "14b"), wan_cfg.TurboDiffusionT2V14BConfig),
    (("turbodiffusion",), wan_cfg.TurboDiffusionT2VConfig),
    (("fastwan2.1", "t2v"), wan_cfg.FastWanT2V480PConfig),
    (("lucy-edit",), wan_cfg.LucyEditDevConfig),
    (("fastwan",), wan_cfg.FastWanT2V480PConfig),
    (("wan", "v2v"), wan_cfg.WanV2VConfig),
    (("wan2.2", "ti2v"), wan_cfg.Wan2_2_TI2V_5B_Config),
    (("wan2.2", "t2v"), wan_cfg.Wan2_2_T2V_A14B_Config),
    (("wan", "i2v", "720"), wan_cfg.WanI2V720PConfig),
    (("wan", "i2v"), wan_cfg.WanI2V480PConfig),
    (("wan", "t2v", "14b"), wan_cfg.WanT2V720PConfig),
    (("wan",), wan_cfg.WanT2V480PConfig),
]


def get_pipeline_config_cls_for_name(
        model_path: str) -> type[PipelineConfig] | None:
    name = os.path.basename(os.path.normpath(model_path)) or model_path
    for frags, cls in _REGISTRY:
        for candidate in (name.lower(), model_path.lower()):
            if all(f in candidate for f in frags):
                return cls
    return None
