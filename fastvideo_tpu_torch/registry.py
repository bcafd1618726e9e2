"""Model path -> PipelineConfig class (port of fastvideo_tpu/registry.py).

The port registers the FastWan name fragments: a path whose name holds
"fastwan2.1" and "t2v", or "fastwan", resolves FastWanT2V480PConfig.
"""

from __future__ import annotations

import os

from fastvideo_tpu_torch.configs.pipelines import wan as wan_cfg
from fastvideo_tpu_torch.configs.pipelines.base import PipelineConfig

# (required name fragments, config class), most specific first
_REGISTRY: list[tuple[tuple[str, ...], type[PipelineConfig]]] = [
    (("fastwan2.1", "t2v"), wan_cfg.FastWanT2V480PConfig),
    (("fastwan",), wan_cfg.FastWanT2V480PConfig),
]


def get_pipeline_config_cls_for_name(
        model_path: str) -> type[PipelineConfig] | None:
    name = os.path.basename(os.path.normpath(model_path)) or model_path
    for frags, cls in _REGISTRY:
        for candidate in (name.lower(), model_path.lower()):
            if all(f in candidate for f in frags):
                return cls
    return None
