"""Model config hierarchy (port of fastvideo_tpu/configs/models/base.py):
an ``ArchConfig`` of architecture hyperparameters, filled from the HF
config.json, wrapped by a ``ModelConfig`` with the checkpoint key mapping.
"""

from __future__ import annotations

import dataclasses
from typing import Any


@dataclasses.dataclass
class ArchConfig:
    """Architecture hyperparameters; populated from the HF config.json."""

    def update_from_hf(self, hf_config: dict[str, Any]) -> None:
        """Overwrite fields present in a HF diffusers/transformers config."""
        for f in dataclasses.fields(self):
            if f.name in hf_config:
                val = hf_config[f.name]
                if isinstance(val, list) and isinstance(
                        getattr(self, f.name), tuple):
                    val = tuple(val)
                setattr(self, f.name, val)
        # re-derive fields computed from the overridden ones
        post = getattr(self, "__post_init__", None)
        if post is not None:
            post()


@dataclasses.dataclass
class ModelConfig:
    arch_config: ArchConfig = dataclasses.field(default_factory=ArchConfig)
    precision: str = "bf16"
    # regex tables mapping checkpoint names -> module paths
    param_names_mapping: dict[str, str] = dataclasses.field(
        default_factory=dict)
    lora_param_names_mapping: dict[str, str] = dataclasses.field(
        default_factory=dict)

    def __getattr__(self, name: str) -> Any:
        # proxy the arch fields
        arch = object.__getattribute__(self, "arch_config")
        if hasattr(arch, name):
            return getattr(arch, name)
        raise AttributeError(
            f"{type(self).__name__} has no attribute {name!r}")


@dataclasses.dataclass
class DiTArchConfig(ArchConfig):
    pass


@dataclasses.dataclass
class VAEArchConfig(ArchConfig):
    pass


@dataclasses.dataclass
class EncoderArchConfig(ArchConfig):
    pass
