"""Training run config, the YAML schema (port of
fastvideo_tpu/training/run_config.py), and the shared component builders.

``method`` resolves through the plugin registry (``training.methods``);
``build_dataloader`` reads ``data.path``'s latents Parquet shards with the
port's own reader.
"""

from __future__ import annotations

import dataclasses
import os
from dataclasses import dataclass, field
from typing import Any

import torch

from fastvideo_tpu_torch.fastvideo_args import TrainingArgs


@dataclass
class ModelSpec:
    pretrained_model_path: str = ""
    dit_precision: str = "fp32"
    flow_shift: float = 3.0


@dataclass
class DataSpec:
    path: str = ""
    batch_size: int = 1
    text_drop_rate: float = 0.0


@dataclass
class DMDSpec:
    dmd_denoising_steps: list[int] = field(
        default_factory=lambda: [1000, 757, 522])
    real_score_guidance_scale: float = 3.5
    dfake_gen_update_ratio: int = 5
    timestep_shift: float = 8.0


@dataclass
class TrainRunConfig:
    method: str = "sft"
    model: ModelSpec = field(default_factory=ModelSpec)
    data: DataSpec = field(default_factory=DataSpec)
    training: dict[str, Any] = field(default_factory=dict)
    dmd: DMDSpec = field(default_factory=DMDSpec)
    # method-specific free-form options, passed to Method.from_config
    method_config: dict[str, Any] = field(default_factory=dict)
    # named callbacks (training/callbacks.py), passed to method.train
    callbacks: dict[str, Any] = field(default_factory=dict)


def load_train_config(path: str) -> TrainRunConfig:
    from fastvideo_tpu_torch.api.parser import load_config_file

    return load_config_file(TrainRunConfig, path)


def build_training_args(cfg: TrainRunConfig) -> TrainingArgs:
    args_fields = {f.name for f in dataclasses.fields(TrainingArgs)}
    unknown = set(cfg.training) - args_fields
    if unknown:
        raise ValueError(f"Unknown training fields: {sorted(unknown)}")
    return TrainingArgs(**cfg.training)


def build_transformer(spec: ModelSpec, device: torch.device | str = "cuda",
                      arch_overrides: dict[str, Any] | None = None):
    """The DiT of a diffusers-format directory (its ``transformer/``),
    loaded trainable in ``spec.dit_precision`` on ``device``, with
    ``arch_overrides`` over its config.json."""
    from fastvideo_tpu_torch.models.loader.component_loader import (
        load_model_component)
    from fastvideo_tpu_torch.registry import get_pipeline_config_cls_for_name

    config_cls = get_pipeline_config_cls_for_name(spec.pretrained_model_path)
    dit_config = None
    if config_cls is not None:
        dit_config = config_cls(
            model_path=spec.pretrained_model_path).dit_config
    tdir = os.path.join(spec.pretrained_model_path, "transformer")
    return load_model_component(tdir, device=torch.device(device),
                                precision=spec.dit_precision,
                                model_config=dit_config, trainable=True,
                                arch_overrides=arch_overrides)


def build_dataloader(cfg: TrainRunConfig, training_args: TrainingArgs):
    """The latents Parquet dataloader of ``data.path`` (None without one)."""
    if not cfg.data.path:
        return None
    from fastvideo_tpu_torch.dataset.parquet import build_parquet_dataloader

    return build_parquet_dataloader(
        cfg.data.path, batch_size=cfg.data.batch_size,
        accum=training_args.gradient_accumulation_steps,
        text_drop_rate=cfg.data.text_drop_rate, seed=training_args.seed)
