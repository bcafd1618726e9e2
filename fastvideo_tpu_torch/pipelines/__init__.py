"""Pipelines: ``build_pipeline`` reads model_index.json and builds the
registered pipeline class on one device."""

from __future__ import annotations

import logging
import os

import torch

from fastvideo_tpu_torch.fastvideo_args import FastVideoArgs
from fastvideo_tpu_torch.models.loader.safetensors_io import load_json_config
from fastvideo_tpu_torch.pipelines.batch import ForwardBatch
from fastvideo_tpu_torch.pipelines.composed import ComposedPipelineBase
from fastvideo_tpu_torch.pipelines.pipeline_registry import (
    resolve_pipeline_cls)

logger = logging.getLogger(__name__)

__all__ = ["ForwardBatch", "ComposedPipelineBase", "build_pipeline"]


def build_pipeline(fastvideo_args: FastVideoArgs,
                   device: torch.device) -> ComposedPipelineBase:
    model_path = fastvideo_args.model_path
    index_path = os.path.join(model_path, "model_index.json")
    if not os.path.exists(index_path):
        raise FileNotFoundError(
            f"{index_path} not found: expected a diffusers-format checkpoint "
            "directory")
    class_name = load_json_config(index_path).get("_class_name",
                                                  "WanPipeline")
    cfg = fastvideo_args.pipeline_config
    pipeline_cls = resolve_pipeline_cls(
        class_name, dmd=bool(cfg is not None and cfg.dmd_denoising_steps))
    logger.info("Building pipeline %s for %s", pipeline_cls.__name__,
                class_name)
    return pipeline_cls(model_path, fastvideo_args, device)
