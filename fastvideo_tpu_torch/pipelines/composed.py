"""ComposedPipelineBase (port of fastvideo_tpu/pipelines/composed.py):
load the modules a pipeline needs from model_index.json's directory, then
compose and run its stages."""

from __future__ import annotations

import logging
import os
from typing import Any

import torch

from fastvideo_tpu_torch.fastvideo_args import FastVideoArgs
from fastvideo_tpu_torch.models.loader.component_loader import (
    PipelineComponentLoader)
from fastvideo_tpu_torch.pipelines.batch import ForwardBatch
from fastvideo_tpu_torch.pipelines.stages.base import PipelineStage

logger = logging.getLogger(__name__)


class ComposedPipelineBase:
    _required_config_modules: list[str] = []

    def __init__(self, model_path: str, fastvideo_args: FastVideoArgs,
                 device: torch.device):
        self.model_path = model_path
        self.fastvideo_args = fastvideo_args
        self.pipeline_config = fastvideo_args.pipeline_config
        self.device = device
        self.modules: dict[str, Any] = {}
        self._stages: list[PipelineStage] = []
        self.load_modules()
        self.initialize_pipeline(fastvideo_args)
        self.create_pipeline_stages(fastvideo_args)

    def load_modules(self) -> None:
        for name in self._required_config_modules:
            component_dir = os.path.join(self.model_path, name)
            if not os.path.isdir(component_dir):
                raise FileNotFoundError(
                    f"Pipeline module dir missing: {component_dir}")
            self.modules[name] = PipelineComponentLoader.load_module(
                name, component_dir, self.pipeline_config, self.device,
                self.fastvideo_args)
        logger.info("Loaded pipeline modules: %s", sorted(self.modules))

    def get_module(self, name: str):
        return self.modules.get(name)

    def initialize_pipeline(self, fastvideo_args: FastVideoArgs) -> None:
        pass

    def create_pipeline_stages(self, fastvideo_args: FastVideoArgs) -> None:
        raise NotImplementedError

    def add_stage(self, stage_name: str, stage: PipelineStage) -> None:
        self._stages.append(stage)
        setattr(self, stage_name, stage)

    @property
    def stages(self) -> list[PipelineStage]:
        return self._stages

    def forward(self, batch: ForwardBatch,
                fastvideo_args: FastVideoArgs) -> ForwardBatch:
        with torch.inference_mode():
            for stage in self._stages:
                batch = stage(batch, fastvideo_args)
        return batch
