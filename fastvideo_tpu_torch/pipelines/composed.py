"""ComposedPipelineBase (port of fastvideo_tpu/pipelines/composed.py):
load the modules a pipeline needs from model_index.json's directory, then
compose and run its stages.

The pipeline makes (or joins) the device mesh when it is built, from
``fastvideo_args.mesh_config()``; its modules are built, and its stages
run, under that mesh."""

from __future__ import annotations

import logging
import os
from typing import Any

import torch

from fastvideo_tpu_torch.fastvideo_args import FastVideoArgs
from fastvideo_tpu_torch.models.loader.component_loader import (
    PipelineComponentLoader)
from fastvideo_tpu_torch.models.loader.safetensors_io import load_json_config
from fastvideo_tpu_torch.parallel import maybe_init_mesh, mesh_context
from fastvideo_tpu_torch.pipelines.batch import ForwardBatch
from fastvideo_tpu_torch.pipelines.stages.base import PipelineStage

logger = logging.getLogger(__name__)


class ComposedPipelineBase:
    # the modules the pipeline loads from the checkpoint; a caller may name
    # others (``required_config_modules``: the T2V-A14B's ``transformer_2``,
    # which no pipeline class names, as in JAX)
    _required_config_modules: list[str] = []

    def __init__(self, model_path: str, fastvideo_args: FastVideoArgs,
                 device: torch.device,
                 required_config_modules: list[str] | None = None):
        self.model_path = model_path
        self.fastvideo_args = fastvideo_args
        self.pipeline_config = fastvideo_args.pipeline_config
        self.device = device
        if required_config_modules is not None:
            self._required_config_modules = list(required_config_modules)
        self.modules: dict[str, Any] = {}
        self._stages: list[PipelineStage] = []
        self.mesh = maybe_init_mesh(fastvideo_args.mesh_config(),
                                    device=device)
        with mesh_context(self.mesh):
            self.load_modules()
            self.initialize_pipeline(fastvideo_args)
            self.create_pipeline_stages(fastvideo_args)

    def load_modules(self) -> None:
        """Load each module the pipeline names. A directory that is missing
        is an error when model_index.json lists the module, and otherwise
        leaves the module out (an I2V checkpoint without
        ``image_processor``), as in the JAX package."""
        model_index = load_json_config(
            os.path.join(self.model_path, "model_index.json"))
        for name in self._required_config_modules:
            component_dir = os.path.join(self.model_path, name)
            if not os.path.isdir(component_dir):
                if name not in model_index:
                    logger.warning("Optional module %s not present", name)
                    continue
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
        with torch.inference_mode(), mesh_context(self.mesh):
            for stage in self._stages:
                batch = stage(batch, fastvideo_args)
        return batch
