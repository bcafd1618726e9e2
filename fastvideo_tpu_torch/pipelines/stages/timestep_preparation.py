"""Timestep preparation (port of
fastvideo_tpu/pipelines/stages/timestep_preparation.py): the pipeline's
flow shift, then either the fixed DMD timesteps (as sigmas, shift 1) or
``num_inference_steps`` scheduler steps."""

from __future__ import annotations

import numpy as np

from fastvideo_tpu_torch.fastvideo_args import FastVideoArgs
from fastvideo_tpu_torch.pipelines.batch import ForwardBatch
from fastvideo_tpu_torch.pipelines.stages.base import PipelineStage


class TimestepPreparationStage(PipelineStage):

    def __init__(self, scheduler, pipeline_config=None, *, device):
        self.scheduler = scheduler
        self.pipeline_config = pipeline_config
        self.device = device

    def forward(self, batch: ForwardBatch,
                fastvideo_args: FastVideoArgs) -> ForwardBatch:
        shift = None
        if self.pipeline_config is not None:
            shift = self.pipeline_config.flow_shift
        if fastvideo_args.flow_shift is not None:
            shift = fastvideo_args.flow_shift
        if shift is not None:
            self.scheduler.set_shift(shift)
        if batch.dmd_denoising_steps is not None:
            timesteps = np.asarray(batch.dmd_denoising_steps, dtype=np.float32)
            sigmas = timesteps / self.scheduler.num_train_timesteps
            self.scheduler.set_timesteps(sigmas=sigmas, shift=1.0)
        else:
            self.scheduler.set_timesteps(batch.num_inference_steps)
        batch.timesteps = self.scheduler.timesteps
        return batch
