"""PipelineStage base (port of fastvideo_tpu/pipelines/stages/base.py)."""

from __future__ import annotations

import torch

from fastvideo_tpu_torch.fastvideo_args import FastVideoArgs
from fastvideo_tpu_torch.pipelines.batch import ForwardBatch, timed_stage


class StageVerificationError(RuntimeError):
    pass


class PipelineStage:
    device: torch.device = torch.device("cpu")

    @property
    def name(self) -> str:
        return type(self).__name__

    def __call__(self, batch: ForwardBatch,
                 fastvideo_args: FastVideoArgs) -> ForwardBatch:
        with timed_stage(batch, self.name, self.device):
            return self.forward(batch, fastvideo_args)

    def forward(self, batch: ForwardBatch,
                fastvideo_args: FastVideoArgs) -> ForwardBatch:
        raise NotImplementedError
