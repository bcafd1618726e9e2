"""Input validation and seed assignment (port of
fastvideo_tpu/pipelines/stages/input_validation.py): seeds are ``seed + i``
per video, and the noise later comes from CPU torch generators with those
seeds."""

from __future__ import annotations

from fastvideo_tpu_torch.fastvideo_args import FastVideoArgs
from fastvideo_tpu_torch.pipelines.batch import ForwardBatch
from fastvideo_tpu_torch.pipelines.stages.base import (PipelineStage,
                                                       StageVerificationError)


class InputValidationStage(PipelineStage):

    def __init__(self, device):
        self.device = device

    def forward(self, batch: ForwardBatch,
                fastvideo_args: FastVideoArgs) -> ForwardBatch:
        if batch.seed is None:
            batch.seed = 1024
        if batch.seed < 0:
            raise StageVerificationError(f"invalid seed {batch.seed}")
        n = max(1, int(batch.extra.get("num_videos_per_prompt", 1)))
        batch.seeds = [batch.seed + i for i in range(n)]
        if batch.height is None or batch.width is None:
            raise StageVerificationError("height/width required")
        if batch.height % 8 or batch.width % 8:
            raise StageVerificationError(
                f"height/width must be divisible by 8, got "
                f"{batch.height}x{batch.width}")
        if batch.prompt is None and not batch.prompt_embeds:
            raise StageVerificationError("prompt or prompt_embeds required")
        if batch.guidance_scale > 1.0:
            batch.do_classifier_free_guidance = True
        return batch
