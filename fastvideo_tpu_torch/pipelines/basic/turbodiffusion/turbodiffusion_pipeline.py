"""TurboDiffusion 1-4 step text-to-video (port of
fastvideo_tpu/pipelines/basic/turbodiffusion/turbodiffusion_pipeline.py).

The Wan stack sampled by the rCM scheduler (sigma_max 80). The published
checkpoints serve it with SLA attention and W8A8 linears:
``FASTVIDEO_ATTENTION_BACKEND=SLA_ATTN`` and ``transformer_quant="int8"``.
The I2V form (sigma_max 200) waits for the image-to-video slice.
"""

from __future__ import annotations

from fastvideo_tpu_torch.fastvideo_args import FastVideoArgs
from fastvideo_tpu_torch.models.schedulers.scheduling_rcm import RCMScheduler
from fastvideo_tpu_torch.pipelines.basic.wan.wan_pipeline import WanPipeline


class TurboDiffusionPipeline(WanPipeline):
    """T2V: rCM sampling over the Wan stack."""

    def initialize_pipeline(self, fastvideo_args: FastVideoArgs) -> None:
        self.modules["scheduler"] = RCMScheduler(sigma_max=80.0)


EntryClass = TurboDiffusionPipeline
