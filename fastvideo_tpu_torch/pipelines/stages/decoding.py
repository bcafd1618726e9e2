"""VAE decoding (port of fastvideo_tpu/pipelines/stages/decoding.py):
denormalize the latents in fp32, decode in the configured decode precision
(bf16 by default), emit fp32 pixels in [-1, 1]."""

from __future__ import annotations

import torch

from fastvideo_tpu_torch.fastvideo_args import FastVideoArgs
from fastvideo_tpu_torch.pipelines.batch import ForwardBatch
from fastvideo_tpu_torch.pipelines.stages.base import PipelineStage


class DecodingStage(PipelineStage):

    def __init__(self, vae, pipeline_config=None, *, device):
        self.vae = vae
        self.pipeline_config = pipeline_config
        self.device = device

    def forward(self, batch: ForwardBatch,
                fastvideo_args: FastVideoArgs) -> ForwardBatch:
        precision = (self.pipeline_config.vae_decode_precision
                     if self.pipeline_config is not None else "bf16")
        dtype = torch.float32 if precision == "fp32" else torch.bfloat16
        z = self.vae.denormalize_latents(batch.latents)
        batch.output = self.vae.decode(z.to(dtype))
        return batch
