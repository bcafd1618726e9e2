"""VAE decoding (port of fastvideo_tpu/pipelines/stages/decoding.py):
denormalize the latents in fp32, decode in the configured decode precision
(bf16 by default), emit fp32 pixels in [-1, 1].

A clip whose full-resolution activations pass 7e8 elements decodes in the
chunks of the JAX package's dispatched decode (about 3.5e8 elements each:
the first latent frame alone, then 2 latent frames at a time at 480p). The
int8 decode convs take one scale per chunk tensor, so the chunks must be
the JAX package's for the numbers to be."""

from __future__ import annotations

import torch

from fastvideo_tpu_torch.fastvideo_args import FastVideoArgs
from fastvideo_tpu_torch.pipelines.batch import ForwardBatch
from fastvideo_tpu_torch.pipelines.stages.base import PipelineStage


def dispatched_chunk_frames(latents: torch.Tensor, vae_config) -> int | None:
    """Latent frames per decode chunk as the JAX DecodingStage picks them:
    None (one pass) up to 7e8 full-resolution elements by the VAE's scale
    factors and base width, else ``decode_dispatched``'s rule."""
    b, _, t, h, w = latents.shape
    st = getattr(vae_config, "scale_factor_temporal", 4) or 4
    ss = getattr(vae_config, "scale_factor_spatial", 8) or 8
    base = getattr(vae_config, "base_dim", 96) or 96
    if b * t * st * h * ss * w * ss * base <= 7e8:
        return None
    full_elems = b * t * 4 * h * 8 * w * 8 * 96
    return (max(1, int(3.5e8 / (full_elems / t)))
            if full_elems > 3.5e8 and t > 2 else t)


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
        batch.output = self.vae.decode(
            z.to(dtype),
            chunk_frames=dispatched_chunk_frames(z, self.vae.config))
        return batch
