"""Denoising stages (port of fastvideo_tpu/pipelines/stages/denoising.py).

Only the 3-step DMD sampler is ported: per step, predict x0 with a flow
update to sigma 0, then renoise to the next step's sigma with noise drawn
from CPU generators seeded ``seed + i + 1`` (the JAX package's
``FASTVIDEO_DEVICE_RNG=0`` path). The 50-step sampler raises until
FlowUniPC's ``step`` is ported.
"""

from __future__ import annotations

import torch

from fastvideo_tpu_torch.attention.backends.abstract import AttentionMetadata
from fastvideo_tpu_torch.fastvideo_args import FastVideoArgs
from fastvideo_tpu_torch.forward_context import set_forward_context
from fastvideo_tpu_torch.pipelines.batch import ForwardBatch
from fastvideo_tpu_torch.pipelines.stages.base import PipelineStage
from fastvideo_tpu_torch.pipelines.stages.latent_preparation import (
    randn_like_reference)


class DenoisingStage(PipelineStage):

    def __init__(self, transformer, scheduler, pipeline_config=None, *,
                 device):
        self.transformer = transformer
        self.scheduler = scheduler
        self.pipeline_config = pipeline_config
        self.device = device

    def _target_dtype(self) -> torch.dtype:
        if self.pipeline_config is None or \
                self.pipeline_config.precision == "bf16":
            return torch.bfloat16
        return torch.float32

    @staticmethod
    def _attn_metadata(fastvideo_args: FastVideoArgs):
        """Per-step sparse-attention metadata: the VSA sparsity."""
        if not fastvideo_args.VSA_sparsity:
            return None
        return AttentionMetadata(
            extra={"VSA_sparsity": float(fastvideo_args.VSA_sparsity)})

    def forward(self, batch: ForwardBatch,
                fastvideo_args: FastVideoArgs) -> ForwardBatch:
        raise NotImplementedError(
            "the multistep (FlowUniPC) denoising loop is not ported yet; the "
            "port runs the DMD sampler (DmdDenoisingStage)")


class DmdDenoisingStage(DenoisingStage):
    """3-step distilled sampling."""

    def forward(self, batch: ForwardBatch,
                fastvideo_args: FastVideoArgs) -> ForwardBatch:
        target_dtype = self._target_dtype()
        latents = batch.latents
        pos_ctx = batch.prompt_embeds[0].to(target_dtype)
        timesteps = list(batch.timesteps)
        num_train = self.scheduler.num_train_timesteps
        sigmas = [float(t) / num_train for t in timesteps]
        attn_metadata = self._attn_metadata(fastvideo_args)
        for i, t in enumerate(timesteps):
            t_arr = torch.full((latents.shape[0],), float(t),
                               dtype=torch.float32, device=latents.device)
            if attn_metadata is not None:
                attn_metadata.current_timestep = i
            with set_forward_context(current_timestep=i,
                                     attn_metadata=attn_metadata,
                                     forward_batch=batch):
                flow_pred = self.transformer(latents.to(target_dtype),
                                             pos_ctx, t_arr)
            x0 = latents.float() - sigmas[i] * flow_pred.float()
            if i < len(timesteps) - 1:
                next_sigma = sigmas[i + 1]
                noise = randn_like_reference(
                    tuple(latents.shape),
                    [s + i + 1 for s in (batch.seeds or [0])]).to(
                        latents.device)
                latents = (1.0 - next_sigma) * x0 + next_sigma * noise
            else:
                latents = x0
        batch.latents = latents
        return batch
