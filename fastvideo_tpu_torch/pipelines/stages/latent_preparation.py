"""Latent preparation (port of
fastvideo_tpu/pipelines/stages/latent_preparation.py): initial noise drawn
per seed from a CPU ``torch.Generator`` (diffusers ``randn_tensor``
semantics), so the latents equal the JAX package's at a fixed seed. The
latent grid is the frame divided by the VAE's ``scale_factor_spatial``
times its ``patch_size`` (Wan2.2), as in JAX."""

from __future__ import annotations

import torch

from fastvideo_tpu_torch.fastvideo_args import FastVideoArgs
from fastvideo_tpu_torch.pipelines.batch import ForwardBatch
from fastvideo_tpu_torch.pipelines.stages.base import PipelineStage


def randn_like_reference(shape: tuple[int, ...],
                         seeds: list[int]) -> torch.Tensor:
    """One CPU generator per seed, each drawing a [1, *shape[1:]] sample."""
    outs = []
    for seed in seeds:
        g = torch.Generator("cpu").manual_seed(int(seed))
        outs.append(torch.randn((1, *shape[1:]), generator=g,
                                dtype=torch.float32))
    return torch.cat(outs, dim=0)


class LatentPreparationStage(PipelineStage):

    def __init__(self, vae_config=None, *, device):
        self.vae_config = vae_config
        self.device = device

    def latent_shape(self, batch: ForwardBatch) -> tuple[int, ...]:
        sf_t, sf_s, z_dim = 4, 8, 16
        if self.vae_config is not None:
            arch = self.vae_config.arch_config
            sf_t, sf_s, z_dim = (arch.scale_factor_temporal,
                                 arch.scale_factor_spatial, arch.z_dim)
            # JAX's rule: the config's spatial factor times the patch (a
            # config that counts the patch in its factor divides twice)
            if arch.patch_size:
                sf_s *= arch.patch_size
        num_latent_frames = (batch.num_frames - 1) // sf_t + 1
        batch_size = len(batch.seeds or [0]) * (
            len(batch.prompt) if isinstance(batch.prompt, list) else 1)
        return (batch_size, z_dim, num_latent_frames, batch.height // sf_s,
                batch.width // sf_s)

    def forward(self, batch: ForwardBatch,
                fastvideo_args: FastVideoArgs) -> ForwardBatch:
        if batch.latents is not None:
            return batch
        shape = self.latent_shape(batch)
        seeds = batch.seeds or [batch.seed or 0]
        batch.latents = randn_like_reference(shape, seeds).to(self.device)
        return batch

