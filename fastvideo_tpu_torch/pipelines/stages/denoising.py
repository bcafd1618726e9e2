"""Denoising stages (port of fastvideo_tpu/pipelines/stages/denoising.py).

``DenoisingStage`` is the multistep sampler of the Wan T2V path: per step a
transformer pass on the prompt, with classifier-free guidance a second pass
on the negative prompt (or the cached cond-uncond delta), the CFG combine,
optional guidance rescale, then ``scheduler.step`` in fp32. The branches of
the JAX stage for other pipelines (dual experts, TI2V, I2V/V2V channel
concat, embedded guidance, camera and action inputs) raise.

``DmdDenoisingStage`` is the 3-step DMD sampler: per step, predict x0 with a
flow update to sigma 0, then renoise to the next step's sigma with noise
drawn from CPU generators seeded ``seed + i + 1`` (the JAX package's
``FASTVIDEO_DEVICE_RNG=0`` path).
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
    def _build_attn_metadata(batch: ForwardBatch,
                             fastvideo_args: FastVideoArgs):
        """Per-step sparse-attention metadata: the VSA sparsity, the
        request's own where it sets one."""
        sparsity = batch.VSA_sparsity or fastvideo_args.VSA_sparsity
        if not sparsity:
            return None
        return AttentionMetadata(extra={"VSA_sparsity": float(sparsity)})

    # request inputs of pipelines the port does not have; the entry point
    # hands every sampling keyword it does not know to ``batch.extra``
    _UNPORTED_INPUTS = ("image_path", "pil_image", "video_path",
                        "boundary_ratio", "use_embedded_guidance", "y_camera",
                        "c2ws_plucker_emb", "mouse_cond", "keyboard_cond")

    def _check_ported(self, batch: ForwardBatch) -> None:
        unported = [k for k in self._UNPORTED_INPUTS
                    if batch.extra.get(k) is not None]
        if unported:
            raise NotImplementedError(
                f"DenoisingStage: {unported} belong to pipelines that are "
                "not ported (I2V/V2V/TI2V, dual experts, embedded guidance, "
                "camera and action inputs); the port runs Wan T2V")

    def _predict(self, latents, ctx, t_arr, i, attn_metadata, batch):
        if attn_metadata is not None:
            attn_metadata.current_timestep = i
        with set_forward_context(current_timestep=i,
                                 attn_metadata=attn_metadata,
                                 forward_batch=batch):
            return self.transformer(latents, ctx, t_arr)

    def forward(self, batch: ForwardBatch,
                fastvideo_args: FastVideoArgs) -> ForwardBatch:
        self._check_ported(batch)
        target_dtype = self._target_dtype()
        latents = batch.latents
        pos_ctx = batch.prompt_embeds[0].to(target_dtype)
        neg_ctx = (batch.negative_prompt_embeds[0].to(target_dtype)
                   if batch.negative_prompt_embeds else None)
        guidance = batch.guidance_scale
        do_cfg = batch.do_classifier_free_guidance and neg_ctx is not None

        timesteps = list(batch.timesteps)
        trajectory = []
        attn_metadata = self._build_attn_metadata(batch, fastvideo_args)
        if batch.extra.get("enable_teacache") and \
                "cfg_cache_interval" not in batch.extra:
            # TeaCache maps onto the delta-CFG cache: reuse the CFG delta on
            # alternating steps
            batch.extra["cfg_cache_interval"] = 2
        cfg_cache_interval = int(batch.extra.get("cfg_cache_interval", 1))
        cfg_delta = None
        for i, t in enumerate(timesteps):
            t_arr = torch.full((latents.shape[0],), float(t),
                               dtype=torch.float32, device=latents.device)
            model_in = latents.to(target_dtype)
            noise_pred = self._predict(model_in, pos_ctx, t_arr, i,
                                       attn_metadata, batch)
            if do_cfg:
                # delta caching: recompute the uncond pass only every
                # `cfg_cache_interval` steps and on the final step; in
                # between reuse the cached (cond - uncond) delta
                recompute = (cfg_cache_interval <= 1
                             or i % cfg_cache_interval == 0
                             or i == len(timesteps) - 1 or cfg_delta is None)
                noise_text = noise_pred
                if recompute:
                    noise_uncond = self._predict(model_in, neg_ctx, t_arr, i,
                                                 attn_metadata, batch)
                    cfg_delta = noise_pred - noise_uncond
                    noise_pred = noise_uncond + guidance * cfg_delta
                else:
                    noise_pred = noise_pred + (guidance - 1.0) * cfg_delta
                if batch.guidance_rescale and batch.guidance_rescale > 0:
                    # arXiv 2305.08891 section 3.4: rescale the combined
                    # prediction toward the text pass's std
                    dims = tuple(range(1, noise_pred.ndim))
                    std_t = noise_text.float().std(dim=dims, keepdim=True,
                                                   correction=0)
                    std_c = noise_pred.float().std(dim=dims, keepdim=True,
                                                   correction=0)
                    rescaled = noise_pred * (std_t / std_c)
                    gr = float(batch.guidance_rescale)
                    noise_pred = gr * rescaled + (1.0 - gr) * noise_pred
            latents = self.scheduler.step(noise_pred.float(), t,
                                          latents.float()).prev_sample
            if batch.return_trajectory_latents:
                trajectory.append(latents)

        batch.latents = latents
        if batch.return_trajectory_latents:
            batch.trajectory_latents = torch.stack(trajectory, dim=1)
            batch.trajectory_timesteps = timesteps
        return batch


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
        attn_metadata = self._build_attn_metadata(batch, fastvideo_args)
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
