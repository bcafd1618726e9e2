"""Denoising stages (port of fastvideo_tpu/pipelines/stages/denoising.py).

``DenoisingStage`` is the multistep sampler of the Wan T2V, I2V, V2V and
Wan2.2 paths: per step a transformer pass on the prompt, with
classifier-free guidance a second pass on the negative prompt (or the
cached cond-uncond delta), the CFG combine, optional guidance rescale, then
``scheduler.step`` in fp32. I2V feeds [noise | image_latent] on the
channels and the CLIP image embeds to both passes; V2V feeds [noise |
video_latent | zeros], Lucy Edit [noise | video_latent] with a timestep
per token. Wan2.2 TI2V (a ``ti2v_task`` config and a request with
``pil_image``) encodes the image into latent frame 0, re-imposes it after
every step and gives its tokens timestep 0. With ``transformer_2`` and a
config ``boundary_ratio`` (the T2V-A14B) each step runs the high-noise
expert (``transformer``) at timesteps at or above the boundary and the
low-noise one (``transformer_2``) below it; the request's own
``boundary_ratio`` is carried and not read, as in JAX. The branches of the
JAX stage for other pipelines (embedded guidance, camera and action
inputs) raise.

``DmdDenoisingStage`` is the 3-step DMD sampler: per step, predict x0 with a
flow update to sigma 0, then renoise to the next step's sigma with noise
drawn from CPU generators seeded ``seed + i + 1`` (the JAX package's
``FASTVIDEO_DEVICE_RNG=0`` path).
"""

from __future__ import annotations

import numpy as np
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
                 device, transformer_2=None, vae=None):
        self.transformer = transformer
        self.transformer_2 = transformer_2
        self.scheduler = scheduler
        self.pipeline_config = pipeline_config
        self.device = device
        self.vae = vae  # TI2V's first-frame encode

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
    _UNPORTED_INPUTS = ("use_embedded_guidance", "y_camera",
                        "c2ws_plucker_emb", "mouse_cond", "keyboard_cond")

    def _check_ported(self, batch: ForwardBatch) -> None:
        unported = [k for k in self._UNPORTED_INPUTS
                    if batch.extra.get(k) is not None]
        if unported:
            raise NotImplementedError(
                f"DenoisingStage: {unported} belong to pipelines that are "
                "not ported (embedded guidance, camera and action inputs); "
                "the port runs Wan T2V, I2V, V2V and the Wan2.2 family")

    def _task(self, name: str) -> bool:
        return bool(self.pipeline_config is not None
                    and getattr(self.pipeline_config, name, False))

    def _model_input(self, batch: ForwardBatch,
                     latents: torch.Tensor) -> torch.Tensor:
        """The DiT's input: the latents, with V2V's [video_latent | zeros]
        (Lucy Edit's video_latent alone) or I2V's image_latent after them
        on the channels."""
        if batch.video_latent is not None:
            video = batch.video_latent.to(latents.dtype)
            if self._task("lucy_edit_task"):
                return torch.cat([latents, video], dim=1)
            return torch.cat([latents, video, torch.zeros_like(latents)],
                             dim=1)
        if batch.image_latent is not None:
            return torch.cat([latents, batch.image_latent.to(latents.dtype)],
                             dim=1)
        return latents

    def _token_grid(self, latents: torch.Tensor) -> tuple[int, int]:
        """(tokens a latent frame, tokens) of the DiT's patch grid."""
        _, _, tt, h, w = latents.shape
        pt, ph, pw = self.pipeline_config.dit_config.arch_config.patch_size
        per_frame = (h // ph) * (w // pw)
        return per_frame, (tt // pt) * per_frame

    def _timesteps(self, t: float, latents: torch.Tensor,
                   ti2v: bool) -> torch.Tensor:
        """The DiT's timesteps for step timestep ``t``: [B], or [B, S] per
        token for TI2V (0 on latent frame 0's tokens) and Lucy Edit (all
        ``t``)."""
        b = latents.shape[0]
        kw = dict(dtype=torch.float32, device=latents.device)
        if not ti2v and not self._task("lucy_edit_task"):
            return torch.full((b,), float(t), **kw)
        per_frame, seq_len = self._token_grid(latents)
        ts = torch.full((seq_len,), float(t), **kw)
        if ti2v:
            ts[:per_frame] = 0.0
        return ts.expand(b, seq_len)

    def _ti2v_encode_first_frame(self, batch: ForwardBatch) -> torch.Tensor:
        """The request's image (``pil_image``, uint8 or [-1, 1] [H, W, 3])
        as one normalized latent frame [1, z, 1, h, w] (the posterior's
        mean, fp32), which TI2V puts in place of latent frame 0."""
        if batch.image_latent is not None:
            raise ValueError("TI2V carries no channel-concat image latent")
        if self.vae is None:
            raise ValueError("TI2V needs the VAE in the DenoisingStage")
        img = np.asarray(batch.pil_image)
        if img.dtype == np.uint8:
            img = img.astype(np.float32) / 127.5 - 1.0
        if img.ndim == 3:  # [H, W, 3] -> [1, 3, 1, H, W]
            img = img.transpose(2, 0, 1)[None, :, None]
        x = torch.from_numpy(np.ascontiguousarray(img, np.float32)).to(
            self.device)
        z = self.vae.encode(x).mean.permute(0, 4, 1, 2, 3)
        return self.vae.normalize_latents(z).float()

    @staticmethod
    def _ti2v_blend(latents: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
        return torch.cat([z.to(latents.dtype), latents[:, :, 1:]], dim=2)

    def _select_expert(self, t: float):
        """The DiT of step timestep ``t``: ``transformer`` unless the
        config has a ``boundary_ratio``, the stage has ``transformer_2``
        and t is below the boundary."""
        ratio = (self.pipeline_config.boundary_ratio
                 if self.pipeline_config is not None else None)
        if ratio is None or self.transformer_2 is None:
            return self.transformer
        boundary = ratio * self.scheduler.num_train_timesteps
        return self.transformer if t >= boundary else self.transformer_2

    def _predict(self, latents, ctx, t_arr, i, attn_metadata, batch,
                 image_embeds=None, model=None):
        if attn_metadata is not None:
            attn_metadata.current_timestep = i
        with set_forward_context(current_timestep=i,
                                 attn_metadata=attn_metadata,
                                 forward_batch=batch):
            return (model or self.transformer)(
                latents, ctx, t_arr, encoder_hidden_states_image=image_embeds)

    def forward(self, batch: ForwardBatch,
                fastvideo_args: FastVideoArgs) -> ForwardBatch:
        self._check_ported(batch)
        target_dtype = self._target_dtype()
        latents = batch.latents
        pos_ctx = batch.prompt_embeds[0].to(target_dtype)
        neg_ctx = (batch.negative_prompt_embeds[0].to(target_dtype)
                   if batch.negative_prompt_embeds else None)
        image_embeds = (batch.image_embeds[0].to(target_dtype)
                        if batch.image_embeds else None)
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
        ti2v = self._task("ti2v_task") and batch.pil_image is not None
        if ti2v:
            ti2v_z = self._ti2v_encode_first_frame(batch)
            latents = self._ti2v_blend(latents.float(), ti2v_z)
        for i, t in enumerate(timesteps):
            model = self._select_expert(float(t))
            t_arr = self._timesteps(float(t), latents, ti2v)
            model_in = self._model_input(batch, latents.to(target_dtype))
            noise_pred = self._predict(model_in, pos_ctx, t_arr, i,
                                       attn_metadata, batch, image_embeds,
                                       model)
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
                                                 attn_metadata, batch,
                                                 image_embeds, model)
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
            if ti2v:  # re-impose the conditioned first frame
                latents = self._ti2v_blend(latents, ti2v_z)
            if batch.return_trajectory_latents:
                trajectory.append(latents)

        batch.latents = latents
        if batch.return_trajectory_latents:
            batch.trajectory_latents = torch.stack(trajectory, dim=1)
            batch.trajectory_timesteps = timesteps
        return batch


class DmdDenoisingStage(DenoisingStage):
    """3-step distilled sampling; the I2V / V2V condition latents go on the
    channels as in ``DenoisingStage`` (the image embeds do not, as in
    JAX)."""

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
                flow_pred = self.transformer(
                    self._model_input(batch, latents.to(target_dtype)),
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
