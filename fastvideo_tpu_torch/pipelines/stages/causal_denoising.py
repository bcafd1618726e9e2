"""Causal (self-forcing) denoising (port of
fastvideo_tpu/pipelines/stages/causal_denoising.py): block-autoregressive
generation. For each block of ``num_frames_per_block`` latent frames the
scheduler is reset and the block is denoised with the rolling KV caches
only read; then one clean pass at t = 0 commits the block's keys and values
into the caches. The text K/V of every layer is computed once per prompt.
The causal blocks call their attention directly, so no forward context is
set (the JAX stage sets one that nothing on this path reads).
"""

from __future__ import annotations

import torch

from fastvideo_tpu_torch.fastvideo_args import FastVideoArgs
from fastvideo_tpu_torch.layers.rotary import get_rotary_pos_embed_wan
from fastvideo_tpu_torch.pipelines.batch import ForwardBatch
from fastvideo_tpu_torch.pipelines.stages.base import PipelineStage


class CausalDenoisingStage(PipelineStage):

    def __init__(self, transformer, scheduler, pipeline_config=None, *,
                 device):
        self.transformer = transformer
        self.scheduler = scheduler
        self.pipeline_config = pipeline_config
        self.device = device

    def forward(self, batch: ForwardBatch,
                fastvideo_args: FastVideoArgs) -> ForwardBatch:
        cfg = self.transformer.config
        target_dtype = torch.bfloat16 if (
            self.pipeline_config is None
            or self.pipeline_config.precision == "bf16") else torch.float32
        latents = batch.latents.float()
        b, _, t, h, w = latents.shape
        pt, ph, pw = cfg.patch_size
        frame_seqlen = (h // ph) * (w // pw)
        nfpb = cfg.num_frames_per_block
        if t % nfpb != 0:
            raise ValueError(
                f"num latent frames {t} not divisible by block {nfpb}")
        ctx = batch.prompt_embeds[0].to(target_dtype)

        dit = self.transformer
        caches = dit.init_caches(b, frame_seqlen, target_dtype,
                                 device=latents.device)
        ca_caches = dit.precompute_crossattn_caches(ctx)

        out_blocks = []
        for blk in range(t // nfpb):
            s = blk * nfpb
            cur = latents[:, :, s:s + nfpb]
            freqs = get_rotary_pos_embed_wan(
                (nfpb // pt, h // ph, w // pw), cfg.attention_head_dim,
                cfg.rope_theta, start_frame=s, device=latents.device)
            self.scheduler.set_timesteps(batch.num_inference_steps)
            for t_cur in self.scheduler.timesteps:
                t_arr = torch.full((b,), float(t_cur), dtype=torch.float32,
                                   device=latents.device)
                pred, _ = dit.forward_block(
                    cur.to(target_dtype), ctx, t_arr, caches,
                    freqs_cis=freqs, crossattn_caches=ca_caches,
                    update_caches=False)
                cur = self.scheduler.step(pred.float(), t_cur,
                                          cur).prev_sample
            out_blocks.append(cur)
            # commit the clean block into the caches
            t_ctx = torch.zeros((b,), dtype=torch.float32,
                                device=latents.device)
            dit.forward_block(cur.to(target_dtype), ctx, t_ctx, caches,
                              freqs_cis=freqs, crossattn_caches=ca_caches)

        # the JAX stage also leaves the caches in batch.extra, which nothing
        # reads; here they are freed before the decode
        batch.latents = torch.cat(out_blocks, dim=2)
        return batch
