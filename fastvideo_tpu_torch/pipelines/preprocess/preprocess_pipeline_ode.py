"""ODE-trajectory preprocess: captions -> teacher denoising trajectories
(port of fastvideo_tpu/pipelines/preprocess/preprocess_pipeline_ode.py).

The teacher DiT samples each text-only prompt with a flow-match Euler
solver over ``SelfForcingFlowMatchScheduler(shift=5, sigma_min=0,
extra_one_step=True)``, with classifier-free guidance against the negative
prompt, and the latents after every step are recorded with the matching
timesteps (``SCHEMA_ODE``): the data that sparse-distillation students
regress onto. Each DiT pass runs in bf16; the guidance combine and the
step ``x + (s' - s) v`` in fp32. The trajectory fills a preallocated
[S, C, T, h, w] fp32 buffer on the device, one step at a time.
"""

from __future__ import annotations

import logging
import os
import time
from collections.abc import Iterable

import numpy as np
import torch

from fastvideo_tpu_torch.dataset.parquet import (SCHEMA_ODE,
                                                 record_from_ode_sample)
from fastvideo_tpu_torch.pipelines.preprocess.preprocess_pipeline import (
    PreprocessPipeline, module_device)
from fastvideo_tpu_torch.pipelines.stages.latent_preparation import (
    randn_like_reference)

logger = logging.getLogger(__name__)


class PreprocessPipelineODE(PreprocessPipeline):
    """Teacher-trajectory collection over text-only records."""

    schema = SCHEMA_ODE

    def __init__(self, vae, text_encoder, tokenizer, transformer,
                 scheduler=None, num_inference_steps: int = 48,
                 guidance_scale: float = 6.0, negative_prompt: str = "",
                 latent_shape: tuple[int, ...] = (16, 21, 60, 104),
                 text_len: int = 512, samples_per_file: int = 8,
                 seed: int = 42):
        super().__init__(vae, text_encoder, tokenizer, text_len=text_len,
                         samples_per_file=samples_per_file)
        if scheduler is None:
            from fastvideo_tpu_torch.models.schedulers.\
                scheduling_self_forcing_flow_match import (
                    SelfForcingFlowMatchScheduler)

            scheduler = SelfForcingFlowMatchScheduler(
                shift=5.0, sigma_min=0.0, extra_one_step=True)
        scheduler.set_timesteps(num_inference_steps, denoising_strength=1.0)
        self.scheduler = scheduler
        self.transformer = transformer
        self.guidance_scale = float(guidance_scale)
        self.negative_prompt = negative_prompt
        self.latent_shape = tuple(latent_shape)
        self.seed = seed
        self.stats.update(sample_s=0.0, steps=0)

    @torch.inference_mode()
    def sample(self, latents: torch.Tensor, embeds: torch.Tensor,
               neg_embeds: torch.Tensor) -> torch.Tensor:
        """latents [B, C, T, h, w] -> the trajectory [S, B, C, T, h, w]
        fp32: the latents after each solver step."""
        device = latents.device
        sigmas = torch.as_tensor(np.asarray(self.scheduler.sigmas),
                                 dtype=torch.float32, device=device)
        timesteps = np.asarray(self.scheduler.timesteps, np.float32)
        steps = torch.cat([sigmas[1:], sigmas.new_zeros(1)]) - sigmas
        x = latents.to(torch.float32)
        traj = torch.empty((len(timesteps), *x.shape), dtype=torch.float32,
                           device=device)
        cond = embeds.to(torch.bfloat16)
        uncond = neg_embeds.to(torch.bfloat16)
        for i, t in enumerate(timesteps):
            tb = torch.full((x.shape[0],), float(t), dtype=torch.float32,
                            device=device)
            xb = x.to(torch.bfloat16)
            v = self.transformer(xb, cond, tb).to(torch.float32)
            if self.guidance_scale > 1.0:
                v_u = self.transformer(xb, uncond, tb).to(torch.float32)
                v = v_u + self.guidance_scale * (v - v_u)
            x = x + steps[i] * v
            traj[i] = x
        return traj

    def collect_trajectory(self, embeds: np.ndarray,
                           sample_seed: int) -> np.ndarray:
        """[S, C, T, h, w] fp32 trajectory of one prompt's embedding."""
        device = module_device(self.transformer)
        neg = self.encode_text(self.negative_prompt)
        t0 = time.perf_counter()
        latents = randn_like_reference((1, *self.latent_shape),
                                       [sample_seed]).to(device)
        traj = self.sample(latents, torch.from_numpy(embeds)[None].to(device),
                           torch.from_numpy(neg)[None].to(device))
        out = traj[:, 0].cpu().numpy()
        self.stats["sample_s"] += time.perf_counter() - t0
        self.stats["steps"] += len(out)
        return out

    def run(self, samples: Iterable[dict], output_dir: str,
            fps: float = 16.0) -> int:
        """samples: iterable of {"id", "caption"} (text-only records)."""
        os.makedirs(output_dir, exist_ok=True)
        tsteps = np.asarray(self.scheduler.timesteps, np.float32)
        records, total = [], 0
        for sample in samples:
            caption = sample.get("caption", "")
            if not caption.strip():
                continue
            embeds = self.encode_text(caption)
            traj = self.collect_trajectory(embeds, self.seed + total)
            records.append(
                record_from_ode_sample(str(sample.get("id", total)), embeds,
                                       traj, tsteps, caption=caption))
            total += 1
            self.stats["samples"] += 1
            if len(records) >= self.samples_per_file:
                self.write(records, output_dir)
                records = []
        if records:
            self.write(records, output_dir)
        logger.info("Collected %d ODE trajectories -> %s", total, output_dir)
        return total
