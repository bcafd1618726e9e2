"""Self-forcing distillation: causal DMD with an autoregressive rollout
(port of fastvideo_tpu/training/self_forcing_pipeline.py).

The causal generator denoises the clip block by block on its rolling KV
caches, as streaming inference does: each block's passes run at the
block's absolute RoPE positions and only read the caches; a commit pass
at t = 0 on the detached block writes them. The gradient flows through
one pass only, the last pass of the sampled grad block. The DMD
objective (the fake score's x0 against the CFG teacher's, on the
rolled-out clip re-noised) trains the generator; the critic trains with
flow matching on a second rollout that carries no gradient.

DMD2's conventions (``distillation_pipeline.py``): bf16 forwards on fp32
master weights, ``selective_checkpointing="full"`` through the DiT's
``gradient_checkpointing``, JAX's clipping and an AdamW per trained role,
and every draw from one CPU ``torch.Generator`` in ``draw``.

The score models run each full-clip pass on fresh caches that are never
allocated (``forward_block(kv_caches=None)``). The rollout's caches are
bf16 where JAX's are fp32: the forward computes keys and values in bf16
and JAX casts them to the queries' bf16 before attention, so both hold the
same values. Under grad the cached attention takes the grad route of
``models/dits/causal_wan.py`` (K1 and K6 over the gathered valid keys on
the card); the passes without a gradient take K5.
"""

from __future__ import annotations

from typing import Any

import torch

from fastvideo_tpu_torch.fastvideo_args import TrainingArgs
from fastvideo_tpu_torch.training.distillation_pipeline import (
    DMD2DistillationPipeline, DMDConfig, UpdateDraws)


class SelfForcingDistillationPipeline(DMD2DistillationPipeline):
    label = "self_forcing"

    def __init__(self, generator: torch.nn.Module,
                 real_score: torch.nn.Module, fake_score: torch.nn.Module,
                 training_args: TrainingArgs,
                 dmd_config: DMDConfig | None = None,
                 denoise_steps: tuple[int, ...] = (1000, 750, 500)):
        super().__init__(generator, real_score, fake_score, training_args,
                         dmd_config)
        self.denoise_steps = tuple(int(t) for t in denoise_steps)
        # the rollout's KV caches (fp32 in JAX, the same values)
        self.cache_dtype = torch.bfloat16

    # -- random numbers -------------------------------------------------------

    def _blocks(self, shape: tuple[int, ...]) -> int:
        return shape[2] // self.generator.config.num_frames_per_block

    def _update_draws(self, shape: tuple[int, ...]) -> UpdateDraws:
        """An update's draws: the rollout's fresh noises (``rollout[blk][i]``
        a block's noise after its step i, for every step but the last),
        the timestep integer and the target's noise (the rolled-out clip's
        shape)."""
        nfpb = self.generator.config.num_frames_per_block
        blocks = self._blocks(shape)
        block_shape = tuple(shape[:2]) + (nfpb,) + tuple(shape[3:])
        g = self.rng
        rollout = [[torch.randn(block_shape, generator=g, dtype=torch.float32)
                    for _ in self.denoise_steps[:-1]] for _ in range(blocks)]
        t_int = int(torch.randint(0, self.dmd.num_train_timestep, (1,),
                                  generator=g))
        video_shape = tuple(shape[:2]) + (blocks * nfpb,) + tuple(shape[3:])
        noise = torch.randn(video_shape, generator=g, dtype=torch.float32)
        return UpdateDraws(rollout, t_int, noise)

    # -- the rollout and the score models -------------------------------------

    def _denoise_pass(self, model, cur, embeds, t, caches, ca, start):
        pred, _ = model.forward_block(
            cur.to(torch.bfloat16), embeds.to(torch.bfloat16), t, caches, ca,
            start_frame=start, update_caches=False)
        return pred.float()

    def _commit(self, model, cur, embeds, caches, ca, start) -> None:
        """The clean pass at t = 0 on the detached block: writes the
        caches."""
        with torch.no_grad():
            model.forward_block(
                cur.detach().to(torch.bfloat16), embeds.to(torch.bfloat16),
                self._full_t(0.0, cur.shape[0]), caches, ca,
                start_frame=start, update_caches=True)

    def _rollout_blocks(self, model, caches, noise: torch.Tensor,
                        embeds: torch.Tensor, fresh, start: int,
                        grad_blocks) -> torch.Tensor:
        """Denoise ``noise`` [B, C, T, H, W] block by block on ``caches``
        from latent frame ``start``, committing each block. Where grad is
        on, the gradient flows through the last pass of the blocks in
        ``grad_blocks`` and nowhere else."""
        nfpb = model.config.num_frames_per_block
        steps = self.denoise_steps
        sigmas = [ts / self.dmd.num_train_timestep for ts in steps] + [0.0]
        grad_on = torch.is_grad_enabled()
        b = noise.shape[0]
        with torch.no_grad():
            ca = model.precompute_crossattn_caches(
                embeds.to(torch.bfloat16), torch.bfloat16)
        out = []
        for blk in range(noise.shape[2] // nfpb):
            s = start + blk * nfpb
            cur = noise[:, :, blk * nfpb:(blk + 1) * nfpb]
            for i, ts in enumerate(steps):
                last = i == len(steps) - 1
                grad = grad_on and last and blk in grad_blocks
                with torch.set_grad_enabled(grad):
                    # the grad pass projects the text K/V under grad
                    pred = self._denoise_pass(model, cur, embeds,
                                              self._full_t(ts, b), caches,
                                              None if grad else ca, s)
                    x0 = cur - sigmas[i] * pred
                del pred
                if last:
                    cur = x0
                else:
                    nsig = sigmas[i + 1]
                    cur = (1 - nsig) * x0 + nsig * fresh[blk][i].to(
                        self.device)
            out.append(cur)
            self._commit(model, cur, embeds, caches, ca, s)
        return torch.cat(out, dim=2)

    def _rollout(self, noise: torch.Tensor, embeds: torch.Tensor, fresh,
                 grad_block: int = -1) -> torch.Tensor:
        """The generator's block rollout on new caches; the gradient, where
        grad is on, through ``grad_block``'s last pass."""
        model = self.generator
        cfg = model.config
        _, _, _, h, w = noise.shape
        caches = model.init_caches(
            noise.shape[0], (h // cfg.patch_size[1]) * (w // cfg.patch_size[2]),
            self.cache_dtype, self.device)
        return self._rollout_blocks(model, caches, noise, embeds, fresh, 0,
                                    (grad_block,))

    def _score_pass(self, model, noisy: torch.Tensor, embeds: torch.Tensor,
                    t: torch.Tensor, start: int = 0) -> torch.Tensor:
        """A score model's flow prediction on the clip at once, on fresh
        caches from latent frame ``start`` (fp32)."""
        pred, _ = model.forward_block(
            noisy.to(torch.bfloat16), embeds.to(torch.bfloat16), t, None,
            start_frame=start, update_caches=False)
        return pred.float()

    def _pred_x0_clip(self, model, noisy, embeds, t, start: int = 0):
        return noisy - self._sigma(t, noisy.ndim) * self._score_pass(
            model, noisy, embeds, t, start)

    # -- the losses -----------------------------------------------------------

    def _dmd_loss(self, video: torch.Tensor, embeds: torch.Tensor,
                  neg_embeds: torch.Tensor, draws: UpdateDraws,
                  start: int = 0) -> torch.Tensor:
        """``0.5 mse(video, detach(video - grad))`` with the DMD gradient
        of the fake score against the CFG teacher on the re-noised clip."""
        dmd = self.dmd
        t = self._critic_timestep(draws.t_int, video.shape[0])
        sigma = self._sigma(t, video.ndim)
        with torch.no_grad():
            noisy = (1 - sigma) * video + sigma * draws.noise.to(self.device)
            x0_fake = self._pred_x0_clip(self.fake_score, noisy, embeds, t,
                                         start)
            x0_real_c = self._pred_x0_clip(self.real_score, noisy, embeds, t,
                                           start)
            x0_real_u = self._pred_x0_clip(self.real_score, noisy,
                                           neg_embeds, t, start)
            x0_real = x0_real_c + (
                x0_real_c - x0_real_u) * dmd.real_score_guidance_scale
            normalizer = torch.clamp(torch.mean(torch.abs(video - x0_real)),
                                     min=1e-6)
            target = video - torch.nan_to_num((x0_fake - x0_real) /
                                              normalizer)
        return 0.5 * torch.mean(torch.square(video - target))

    def _flow_matching_loss(self, video: torch.Tensor, embeds: torch.Tensor,
                            draws: UpdateDraws,
                            start: int = 0) -> torch.Tensor:
        """The fake score's flow-matching loss on the detached clip."""
        t = self._critic_timestep(draws.t_int, video.shape[0])
        sigma = self._sigma(t, video.ndim)
        n = draws.noise.to(self.device)
        noisy = (1 - sigma) * video + sigma * n
        v_pred = self._score_pass(self.fake_score, noisy, embeds, t, start)
        return torch.mean(torch.square(v_pred - (n - video)))

    def generator_loss(self, noise: torch.Tensor, embeds: torch.Tensor,
                       neg_embeds: torch.Tensor, draws: UpdateDraws,
                       grad_block: int = 0) -> torch.Tensor:
        video = self._rollout(noise, embeds, draws.rollout, grad_block)
        return self._dmd_loss(video, embeds, neg_embeds, draws)

    def critic_loss(self, noise: torch.Tensor, embeds: torch.Tensor,
                    draws: UpdateDraws) -> torch.Tensor:
        with torch.no_grad():
            video = self._rollout(noise, embeds, draws.rollout)
        return self._flow_matching_loss(video, embeds, draws)

    # -- public ---------------------------------------------------------------

    def train_one_step(self, embeds, neg_embeds,
                       latent_shape: tuple[int, ...]) -> dict[str, Any]:
        """A critic update every step, and before it a generator update
        through grad block ``(step // ratio) % blocks`` where ``step %
        ratio == 0``; ``latent_shape`` the noise's [B, C, T, H, W]."""
        embeds = torch.as_tensor(embeds, dtype=torch.float32).to(self.device)
        neg_embeds = torch.as_tensor(neg_embeds, dtype=torch.float32).to(
            self.device)
        ratio = self.dmd.dfake_gen_update_ratio
        gen_update = self.step % ratio == 0
        draws = self.draw(tuple(latent_shape), gen_update)
        noise = draws["noise"].to(self.device)
        metrics: dict[str, Any] = {}
        if gen_update:
            grad_block = (self.step // ratio) % self._blocks(latent_shape)
            loss = self.generator_loss(noise, embeds, neg_embeds,
                                       draws["generator"], grad_block)
            metrics["generator_grad_norm"] = self._update(
                loss, self.gen_params, self.gen_opt, self.gen_updates)
            metrics["generator_loss"] = float(loss.detach())
            metrics["grad_block"] = grad_block
            self.gen_updates += 1
        loss = self.critic_loss(noise, embeds, draws["critic"])
        metrics["critic_grad_norm"] = self._update(
            loss, self.fake_params, self.fake_opt, self.fake_updates)
        metrics["critic_loss"] = float(loss.detach())
        self.fake_updates += 1
        self.step += 1
        metrics["step"] = self.step
        return metrics
