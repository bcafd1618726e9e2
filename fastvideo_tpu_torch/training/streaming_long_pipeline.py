"""LongLive-style multi-stage streaming self-forcing distillation (port of
fastvideo_tpu/training/streaming_long_pipeline.py).

A schedule of stages (``DistillStage``): a plain stage runs the
short-horizon self-forcing step on its ``num_latent_t`` frames; a
streaming stage trains on one persistent sequence, whose generator
produces chunk after chunk on its live rolling KV caches. A stream step
samples the chunk's new frames (block-aligned; the first chunk takes the
whole chunk size), rolls them out with the gradient through the last pass
of every block of the chunk, applies the DMD loss with the score models on
the chunk alone (fresh caches at the chunk's absolute positions), then the
critic's flow-matching loss on the same detached chunk. The stream starts
over when its stage changes or its length reaches the stage's maximum.

As in the JAX package, context rides on the generator's KV caches only
(no re-fed overlap latents). A step without a student update rolls the
chunk out without grad and skips the score models, whose outputs only the
student's loss reads (JAX evaluates and discards them).
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from fastvideo_tpu_torch.fastvideo_args import TrainingArgs
from fastvideo_tpu_torch.training.distillation_pipeline import (DMDConfig,
                                                                UpdateDraws)
from fastvideo_tpu_torch.training.self_forcing_pipeline import (
    SelfForcingDistillationPipeline)


@dataclasses.dataclass(frozen=True)
class DistillStage:
    """One resolved stage of the multi-phase distillation schedule."""

    name: str
    start_step: int
    end_step: int | None
    num_latent_t: int
    streaming_training: bool
    streaming_chunk_size: int | None = None
    streaming_max_length: int | None = None
    streaming_min_new_frame: int | None = None
    streaming_fixed_overlap_latents: int | None = None


def parse_multi_phased_distill_schedule(
        raw, *, default_num_latent_t: int,
        default_streaming_chunk_size: int | None = None,
        default_streaming_max_length: int | None = None
) -> list[DistillStage]:
    """Parse the compact-string / list-of-dicts schedule forms.

    Accepted forms:
      - ``None`` / ``""``: one always-streaming stage
      - ``"700:21,3000:240"``: first stage plain self-forcing to step 700
        at 21 latent frames, then streaming to 240
      - list of dicts with stage/start_step/end_step/num_latent_t/
        streaming_* keys
    """
    if raw is None or raw == "":
        max_length = default_streaming_max_length or default_num_latent_t
        return [
            DistillStage(name="streaming_long", start_step=0, end_step=None,
                         num_latent_t=int(max_length),
                         streaming_training=True,
                         streaming_chunk_size=default_streaming_chunk_size,
                         streaming_max_length=int(max_length))
        ]

    stages: list[DistillStage] = []
    prev_end = 0
    if isinstance(raw, str):
        for idx, part in enumerate(p.strip() for p in raw.split(",")
                                   if p.strip()):
            fields = [f.strip() for f in part.split(":")]
            if len(fields) == 2:
                start, end, nt = prev_end, int(fields[0]), int(fields[1])
            elif len(fields) == 3:
                start, end, nt = (int(fields[0]), int(fields[1]),
                                  int(fields[2]))
            else:
                raise ValueError(
                    "schedule entries must be 'end:num_latent_t' or "
                    f"'start:end:num_latent_t', got {part!r}")
            streaming = idx > 0
            stages.append(DistillStage(
                name="streaming_long" if streaming else "self_forcing",
                start_step=start, end_step=end, num_latent_t=nt,
                streaming_training=streaming,
                streaming_chunk_size=(default_streaming_chunk_size
                                      if streaming else None),
                streaming_max_length=nt if streaming else None))
            prev_end = end
    elif isinstance(raw, (list, tuple)):
        for idx, entry in enumerate(raw):
            if not isinstance(entry, dict):
                raise ValueError("schedule list entries must be dicts")
            name = str(entry.get("stage", "") or entry.get("name",
                                                           "")).strip()
            streaming = entry.get("streaming_training")
            if streaming is None:
                streaming = name in {"streaming_long", "long", "streaming"}
            if not name:
                name = "streaming_long" if streaming else "self_forcing"
            start = int(entry.get("start_step", prev_end))
            end_raw = entry.get("end_step")
            end = None if end_raw is None else int(end_raw)
            nt = int(entry.get(
                "num_latent_t",
                entry.get("streaming_max_length",
                          entry.get("max_length", default_num_latent_t))))

            def opt_int(key):
                v = entry.get(key)
                return None if v is None else int(v)

            stages.append(DistillStage(
                name=name, start_step=start, end_step=end, num_latent_t=nt,
                streaming_training=bool(streaming),
                streaming_chunk_size=opt_int("streaming_chunk_size"),
                streaming_max_length=opt_int("streaming_max_length"),
                streaming_min_new_frame=opt_int("streaming_min_new_frame"),
                streaming_fixed_overlap_latents=opt_int(
                    "streaming_fixed_overlap_latents")))
            if end is not None:
                prev_end = end
    else:
        raise ValueError(
            "multi_phased_distill_schedule must be a list, string, or empty")

    if not stages:
        raise ValueError("multi_phased_distill_schedule produced no stages")
    prev_end = 0
    for st in stages:
        if st.start_step < prev_end:
            raise ValueError("stages must be ordered and non-overlapping")
        if st.end_step is not None and st.end_step <= st.start_step:
            raise ValueError("stage end_step must be > start_step")
        if st.num_latent_t <= 0:
            raise ValueError("stage num_latent_t must be positive")
        if st.streaming_training:
            chunk = st.streaming_chunk_size or default_streaming_chunk_size
            if chunk is None or chunk <= 0:
                raise ValueError("streaming_chunk_size must be positive")
            if (st.streaming_fixed_overlap_latents is not None
                    and not 0 <= st.streaming_fixed_overlap_latents < chunk):
                raise ValueError(
                    "streaming_fixed_overlap_latents must be in [0, chunk)")
        if st.end_step is not None:
            prev_end = st.end_step
    return stages


def select_distill_stage(stages: list[DistillStage],
                         iteration: int) -> DistillStage:
    """The active stage at ``iteration``."""
    for st in stages:
        if st.end_step is None:
            if iteration >= st.start_step:
                return st
        elif st.start_step <= iteration < st.end_step:
            return st
    return stages[-1]


class _StreamState:
    """The persistent stream: its stage, the generator's caches and the
    latent frames generated so far."""

    def __init__(self, stage: DistillStage, caches: list[dict]):
        self.stage = stage
        self.caches = caches
        self.current_length = 0


class StreamingLongTuningPipeline(SelfForcingDistillationPipeline):
    """Self-forcing with the streaming long-tuning stages."""

    label = "streaming_long_tuning"

    def __init__(self, generator: torch.nn.Module,
                 real_score: torch.nn.Module, fake_score: torch.nn.Module,
                 training_args: TrainingArgs,
                 dmd_config: DMDConfig | None = None,
                 denoise_steps: tuple[int, ...] = (1000, 750, 500),
                 stages: list[DistillStage] | None = None,
                 default_chunk_size: int | None = None):
        super().__init__(generator, real_score, fake_score, training_args,
                         dmd_config, denoise_steps)
        nt = generator.config.num_frames_per_block
        self.stages = stages or parse_multi_phased_distill_schedule(
            None, default_num_latent_t=nt * 4,
            default_streaming_chunk_size=nt * 2)
        self.default_chunk_size = default_chunk_size
        self._stream: _StreamState | None = None

    # -- the stage's geometry -------------------------------------------------

    def _stage_max_length(self, stage: DistillStage) -> int:
        return int(stage.streaming_max_length or stage.num_latent_t)

    def _stage_chunk(self, stage: DistillStage) -> int:
        chunk = stage.streaming_chunk_size or self.default_chunk_size
        nfpb = self.generator.config.num_frames_per_block
        if chunk is None:
            chunk = nfpb * 2
        if chunk % nfpb:
            raise ValueError(
                f"streaming_chunk_size {chunk} must be divisible by "
                f"num_frames_per_block {nfpb}")
        return int(chunk)

    def _select_new_frames(self, stage: DistillStage, remaining: int,
                           first: bool) -> int:
        """The chunk's new latent frames, always a whole number of blocks
        (a ragged tail would be dropped by the rollout while the stream's
        length still counted it): the chunk size for the first chunk, else
        a block count drawn from ``default_rng(seed * 100003 + step)``."""
        nfpb = self.generator.config.num_frames_per_block

        def aligned(n: int) -> int:
            return int(max(nfpb, (n // nfpb) * nfpb))

        chunk = self._stage_chunk(stage)
        if first:
            return aligned(min(chunk, remaining))
        lo = stage.streaming_min_new_frame or nfpb
        if stage.streaming_fixed_overlap_latents is not None:
            return aligned(min(chunk - stage.streaming_fixed_overlap_latents,
                               remaining))
        hi = min(chunk, remaining)
        lo = min(lo, hi)
        rng = np.random.default_rng(self.args.seed * 100003 + self.step)
        blocks = rng.integers(lo // nfpb, hi // nfpb + 1)
        return int(max(nfpb, blocks * nfpb))

    # -- a stream step --------------------------------------------------------

    def stream_draw(self, chunk_shape: tuple[int, ...]) -> dict[str, Any]:
        """A stream step's draws: the chunk's ``noise``, the ``generator``'s
        (rollout noises, and the DMD target's timestep and noise) and the
        ``critic``'s (timestep and noise; no rollout of its own)."""
        noise = torch.randn(chunk_shape, generator=self.rng,
                            dtype=torch.float32)
        gen = self._update_draws(chunk_shape)
        t_int = int(torch.randint(0, self.dmd.num_train_timestep, (1,),
                                  generator=self.rng))
        critic = UpdateDraws([], t_int, torch.randn(
            chunk_shape, generator=self.rng, dtype=torch.float32))
        return {"noise": noise, "generator": gen, "critic": critic}

    def _stream_step(self, st: _StreamState, embeds: torch.Tensor,
                     neg_embeds: torch.Tensor, chunk_shape: tuple[int, ...],
                     update_student: bool) -> dict[str, Any]:
        draws = self.stream_draw(chunk_shape)
        noise = draws["noise"].to(self.device)
        start = st.current_length
        blocks = range(self._blocks(chunk_shape))
        gen = draws["generator"]
        metrics: dict[str, Any] = {}
        if update_student:
            video = self._rollout_blocks(self.generator, st.caches, noise,
                                         embeds, gen.rollout, start, blocks)
            loss = self._dmd_loss(video, embeds, neg_embeds, gen, start)
            metrics["generator_grad_norm"] = self._update(
                loss, self.gen_params, self.gen_opt, self.gen_updates)
            metrics["generator_loss"] = float(loss.detach())
            self.gen_updates += 1
        else:
            with torch.no_grad():
                video = self._rollout_blocks(self.generator, st.caches,
                                             noise, embeds, gen.rollout,
                                             start, ())
        loss = self._flow_matching_loss(video.detach(), embeds,
                                        draws["critic"], start)
        metrics["critic_grad_norm"] = self._update(
            loss, self.fake_params, self.fake_opt, self.fake_updates)
        metrics["critic_loss"] = float(loss.detach())
        self.fake_updates += 1
        return metrics

    def train_one_step(self, embeds, neg_embeds,
                       latent_shape: tuple[int, ...]) -> dict[str, Any]:
        """The active stage's step: a plain stage's self-forcing step on
        its ``num_latent_t`` frames (at most the latents'), or a stream
        step of the chunk's new frames."""
        stage = select_distill_stage(self.stages, self.step)
        stage_idx = self.stages.index(stage)
        if not stage.streaming_training:
            shape = (tuple(latent_shape[:2]) +
                     (min(stage.num_latent_t, latent_shape[2]),) +
                     tuple(latent_shape[3:]))
            metrics = super().train_one_step(embeds, neg_embeds, shape)
            metrics["distill_stage_index"] = stage_idx
            return metrics

        cfg = self.generator.config
        max_len = self._stage_max_length(stage)
        b, c, _, h, w = latent_shape
        st = self._stream
        if (st is None or st.stage != stage
                or st.current_length >= max_len):
            # free the old stream's caches before the new ones
            st = self._stream = None
            frame_seqlen = (h // cfg.patch_size[1]) * (w // cfg.patch_size[2])
            st = _StreamState(stage, self.generator.init_caches(
                b, frame_seqlen, self.cache_dtype, self.device))
            self._stream = st
        nf = self._select_new_frames(stage, max_len - st.current_length,
                                     first=st.current_length == 0)
        update_student = self.step % self.dmd.dfake_gen_update_ratio == 0
        embeds = torch.as_tensor(embeds, dtype=torch.float32).to(self.device)
        neg_embeds = torch.as_tensor(neg_embeds, dtype=torch.float32).to(
            self.device)
        metrics = self._stream_step(st, embeds, neg_embeds,
                                    (b, c, nf, h, w), update_student)
        st.current_length += nf
        self.step += 1
        metrics.update(step=self.step, distill_stage_index=stage_idx,
                       streaming_current_length=st.current_length,
                       streaming_max_length=max_len,
                       streaming_new_frames=nf)
        return metrics
