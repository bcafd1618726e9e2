"""Distribution-matching methods (port of
fastvideo_tpu/training/methods/distribution_matching.py).

Each method wraps a three-role pipeline behind the plugin protocol: three
DiTs of the config's checkpoint (generator, real score, fake score), each
loaded trainable in ``model.dit_precision``.

* ``dmd2``: :class:`DMD2DistillationPipeline` (the ``dmd`` section).
* ``self_forcing``: :class:`SelfForcingDistillationPipeline` on a causal
  checkpoint, its rollout's denoise steps from ``method_config``'s
  ``denoise_steps`` (default ``dmd.dmd_denoising_steps``). Its gradient
  crosses the KV-cache attention through the grad route of
  ``models/dits/causal_wan.py`` (K1 and K6 over the gathered valid keys).
* ``streaming_long_tuning``: :class:`StreamingLongTuningPipeline`, the
  stages from ``multi_phased_distill_schedule``.
"""

from __future__ import annotations

from fastvideo_tpu_torch.training.distillation_pipeline import (
    DMD2DistillationPipeline, DMDConfig)
from fastvideo_tpu_torch.training.methods.base import (PipelineMethod,
                                                       register_method)
from fastvideo_tpu_torch.training.run_config import (TrainRunConfig,
                                                     build_training_args,
                                                     build_transformer)
from fastvideo_tpu_torch.training.self_forcing_pipeline import (
    SelfForcingDistillationPipeline)
from fastvideo_tpu_torch.training.streaming_long_pipeline import (
    StreamingLongTuningPipeline, parse_multi_phased_distill_schedule)
from fastvideo_tpu_torch.training.training_pipeline import resolve_device


def _dmd_config(cfg: TrainRunConfig) -> DMDConfig:
    return DMDConfig(
        dmd_denoising_steps=tuple(cfg.dmd.dmd_denoising_steps),
        real_score_guidance_scale=cfg.dmd.real_score_guidance_scale,
        dfake_gen_update_ratio=cfg.dmd.dfake_gen_update_ratio,
        timestep_shift=cfg.dmd.timestep_shift)


@register_method
class DMD2Method(PipelineMethod):
    """Distribution Matching Distillation v2 (generator / real / fake)."""

    name = "dmd2"

    @classmethod
    def from_config(cls, cfg: TrainRunConfig) -> "DMD2Method":
        targs, generator, real_score, fake_score = _roles(cfg)
        return cls(DMD2DistillationPipeline(generator, real_score,
                                            fake_score, targs,
                                            _dmd_config(cfg)))


def _roles(cfg: TrainRunConfig):
    """(training args, generator, real score, fake score)."""
    targs = build_training_args(cfg)
    device = resolve_device(targs)
    return (targs, *(build_transformer(cfg.model, device=device)
                     for _ in range(3)))


def _denoise_steps(cfg: TrainRunConfig) -> tuple[int, ...]:
    return tuple(cfg.method_config.get("denoise_steps",
                                       cfg.dmd.dmd_denoising_steps))


@register_method
class SelfForcingMethod(PipelineMethod):
    """Causal self-forcing distillation (the generator's autoregressive
    rollout on its rolling KV caches).

    ``method_config`` key: ``denoise_steps``."""

    name = "self_forcing"

    @classmethod
    def from_config(cls, cfg: TrainRunConfig) -> "SelfForcingMethod":
        targs, generator, real_score, fake_score = _roles(cfg)
        return cls(SelfForcingDistillationPipeline(
            generator, real_score, fake_score, targs, _dmd_config(cfg),
            denoise_steps=_denoise_steps(cfg)))


@register_method
class StreamingLongTuningMethod(PipelineMethod):
    """LongLive-style multi-stage streaming self-forcing.

    ``method_config`` keys: ``multi_phased_distill_schedule`` (a compact
    string such as ``"700:21,3000:240"`` or a list of stage dicts),
    ``streaming_chunk_size``, ``streaming_max_length``, ``num_latent_t``
    (default 8) and ``denoise_steps``."""

    name = "streaming_long_tuning"

    @classmethod
    def from_config(cls, cfg: TrainRunConfig) -> "StreamingLongTuningMethod":
        mc = cfg.method_config
        chunk = mc.get("streaming_chunk_size")
        stages = parse_multi_phased_distill_schedule(
            mc.get("multi_phased_distill_schedule"),
            default_num_latent_t=int(mc.get("num_latent_t", 8)),
            default_streaming_chunk_size=chunk,
            default_streaming_max_length=mc.get("streaming_max_length"))
        targs, generator, real_score, fake_score = _roles(cfg)
        return cls(StreamingLongTuningPipeline(
            generator, real_score, fake_score, targs, _dmd_config(cfg),
            denoise_steps=_denoise_steps(cfg), stages=stages,
            default_chunk_size=chunk))
