"""Distribution-matching methods (port of
fastvideo_tpu/training/methods/distribution_matching.py).

``dmd2`` wraps :class:`DMD2DistillationPipeline` behind the plugin
protocol: three DiTs of the config's checkpoint (generator, real score,
fake score), each loaded trainable in ``model.dit_precision``.
``self_forcing`` and ``streaming_long_tuning`` are not ported yet
(``base.NOT_PORTED``).
"""

from __future__ import annotations

from fastvideo_tpu_torch.training.distillation_pipeline import (
    DMD2DistillationPipeline, DMDConfig)
from fastvideo_tpu_torch.training.methods.base import (PipelineMethod,
                                                       register_method)
from fastvideo_tpu_torch.training.run_config import (TrainRunConfig,
                                                     build_training_args,
                                                     build_transformer)
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
        targs = build_training_args(cfg)
        device = resolve_device(targs)
        generator, real_score, fake_score = (
            build_transformer(cfg.model, device=device) for _ in range(3))
        return cls(DMD2DistillationPipeline(generator, real_score,
                                            fake_score, targs,
                                            _dmd_config(cfg)))
