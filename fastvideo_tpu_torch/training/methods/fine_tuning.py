"""Fine-tuning methods (port of fastvideo_tpu/training/methods/fine_tuning.py):
``sft``, flow-matching supervised fine-tuning. ``dfsft`` and ``tfsft`` wait
for K1's chunk-causal and teacher-forcing masks."""

from __future__ import annotations

from fastvideo_tpu_torch.training.methods.base import (PipelineMethod,
                                                       register_method)
from fastvideo_tpu_torch.training.run_config import (TrainRunConfig,
                                                     build_training_args,
                                                     build_transformer)
from fastvideo_tpu_torch.training.training_pipeline import (TrainingPipeline,
                                                            resolve_device)


@register_method
class SFTMethod(PipelineMethod):
    """Flow-matching supervised fine-tuning."""

    name = "sft"

    @classmethod
    def from_config(cls, cfg: TrainRunConfig) -> "SFTMethod":
        from fastvideo_tpu_torch.models.schedulers.flow_match_euler import (
            FlowMatchEulerDiscreteScheduler)

        targs = build_training_args(cfg)
        scheduler = FlowMatchEulerDiscreteScheduler(
            shift=cfg.model.flow_shift)
        scheduler.set_timesteps(1000)
        transformer = build_transformer(cfg.model,
                                        device=resolve_device(targs))
        return cls(TrainingPipeline(transformer, scheduler, targs))
