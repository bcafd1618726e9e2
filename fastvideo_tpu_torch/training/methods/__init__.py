"""Training method plugin registry (port of
fastvideo_tpu/training/methods/__init__.py). Importing this package
registers the built-in methods: ``sft``, ``dfsft``, ``tfsft``,
``lora_finetune``, ``dmd2``, ``self_forcing``, ``streaming_long_tuning``,
``causal_cd``, ``kd``, ``anyflow_pretrain``, ``anyflow`` and
``diffusion_nft``."""

from fastvideo_tpu_torch.training.methods import (  # noqa: F401
    anyflow, anyflow_pretrain, causal_cd, distribution_matching, fine_tuning,
    knowledge_distillation, lora, rl)
from fastvideo_tpu_torch.training.methods.base import (NOT_PORTED,
                                                       PipelineMethod,
                                                       TrainingMethod,
                                                       list_methods,
                                                       register_method,
                                                       resolve_method)

__all__ = [
    "NOT_PORTED",
    "TrainingMethod",
    "PipelineMethod",
    "register_method",
    "resolve_method",
    "list_methods",
]
