"""FastVideoArgs / TrainingArgs: runtime configuration (port of
fastvideo_tpu/fastvideo_args.py, the fields the inference and SFT training
paths read).

The port runs on one card: ``num_gpus``, ``sp_size`` and ``tp_size`` (and
for training ``dp_size``) must be 1 until the parallelism slice.
"""

from __future__ import annotations

import dataclasses
from typing import Any


@dataclasses.dataclass
class FastVideoArgs:
    model_path: str = ""
    num_gpus: int = 1
    tp_size: int = 1
    sp_size: int = 1
    # "cuda" (default) or "cpu"; resolved by the entry point
    device: str | None = None
    flow_shift: float | None = None
    VSA_sparsity: float = 0.0
    # int8 quantization of the DiT's linears after load ("int8" W8A8 or
    # "int8-weight-only"), and of the text encoder's linears at load
    # (FASTVIDEO_TRANSFORMER_QUANT / FASTVIDEO_TEXT_ENCODER_QUANT win)
    transformer_quant: str | None = None
    text_encoder_quant: str | None = None
    # stored and not applied, as in the JAX package: an adapter reaches the
    # model through VideoGenerator.set_lora_adapter only
    lora_path: str | None = None
    lora_nickname: str = "default"
    pipeline_config: Any = None

    @classmethod
    def from_kwargs(cls, **kwargs) -> "FastVideoArgs":
        unknown = set(kwargs) - {f.name for f in dataclasses.fields(cls)}
        if unknown:
            raise TypeError(f"unknown arguments for the port: {sorted(unknown)}")
        args = cls(**kwargs)
        if args.num_gpus != 1 or args.sp_size != 1 or args.tp_size != 1:
            raise NotImplementedError(
                "the port runs on one card (num_gpus = sp_size = tp_size = 1)")
        return args


@dataclasses.dataclass
class TrainingArgs(FastVideoArgs):
    """The fields of the JAX ``TrainingArgs`` that the SFT path reads, with
    the JAX defaults and names (a JAX training config's fields parse)."""

    gradient_accumulation_steps: int = 1
    max_train_steps: int = 1000
    # optimizer (AdamW)
    learning_rate: float = 1e-5
    lr_scheduler: str = "constant"
    lr_warmup_steps: int = 0
    weight_decay: float = 1e-4
    max_grad_norm: float = 1.0
    betas: tuple[float, float] = (0.9, 0.999)
    # VSA sparsity ramp: sparsity grows by VSA_decay_rate every
    # VSA_decay_interval_steps up to VSA_sparsity; rate or interval <= 0
    # jumps straight to the target
    VSA_decay_rate: float = 0.0
    VSA_decay_interval_steps: int = 0
    # timestep sampling
    weighting_scheme: str = "uniform"
    logit_mean: float = 0.0
    logit_std: float = 1.0
    mode_scale: float = 1.29
    # checkpointing
    output_dir: str = "outputs"
    checkpointing_steps: int = 500
    # activation checkpointing: "full" recomputes each DiT block in the
    # backward; "ops" keeps the matmul outputs and recomputes the rest
    # (training_utils.set_activation_checkpointing)
    selective_checkpointing: str = "full"
    validation_steps: int = 0
    # tracking ("jsonl" local files; unknown backends are skipped)
    trackers: tuple[str, ...] = ()
    tracker_project_name: str | None = None
    wandb_run_name: str | None = None
    seed: int = 42

    def __post_init__(self):
        if self.num_gpus != 1 or self.sp_size != 1 or self.tp_size != 1:
            raise NotImplementedError(
                "the port trains on one card (num_gpus = sp_size = tp_size "
                "= 1)")
        self.betas = tuple(self.betas)
        self.trackers = tuple(self.trackers or ())
