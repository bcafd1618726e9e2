"""FastVideoArgs / TrainingArgs: runtime configuration (port of
fastvideo_tpu/fastvideo_args.py, the fields the inference and SFT training
paths read).

Serving spreads over ``num_gpus`` processes, one a card, on the mesh
``mesh_config()`` gives (``parallel/``): with sp = tp = 1 and dp left at
-1, sp takes all of ``num_gpus``, as in the JAX package. Training runs on
one card: ``TrainingArgs`` refuses more (ROADMAP Queue 1, the training half
of parallelism).
"""

from __future__ import annotations

import dataclasses
from typing import Any

from fastvideo_tpu_torch.parallel.mesh import MeshConfig


@dataclasses.dataclass
class FastVideoArgs:
    model_path: str = ""
    num_gpus: int = 1
    tp_size: int = 1
    sp_size: int = 1
    dp_size: int = -1
    # seconds the process groups (and the executor's calls) wait; None
    # keeps torch.distributed's default and lets a call run as long as it
    # takes (a dead worker is still found at once)
    dist_timeout: int | None = None
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

    def mesh_config(self) -> MeshConfig:
        dp = self.dp_size
        if dp == -1:
            # the world is num_gpus, not every device of the host
            dp = max(1, self.num_gpus // (self.sp_size * self.tp_size))
        return MeshConfig(dp_size=dp, sp_size=self.sp_size,
                          tp_size=self.tp_size)

    @classmethod
    def from_kwargs(cls, **kwargs) -> "FastVideoArgs":
        unknown = set(kwargs) - {f.name for f in dataclasses.fields(cls)}
        if unknown:
            raise TypeError(f"unknown arguments for the port: {sorted(unknown)}")
        args = cls(**kwargs)
        # num_gpus defines the world; sp fills it
        if args.num_gpus > 1 and args.sp_size == 1 and args.tp_size == 1 \
                and args.dp_size == -1:
            args.sp_size = args.num_gpus
        dp, sp, tp = args.mesh_config().resolve(args.num_gpus)
        if dp * sp * tp != args.num_gpus:
            raise ValueError(f"dp*sp*tp={dp * sp * tp} must equal "
                             f"num_gpus={args.num_gpus}: one process a card, "
                             "each with a place in the mesh")
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
        if (self.num_gpus != 1 or self.sp_size != 1 or self.tp_size != 1
                or self.dp_size not in (-1, 1)):
            raise NotImplementedError(
                "the port trains on one card (num_gpus = sp_size = tp_size "
                "= 1): training's dp, FSDP and sp are ROADMAP Queue 1's "
                "training half of parallelism")
        self.betas = tuple(self.betas)
        self.trackers = tuple(self.trackers or ())
