"""LoRA fine-tuning: train low-rank adapters with the base model frozen
(port of fastvideo_tpu/training/methods/lora.py).

The DiT's target linears become ``LoRALinear``s; the base's parameters get
``requires_grad=False``, so the trainer's AdamW (built over the parameters
that require grad) holds the adapters alone, and a checkpoint holds the
adapters and their AdamW state, not the base (JAX's ``state.params`` is the
adapter tree).

The A matrices are drawn in walk order from a CPU ``torch.Generator``
seeded with ``init_seed``, in :meth:`LoRATrainingPipeline.draw_lora_A`
alone, so a test can hand the port JAX's draws. Same seed, other numbers.
"""

from __future__ import annotations

import logging
from collections.abc import Callable

import torch
from torch import nn

from fastvideo_tpu_torch.layers.lora import LoRALinear
from fastvideo_tpu_torch.pipelines.lora_pipeline import (
    DEFAULT_TARGET_MODULES, convert_to_lora_layers)
from fastvideo_tpu_torch.training.methods.base import (PipelineMethod,
                                                       register_method)
from fastvideo_tpu_torch.training.run_config import (TrainRunConfig,
                                                     build_training_args,
                                                     build_transformer)
from fastvideo_tpu_torch.training.training_pipeline import (TrainingPipeline,
                                                            resolve_device)

logger = logging.getLogger(__name__)


@torch.no_grad()
def init_lora_for_training(
        model: nn.Module,
        draw: Callable[[str, tuple[int, ...]], torch.Tensor]) -> int:
    """The standard LoRA train init (Hu et al.): A ~ N(0, 1/in), B = 0,
    adapter active and unmerged. ``draw(path, shape)`` gives each layer's
    standard normal draw, one a layer in walk order. B = 0 keeps step 0's
    output that of the base model; a random A makes dL/dB nonzero."""
    n = 0
    for name, mod in model.named_modules():
        if isinstance(mod, LoRALinear):
            a = draw(name, tuple(mod.lora_A.shape)).float()
            a = a / float(mod.in_features) ** 0.5
            mod.lora_A.copy_(a.to(mod.lora_A.dtype))
            mod.lora_B.zero_()
            mod.lora_active = True
            mod.merged = False
            n += 1
    return n


class LoRATrainingPipeline(TrainingPipeline):
    """Flow-matching SFT where only the LoRA adapters receive gradients."""

    def __init__(self, transformer: nn.Module, scheduler, training_args, *,
                 rank: int = 16, alpha: float | None = None,
                 target_modules=None, init_seed: int = 0):
        targets = tuple(target_modules or DEFAULT_TARGET_MODULES)
        n = convert_to_lora_layers(transformer, targets, rank=rank,
                                   alpha=alpha)
        if n == 0:
            raise ValueError(
                f"no Linear matched LoRA target_modules {targets}")
        self.n_lora_layers = n
        self.init_generator = torch.Generator("cpu").manual_seed(
            int(init_seed))
        init_lora_for_training(transformer, self.draw_lora_A)
        transformer.requires_grad_(False)
        for mod in transformer.modules():
            if isinstance(mod, LoRALinear):
                mod.lora_A.requires_grad_(True)
                mod.lora_B.requires_grad_(True)
        super().__init__(transformer, scheduler, training_args)
        logger.info("LoRA training: %d adapted linears, rank=%d (%d "
                    "trainable params)", n, rank,
                    sum(p.numel() for p in self.params))

    def draw_lora_A(self, name: str, shape: tuple[int, ...]) -> torch.Tensor:
        """The standard normal draw of the layer at ``name``."""
        return torch.randn(shape, generator=self.init_generator,
                           dtype=torch.float32)

    def checkpoint_state(self) -> dict[str, torch.Tensor]:
        """The adapters only (the frozen base is the checkpoint's)."""
        return {name: p.detach() for name, p in
                self.transformer.named_parameters() if p.requires_grad}


@register_method
class LoRAFinetuneMethod(PipelineMethod):
    """``method: lora_finetune``: the SFT objective, adapter-only updates.

    ``method_config`` keys: ``rank`` (16), ``alpha`` (the rank),
    ``target_modules`` (``DEFAULT_TARGET_MODULES``), ``init_seed`` (0)."""

    name = "lora_finetune"

    @classmethod
    def from_config(cls, cfg: TrainRunConfig) -> "LoRAFinetuneMethod":
        from fastvideo_tpu_torch.models.schedulers.flow_match_euler import (
            FlowMatchEulerDiscreteScheduler)

        targs = build_training_args(cfg)
        scheduler = FlowMatchEulerDiscreteScheduler(
            shift=cfg.model.flow_shift)
        scheduler.set_timesteps(1000)
        transformer = build_transformer(cfg.model,
                                        device=resolve_device(targs))
        mc = dict(cfg.method_config)
        return cls(LoRATrainingPipeline(
            transformer, scheduler, targs, rank=int(mc.get("rank", 16)),
            alpha=mc.get("alpha"), target_modules=mc.get("target_modules"),
            init_seed=int(mc.get("init_seed", 0))))
