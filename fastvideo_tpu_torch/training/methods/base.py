"""TrainingMethod plugin base and registry (port of
fastvideo_tpu/training/methods/base.py).

A method owns its role models and steps and is resolved by registry name
or by a dotted ``_target_`` path (``training/instantiate.py``: a path under
``fastvideo_tpu.`` resolves in the port's package). The port registers
every built-in method of the JAX package: ``sft``, ``dfsft``, ``tfsft``,
``lora_finetune``, ``dmd2``, ``self_forcing``, ``streaming_long_tuning``,
``causal_cd``, ``kd``, ``anyflow_pretrain``, ``anyflow`` and
``diffusion_nft``.
"""

from __future__ import annotations

import abc
import logging
from typing import TYPE_CHECKING, Any, ClassVar

if TYPE_CHECKING:
    from fastvideo_tpu_torch.training.run_config import TrainRunConfig

logger = logging.getLogger(__name__)

_METHOD_REGISTRY: dict[str, type["TrainingMethod"]] = {}

# the JAX package's built-in methods the port lacks, and what it waits on
NOT_PORTED: dict[str, str] = {}


def register_method(cls: type["TrainingMethod"]) -> type["TrainingMethod"]:
    """Class decorator: register under ``cls.name``."""
    if not getattr(cls, "name", None):
        raise ValueError(f"{cls.__name__} must define a class-level `name`")
    _METHOD_REGISTRY[cls.name] = cls
    return cls


def list_methods() -> list[str]:
    return sorted(_METHOD_REGISTRY)


def resolve_method(spec: str | dict[str, Any]) -> type["TrainingMethod"]:
    """The method class of a registry name, a dotted path or a
    ``{"_target_": path}`` dict."""
    if isinstance(spec, dict):
        from fastvideo_tpu_torch.training.instantiate import resolve_target

        cls = resolve_target(str(spec.get("_target_", "")))
    elif spec in _METHOD_REGISTRY:
        cls = _METHOD_REGISTRY[spec]
    elif spec in NOT_PORTED:
        raise NotImplementedError(
            f"training method {spec!r} is not ported: {NOT_PORTED[spec]}")
    elif "." in spec:
        from fastvideo_tpu_torch.training.instantiate import resolve_target

        cls = resolve_target(spec)
    else:
        raise ValueError(
            f"Unknown training method {spec!r}; registered: "
            f"{list_methods()} (or pass a dotted _target_ path)")
    if not (isinstance(cls, type) and issubclass(cls, TrainingMethod)):
        raise TypeError(f"{cls!r} is not a TrainingMethod subclass")
    return cls


class TrainingMethod(abc.ABC):
    """Algorithm layer: owns the role models and steps, drives training."""

    name: ClassVar[str] = ""

    @classmethod
    @abc.abstractmethod
    def from_config(cls, cfg: "TrainRunConfig") -> "TrainingMethod":
        """Build the method (role models, optimizers) from a run config."""

    @property
    @abc.abstractmethod
    def args(self) -> Any:
        """The TrainingArgs in effect."""

    @abc.abstractmethod
    def train(self, dataloader: Any, max_steps: int | None = None,
              **kwargs: Any) -> None:
        """Run the training loop over ``dataloader``."""

    def save_checkpoint(self) -> None:
        logger.warning("%s does not implement checkpointing", self.name)

    def resume_from_checkpoint(self, step: int | None = None) -> None:
        raise NotImplementedError(
            f"{self.name} does not implement checkpoint resume")


class PipelineMethod(TrainingMethod):
    """Adapter: a pipeline object (``train``, ``train_one_step``,
    ``save_checkpoint``, ``resume_from_checkpoint``, ``args``) behind the
    method protocol."""

    def __init__(self, pipeline: Any):
        self.pipeline = pipeline

    @property
    def args(self) -> Any:
        return self.pipeline.args

    def train(self, dataloader, max_steps=None, **kwargs) -> None:
        self.pipeline.train(dataloader, max_steps=max_steps, **kwargs)

    def save_checkpoint(self) -> None:
        if hasattr(self.pipeline, "save_checkpoint"):
            self.pipeline.save_checkpoint()
        else:
            super().save_checkpoint()

    def resume_from_checkpoint(self, step: int | None = None) -> None:
        self.pipeline.resume_from_checkpoint(step)

    def __getattr__(self, item: str) -> Any:
        return getattr(self.pipeline, item)
