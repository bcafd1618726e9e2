"""TrainingMethod plugin base and registry (port of
fastvideo_tpu/training/methods/base.py).

A method owns its role models and steps and is resolved by registry name.
The port registers ``sft``, ``dfsft``, ``tfsft``, ``lora_finetune``,
``dmd2``, ``self_forcing``, ``streaming_long_tuning``, ``causal_cd``,
``kd``, ``anyflow_pretrain`` and ``anyflow``; the JAX package's other
built-in name (``NOT_PORTED``: ``diffusion_nft``) raises with the ROADMAP
item that brings it (and the JAX package's dotted ``_target_`` paths are
not taken).
"""

from __future__ import annotations

import abc
import logging
from typing import TYPE_CHECKING, Any, ClassVar

if TYPE_CHECKING:
    from fastvideo_tpu_torch.training.run_config import TrainRunConfig

logger = logging.getLogger(__name__)

_METHOD_REGISTRY: dict[str, type["TrainingMethod"]] = {}

# the JAX package's other built-in methods, and what the port waits on
NOT_PORTED = {
    "diffusion_nft": "ROADMAP Queue 1, diffusion_nft",
}


def register_method(cls: type["TrainingMethod"]) -> type["TrainingMethod"]:
    """Class decorator: register under ``cls.name``."""
    if not getattr(cls, "name", None):
        raise ValueError(f"{cls.__name__} must define a class-level `name`")
    _METHOD_REGISTRY[cls.name] = cls
    return cls


def list_methods() -> list[str]:
    return sorted(_METHOD_REGISTRY)


def resolve_method(name: str) -> type["TrainingMethod"]:
    """The registered method class of ``name``."""
    if name in _METHOD_REGISTRY:
        return _METHOD_REGISTRY[name]
    if name in NOT_PORTED:
        raise NotImplementedError(
            f"training method {name!r} is not ported: {NOT_PORTED[name]}")
    raise ValueError(f"Unknown training method {name!r}; registered: "
                     f"{list_methods()}")


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
        self.pipeline.save_checkpoint()

    def resume_from_checkpoint(self, step: int | None = None) -> None:
        self.pipeline.resume_from_checkpoint(step)

    def __getattr__(self, item: str) -> Any:
        return getattr(self.pipeline, item)
