"""Workflow layer (port of fastvideo_tpu/workflow/workflow_base.py): a
workflow registers components and pipelines, prepares the environment and
runs the overall task (preprocess).
"""

from __future__ import annotations

from abc import ABC, abstractmethod
from typing import Any

from fastvideo_tpu_torch.fastvideo_args import FastVideoArgs


class WorkflowBase(ABC):
    def __init__(self, fastvideo_args: FastVideoArgs):
        self.fastvideo_args = fastvideo_args
        self._components: dict[str, Any] = {}
        self.register_components()
        self.prepare_system_environment()

    def add_component(self, name: str, component: Any) -> None:
        self._components[name] = component
        setattr(self, name, component)

    def get_component(self, name: str) -> Any:
        return self._components[name]

    @abstractmethod
    def register_components(self) -> None:
        ...

    def prepare_system_environment(self) -> None:
        pass

    @abstractmethod
    def run(self):
        ...

    @classmethod
    def get_workflow_cls(cls, fastvideo_args: FastVideoArgs):
        mode = getattr(fastvideo_args, "mode", "inference")
        if mode == "preprocess":
            from fastvideo_tpu_torch.workflow.preprocess_workflow import (
                PreprocessWorkflow)

            return PreprocessWorkflow
        raise ValueError(f"No workflow for execution mode {mode!r}")
