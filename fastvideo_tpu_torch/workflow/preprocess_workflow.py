"""Preprocess workflow: validate -> sample frames -> encode -> Parquet
(port of fastvideo_tpu/workflow/preprocess_workflow.py): a
PreprocessingDataValidator (per-validator filter counts), fps-matched
frame sampling, and the encode/save loop of PreprocessPipeline (VAE + text
encoder).
"""

from __future__ import annotations

import logging
import os
from collections.abc import Callable, Iterable
from typing import Any

import numpy as np

from fastvideo_tpu_torch.workflow.workflow_base import WorkflowBase

logger = logging.getLogger(__name__)


class PreprocessingDataValidator:
    """Chain of named validators with filter statistics."""

    def __init__(self, max_height: int = 1024, max_width: int = 1024,
                 num_frames: int = 81, train_fps: int = 16,
                 speed_factor: float = 1.0,
                 video_length_tolerance_range: float = 5.0):
        self.max_height = max_height
        self.max_width = max_width
        self.num_frames = num_frames
        self.train_fps = train_fps
        self.speed_factor = speed_factor
        self.video_length_tolerance_range = video_length_tolerance_range
        self.validators: dict[str, Callable[[dict[str, Any]], bool]] = {}
        self.filter_counts: dict[str, int] = {}
        self.num_items_before_filtering = 0
        self.num_items_after_filtering = 0
        self.add_validator("data_type_validator", self._validate_data_type)
        self.add_validator("resolution_validator", self._validate_resolution)
        self.add_validator("frame_sampling_validator",
                           self._validate_frame_sampling)

    def add_validator(self, name: str,
                      validator: Callable[[dict[str, Any]], bool]) -> None:
        self.validators[name] = validator
        self.filter_counts[name] = 0

    def __call__(self, sample: dict[str, Any]) -> bool:
        self.num_items_before_filtering += 1
        for name, validator in self.validators.items():
            if not validator(sample):
                self.filter_counts[name] += 1
                return False
        self.num_items_after_filtering += 1
        return True

    def _validate_data_type(self, sample: dict[str, Any]) -> bool:
        return bool(sample.get("caption")) and sample.get(
            "fps", 0) > 0 and sample.get("num_frames", 0) > 0

    def _validate_resolution(self, sample: dict[str, Any]) -> bool:
        h, w = sample.get("height"), sample.get("width")
        if h is None or w is None:
            return False
        return h <= self.max_height and w <= self.max_width

    def _validate_frame_sampling(self, sample: dict[str, Any]) -> bool:
        seconds = sample["num_frames"] / sample["fps"]
        max_seconds = self.video_length_tolerance_range * (
            self.num_frames / self.train_fps * self.speed_factor)
        return seconds <= max_seconds

    def log_validation_stats(self) -> None:
        logger.info(
            "preprocess filter: %s; before=%d after=%d", ", ".join(
                f"{n}={c}" for n, c in self.filter_counts.items()),
            self.num_items_before_filtering, self.num_items_after_filtering)


def sample_frame_indices(num_frames: int, fps: float, train_fps: float,
                         target_frames: int) -> np.ndarray:
    """fps-matched frame index sampling."""
    interval = max(fps / train_fps, 1e-6)
    indices = np.arange(0, num_frames, interval).astype(int)
    return indices[:target_frames]


class PreprocessWorkflow(WorkflowBase):
    """Orchestrates dataset validation + encoding into training parquet."""

    def __init__(self, fastvideo_args, vae=None, text_encoder=None,
                 tokenizer=None):
        self._init_modules = (vae, text_encoder, tokenizer)
        super().__init__(fastvideo_args)

    def register_components(self) -> None:
        from fastvideo_tpu_torch.pipelines.preprocess.preprocess_pipeline \
            import PreprocessPipeline

        vae, text_encoder, tokenizer = self._init_modules
        args = self.fastvideo_args
        self.add_component(
            "validator",
            PreprocessingDataValidator(
                num_frames=getattr(args, "num_frames", 81),
                train_fps=getattr(args, "train_fps", 16)))
        if vae is not None:
            self.add_component(
                "preprocess_pipeline",
                PreprocessPipeline(vae, text_encoder, tokenizer))

    def run(self, samples: Iterable[dict] | None = None,
            output_dir: str | None = None) -> int:
        validator = self.get_component("validator")
        if "preprocess_pipeline" not in self._components:
            raise RuntimeError(
                "PreprocessWorkflow was constructed without a VAE: "
                "pass vae= (and text_encoder/tokenizer) to encode "
                "samples, or use the validator standalone")
        pipeline = self.get_component("preprocess_pipeline")
        output_dir = output_dir or getattr(self.fastvideo_args, "output_dir",
                                           "preprocessed")
        os.makedirs(output_dir, exist_ok=True)

        def valid_samples():
            for sample in samples or ():
                meta = dict(sample)
                frames = meta.get("frames")
                if frames is not None:
                    meta.setdefault("num_frames", frames.shape[0])
                    meta.setdefault("height", frames.shape[1])
                    meta.setdefault("width", frames.shape[2])
                meta.setdefault("fps", getattr(self.fastvideo_args,
                                               "train_fps", 16))
                if validator(meta):
                    yield sample | {"fps": meta["fps"]}

        total = pipeline.run(valid_samples(), output_dir)
        validator.log_validation_stats()
        return total
