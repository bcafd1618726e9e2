"""SamplingParam: per-generation parameters (port of
fastvideo_tpu/configs/sample.py; same field names and defaults)."""

from __future__ import annotations

import dataclasses
from typing import Any

DEFAULT_NEGATIVE_PROMPT = (
    "Bright tones, overexposed, static, blurred details, subtitles, style, "
    "works, paintings, images, static, overall gray, worst quality, low "
    "quality, JPEG compression residue, ugly, incomplete, extra fingers, "
    "poorly drawn hands, poorly drawn faces, deformed, disfigured, "
    "misshapen limbs, fused fingers, still picture, messy background, "
    "three legs, many people in the background, walking backwards")


@dataclasses.dataclass
class SamplingParam:
    prompt: str | list[str] | None = None
    negative_prompt: str = DEFAULT_NEGATIVE_PROMPT
    output_path: str = "outputs/"
    output_video_name: str | None = None

    num_videos_per_prompt: int = 1
    seed: int = 1024

    num_frames: int = 81
    height: int = 480
    width: int = 832

    num_inference_steps: int = 50
    guidance_scale: float = 5.0
    guidance_rescale: float = 0.0
    dmd_denoising_steps: list[int] | None = None

    return_frames: bool = False
    save_video: bool = True
    return_trajectory_latents: bool = False

    extra: dict[str, Any] = dataclasses.field(default_factory=dict)

    def update(self, kwargs: dict[str, Any]) -> "SamplingParam":
        field_names = {f.name for f in dataclasses.fields(self)}
        for k, v in kwargs.items():
            if v is None:
                continue
            if k in field_names:
                setattr(self, k, v)
            else:
                self.extra[k] = v
        return self
