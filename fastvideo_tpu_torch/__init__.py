"""PyTorch/CUDA port of fastvideo_tpu for NVIDIA Hopper (H100).

The JAX package ``fastvideo_tpu`` is the reference; this package keeps its
module paths and class names and imports nothing of it. Every Pallas
kernel on a ported path is a hand-written sm_90a kernel under ``csrc/``,
built with nvcc at first use (``ops/_build.py``).
"""

from __future__ import annotations

__all__ = ["VideoGenerator"]


def __getattr__(name: str):
    # lazy, so that importing a submodule does not build the whole stack
    if name == "VideoGenerator":
        from fastvideo_tpu_torch.entrypoints.video_generator import (
            VideoGenerator)

        return VideoGenerator
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
