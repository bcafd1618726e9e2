"""Environment flags the port reads (port of fastvideo_tpu/envs.py), resolved
on attribute access so that changes made before first use are honored."""

from __future__ import annotations

import os
from collections.abc import Callable
from typing import Any

environment_flags: dict[str, Callable[[], Any]] = {
    # attention backend for the DiT self-attention
    "FASTVIDEO_ATTENTION_BACKEND":
    lambda: os.getenv("FASTVIDEO_ATTENTION_BACKEND", None),
    # "t,h,w": forces the VSA tile geometry (a tile that does not divide the
    # token grid takes the padded route)
    "FASTVIDEO_VSA_TILE":
    lambda: os.getenv("FASTVIDEO_VSA_TILE", None),
    # N > 0: forces N query tiles per shared VSA top-k set on exact grids
    "FASTVIDEO_VSA_QGROUP":
    lambda: os.getenv("FASTVIDEO_VSA_QGROUP", None),
    # VAE conv mode name (every name routes to the conv kernel)
    "FASTVIDEO_VAE_CONV3D":
    lambda: os.getenv("FASTVIDEO_VAE_CONV3D", None),
}


def __getattr__(name: str) -> Any:
    if name in environment_flags:
        return environment_flags[name]()
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def __dir__() -> list[str]:
    return list(environment_flags.keys())
