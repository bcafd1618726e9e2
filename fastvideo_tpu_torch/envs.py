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
    # VAE conv mode name: "kf_int8" / "auto_int8" take the int8 conv kernel
    # where its rule allows, every other name the bf16 conv kernel
    "FASTVIDEO_VAE_CONV3D":
    lambda: os.getenv("FASTVIDEO_VAE_CONV3D", None),
    # transformer quantization, wins over FastVideoArgs.transformer_quant;
    # "" disables. An alias of layers/quantization/int8.py ("int8", "w8a8",
    # "int8-weight-only", ...)
    "FASTVIDEO_TRANSFORMER_QUANT":
    lambda: os.getenv("FASTVIDEO_TRANSFORMER_QUANT", "") or None,
    # text-encoder quantize-at-load, wins over
    # FastVideoArgs.text_encoder_quant; "" disables
    "FASTVIDEO_TEXT_ENCODER_QUANT":
    lambda: os.getenv("FASTVIDEO_TEXT_ENCODER_QUANT", "") or None,
}


def __getattr__(name: str) -> Any:
    if name in environment_flags:
        return environment_flags[name]()
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def __dir__() -> list[str]:
    return list(environment_flags.keys())
