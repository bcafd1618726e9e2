"""FastVideoArgs: runtime configuration (port of
fastvideo_tpu/fastvideo_args.py, the fields the inference path reads).

The port runs on one card: ``num_gpus``, ``sp_size`` and ``tp_size`` must
be 1 until the parallelism slice.
"""

from __future__ import annotations

import dataclasses
from typing import Any


@dataclasses.dataclass
class FastVideoArgs:
    model_path: str = ""
    num_gpus: int = 1
    tp_size: int = 1
    sp_size: int = 1
    # "cuda" (default) or "cpu"; resolved by the entry point
    device: str | None = None
    flow_shift: float | None = None
    VSA_sparsity: float = 0.0
    # int8 quantization of the DiT's linears after load ("int8" W8A8 or
    # "int8-weight-only"), and of the text encoder's linears at load
    # (FASTVIDEO_TRANSFORMER_QUANT / FASTVIDEO_TEXT_ENCODER_QUANT win)
    transformer_quant: str | None = None
    text_encoder_quant: str | None = None
    pipeline_config: Any = None

    @classmethod
    def from_kwargs(cls, **kwargs) -> "FastVideoArgs":
        unknown = set(kwargs) - {f.name for f in dataclasses.fields(cls)}
        if unknown:
            raise TypeError(f"unknown arguments for the port: {sorted(unknown)}")
        args = cls(**kwargs)
        if args.num_gpus != 1 or args.sp_size != 1 or args.tp_size != 1:
            raise NotImplementedError(
                "the port runs on one card (num_gpus = sp_size = tp_size = 1)")
        return args
