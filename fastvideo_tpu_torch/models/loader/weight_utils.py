"""Checkpoint tensors -> module parameters (port of
fastvideo_tpu/models/loader/weight_utils.py).

Checkpoint names go through the model's regex table, then the whole state
dict is assigned at once onto a module built on the meta device. The load
is strict both ways: a checkpoint tensor with no parameter and a parameter
with no checkpoint tensor are both errors.

The weight of an ``Int8Linear`` is a quantize-at-load slot: the checkpoint
tensor is quantized on the host, as it was stored, and only the int8 weight
and its fp32 scales go to the device.
"""

from __future__ import annotations

import re
from collections.abc import Iterable

import torch
from torch import nn

from fastvideo_tpu_torch.layers.quantization.int8 import (Int8Linear,
                                                          quantize_weight_int8)


def apply_param_mapping(name: str, mapping: dict[str, str]) -> str:
    """Rewrite a checkpoint name through the first matching regex."""
    for pattern, repl in mapping.items():
        new, n = re.subn(pattern, repl, name)
        if n:
            return new
    return name


def load_weights(model: nn.Module,
                 weights: Iterable[tuple[str, torch.Tensor]],
                 param_names_mapping: dict[str, str] | None = None, *,
                 device: torch.device | str, dtype: torch.dtype,
                 optional_prefixes: tuple[str, ...] = ()) -> int:
    """Load ``weights`` into ``model`` on ``device``, floating tensors in
    ``dtype``. Parameters under ``optional_prefixes`` may be missing from the
    checkpoint: they are left as built (on the meta device, for the caller
    to fill). Returns the number of tensors loaded."""
    expected = model.state_dict(keep_vars=True)
    int8_weights = {f"{n}.weight" for n, m in model.named_modules()
                    if isinstance(m, Int8Linear)}
    state: dict[str, torch.Tensor] = {}
    for name, value in weights:
        target = (apply_param_mapping(name, param_names_mapping)
                  if param_names_mapping else name)
        if target in int8_weights:
            prefix = target[:-len("weight")]
            wq, scale = quantize_weight_int8(value.cpu())
            if wq.shape != expected[prefix + "weight_q"].shape:
                raise ValueError(
                    f"Shape mismatch for {target}: checkpoint "
                    f"{tuple(wq.shape)} vs model "
                    f"{tuple(expected[prefix + 'weight_q'].shape)}")
            state[prefix + "weight_q"] = wq.to(device)
            state[prefix + "scale"] = scale.to(device)
            continue
        if target not in expected:
            raise KeyError(f"Checkpoint key {name!r} (-> {target!r}) has no "
                           f"matching parameter in {type(model).__name__}")
        shape = tuple(expected[target].shape)
        if tuple(value.shape) != shape:
            if value.numel() != expected[target].numel():
                raise ValueError(f"Shape mismatch for {target}: checkpoint "
                                 f"{tuple(value.shape)} vs model {shape}")
            value = value.reshape(shape)  # e.g. a [C, 1, 1, 1] norm gamma
        state[target] = value.to(
            device=device,
            dtype=dtype if value.is_floating_point() else value.dtype)
    missing = sorted(n for n in set(expected) - set(state)
                     if not n.startswith(optional_prefixes))
    if missing:
        raise KeyError(f"{type(model).__name__}: {len(missing)} parameters "
                       f"missing from the checkpoint, e.g. {missing[:5]}")
    model.load_state_dict(state, strict=not optional_prefixes, assign=True)
    return len(state)
