"""LoRA pipeline mixin: convert linears, load / swap / merge adapters (port
of fastvideo_tpu/pipelines/lora_pipeline.py).

Adapter checkpoints are safetensors with diffusers or official naming; each
key goes through the model's ``lora_param_names_mapping``, then its
``param_names_mapping``, to find the target Linear. The file is read with
the port's own safetensors reader.
"""

from __future__ import annotations

import logging
import os
import re

import torch
from torch import nn

from fastvideo_tpu_torch.layers.linear import Linear
from fastvideo_tpu_torch.layers.lora import LoRALinear
from fastvideo_tpu_torch.models.loader.safetensors_io import iterate_file
from fastvideo_tpu_torch.models.loader.weight_utils import apply_param_mapping

logger = logging.getLogger(__name__)

# matched by the child's name alone, so the time and text embedders' MLPs
# (fc_in / fc_out) are converted too
DEFAULT_TARGET_MODULES = ("to_q", "to_k", "to_v", "to_out", "add_k_proj",
                          "add_v_proj", "fc_in", "fc_out")

_KEY = re.compile(r"^(.*)\.(lora_A|lora_B|lora_down|lora_up)"
                  r"(?:\.default)?\.weight$")
_PREFIXES = ("diffusion_model.", "transformer.", "lora_unet_")


def convert_to_lora_layers(model: nn.Module,
                           target_modules=DEFAULT_TARGET_MODULES,
                           rank: int = 16,
                           alpha: float | None = None) -> int:
    """Replace the Linear children named in ``target_modules`` with
    ``LoRALinear`` in place (never a LoRA layer twice; names starting with
    ``_`` are skipped); returns how many."""
    count = 0

    def walk(mod: nn.Module) -> None:
        nonlocal count
        for name, child in list(mod.named_children()):
            if name.startswith("_") or isinstance(child, LoRALinear):
                continue
            if isinstance(child, Linear) and name in target_modules:
                setattr(mod, name, LoRALinear.from_linear(child, rank=rank,
                                                          alpha=alpha))
                count += 1
            else:
                walk(child)

    walk(model)
    logger.info("Converted %d linears to LoRA", count)
    return count


def lora_layers(model: nn.Module) -> list[LoRALinear]:
    return [m for m in model.modules() if isinstance(m, LoRALinear)]


def _resolve_lora_target(model: nn.Module, path: str):
    obj = model
    for part in path.split("."):
        if part.isdigit() and isinstance(obj, (nn.ModuleList, list)):
            idx = int(part)
            obj = obj[idx] if idx < len(obj) else None
        else:
            obj = getattr(obj, part, None)
        if obj is None:
            return None
    return obj


def _adapter_file(path: str) -> str:
    """A ``.safetensors`` file, or the first one (by name) of a directory."""
    if not os.path.isdir(path):
        return path
    cands = sorted(f for f in os.listdir(path) if f.endswith(".safetensors"))
    if not cands:
        raise FileNotFoundError(f"no .safetensors file in {path}")
    return os.path.join(path, cands[0])


def read_lora_pairs(path: str, lora_map: dict[str, str],
                    name_map: dict[str, str]
                    ) -> dict[str, dict[str, torch.Tensor]]:
    """{module path: {"lora_A": [r, in], "lora_B": [out, r]}} of an adapter
    file: the prefixes ``diffusion_model.``, ``transformer.`` and
    ``lora_unet_`` stripped, ``lora_down`` / ``lora_up`` read as A / B (an
    optional ``.default`` infix), then the LoRA mapping and the name
    mapping. Keys of no A / B weight (an ``alpha``) are not read."""
    pairs: dict[str, dict[str, torch.Tensor]] = {}
    for key, tensor in iterate_file(_adapter_file(path)):
        name = key
        for prefix in _PREFIXES:
            if name.startswith(prefix):
                name = name[len(prefix):]
        m = _KEY.match(name)
        if not m:
            continue
        base, which = m.group(1), m.group(2)
        which = {"lora_down": "lora_A", "lora_up": "lora_B"}.get(which, which)
        base = apply_param_mapping(base + ".weight", lora_map)
        base = apply_param_mapping(base, name_map)
        pairs.setdefault(base[:-len(".weight")], {})[which] = tensor
    return pairs


class LoRAPipelineMixin:
    """Adds ``set_lora_adapter``, ``merge_lora_weights`` and
    ``unmerge_lora_weights`` to a pipeline with a ``transformer`` module."""

    def _lora_init(self) -> None:
        if not hasattr(self, "lora_adapters"):
            self.lora_adapters: dict[str, str] = {}
            self.current_adapter: str | None = None

    def set_lora_adapter(self, lora_nickname: str,
                         lora_path: str | None = None) -> None:
        """Load a safetensors adapter (a file or a directory) and attach it;
        a nickname seen before may come without its path. A target that is
        not yet a LoRA layer is converted on demand (rank 16, alpha 16: the
        adapter's rank then sets the scaling to 16 / r); a target that is
        not a Linear (an int8 one) is skipped with a warning."""
        self._lora_init()
        transformer = self.get_module("transformer")
        if lora_path is None:
            lora_path = self.lora_adapters.get(lora_nickname)
        if lora_path is None:
            raise ValueError(f"Unknown LoRA {lora_nickname!r}")
        self.lora_adapters[lora_nickname] = lora_path
        cfg = self.pipeline_config.dit_config
        pairs = read_lora_pairs(lora_path,
                                getattr(cfg, "lora_param_names_mapping", {}),
                                getattr(cfg, "param_names_mapping", {}))
        applied = 0
        for base, ab in pairs.items():
            if "lora_A" not in ab or "lora_B" not in ab:
                continue
            target = _resolve_lora_target(transformer, base)
            if target is None or not isinstance(target, Linear):
                logger.warning("LoRA target %s not found", base)
                continue
            if not isinstance(target, LoRALinear):
                owner_path, _, leaf = base.rpartition(".")
                owner = _resolve_lora_target(transformer, owner_path)
                target = LoRALinear.from_linear(target)
                setattr(owner, leaf, target)
            target.set_adapter(ab["lora_A"], ab["lora_B"])
            applied += 1
        self.current_adapter = lora_nickname
        logger.info("Applied LoRA %s: %d layers", lora_nickname, applied)

    def merge_lora_weights(self) -> None:
        for layer in lora_layers(self.get_module("transformer")):
            layer.merge()

    def unmerge_lora_weights(self) -> None:
        for layer in lora_layers(self.get_module("transformer")):
            layer.unmerge()
