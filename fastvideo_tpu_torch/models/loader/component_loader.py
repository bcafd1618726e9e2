"""Per-component loaders for a diffusers directory (port of
fastvideo_tpu/models/loader/component_loader.py).

A pipeline directory holds model_index.json plus one subdirectory per
component. A model component's config.json picks the module class and
fills its arch config; the module is built on the meta device and the
safetensors tensors are assigned onto the target device in the
component's precision.
"""

from __future__ import annotations

import inspect
import logging
import os

import torch

from fastvideo_tpu_torch.models.loader.safetensors_io import (
    iterate_safetensors, load_json_config)
from fastvideo_tpu_torch.models.loader.tokenizer import load_tokenizer
from fastvideo_tpu_torch.models.loader.weight_utils import load_weights
from fastvideo_tpu_torch.models.registry import resolve_model_cls
from fastvideo_tpu_torch.models.schedulers.flow_unipc import (
    FlowUniPCMultistepScheduler)

logger = logging.getLogger(__name__)

PRECISION_TO_DTYPE = {
    "fp32": torch.float32, "float32": torch.float32,
    "bf16": torch.bfloat16, "bfloat16": torch.bfloat16,
    "fp16": torch.float16, "float16": torch.float16,
}


def _build_arch_config(arch_cls, hf_config: dict):
    arch = arch_cls()
    arch.update_from_hf(hf_config)
    if hf_config.get("model_type") == "umt5" and hasattr(arch, "is_umt5"):
        arch.is_umt5 = True
    return arch


def load_model_component(component_dir: str, *, device: torch.device,
                         precision: str = "bf16", model_config=None):
    """Build the component's module and load its weights (strict)."""
    hf_config = load_json_config(os.path.join(component_dir, "config.json"))
    class_name = hf_config.get("_class_name") or hf_config.get(
        "architectures", ["?"])[0]
    model_cls, arch_cls = resolve_model_cls(class_name)
    arch = _build_arch_config(arch_cls, hf_config)
    mapping = None
    if model_config is not None:
        # the stages read the checkpoint's real dims from the pipeline config
        model_config.arch_config = arch
        mapping = model_config.param_names_mapping
    dtype = PRECISION_TO_DTYPE[precision]
    model = model_cls(arch, device="meta", dtype=dtype)
    n = load_weights(model, iterate_safetensors(component_dir), mapping,
                     device=device, dtype=dtype,
                     ignore_prefixes=getattr(model_cls,
                                             "ignored_checkpoint_prefixes",
                                             ()))
    logger.info("Loaded %d tensors for %s from %s", n, class_name,
                component_dir)
    return model.eval().requires_grad_(False)


def load_scheduler(component_dir: str, pipeline_config=None):
    cfg = load_json_config(os.path.join(component_dir,
                                        "scheduler_config.json"))
    valid = set(inspect.signature(
        FlowUniPCMultistepScheduler.__init__).parameters)
    scheduler = FlowUniPCMultistepScheduler(
        **{k: v for k, v in cfg.items() if k in valid})
    if pipeline_config is not None and pipeline_config.flow_shift is not None:
        scheduler.set_shift(pipeline_config.flow_shift)
    return scheduler


class PipelineComponentLoader:
    """Dispatch over component types."""

    @staticmethod
    def load_module(module_name: str, component_dir: str, pipeline_config,
                    device: torch.device):
        if module_name == "transformer":
            return load_model_component(component_dir, device=device,
                                        precision=pipeline_config.precision,
                                        model_config=pipeline_config.dit_config)
        if module_name == "vae":
            return load_model_component(
                component_dir, device=device,
                precision=pipeline_config.vae_precision,
                model_config=pipeline_config.vae_config)
        if module_name == "text_encoder":
            cfgs = pipeline_config.text_encoder_configs
            precisions = pipeline_config.text_encoder_precisions
            return load_model_component(
                component_dir, device=device,
                precision=precisions[0] if precisions else "fp32",
                model_config=cfgs[0] if cfgs else None)
        if module_name == "tokenizer":
            return load_tokenizer(component_dir)
        if module_name == "scheduler":
            return load_scheduler(component_dir, pipeline_config)
        raise ValueError(f"Unknown pipeline module {module_name!r}")
