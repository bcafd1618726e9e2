"""Per-component loaders for a diffusers directory (port of
fastvideo_tpu/models/loader/component_loader.py).

A pipeline directory holds model_index.json plus one subdirectory per
component. A model component's config.json picks the module class and
fills its arch config; the module is built on the meta device and the
safetensors tensors are assigned onto the target device in the
component's precision.

Two int8 forms, as in the JAX package: the text encoder may be quantized
at load (``text_encoder_quant``: its linears become ``Int8Linear`` slots on
the meta skeleton and each checkpoint tensor is quantized on the host, so
the full-precision encoder never reaches the device), and the DiT may be
quantized after its load (``transformer_quant``). The environment flags
``FASTVIDEO_TEXT_ENCODER_QUANT`` and ``FASTVIDEO_TRANSFORMER_QUANT`` win
over the arguments.
"""

from __future__ import annotations

import inspect
import logging
import os

import torch

from fastvideo_tpu_torch import envs
from fastvideo_tpu_torch.layers.quantization.int8 import (
    QuantizationConfig, quantize_model_linears, resolve_quant_method)
from fastvideo_tpu_torch.models.loader.safetensors_io import (
    iterate_safetensors, load_json_config)
from fastvideo_tpu_torch.models.loader.tokenizer import load_tokenizer
from fastvideo_tpu_torch.models.loader.weight_utils import load_weights
from fastvideo_tpu_torch.models.registry import (resolve_model_cls,
                                                 resolve_scheduler_cls)
from fastvideo_tpu_torch.models.schedulers.flow_unipc import (
    FlowUniPCMultistepScheduler)

logger = logging.getLogger(__name__)

PRECISION_TO_DTYPE = {
    "fp32": torch.float32, "float32": torch.float32,
    "bf16": torch.bfloat16, "bfloat16": torch.bfloat16,
    "fp16": torch.float16, "float16": torch.float16,
}


def _maybe_quantize_transformer(dit, fastvideo_args):
    """Swap the DiT's linears for int8 once its weights are loaded, when
    ``FASTVIDEO_TRANSFORMER_QUANT`` or ``transformer_quant`` asks for it."""
    spec = envs.FASTVIDEO_TRANSFORMER_QUANT or (
        getattr(fastvideo_args, "transformer_quant", None)
        if fastvideo_args is not None else None)
    if not spec:
        return dit
    method = resolve_quant_method(spec)
    count = quantize_model_linears(dit, QuantizationConfig(method=method))
    logger.info("Quantized %d transformer linears (%s)", count, method)
    return dit


def _build_arch_config(arch_cls, hf_config: dict):
    arch = arch_cls()
    arch.update_from_hf(hf_config)
    if hf_config.get("model_type") == "umt5" and hasattr(arch, "is_umt5"):
        arch.is_umt5 = True
    return arch


def load_model_component(component_dir: str, *, device: torch.device,
                         precision: str = "bf16", model_config=None,
                         quantize_spec: str | None = None,
                         trainable: bool = False,
                         arch_overrides: dict | None = None):
    """Build the component's module and load its weights (strict). With
    ``quantize_spec`` (an int8 alias) its linears are quantized at load.
    With ``trainable`` the module comes back in train mode with every
    parameter requiring grad (the trainer's load), else in eval mode with
    none. ``arch_overrides`` set arch fields over config.json's; parts they
    grow (the class's ``optional_checkpoint_prefixes``) may be missing
    from the checkpoint, and are then left on the meta device for the
    caller to fill."""
    hf_config = load_json_config(os.path.join(component_dir, "config.json"))
    class_name = hf_config.get("_class_name") or hf_config.get(
        "architectures", ["?"])[0]
    model_cls, arch_cls = resolve_model_cls(class_name)
    arch = _build_arch_config(arch_cls, hf_config)
    for key, value in (arch_overrides or {}).items():
        if not hasattr(arch, key):
            raise ValueError(f"{type(arch).__name__} has no field {key!r}")
        setattr(arch, key, value)
    mapping = None
    if model_config is not None:
        # the stages read the checkpoint's real dims from the pipeline config
        model_config.arch_config = arch
        mapping = model_config.param_names_mapping
    dtype = PRECISION_TO_DTYPE[precision]
    model = model_cls(arch, device="meta", dtype=dtype)
    count = 0
    if quantize_spec:
        method = resolve_quant_method(quantize_spec)
        count = quantize_model_linears(model, QuantizationConfig(method=method),
                                       init_only=True)
    n = load_weights(model, iterate_safetensors(component_dir), mapping,
                     device=device, dtype=dtype,
                     ignore_prefixes=getattr(model_cls,
                                             "ignored_checkpoint_prefixes",
                                             ()),
                     optional_prefixes=getattr(
                         model_cls, "optional_checkpoint_prefixes", ())
                     if arch_overrides else ())
    logger.info("Loaded %d tensors for %s from %s (%d linears int8 at load)",
                n, class_name, component_dir, count)
    if trainable:
        if count:
            raise ValueError("an int8-quantized component cannot be trained")
        return model.train().requires_grad_(True)
    return model.eval().requires_grad_(False)


def load_scheduler(component_dir: str, pipeline_config=None):
    """The scheduler the config names. A name the port lacks builds
    FlowUniPC; every ported pipeline installs its own scheduler anyway."""
    cfg = load_json_config(os.path.join(component_dir,
                                        "scheduler_config.json"))
    sched_cls = resolve_scheduler_cls(cfg.get("_class_name", ""))
    if sched_cls is None:
        logger.info("Scheduler %r is not ported; loading FlowUniPC",
                    cfg.get("_class_name"))
        sched_cls = FlowUniPCMultistepScheduler
    valid = set(inspect.signature(sched_cls.__init__).parameters)
    scheduler = sched_cls(**{k: v for k, v in cfg.items() if k in valid})
    if pipeline_config is not None and pipeline_config.flow_shift is not None:
        scheduler.set_shift(pipeline_config.flow_shift)
    return scheduler


class PipelineComponentLoader:
    """Dispatch over component types."""

    @staticmethod
    def load_module(module_name: str, component_dir: str, pipeline_config,
                    device: torch.device, fastvideo_args=None):
        if module_name == "transformer":
            dit = load_model_component(component_dir, device=device,
                                       precision=pipeline_config.precision,
                                       model_config=pipeline_config.dit_config)
            return _maybe_quantize_transformer(dit, fastvideo_args)
        if module_name == "vae":
            return load_model_component(
                component_dir, device=device,
                precision=pipeline_config.vae_precision,
                model_config=pipeline_config.vae_config)
        if module_name == "text_encoder":
            cfgs = pipeline_config.text_encoder_configs
            precisions = pipeline_config.text_encoder_precisions
            quant = envs.FASTVIDEO_TEXT_ENCODER_QUANT or (
                getattr(fastvideo_args, "text_encoder_quant", None)
                if fastvideo_args is not None else None)
            return load_model_component(
                component_dir, device=device,
                precision=precisions[0] if precisions else "fp32",
                model_config=cfgs[0] if cfgs else None, quantize_spec=quant)
        if module_name == "tokenizer":
            return load_tokenizer(component_dir)
        if module_name == "scheduler":
            return load_scheduler(component_dir, pipeline_config)
        raise ValueError(f"Unknown pipeline module {module_name!r}")
