"""W8A8 and weight-only int8 linears (port of
fastvideo_tpu/layers/quantization/int8.py).

The weight is torch's ``[out, in]`` (the JAX ``kernel_q`` is its transpose)
with one fp32 scale per output channel. The W8A8 form quantizes the
activations per token at every call and multiplies int8 by int8 with int32
accumulation (:func:`int8_mm`: ``torch._int_mm``, cuBLASLt, on the card),
as the JAX package leaves that product to one ``lax.dot_general``: it is a
plain matrix product, not a Pallas kernel. The quantize and dequantize passes
around it are plain PyTorch, as they are XLA elementwise ops in JAX. The
weight-only form dequantizes the weight to the activation dtype and runs a
plain ``F.linear``.

Every rounding follows the JAX package: scales are ``max(amax / 127, 1e-8)``
in fp32, values round half to even and clip to [-127, 127], the W8A8 output
is ``acc * sx * scale`` in fp32 cast to the layer's parameter dtype, and the
bias is added after that cast.
"""

from __future__ import annotations

import dataclasses
import logging

import torch
import torch.nn.functional as F
from torch import nn

from fastvideo_tpu_torch.layers.embeddings import PatchEmbed3D
from fastvideo_tpu_torch.layers.linear import Linear
from fastvideo_tpu_torch.layers.lora import LoRALinear

logger = logging.getLogger(__name__)


@dataclasses.dataclass
class QuantizationConfig:
    method: str = "int8_w8a8"  # or "int8_weight_only"
    # modules whose path has any of these as a whole word are skipped
    exclude: tuple[str, ...] = ("embedder", "norm", "proj_out")
    # W8A8 only: skip the linears whose output feeds an attention kernel
    # (q/k/v and the VSA gate), as the JAX package does
    exclude_kernel_feeders: bool = True


# linear names (across model families) whose outputs enter an attention
# kernel directly
KERNEL_FEEDER_FRAGMENTS = ("to_q", "to_k", "to_v", "q_proj", "k_proj",
                           "v_proj", "qkv", "compress")

W8A8_ALIASES = ("int8", "int8_w8a8", "w8a8")
WEIGHT_ONLY_ALIASES = ("int8_weight_only", "w8", "weight_only")

# forward calls by method, so that a run can show which linears it took
FORWARD_CALLS = {"int8_w8a8": 0, "int8_weight_only": 0}


def reset_forward_calls() -> None:
    for k in FORWARD_CALLS:
        FORWARD_CALLS[k] = 0


def div127(t: torch.Tensor) -> torch.Tensor:
    """t / 127 rounded as a true division. A CUDA tensor divided by a host
    scalar is multiplied by the scalar's reciprocal instead, which can
    differ in the last bit; dividing by a tensor on the same device does
    not."""
    return t / torch.full_like(t, 127.0)


def quantize_weight_int8(w: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """[out, in] -> (int8 weight [out, in], fp32 scale [out]), amax over
    ``in``. On a CPU tensor this is the JAX package's
    ``host_quantize_weight_int8``: quantize before the upload."""
    amax = w.abs().amax(dim=1).float()  # exact: abs and max do not round
    scale = div127(amax).clamp_min(1e-8)
    wq = torch.round(w.float() / scale[:, None]).clamp_(-127, 127)
    return wq.to(torch.int8), scale


def quantize_activation(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Dynamic per-token symmetric int8: [..., in] -> (int8, fp32 scale
    [..., 1])."""
    amax = x.abs().amax(dim=-1, keepdim=True).float()
    scale = div127(amax).clamp_min(1e-8)
    xq = torch.round(x.float() / scale).clamp_(-127, 127)
    return xq.to(torch.int8), scale


def int8_mm(a: torch.Tensor, b_t: torch.Tensor) -> torch.Tensor:
    """The exact int32 product ``a @ b_t.T`` of int8 [M, K] and [N, K].

    On the card it is ``torch._int_mm`` (cuBLASLt), which takes more than
    16 rows and K and N multiples of 8; other shapes are zero-padded, which
    leaves every sum as it is. On the CPU it is an fp64 product: every
    partial sum is an integer below K * 127**2 < 2**53, so it is exact in
    any order, whichever GEMM the CPU build of PyTorch picks."""
    m, k = a.shape
    n = b_t.shape[0]
    if not a.is_cuda:
        return (a.double() @ b_t.double().t()).to(torch.int32)
    pad_m, pad_k, pad_n = max(17 - m, 0), -k % 8, -n % 8
    if pad_m or pad_k:
        a = F.pad(a, (0, pad_k, 0, pad_m))
    if pad_k or pad_n:
        b_t = F.pad(b_t, (0, pad_k, 0, pad_n))
    out = torch._int_mm(a.contiguous(), b_t.contiguous().t())
    return out if out.shape == (m, n) else out[:m, :n]


class Int8Linear(nn.Module):
    """y = dequant(int8(x) @ int8(W)^T) + b with int32 accumulation, or with
    ``weight_only`` y = x @ dequant(W)^T + b."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True,
                 weight_only: bool = False, *,
                 dtype: torch.dtype = torch.bfloat16, device=None):
        super().__init__()
        self.in_features = in_features
        self.out_features = out_features
        self.weight_only = weight_only
        self.out_dtype = dtype
        self.register_buffer("weight_q", torch.zeros(
            (out_features, in_features), dtype=torch.int8, device=device))
        self.register_buffer("scale", torch.ones(
            (out_features,), dtype=torch.float32, device=device))
        self.bias = (nn.Parameter(torch.zeros(out_features, dtype=dtype,
                                              device=device))
                     if bias else None)

    @classmethod
    def from_linear(cls, linear: Linear, weight_only: bool = False,
                    init_only: bool = False) -> "Int8Linear":
        """``init_only``: swap the module without quantizing the current
        (random or meta) weight; the checkpoint loader assigns the quantized
        values afterwards."""
        w = linear.weight
        new = cls(linear.in_features, linear.out_features,
                  bias=linear.bias is not None, weight_only=weight_only,
                  dtype=w.dtype, device="meta")
        if init_only:
            new.to_empty(device=w.device)
            new.weight_q.zero_()
            new.scale.fill_(1.0)
        else:
            new.weight_q, new.scale = quantize_weight_int8(w.detach())
        new.bias = linear.bias
        return new

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.weight_only:
            FORWARD_CALLS["int8_weight_only"] += 1
            w = (self.weight_q.float() * self.scale[:, None]).to(x.dtype)
            y = F.linear(x, w)
        else:
            FORWARD_CALLS["int8_w8a8"] += 1
            xq, sx = quantize_activation(x)
            acc = int8_mm(xq.reshape(-1, self.in_features), self.weight_q)
            acc = acc.reshape(*x.shape[:-1], self.out_features)
            y = (acc.float() * sx * self.scale).to(self.out_dtype)
        if self.bias is not None:
            y = y + self.bias.to(y.dtype)
        return y


def resolve_quant_method(spec: str) -> str:
    """A user-facing quant spec -> ``QuantizationConfig.method``: after
    lowercasing and ``-`` -> ``_``, any of ``W8A8_ALIASES`` is W8A8 and any
    of ``WEIGHT_ONLY_ALIASES`` weight-only."""
    s = spec.strip().lower().replace("-", "_")
    if s in W8A8_ALIASES:
        return "int8_w8a8"
    if s in WEIGHT_ONLY_ALIASES:
        return "int8_weight_only"
    raise ValueError(
        f"Unknown transformer_quant {spec!r}; accepted: "
        f"{W8A8_ALIASES + WEIGHT_ONLY_ALIASES}")


def quantize_model_linears(model: nn.Module,
                           config: QuantizationConfig | None = None,
                           init_only: bool = False) -> int:
    """Swap the eligible ``Linear`` submodules for ``Int8Linear`` in place and
    return how many. A linear is skipped when an exclude fragment equals a
    component of its dotted path or one of that component's underscore-
    separated words ("embedder" skips "time_embedder", "to_q" skips
    "attn2.to_q", "norm" does not skip "denorm"). A ``PatchEmbed3D`` counts
    as the Linear ``<path>.proj`` that the JAX module holds."""
    config = config or QuantizationConfig()
    fragments = tuple(config.exclude)
    if config.method == "int8_w8a8" and config.exclude_kernel_feeders:
        fragments += KERNEL_FEEDER_FRAGMENTS
    weight_only = config.method == "int8_weight_only"
    count = 0

    def excluded(full: str) -> bool:
        return any(frag == comp or frag in comp.split("_")
                   for comp in full.split(".") for frag in fragments)

    def walk(mod: nn.Module, path: str) -> None:
        nonlocal count
        for name, child in list(mod.named_children()):
            # a LoRA linear keeps its weight (JAX skips a linear that has
            # lora_A)
            if name.startswith("_") or isinstance(child,
                                                  (Int8Linear, LoRALinear)):
                continue
            full = f"{path}.{name}" if path else name
            if isinstance(child, PatchEmbed3D):
                if child.proj is None and not excluded(f"{full}.proj"):
                    proj = Int8Linear.from_linear(
                        child.as_linear(), weight_only=weight_only,
                        init_only=init_only)
                    del child.weight, child.bias
                    child.proj = proj
                    count += 1
            elif not isinstance(child, Linear):
                walk(child, full)
            elif excluded(full):
                logger.debug("int8 quantize: skipping excluded %s", full)
            else:
                setattr(mod, name, Int8Linear.from_linear(
                    child, weight_only=weight_only, init_only=init_only))
                count += 1

    walk(model, "")
    return count
