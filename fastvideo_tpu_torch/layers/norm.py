"""Normalization layers (port of fastvideo_tpu/layers/norm.py).

Every norm takes its statistics in float32 whatever the activation dtype,
and the AdaLN ``norm * (1 + scale) + shift`` helpers keep the modulation in
float32 before casting back, as in the JAX package.
"""

from __future__ import annotations

import torch
from torch import nn


def _f32(t: torch.Tensor | float) -> torch.Tensor | float:
    return t.float() if torch.is_tensor(t) else float(t)


class RMSNorm(nn.Module):
    """w * x / sqrt(mean(x^2) + eps); the statistics in fp32, the result
    cast back to the input dtype before the weight multiply."""

    def __init__(self, hidden_size: int, eps: float = 1e-6, *, device=None,
                 dtype=None):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(hidden_size, device=device,
                                              dtype=dtype))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        var = xf.square().mean(dim=-1, keepdim=True)
        out = (xf * torch.rsqrt(var + self.eps)).to(x.dtype)
        return out * self.weight.to(x.dtype)


class FP32LayerNorm(nn.Module):
    """LayerNorm evaluated in fp32, output cast back to the input dtype."""

    def __init__(self, hidden_size: int, eps: float = 1e-6,
                 elementwise_affine: bool = True, *, device=None, dtype=None):
        super().__init__()
        self.eps = eps
        if elementwise_affine:
            self.weight = nn.Parameter(torch.ones(hidden_size, device=device,
                                                  dtype=dtype))
            self.bias = nn.Parameter(torch.zeros(hidden_size, device=device,
                                                 dtype=dtype))
        else:
            self.weight = None
            self.bias = None

    def norm_f32(self, x: torch.Tensor) -> torch.Tensor:
        """The normalized x in fp32 (affine applied when present)."""
        x = x.float()
        mean = x.mean(dim=-1, keepdim=True)
        var = (x - mean).square().mean(dim=-1, keepdim=True)
        out = (x - mean) * torch.rsqrt(var + self.eps)
        if self.weight is not None:
            out = out * self.weight.float() + self.bias.float()
        return out

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.norm_f32(x).to(x.dtype)


class LayerNormScaleShift(nn.Module):
    """``LN(x) * (1 + scale) + shift`` with the modulation in fp32."""

    def __init__(self, hidden_size: int, eps: float = 1e-6,
                 elementwise_affine: bool = False, *, device=None, dtype=None):
        super().__init__()
        self.norm = FP32LayerNorm(hidden_size, eps, elementwise_affine,
                                  device=device, dtype=dtype)

    def forward(self, x: torch.Tensor, shift: torch.Tensor,
                scale: torch.Tensor) -> torch.Tensor:
        out = self.norm.norm_f32(x) * (1.0 + _f32(scale)) + _f32(shift)
        return out.to(x.dtype)


class ScaleResidual(nn.Module):
    """residual + x * gate (the product in fp32)."""

    def forward(self, residual: torch.Tensor, x: torch.Tensor,
                gate: torch.Tensor | float) -> torch.Tensor:
        return residual + (x.float() * _f32(gate)).to(residual.dtype)


class ScaleResidualLayerNormScaleShift(nn.Module):
    """Gated residual, then LN * (1 + scale) + shift, all in fp32.

    Returns (normed, residual_out) with residual_out = residual + x * gate
    and normed = LN(residual_out) * (1 + scale) + shift.
    """

    def __init__(self, hidden_size: int, eps: float = 1e-6,
                 elementwise_affine: bool = True, *, device=None, dtype=None):
        super().__init__()
        self.norm = FP32LayerNorm(hidden_size, eps, elementwise_affine,
                                  device=device, dtype=dtype)

    def forward(self, residual: torch.Tensor, x: torch.Tensor,
                gate: torch.Tensor | float, shift: torch.Tensor | float,
                scale: torch.Tensor | float
                ) -> tuple[torch.Tensor, torch.Tensor]:
        residual_out = (residual.float() + x.float() * _f32(gate)).to(
            residual.dtype)
        normed = self.norm.norm_f32(residual_out) * (1.0 + _f32(scale)) + \
            _f32(shift)
        return normed.to(residual.dtype), residual_out
