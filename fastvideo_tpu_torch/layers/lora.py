"""LoRA linear layers (port of fastvideo_tpu/layers/lora.py): a Linear
augmented with low-rank A/B deltas, with runtime swap, merge and unmerge.

The adapters are held in the torch / peft layouts, ``lora_A`` [r, in] and
``lora_B`` [out, r] (the JAX module holds their transposes). The two thin
products are plain matrix products, outside any kernel, as in JAX.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from fastvideo_tpu_torch.layers.linear import Linear


class LoRALinear(Linear):
    """y = x W^T + b + scaling (x A^T) B^T, scaling = alpha / rank.

    When ``merged`` the delta is folded into the weight and the A/B path is
    skipped; when not ``lora_active`` the layer is its base linear."""

    def __init__(self, in_features: int, out_features: int,
                 bias: bool = True, rank: int = 16,
                 alpha: float | None = None, *, device=None, dtype=None):
        super().__init__(in_features, out_features, bias, device=device,
                         dtype=dtype)
        self.rank = rank
        self.alpha = float(alpha if alpha is not None else rank)
        self.lora_A = nn.Parameter(torch.zeros(rank, in_features,
                                               device=device, dtype=dtype))
        self.lora_B = nn.Parameter(torch.zeros(out_features, rank,
                                               device=device, dtype=dtype))
        self.lora_active = False
        self.merged = False

    @classmethod
    def from_linear(cls, linear: Linear, rank: int = 16,
                    alpha: float | None = None) -> "LoRALinear":
        """A LoRA layer over ``linear``'s own weight and bias tensors (shared,
        not copied), with zero adapters."""
        w = linear.weight
        new = cls(linear.in_features, linear.out_features,
                  bias=linear.bias is not None, rank=rank, alpha=alpha,
                  device="meta", dtype=w.dtype)
        new.weight = w
        new.bias = linear.bias
        new.lora_A = nn.Parameter(torch.zeros(rank, linear.in_features,
                                              device=w.device, dtype=w.dtype))
        new.lora_B = nn.Parameter(torch.zeros(linear.out_features, rank,
                                              device=w.device, dtype=w.dtype))
        return new

    @property
    def scaling(self) -> float:
        return self.alpha / self.rank

    def set_adapter(self, lora_A: torch.Tensor, lora_B: torch.Tensor,
                    alpha: float | None = None) -> None:
        """Attach adapters ``lora_A`` [r, in] and ``lora_B`` [out, r] (cast to
        the weight's dtype and device); the rank becomes r, alpha stays
        unless given."""
        if self.merged:
            self.unmerge()
        w = self.weight
        self.rank = lora_A.shape[0]
        if alpha is not None:
            self.alpha = float(alpha)
        grad = self.lora_A.requires_grad
        self.lora_A = nn.Parameter(
            torch.as_tensor(lora_A).to(device=w.device, dtype=w.dtype),
            requires_grad=grad)
        self.lora_B = nn.Parameter(
            torch.as_tensor(lora_B).to(device=w.device, dtype=w.dtype),
            requires_grad=grad)
        self.lora_active = True

    def _delta(self) -> torch.Tensor:
        """scaling B A [out, in], in fp32."""
        return (self.lora_B.detach().float() @ self.lora_A.detach().float()
                ) * self.scaling

    @torch.no_grad()
    def merge(self) -> None:
        if self.merged or not self.lora_active:
            return
        w = self.weight
        w.copy_((w.float() + self._delta()).to(w.dtype))
        self.merged = True

    @torch.no_grad()
    def unmerge(self) -> None:
        if not self.merged:
            return
        w = self.weight
        w.copy_((w.float() - self._delta()).to(w.dtype))
        self.merged = False

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = super().forward(x)
        if self.lora_active and not self.merged:
            a = self.lora_A.to(x.dtype)
            b = self.lora_B.to(x.dtype)
            y = y + F.linear(F.linear(x, a), b) * self.scaling
        return y
