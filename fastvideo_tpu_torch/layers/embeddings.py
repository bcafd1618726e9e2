"""Patch / timestep / modulation embeddings (port of
fastvideo_tpu/layers/embeddings.py)."""

from __future__ import annotations

import math

import torch
from torch import nn

from fastvideo_tpu_torch.layers.activation import get_act_fn
from fastvideo_tpu_torch.layers.linear import Linear
from fastvideo_tpu_torch.layers.mlp import MLP


class Embedding(nn.Module):
    """Lookup table with its leaf named ``weight`` ([num, features])."""

    def __init__(self, num_embeddings: int, features: int, *, device=None,
                 dtype=None):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(num_embeddings, features,
                                               device=device, dtype=dtype))
        if self.weight.device.type != "meta":
            nn.init.normal_(self.weight)

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        return nn.functional.embedding(ids, self.weight)


class PatchEmbed3D(nn.Module):
    """[B, C, T, H, W] -> [B, T/pt * H/ph * W/pw, dim] token embedding.

    The weight is the 5-D ``Conv3d(kernel=stride=patch)`` weight
    [dim, C, pt, ph, pw]; non-overlapping patches make the conv one matmul
    over the (C, pt, ph, pw) features. The JAX module holds that matmul as
    its Linear ``proj``; int8 quantization swaps it in here as an
    ``Int8Linear`` ``proj`` over the [dim, C*pt*ph*pw] weight
    (:meth:`as_linear`), in place of ``weight`` and ``bias``.
    """

    def __init__(self, in_channels: int, embed_dim: int,
                 patch_size: tuple[int, int, int], *, device=None,
                 dtype=None):
        super().__init__()
        self.patch_size = tuple(patch_size)
        self.weight = nn.Parameter(torch.empty(embed_dim, in_channels,
                                               *self.patch_size,
                                               device=device, dtype=dtype))
        self.bias = nn.Parameter(torch.zeros(embed_dim, device=device,
                                             dtype=dtype))
        self.register_module("proj", None)
        if self.weight.device.type != "meta":
            nn.init.xavier_uniform_(self.weight.view(embed_dim, -1))

    def as_linear(self) -> Linear:
        """The patch matmul as a Linear sharing this module's parameters."""
        out = self.weight.shape[0]
        lin = Linear(self.weight[0].numel(), out, device="meta",
                     dtype=self.weight.dtype)
        lin.weight = nn.Parameter(self.weight.reshape(out, -1),
                                  requires_grad=self.weight.requires_grad)
        lin.bias = self.bias
        return lin

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, c, t, h, w = x.shape
        pt, ph, pw = self.patch_size
        x = x.reshape(b, c, t // pt, pt, h // ph, ph, w // pw, pw)
        # token order (t, h, w)-major, features (C, pt, ph, pw)
        x = x.permute(0, 2, 4, 6, 1, 3, 5, 7)
        x = x.reshape(b, (t // pt) * (h // ph) * (w // pw), -1)
        if self.proj is not None:
            return self.proj(x)
        weight = self.weight.reshape(self.weight.shape[0], -1).to(x.dtype)
        return nn.functional.linear(x, weight, self.bias.to(x.dtype))


def timestep_embedding(t: torch.Tensor, dim: int,
                       max_period: int = 10000) -> torch.Tensor:
    """Sinusoidal embedding [cos | sin] in fp32."""
    half = dim // 2
    freqs = torch.exp(-math.log(max_period) *
                      torch.arange(half, dtype=torch.float32,
                                   device=t.device) / half)
    args = t.float()[:, None] * freqs[None]
    emb = torch.cat([torch.cos(args), torch.sin(args)], dim=-1)
    if dim % 2:
        emb = torch.cat([emb, torch.zeros_like(emb[:, :1])], dim=-1)
    return emb


class TimestepEmbedder(nn.Module):
    """Sinusoid -> MLP timestep embedding."""

    def __init__(self, hidden_size: int, act_layer: str = "silu",
                 frequency_embedding_size: int = 256,
                 max_period: int = 10000, *, device=None, dtype=None):
        super().__init__()
        self.frequency_embedding_size = frequency_embedding_size
        self.max_period = max_period
        self.mlp = MLP(frequency_embedding_size, hidden_size, hidden_size,
                       act_type=act_layer, device=device, dtype=dtype)

    def forward(self, t: torch.Tensor,
                timestep_seq_len: int | None = None) -> torch.Tensor:
        """t [N] -> [N, hidden]; with ``timestep_seq_len`` the N timesteps
        are per token, N = B * seq_len, and the result is [B, seq_len,
        hidden]."""
        t_freq = timestep_embedding(t, self.frequency_embedding_size,
                                    self.max_period)
        # the MLP's parameter dtype, read off the bias that a Linear and an
        # Int8Linear both carry
        t_freq = t_freq.to(self.mlp.fc_in.bias.dtype)
        if timestep_seq_len is not None:
            t_freq = t_freq.reshape(-1, timestep_seq_len, t_freq.shape[-1])
        return self.mlp(t_freq)


class ModulateProjection(nn.Module):
    """act -> Linear(dim, dim * factor)."""

    def __init__(self, hidden_size: int, factor: int = 2,
                 act_layer: str = "silu", *, device=None, dtype=None):
        super().__init__()
        self.factor = factor
        self.linear = Linear(hidden_size, hidden_size * factor, bias=True,
                             device=device, dtype=dtype)
        self.act = get_act_fn(act_layer)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.linear(self.act(x))


def unpatchify(x: torch.Tensor, t: int, h: int, w: int,
               patch_size: tuple[int, int, int],
               channels: int) -> torch.Tensor:
    """[B, T*H*W, pt*ph*pw*C] -> [B, C, T*pt, H*ph, W*pw] (Wan's per-patch
    feature order (pt, ph, pw, C))."""
    pt, ph, pw = patch_size
    b = x.shape[0]
    x = x.reshape(b, t, h, w, pt, ph, pw, channels)
    x = x.permute(0, 7, 1, 4, 2, 5, 3, 6)
    return x.reshape(b, channels, t * pt, h * ph, w * pw)
