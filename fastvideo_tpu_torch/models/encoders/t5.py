"""T5 / UMT5 text encoder (port of fastvideo_tpu/models/encoders/t5.py).

RMS "layer norm" (no mean, no bias), attention without 1/sqrt(d) scaling,
binned relative position bias (in every layer for UMT5, shared from layer
0 for T5), gated-activation FF. Norm statistics and attention scores are
fp32; the matmuls run in the parameter dtype.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
from torch import nn

from fastvideo_tpu_torch.configs.models.encoders.t5 import T5ArchConfig
from fastvideo_tpu_torch.layers.activation import get_act_fn
from fastvideo_tpu_torch.layers.embeddings import Embedding
from fastvideo_tpu_torch.layers.linear import Linear
from fastvideo_tpu_torch.layers.norm import RMSNorm


@dataclasses.dataclass
class BaseEncoderOutput:
    last_hidden_state: torch.Tensor
    attention_mask: torch.Tensor | None = None


def relative_position_bucket(relative_position: np.ndarray,
                             num_buckets: int = 32,
                             max_distance: int = 128) -> np.ndarray:
    """Mesh-TF bidirectional relative position bucketing, on the host."""
    num_buckets //= 2
    relative_buckets = (relative_position > 0).astype(np.int64) * num_buckets
    relative_position = np.abs(relative_position)
    max_exact = num_buckets // 2
    is_small = relative_position < max_exact
    rp_large = max_exact + (
        np.log(np.maximum(relative_position, 1) / max_exact) /
        math.log(max_distance / max_exact) *
        (num_buckets - max_exact)).astype(np.int64)
    rp_large = np.minimum(rp_large, num_buckets - 1)
    return relative_buckets + np.where(is_small, relative_position, rp_large)


class T5SelfAttention(nn.Module):

    def __init__(self, config: T5ArchConfig,
                 has_relative_attention_bias: bool, *, device=None,
                 dtype=None):
        super().__init__()
        self.config = config
        self.n_heads = config.num_heads
        self.d_kv = config.d_kv
        inner = config.num_heads * config.d_kv
        kw = dict(bias=False, device=device, dtype=dtype)
        self.q = Linear(config.d_model, inner, **kw)
        self.k = Linear(config.d_model, inner, **kw)
        self.v = Linear(config.d_model, inner, **kw)
        self.o = Linear(inner, config.d_model, **kw)
        self.relative_attention_bias = (Embedding(
            config.relative_attention_num_buckets, config.num_heads,
            device=device, dtype=dtype)
            if has_relative_attention_bias else None)

    def compute_bias(self, q_len: int, k_len: int) -> torch.Tensor:
        """[1, H, Q, K] additive bias."""
        buckets = relative_position_bucket(
            np.arange(k_len)[None, :] - np.arange(q_len)[:, None],
            num_buckets=self.config.relative_attention_num_buckets,
            max_distance=self.config.relative_attention_max_distance)
        ids = torch.as_tensor(buckets,
                              device=self.relative_attention_bias.weight.device)
        return self.relative_attention_bias(ids).permute(2, 0, 1)[None]

    def forward(self, x: torch.Tensor, position_bias: torch.Tensor | None,
                mask_bias: torch.Tensor | None
                ) -> tuple[torch.Tensor, torch.Tensor | None]:
        b, s, _ = x.shape
        q = self.q(x).reshape(b, s, self.n_heads, self.d_kv)
        k = self.k(x).reshape(b, s, self.n_heads, self.d_kv)
        v = self.v(x).reshape(b, s, self.n_heads, self.d_kv)
        if position_bias is None and self.relative_attention_bias is not None:
            position_bias = self.compute_bias(s, s)
        # T5: no 1/sqrt(d) scale; scores accumulate in fp32
        scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
        if position_bias is not None:
            scores = scores + position_bias.float()
        if mask_bias is not None:
            scores = scores + mask_bias
        probs = torch.softmax(scores, dim=-1).to(v.dtype)
        out = torch.einsum("bhqk,bkhd->bqhd", probs, v).reshape(b, s, -1)
        return self.o(out), position_bias


class T5FF(nn.Module):

    def __init__(self, config: T5ArchConfig, *, device=None, dtype=None):
        super().__init__()
        kw = dict(bias=False, device=device, dtype=dtype)
        self.gated = config.is_gated_act
        if self.gated:
            self.wi_0 = Linear(config.d_model, config.d_ff, **kw)
            self.wi_1 = Linear(config.d_model, config.d_ff, **kw)
        else:
            self.wi = Linear(config.d_model, config.d_ff, **kw)
        self.wo = Linear(config.d_ff, config.d_model, **kw)
        self.act = get_act_fn(config.dense_act_fn)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.gated:
            h = self.act(self.wi_0(x)) * self.wi_1(x)
        else:
            h = self.act(self.wi(x))
        return self.wo(h)


class T5Block(nn.Module):

    def __init__(self, config: T5ArchConfig,
                 has_relative_attention_bias: bool, *, device=None,
                 dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.self_attn = T5SelfAttention(config, has_relative_attention_bias,
                                         **kw)
        self.self_attn_layer_norm = RMSNorm(config.d_model,
                                            config.layer_norm_epsilon, **kw)
        self.ff = T5FF(config, **kw)
        self.ff_layer_norm = RMSNorm(config.d_model, config.layer_norm_epsilon,
                                     **kw)

    def forward(self, x: torch.Tensor, position_bias: torch.Tensor | None,
                mask_bias: torch.Tensor | None
                ) -> tuple[torch.Tensor, torch.Tensor | None]:
        attn_out, position_bias = self.self_attn(
            self.self_attn_layer_norm(x), position_bias, mask_bias)
        x = x + attn_out
        x = x + self.ff(self.ff_layer_norm(x))
        return x, position_bias


class T5EncoderModel(nn.Module):
    """Encoder-only (U)MT5."""

    def __init__(self, config: T5ArchConfig, *, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.config = config
        self.shared = Embedding(config.vocab_size, config.d_model, **kw)
        self.blocks = nn.ModuleList([
            T5Block(config, has_relative_attention_bias=(config.is_umt5
                                                         or i == 0), **kw)
            for i in range(config.num_layers)
        ])
        self.final_layer_norm = RMSNorm(config.d_model,
                                        config.layer_norm_epsilon, **kw)

    def forward(self, input_ids: torch.Tensor,
                attention_mask: torch.Tensor | None = None
                ) -> BaseEncoderOutput:
        x = self.shared(input_ids)
        mask_bias = None
        if attention_mask is not None:
            mask_bias = torch.where(
                attention_mask[:, None, None, :] > 0, 0.0,
                torch.finfo(torch.float32).min).to(x.device)
        position_bias = None
        for block in self.blocks:
            x, pb = block(x, position_bias, mask_bias)
            if not self.config.is_umt5:
                position_bias = pb  # T5 shares the layer-0 bias
        return BaseEncoderOutput(last_hidden_state=self.final_layer_norm(x),
                                 attention_mask=attention_mask)

