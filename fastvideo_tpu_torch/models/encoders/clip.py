"""CLIP vision and text towers (port of fastvideo_tpu/models/encoders/clip.py).

The module tree follows HF's ``CLIPVisionModel`` / ``CLIPTextModel`` with the
encoder layers directly under ``vision_model.layers`` / ``text_model.layers``
(the JAX package's tree; ``pre_layrnorm`` keeps the upstream typo). The
patch "conv" is a bias-free Linear over flattened (C, ph, pw) patches, as in
JAX: an HF conv weight [dim, C, p, p] loads into it by reshape.

Numerics follow the JAX towers: LayerNorm statistics in fp32, linears in
the activation dtype, attention as ``jax.nn.dot_product_attention`` computes
it (fp32 logits scaled by 1/sqrt(d), fp32 softmax, probabilities cast to
V's dtype), in plain PyTorch, as the port's UMT5 computes its attention.

:func:`preprocess_image` resizes without PIL: :func:`resize_bicubic` gives
what Pillow's ``Image.resize((S, S))`` gives for an RGB uint8 image.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
from torch import nn

from fastvideo_tpu_torch.configs.models.encoders.clip import (
    CLIPTextArchConfig, CLIPVisionArchConfig)
from fastvideo_tpu_torch.layers.activation import get_act_fn
from fastvideo_tpu_torch.layers.embeddings import Embedding
from fastvideo_tpu_torch.layers.linear import Linear
from fastvideo_tpu_torch.layers.norm import FP32LayerNorm
from fastvideo_tpu_torch.models.encoders.t5 import BaseEncoderOutput


@dataclasses.dataclass
class CLIPTextOutput(BaseEncoderOutput):
    pooler_output: torch.Tensor | None = None


def dot_product_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          bias: torch.Tensor | None = None) -> torch.Tensor:
    """q, k, v [B, S, H, D] -> [B, S, H, D]: fp32 logits times 1/sqrt(D)
    plus ``bias``, fp32 softmax, probabilities in V's dtype."""
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
    scores = scores * (1.0 / math.sqrt(q.shape[-1]))
    if bias is not None:
        scores = scores + bias.float()
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


class CLIPVisionEmbeddings(nn.Module):

    def __init__(self, config: CLIPVisionArchConfig, *, device=None,
                 dtype=None):
        super().__init__()
        self.config = config
        dim = config.hidden_size
        self.class_embedding = nn.Parameter(torch.empty(dim, device=device,
                                                        dtype=dtype))
        if self.class_embedding.device.type != "meta":
            nn.init.normal_(self.class_embedding)
        patch_in = config.patch_size**2 * config.num_channels
        self.patch_embedding = Linear(patch_in, dim, bias=False,
                                      device=device, dtype=dtype)
        num_positions = (config.image_size // config.patch_size)**2 + 1
        self.position_embedding = Embedding(num_positions, dim, device=device,
                                            dtype=dtype)

    def forward(self, pixel_values: torch.Tensor) -> torch.Tensor:
        """pixel_values [B, C, H, W] -> [B, 1 + patches, dim]."""
        b, c, hh, ww = pixel_values.shape
        p = self.config.patch_size
        x = pixel_values.reshape(b, c, hh // p, p, ww // p, p)
        # an HF conv weight [dim, C, p, p] contracts features (C, ph, pw)
        x = x.permute(0, 2, 4, 1, 3, 5).reshape(b, -1, c * p * p)
        patches = self.patch_embedding(x)
        cls = self.class_embedding.to(patches.dtype)[None, None].expand(
            b, 1, -1)
        x = torch.cat([cls, patches], dim=1)
        pos = self.position_embedding(torch.arange(x.shape[1],
                                                   device=x.device))
        return x + pos.to(x.dtype)


class CLIPAttention(nn.Module):

    def __init__(self, hidden_size: int, num_heads: int, *, device=None,
                 dtype=None):
        super().__init__()
        self.num_heads = num_heads
        self.head_dim = hidden_size // num_heads
        kw = dict(device=device, dtype=dtype)
        self.q_proj = Linear(hidden_size, hidden_size, **kw)
        self.k_proj = Linear(hidden_size, hidden_size, **kw)
        self.v_proj = Linear(hidden_size, hidden_size, **kw)
        self.out_proj = Linear(hidden_size, hidden_size, **kw)

    def forward(self, x: torch.Tensor,
                bias: torch.Tensor | None = None) -> torch.Tensor:
        b, s, _ = x.shape
        n, d = self.num_heads, self.head_dim
        q = self.q_proj(x).reshape(b, s, n, d)
        k = self.k_proj(x).reshape(b, s, n, d)
        v = self.v_proj(x).reshape(b, s, n, d)
        out = dot_product_attention(q, k, v, bias)
        return self.out_proj(out.reshape(b, s, -1))


class CLIPMLP(nn.Module):

    def __init__(self, hidden_size: int, intermediate_size: int,
                 hidden_act: str, *, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.fc1 = Linear(hidden_size, intermediate_size, **kw)
        self.fc2 = Linear(intermediate_size, hidden_size, **kw)
        self.act = get_act_fn(hidden_act)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(self.act(self.fc1(x)))


class CLIPEncoderLayer(nn.Module):
    """Pre-norm attention and MLP; the text tower passes its causal bias."""

    def __init__(self, config, *, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        dim, eps = config.hidden_size, config.layer_norm_eps
        self.self_attn = CLIPAttention(dim, config.num_attention_heads, **kw)
        self.layer_norm1 = FP32LayerNorm(dim, eps, **kw)
        self.mlp = CLIPMLP(dim, config.intermediate_size, config.hidden_act,
                           **kw)
        self.layer_norm2 = FP32LayerNorm(dim, eps, **kw)

    def forward(self, x: torch.Tensor,
                bias: torch.Tensor | None = None) -> torch.Tensor:
        x = x + self.self_attn(self.layer_norm1(x), bias)
        return x + self.mlp(self.layer_norm2(x))


class CLIPVisionTransformer(nn.Module):

    def __init__(self, config: CLIPVisionArchConfig, *, device=None,
                 dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        dim, eps = config.hidden_size, config.layer_norm_eps
        self.embeddings = CLIPVisionEmbeddings(config, **kw)
        self.pre_layrnorm = FP32LayerNorm(dim, eps, **kw)
        self.layers = nn.ModuleList([
            CLIPEncoderLayer(config, **kw)
            for _ in range(config.num_hidden_layers)
        ])
        self.post_layernorm = FP32LayerNorm(dim, eps, **kw)

    def forward(self, pixel_values: torch.Tensor) -> torch.Tensor:
        x = self.pre_layrnorm(self.embeddings(pixel_values))
        for layer in self.layers:
            x = layer(x)
        return self.post_layernorm(x)


class CLIPVisionModel(nn.Module):
    """The HF-layout vision tower; ``CLIPVisionModelWithProjection``
    checkpoints load here too, without the visual projection."""

    def __init__(self, config: CLIPVisionArchConfig, *, device=None,
                 dtype=None):
        super().__init__()
        self.config = config
        self.vision_model = CLIPVisionTransformer(config, device=device,
                                                  dtype=dtype)

    def forward(self, pixel_values: torch.Tensor,
                **kwargs) -> BaseEncoderOutput:
        return BaseEncoderOutput(
            last_hidden_state=self.vision_model(pixel_values))


class CLIPTextEmbeddings(nn.Module):

    def __init__(self, config: CLIPTextArchConfig, *, device=None,
                 dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.token_embedding = Embedding(config.vocab_size,
                                         config.hidden_size, **kw)
        self.position_embedding = Embedding(config.max_position_embeddings,
                                            config.hidden_size, **kw)

    def forward(self, input_ids: torch.Tensor) -> torch.Tensor:
        pos = torch.arange(input_ids.shape[1], device=input_ids.device)
        return self.token_embedding(input_ids) + self.position_embedding(pos)


class CLIPTextTransformer(nn.Module):

    def __init__(self, config: CLIPTextArchConfig, *, device=None,
                 dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.config = config
        self.embeddings = CLIPTextEmbeddings(config, **kw)
        self.layers = nn.ModuleList([
            CLIPEncoderLayer(config, **kw)
            for _ in range(config.num_hidden_layers)
        ])
        self.final_layer_norm = FP32LayerNorm(config.hidden_size,
                                              config.layer_norm_eps, **kw)

    def forward(self, input_ids: torch.Tensor,
                attention_mask: torch.Tensor | None = None
                ) -> tuple[torch.Tensor, torch.Tensor]:
        x = self.embeddings(input_ids)
        s = x.shape[1]
        ok = torch.ones(s, s, dtype=torch.bool,
                        device=x.device).tril()[None, None]
        if attention_mask is not None:
            ok = ok & (attention_mask[:, None, None, :] > 0)
        # the additive mask in the activation dtype, as JAX builds it
        bias = torch.where(ok, 0.0, torch.finfo(torch.float32).min).to(
            x.dtype)
        for layer in self.layers:
            x = layer(x, bias)
        x = self.final_layer_norm(x)
        # the pooled token: with the legacy eos_token_id == 2, HF's
        # CLIPTextModel pools at the highest token id; otherwise at the
        # first EOS
        eos = self.config.eos_token_id
        if eos == 2:
            idx = torch.argmax(input_ids, dim=1)
        else:
            idx = torch.argmax((input_ids == eos).to(torch.int32), dim=1)
        pooled = x[torch.arange(x.shape[0], device=x.device), idx]
        return x, pooled


class CLIPTextModel(nn.Module):
    """The HF-layout text tower; with ``config.projection_dim`` set it is
    CLIPTextModelWithProjection: the pooled token goes through the
    bias-free ``text_projection``."""

    def __init__(self, config: CLIPTextArchConfig, *, device=None,
                 dtype=None):
        super().__init__()
        self.config = config
        self.text_model = CLIPTextTransformer(config, device=device,
                                              dtype=dtype)
        proj = getattr(config, "projection_dim", 0) or 0
        self.text_projection = (Linear(config.hidden_size, proj, bias=False,
                                       device=device, dtype=dtype)
                                if proj else None)

    def forward(self, input_ids: torch.Tensor,
                attention_mask: torch.Tensor | None = None,
                **kwargs) -> CLIPTextOutput:
        hidden, pooled = self.text_model(input_ids, attention_mask)
        if self.text_projection is not None:
            pooled = self.text_projection(pooled)
        return CLIPTextOutput(last_hidden_state=hidden,
                              attention_mask=attention_mask,
                              pooler_output=pooled)


# -- Pillow's resize, without PIL --------------------------------------------

# Pillow's fixed-point precision of the 8-bit resample passes
_PRECISION_BITS = 32 - 8 - 2


def _bicubic(x: np.ndarray) -> np.ndarray:
    """Pillow's bicubic kernel (a = -0.5), support 2."""
    a = -0.5
    x = np.abs(x)
    near = ((a + 2.0) * x - (a + 3.0)) * x * x + 1
    far = (((x - 5) * x + 8) * x - 4) * a
    return np.where(x < 1.0, near, np.where(x < 2.0, far, 0.0))


def _resample_coeffs(in_size: int, out_size: int
                     ) -> tuple[np.ndarray, np.ndarray]:
    """Pillow's ``precompute_coeffs`` for the box (0, in_size) and the
    bicubic filter, with ``normalize_coeffs_8bpc``'s rounding: (first source
    index [out], int32 coefficients [out, ksize]; taps past a row's window
    are 0)."""
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = 2.0 * filterscale
    ksize = int(math.ceil(support)) * 2 + 1
    center = (np.arange(out_size) + 0.5) * scale
    # C's (int) truncates toward zero; a negative start is clamped to 0
    xmin = np.maximum(np.trunc(center - support + 0.5), 0).astype(np.int64)
    xmax = np.minimum(np.trunc(center + support + 0.5), in_size).astype(
        np.int64) - xmin
    taps = np.arange(ksize)
    w = _bicubic((taps[None] + xmin[:, None] - center[:, None] + 0.5) *
                 (1.0 / filterscale))
    w = np.where(taps[None] < xmax[:, None], w, 0.0)
    total = np.zeros(out_size)
    for t in range(ksize):  # C's order of the sum
        total = total + w[:, t]
    total = total[:, None]
    w = np.where(total != 0.0, w / np.where(total != 0.0, total, 1.0), w)
    fixed = w * (1 << _PRECISION_BITS)
    kk = np.where(w < 0, np.trunc(-0.5 + fixed), np.trunc(0.5 + fixed))
    return xmin, kk.astype(np.int64)


def _resample_axis(img: np.ndarray, out_size: int, axis: int) -> np.ndarray:
    """One 8-bit pass of Pillow's resample along ``axis`` (0 rows, 1
    columns) of a uint8 [H, W, C] image: the fixed-point sum from the
    rounding half, then the floor shift and the clamp to [0, 255]."""
    in_size = img.shape[axis]
    xmin, kk = _resample_coeffs(in_size, out_size)
    idx = np.minimum(xmin[:, None] + np.arange(kk.shape[1])[None],
                     in_size - 1)
    src = np.take(img.astype(np.int64), idx, axis=axis)
    if axis == 0:  # [out, k, W, C]
        acc = np.einsum("okwc,ok->owc", src, kk)
    else:  # [H, out, k, C]
        acc = np.einsum("hokc,ok->hoc", src, kk)
    acc = acc + (1 << (_PRECISION_BITS - 1))
    return np.clip(acc >> _PRECISION_BITS, 0, 255).astype(np.uint8)


def resize_bicubic(img: np.ndarray, size: tuple[int, int]) -> np.ndarray:
    """What ``PIL.Image.fromarray(img).resize(size)`` gives for a uint8
    [H, W, 3] image: Pillow's default bicubic resample, its support widened
    by the shrink factor, its fixed-point coefficients, a horizontal then a
    vertical pass, each rounded and clamped to uint8. ``size`` is (width,
    height), as PIL's."""
    out_w, out_h = size
    out = np.asarray(img, np.uint8)
    if out.shape[1] != out_w:
        out = _resample_axis(out, out_w, axis=1)
    if out.shape[0] != out_h:
        out = _resample_axis(out, out_h, axis=0)
    return out


def preprocess_image(image: np.ndarray,
                     config: CLIPVisionArchConfig) -> np.ndarray:
    """A uint8 RGB [H, W, 3] image -> normalized fp32 [1, 3, S, S]
    (CLIPImageProcessor's semantics, as the JAX ``preprocess_image``)."""
    size = config.image_size
    arr = resize_bicubic(image, (size, size)).astype(np.float32) / 255.0
    mean = np.asarray(config.image_mean, np.float32)
    std = np.asarray(config.image_std, np.float32)
    arr = (arr - mean) / std
    return arr.transpose(2, 0, 1)[None]


EntryClass = CLIPVisionModel
