"""Quantization-aware-training attention (port of
fastvideo_tpu/ops/attn_qat.py).

Attention through FAKE-quantized q, k (and the softmax probabilities):
int8 per (64-token block, head) scales, quantize then dequantize, with a
straight-through gradient (:class:`FakeQuantInt8`, the counterpart of
JAX's ``custom_vjp``), then differentiable fp32 attention math. It is XLA
in JAX, so it is plain PyTorch here.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

QAT_BLOCK = 64


class FakeQuantInt8(torch.autograd.Function):
    """round(x / scale).clip(-127, 127) * scale with an identity gradient
    for x and none for the scale."""

    @staticmethod
    def forward(ctx, x, scale):
        return torch.clamp(torch.round(x / scale), -127, 127) * scale

    @staticmethod
    def backward(ctx, g):
        return g, None


def fake_quant_int8(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return FakeQuantInt8.apply(x, scale)


def _block_scales(x: torch.Tensor, block: int) -> torch.Tensor:
    """Per-(seq-block, head) amax/127 scales for [B, S, H, D] tensors,
    outside the graph."""
    b, s, h, d = x.shape
    xb = x.detach().float().reshape(b, s // block, block, h, d)
    amax = xb.abs().amax(dim=(2, 4), keepdim=True)
    scale = torch.clamp(amax / 127.0, min=1e-8)
    return scale.expand(xb.shape).reshape(x.shape)


def fake_quant_blockwise(x: torch.Tensor, block: int = QAT_BLOCK
                         ) -> torch.Tensor:
    return fake_quant_int8(x.float(), _block_scales(x, block)).to(x.dtype)


def qat_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  scale: float | None = None, quant_p: bool = True,
                  smooth_k: bool = False,
                  block: int = QAT_BLOCK) -> torch.Tensor:
    """Differentiable fake-quantized attention on [B, S, H, D]. Pads the
    sequence to the quant block inside; gradients reach q, k and v through
    the straight-through estimator."""
    b, s, h, d = q.shape
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    # smooth the UNPADDED keys: a mean over zero padding rows would centre
    # k less than the serving-time quantization does
    if smooth_k:
        k = k - k.mean(dim=1, keepdim=True)
    pad = (-s) % block
    if pad:
        q, k, v = (F.pad(x, (0, 0, 0, 0, 0, pad)) for x in (q, k, v))
    qq = fake_quant_blockwise(q, block)
    kq = fake_quant_blockwise(k, block)
    logits = torch.einsum("bshd,bthd->bhst", qq.float(), kq.float()) * scale
    if pad:
        keys = torch.arange(s + pad, device=q.device) < s
        logits = logits.masked_fill(~keys, float("-inf"))
    p = torch.softmax(logits, dim=-1)
    if quant_p:
        # per-(query-block, head) scales over the probability rows
        bp, hp, sq, st = p.shape
        pb = p.detach().reshape(bp, hp, sq // block, block, st)
        amax = torch.clamp(pb.amax(dim=(3, 4), keepdim=True) / 127.0,
                           min=1e-8)
        p = fake_quant_int8(p, amax.expand(pb.shape).reshape(p.shape))
    out = torch.einsum("bhst,bthd->bshd", p, v.float())
    if pad:
        out = out[:, :s]
    return out.to(q.dtype)
