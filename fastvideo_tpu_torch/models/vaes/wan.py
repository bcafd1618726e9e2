"""Wan 2.1 causal VAE, decoder only (port of fastvideo_tpu/models/vaes/wan.py).

Activations are channels-last (NDHWC) inside, NCDHW at the API. Every
CausalConv3d whose shape ``ops.conv3d.supports`` accepts runs through
``conv3d_ndhwc`` (K3 on CUDA); the (3, 1, 1) time convs and the 1x1
convs stay plain PyTorch convs, as they are XLA convs in the JAX package.
The mid-block attention runs through ``flash_attention`` (K1, head dim
equal to the channel count).

Long clips decode in chunks of latent frames, a Python loop in which each
causal conv carries its last two input frames to the next chunk
(``StreamCache``), so the chunked decode equals the whole-clip decode.
``streaming_decode`` exposes the same carried cache to a caller that
decodes a stream chunk by chunk (the streaming generator).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from fastvideo_tpu_torch.configs.models.vaes.wan import WanVAEArchConfig
from fastvideo_tpu_torch.ops import conv3d as conv3d_ops
from fastvideo_tpu_torch.ops.flash_attention import flash_attention


class StreamCache:
    """Conv-cache bookkeeping for chunked decode: each temporal conv takes
    one entry (its last input frames from the previous chunk, in call
    order) and records the updated one."""

    def __init__(self, entries: list[torch.Tensor] | None):
        self.entries = entries
        self.idx = 0
        self.out: list[torch.Tensor] = []

    def pop(self) -> torch.Tensor | None:
        self.idx += 1
        return None if self.entries is None else self.entries[self.idx - 1]

    def push(self, e: torch.Tensor) -> None:
        self.out.append(e)


def _triple(v):
    return (v,) * 3 if isinstance(v, int) else tuple(v)


class CausalConv3d(nn.Module):
    """3D conv with stride 1, temporally causal (2*pt zero frames in
    front). The weight is torch's [Co, C, kt, kh, kw]."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: int | tuple[int, int, int],
                 padding: int | tuple[int, int, int] = 0, *, device=None,
                 dtype=None):
        super().__init__()
        self.kernel_size = _triple(kernel_size)
        self.pad = _triple(padding)
        self.weight = nn.Parameter(torch.empty(out_channels, in_channels,
                                               *self.kernel_size,
                                               device=device, dtype=dtype))
        self.bias = nn.Parameter(torch.zeros(out_channels, device=device,
                                             dtype=dtype))
        if self.weight.device.type != "meta":
            nn.init.kaiming_normal_(self.weight)

    def forward(self, x: torch.Tensor, *,
                ctx: StreamCache | None = None) -> torch.Tensor:
        """x [B, T, H, W, C]. With a StreamCache the causal context comes
        from the previous chunk's cached frames instead of zeros, and this
        chunk's last frames are recorded."""
        pt, ph, pw = self.pad
        tp = need = 2 * pt
        if ctx is not None and tp > 0:
            prev = ctx.pop()
            if prev is not None:
                x = torch.cat([prev.to(x.dtype), x], dim=1)
                tp = 0
            tail = x[:, -need:]
            if tail.shape[1] < need:
                tail = F.pad(tail, (0, 0, 0, 0, 0, 0, need - tail.shape[1], 0))
            ctx.push(tail.clone())
        w = self.weight.to(x.dtype)
        b = self.bias.to(x.dtype)
        mode = conv3d_ops.vae_conv3d_mode()
        if conv3d_ops.supports(self.kernel_size, (1, 1, 1), (tp, ph, pw),
                               x.shape[-1], w.shape[0], w_dim=x.shape[3],
                               mode=mode, h_dim=x.shape[2]):
            return conv3d_ops.conv3d_ndhwc(x, w.permute(2, 3, 4, 1, 0), b,
                                           time_pad=tp, mode=mode)
        if tp or ph or pw:
            x = F.pad(x, (0, 0, pw, pw, ph, ph, tp, 0))
        out = F.conv3d(x.permute(0, 4, 1, 2, 3), w, b)
        return out.permute(0, 2, 3, 4, 1)


class WanRMSNorm(nn.Module):
    """Channels L2-normalized, times sqrt(C) * gamma; the sum of squares in
    fp32, the rescale in the input dtype."""

    def __init__(self, dim: int, *, device=None, dtype=None):
        super().__init__()
        self.scale = dim**0.5
        self.gamma = nn.Parameter(torch.ones(dim, device=device, dtype=dtype))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        sq = x.float().square().sum(dim=-1, keepdim=True)
        inv = (self.scale * torch.rsqrt(sq.clamp_min(1e-24))).to(x.dtype)
        return x * inv * self.gamma.to(x.dtype)


class WanResidualBlock(nn.Module):
    """norm-silu-conv twice, plus a shortcut."""

    def __init__(self, in_dim: int, out_dim: int, *, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.norm1 = WanRMSNorm(in_dim, **kw)
        self.conv1 = CausalConv3d(in_dim, out_dim, 3, padding=1, **kw)
        self.norm2 = WanRMSNorm(out_dim, **kw)
        self.conv2 = CausalConv3d(out_dim, out_dim, 3, padding=1, **kw)
        self.conv_shortcut = (CausalConv3d(in_dim, out_dim, 1, **kw)
                              if in_dim != out_dim else None)

    def forward(self, x: torch.Tensor,
                ctx: StreamCache | None = None) -> torch.Tensor:
        h = self.conv_shortcut(x) if self.conv_shortcut is not None else x
        x = self.conv1(F.silu(self.norm1(x)), ctx=ctx)
        x = self.conv2(F.silu(self.norm2(x)), ctx=ctx)
        return x + h


class WanAttentionBlock(nn.Module):
    """Per-frame single-head spatial self-attention (head dim = channels)."""

    def __init__(self, dim: int, *, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.dim = dim
        self.norm = WanRMSNorm(dim, **kw)
        self.to_qkv = CausalConv3d(dim, dim * 3, 1, **kw)
        self.proj = CausalConv3d(dim, dim, 1, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        identity = x
        b, t, h, w, c = x.shape
        qkv = self.to_qkv(self.norm(x)).reshape(b * t, h * w, 3 * c)
        q, k, v = qkv.split(c, dim=-1)
        out = flash_attention(q[:, :, None], k[:, :, None], v[:, :, None])
        return self.proj(out.reshape(b, t, h, w, c)) + identity


class WanMidBlock(nn.Module):
    """res -> [attn -> res] x num_layers."""

    def __init__(self, dim: int, num_layers: int = 1, *, device=None,
                 dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.attentions = nn.ModuleList(
            [WanAttentionBlock(dim, **kw) for _ in range(num_layers)])
        self.resnets = nn.ModuleList(
            [WanResidualBlock(dim, dim, **kw) for _ in range(num_layers + 1)])

    def forward(self, x: torch.Tensor,
                ctx: StreamCache | None = None) -> torch.Tensor:
        x = self.resnets[0](x, ctx)
        for attn, resnet in zip(self.attentions, self.resnets[1:],
                                strict=True):
            x = resnet(attn(x), ctx)
        return x


class WanResample(nn.Module):
    """Decoder up-sampling: 2x nearest spatial + (1, 3, 3) conv, and for
    "upsample3d" a doubling (3, 1, 1) time conv over frames >= first_len
    (frame 0 of the clip is never doubled)."""

    def __init__(self, dim: int, mode: str,
                 upsample_out_dim: int | None = None, *, device=None,
                 dtype=None):
        super().__init__()
        if mode not in ("upsample2d", "upsample3d"):
            raise NotImplementedError(f"WanResample mode {mode!r}: the port "
                                      "has the decoder only")
        kw = dict(device=device, dtype=dtype)
        self.dim = dim
        self.mode = mode
        out_dim = upsample_out_dim if upsample_out_dim is not None else dim // 2
        self.resample_conv = CausalConv3d(dim, out_dim, (1, 3, 3),
                                          padding=(0, 1, 1), **kw)
        self.time_conv = (CausalConv3d(dim, dim * 2, (3, 1, 1),
                                       padding=(1, 0, 0), **kw)
                          if mode == "upsample3d" else None)

    def forward(self, x: torch.Tensor, first_len: int = 1,
                ctx: StreamCache | None = None) -> torch.Tensor:
        b, t, h, w, c = x.shape
        if self.mode == "upsample3d":
            x0, xr = x[:, :first_len], x[:, first_len:]
            if xr.shape[1] > 0:
                xr = self.time_conv(xr, ctx=ctx)  # [B, Tr, H, W, 2C]
                tr = xr.shape[1]
                xr = xr.reshape(b, tr, h, w, 2, c).permute(0, 1, 4, 2, 3, 5)
                x = torch.cat([x0, xr.reshape(b, tr * 2, h, w, c)], dim=1)
            else:
                # keep the cache order when a chunk holds only frame 0
                if ctx is not None:
                    ctx.pop()
                    ctx.push(x.new_zeros((b, 2, h, w, c)))
                x = x0
        x = x.repeat_interleave(2, dim=2).repeat_interleave(2, dim=3)
        return self.resample_conv(x)


class WanUpBlock(nn.Module):
    """(num_res_blocks + 1) residual blocks and an optional upsampler."""

    def __init__(self, in_dim: int, out_dim: int, num_res_blocks: int,
                 upsample_mode: str | None = None, *, device=None,
                 dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.resnets = nn.ModuleList([
            WanResidualBlock(in_dim if i == 0 else out_dim, out_dim, **kw)
            for i in range(num_res_blocks + 1)
        ])
        self.upsamplers = (nn.ModuleList(
            [WanResample(out_dim, upsample_mode, **kw)])
            if upsample_mode is not None else None)

    def forward(self, x: torch.Tensor, first_len: int = 1,
                ctx: StreamCache | None = None) -> torch.Tensor:
        for resnet in self.resnets:
            x = resnet(x, ctx)
        if self.upsamplers is not None:
            x = self.upsamplers[0](x, first_len=first_len, ctx=ctx)
        return x


class WanDecoder3d(nn.Module):
    """Latent -> pixel pyramid (Wan2.1 layout)."""

    def __init__(self, dim: int, z_dim: int, dim_mult: tuple[int, ...],
                 num_res_blocks: int, temperal_upsample: tuple[bool, ...],
                 out_channels: int = 3, *, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        dims = [dim * u for u in [dim_mult[-1], *dim_mult[::-1]]]
        self.conv_in = CausalConv3d(z_dim, dims[0], 3, padding=1, **kw)
        self.mid_block = WanMidBlock(dims[0], **kw)
        up_blocks = []
        for i, (in_dim, out_dim) in enumerate(zip(dims[:-1], dims[1:],
                                                  strict=True)):
            if i > 0:
                in_dim = in_dim // 2
            mode = None
            if i != len(dim_mult) - 1:
                mode = "upsample3d" if temperal_upsample[i] else "upsample2d"
            up_blocks.append(WanUpBlock(in_dim, out_dim, num_res_blocks, mode,
                                        **kw))
        self.up_blocks = nn.ModuleList(up_blocks)
        self.norm_out = WanRMSNorm(dims[-1], **kw)
        self.conv_out = CausalConv3d(dims[-1], out_channels, 3, padding=1,
                                     **kw)

    def forward(self, x: torch.Tensor, first_len: int = 1,
                ctx: StreamCache | None = None) -> torch.Tensor:
        x = self.conv_in(x, ctx=ctx)
        x = self.mid_block(x, ctx)
        for block in self.up_blocks:
            x = block(x, first_len=first_len, ctx=ctx)
        return self.conv_out(F.silu(self.norm_out(x)), ctx=ctx)


class AutoencoderKLWan(nn.Module):
    """Wan 2.1 VAE decoder; the API is NCDHW."""

    # checkpoint tensors of the encoder half, which the port does not build
    ignored_checkpoint_prefixes = ("encoder.", "quant_conv.")

    def __init__(self, config: WanVAEArchConfig, *, device=None, dtype=None):
        super().__init__()
        if config.is_residual or config.patch_size:
            raise NotImplementedError("the port has the Wan2.1 VAE layout only")
        kw = dict(device=device, dtype=dtype)
        self.config = config
        self.z_dim = config.z_dim
        self.post_quant_conv = CausalConv3d(config.z_dim, config.z_dim, 1, **kw)
        self.decoder = WanDecoder3d(
            config.decoder_base_dim or config.base_dim, config.z_dim,
            config.dim_mult, config.num_res_blocks,
            tuple(config.temperal_downsample[::-1]), config.out_channels,
            **kw)

    def denormalize_latents(self, latents: torch.Tensor) -> torch.Tensor:
        mean = torch.as_tensor(self.config.latents_mean_arr(),
                               device=latents.device)[None, :, None, None,
                                                      None]
        std = torch.as_tensor(self.config.latents_std_arr(),
                              device=latents.device)[None, :, None, None, None]
        return latents.float() * std + mean

    def decode(self, z: torch.Tensor, *,
               chunk_frames: int | None = None) -> torch.Tensor:
        """z [B, C, T, H, W] (denormalized) -> pixels [B, 3, T', H', W'] in
        fp32, clipped to [-1, 1]. ``chunk_frames`` latent frames decode at a
        time; by default clips whose full-resolution activations pass ~7e8
        elements are chunked."""
        x = self.post_quant_conv(z.permute(0, 2, 3, 4, 1))
        b, t, h, w, _ = x.shape
        if chunk_frames is None:
            full_elems = b * t * 4 * h * 8 * w * 8 * 96
            if full_elems > 7e8 and t > 2:
                chunk_frames = max(1, int(7e8 / (full_elems / t)))
        if chunk_frames is not None and t > max(chunk_frames, 1):
            out = self._decode_chunked(x, max(chunk_frames, 1))
        else:
            out = self.decoder(x)
        out = out.float().permute(0, 4, 1, 2, 3)
        if self.config.clip_output:
            out = out.clamp(-1.0, 1.0)
        return out

    def _decode_chunked(self, x: torch.Tensor, chunk: int) -> torch.Tensor:
        ctx = StreamCache(None)
        outs = [self.decoder(x[:, :1], first_len=1, ctx=ctx)]
        for start in range(1, x.shape[1], chunk):
            ctx = StreamCache(ctx.out)
            outs.append(self.decoder(x[:, start:start + chunk], first_len=0,
                                     ctx=ctx))
        return torch.cat(outs, dim=1)


    def streaming_decode(self, z: torch.Tensor,
                         cache: list[torch.Tensor] | None,
                         is_first_chunk: bool = False
                         ) -> tuple[torch.Tensor, list[torch.Tensor]]:
        """Causal streaming decode: one chunk z [B, C, T, H, W]
        (denormalized) in, (pixels [B, 3, T', H', W'], the new conv cache)
        out. With no cache the causal context is zeros and, for the
        stream's first chunk, its first frame is not doubled in time."""
        first_len = 1 if cache is None and is_first_chunk else 0
        ctx = StreamCache(cache)
        out = self._streaming_decode_body(z, ctx, first_len)
        return out, ctx.out

    def _streaming_decode_body(self, z: torch.Tensor, ctx: StreamCache,
                               first_len: int) -> torch.Tensor:
        x = self.post_quant_conv(z.permute(0, 2, 3, 4, 1))
        out = self.decoder(x, first_len=first_len, ctx=ctx).float()
        if self.config.clip_output:
            out = out.clamp(-1.0, 1.0)
        return out.permute(0, 4, 1, 2, 3)
