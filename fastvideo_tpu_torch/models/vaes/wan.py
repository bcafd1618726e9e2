"""Wan causal VAE, encoder and decoder (port of
fastvideo_tpu/models/vaes/wan.py), in the Wan2.1 layout and the Wan2.2 one
(``is_residual``, ``patch_size``): the Wan2.2 VAE folds 2x2 pixel patches
into the channels before the encoder and unfolds them after the decoder
(:func:`pixel_patchify`), its encoder levels are ``WanResidualDownBlock``s
(residual blocks, a down-sampler, and an average-pool shortcut around them,
``AvgDown3D``) and its decoder levels ``WanResidualUpBlock``s (a duplicating
shortcut, ``DupUp3D``), and its decoder may be wider than its encoder
(``decoder_base_dim``).

Activations are channels-last (NDHWC) inside, NCDHW at the API. Every
stride-1 CausalConv3d whose shape ``ops.conv3d.supports`` accepts runs
through ``conv3d_ndhwc`` (K3 on CUDA); the (3, 1, 1) time convs, the 1x1
convs, the encoder's 3-channel ``conv_in`` and its stride-2 down-sampling
convs stay plain PyTorch convs, as they are XLA convs in the JAX package.
The mid-block attention runs through ``flash_attention`` (K1, head dim
equal to the channel count: 384 in the Wan2.1 decoder, 640 in the Wan2.2
encoder and 1024 in its decoder).

Long clips decode in chunks of latent frames, a Python loop in which each
causal conv carries its last two input frames to the next chunk
(``StreamCache``), so the chunked decode equals the whole-clip decode.
``streaming_decode`` exposes the same carried cache to a caller that
decodes a stream chunk by chunk (the streaming generator).

The encode runs in causal chunks the same way (the JAX package encodes
the whole clip in one program; at 81x480x832 in fp32 one full-resolution
activation is 12.4 GB, and a residual block holds several): frame 0 alone,
then ``scale_factor_temporal`` frames at a time. Each 3x3x3 conv carries
its last two input frames, and each stride-2 time conv of a
``downsample3d`` the input frames its next window starts at (one, in
chunks of an even length), so the chunked encode equals the whole-clip
encode.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from fastvideo_tpu_torch.configs.models.vaes.wan import WanVAEArchConfig
from fastvideo_tpu_torch.ops import conv3d as conv3d_ops
from fastvideo_tpu_torch.ops.flash_attention import flash_attention
from fastvideo_tpu_torch.parallel.collectives import world_all_gather
from fastvideo_tpu_torch.parallel.mesh import get_mesh


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
    """3D conv, temporally causal (2*pt zero frames in front). The weight
    is torch's [Co, C, kt, kh, kw]."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: int | tuple[int, int, int],
                 padding: int | tuple[int, int, int] = 0,
                 stride: int | tuple[int, int, int] = 1, *, device=None,
                 dtype=None):
        super().__init__()
        self.kernel_size = _triple(kernel_size)
        self.pad = _triple(padding)
        self.stride = _triple(stride)
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
        if conv3d_ops.supports(self.kernel_size, self.stride, (tp, ph, pw),
                               x.shape[-1], w.shape[0], w_dim=x.shape[3],
                               mode=mode, h_dim=x.shape[2]):
            return conv3d_ops.conv3d_ndhwc(x, w.permute(2, 3, 4, 1, 0), b,
                                           time_pad=tp, mode=mode)
        if tp or ph or pw:
            x = F.pad(x, (0, 0, pw, pw, ph, ph, tp, 0))
        out = F.conv3d(x.permute(0, 4, 1, 2, 3), w, b, stride=self.stride)
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
    """Up- and down-sampling. Decoder: 2x nearest spatial + (1, 3, 3) conv,
    and for "upsample3d" a doubling (3, 1, 1) time conv over frames >=
    first_len (frame 0 of the clip is never doubled). Encoder: a stride-2
    (1, 3, 3) conv behind a right/bottom zero pad, and for "downsample3d" a
    stride-2 (3, 1, 1) time conv over the whole clip with no pad, frame 0
    passed through in front."""

    def __init__(self, dim: int, mode: str,
                 upsample_out_dim: int | None = None, *, device=None,
                 dtype=None):
        super().__init__()
        if mode not in ("upsample2d", "upsample3d", "downsample2d",
                        "downsample3d"):
            raise NotImplementedError(f"WanResample mode {mode!r}")
        kw = dict(device=device, dtype=dtype)
        self.dim = dim
        self.mode = mode
        if mode.startswith("upsample"):
            out_dim = (upsample_out_dim if upsample_out_dim is not None else
                       dim // 2)
            self.resample_conv = CausalConv3d(dim, out_dim, (1, 3, 3),
                                              padding=(0, 1, 1), **kw)
        else:
            self.resample_conv = CausalConv3d(dim, dim, (1, 3, 3),
                                              stride=(1, 2, 2), **kw)
        self.time_conv = None
        if mode == "upsample3d":
            self.time_conv = CausalConv3d(dim, dim * 2, (3, 1, 1),
                                          padding=(1, 0, 0), **kw)
        elif mode == "downsample3d":
            self.time_conv = CausalConv3d(dim, dim, (3, 1, 1),
                                          stride=(2, 1, 1), **kw)

    def forward(self, x: torch.Tensor, first_len: int = 1,
                ctx: StreamCache | None = None) -> torch.Tensor:
        if self.mode.startswith("downsample"):
            x = self.resample_conv(F.pad(x, (0, 0, 0, 1, 0, 1)))
            if self.mode == "downsample3d":
                x = self._time_downsample(x, first_len, ctx)
            return x
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

    def _time_downsample(self, x: torch.Tensor, first_len: int,
                         ctx: StreamCache | None) -> torch.Tensor:
        """Frames [0, first_len) in front of the stride-2 time conv over
        every frame. In a chunk the conv's input starts with the frames
        cached by the chunk before (where its next window starts), and
        the frames from this chunk's next window on are cached."""
        x0 = x[:, :first_len]
        if ctx is not None:
            prev = ctx.pop()
            if prev is not None:
                x = torch.cat([prev, x], dim=1)
        n_out = (x.shape[1] - 3) // 2 + 1 if x.shape[1] >= 3 else 0
        if ctx is not None:
            ctx.push(x[:, 2 * n_out:].clone())
        if n_out == 0:
            return x0
        return torch.cat([x0, self.time_conv(x[:, :2 * n_out + 1])], dim=1)


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


def pixel_patchify(x: torch.Tensor, p: int | None) -> torch.Tensor:
    """[B, C, T, H, W] -> [B, C p p, T, H / p, W / p], the channel order
    (c, w-sub, h-sub)."""
    if not p or p == 1:
        return x
    b, c, t, h, w = x.shape
    x = x.reshape(b, c, t, h // p, p, w // p, p).permute(0, 1, 6, 4, 2, 3, 5)
    return x.reshape(b, c * p * p, t, h // p, w // p)


def pixel_unpatchify(x: torch.Tensor, p: int | None) -> torch.Tensor:
    """The inverse of :func:`pixel_patchify`."""
    if not p or p == 1:
        return x
    b, cpp, t, h, w = x.shape
    c = cpp // (p * p)
    x = x.reshape(b, c, p, p, t, h, w).permute(0, 1, 4, 5, 3, 6, 2)
    return x.reshape(b, c, t, h * p, w * p)


class AvgDown3D(nn.Module):
    """Space(/time)-to-depth average-pool shortcut: groups of ``factor_t``
    frames (zero frames in front to fill the first) and ``factor_s`` x
    ``factor_s`` pixels fold into the channels (channel-major order), and
    each run of ``group_size`` of those channels is averaged."""

    def __init__(self, in_channels: int, out_channels: int, factor_t: int,
                 factor_s: int = 1):
        super().__init__()
        self.out_channels = out_channels
        self.factor_t = factor_t
        self.factor_s = factor_s
        self.factor = factor_t * factor_s * factor_s
        assert in_channels * self.factor % out_channels == 0
        self.group_size = in_channels * self.factor // out_channels

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        ft, fs = self.factor_t, self.factor_s
        b, t, h, w, c = x.shape
        pad_t = (ft - t % ft) % ft
        if pad_t:
            x = F.pad(x, (0, 0, 0, 0, 0, 0, pad_t, 0))
            t += pad_t
        x = x.reshape(b, t // ft, ft, h // fs, fs, w // fs, fs, c)
        x = x.permute(0, 1, 3, 5, 7, 2, 4, 6).reshape(
            b, t // ft, h // fs, w // fs, self.out_channels, self.group_size)
        return x.mean(dim=-1)


class DupUp3D(nn.Module):
    """Depth-to-space duplicating shortcut: each channel repeated, the
    copies unfolded into ``factor_t`` frames and ``factor_s`` x
    ``factor_s`` pixels; a first chunk (``first_len``) drops the
    ``factor_t - 1`` duplicated leading frames."""

    def __init__(self, in_channels: int, out_channels: int, factor_t: int,
                 factor_s: int = 1):
        super().__init__()
        self.out_channels = out_channels
        self.factor_t = factor_t
        self.factor_s = factor_s
        factor = factor_t * factor_s * factor_s
        assert out_channels * factor % in_channels == 0
        self.repeats = out_channels * factor // in_channels

    def forward(self, x: torch.Tensor, first_len: int = 0) -> torch.Tensor:
        ft, fs = self.factor_t, self.factor_s
        b, t, h, w, _ = x.shape
        x = x.repeat_interleave(self.repeats, dim=-1)
        x = x.reshape(b, t, h, w, self.out_channels, ft, fs, fs)
        x = x.permute(0, 1, 5, 2, 6, 3, 7, 4).reshape(
            b, t * ft, h * fs, w * fs, self.out_channels)
        if first_len:
            x = x[:, ft - 1:]
        return x


class WanResidualDownBlock(nn.Module):
    """A Wan2.2 encoder level: ``num_res_blocks`` residual blocks and a
    down-sampler (``down_flag``), with an ``AvgDown3D`` shortcut of the
    level's input added at the end."""

    def __init__(self, in_dim: int, out_dim: int, num_res_blocks: int,
                 temperal_downsample: bool = False, down_flag: bool = False,
                 *, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.avg_shortcut = AvgDown3D(in_dim, out_dim,
                                      factor_t=2 if temperal_downsample else 1,
                                      factor_s=2 if down_flag else 1)
        self.resnets = nn.ModuleList([
            WanResidualBlock(in_dim if i == 0 else out_dim, out_dim, **kw)
            for i in range(num_res_blocks)
        ])
        self.downsampler = None
        if down_flag:
            mode = "downsample3d" if temperal_downsample else "downsample2d"
            self.downsampler = WanResample(out_dim, mode, **kw)

    def forward(self, x: torch.Tensor, first_len: int = 1,
                ctx: StreamCache | None = None) -> torch.Tensor:
        shortcut = self.avg_shortcut(x)
        for resnet in self.resnets:
            x = resnet(x, ctx)
        if self.downsampler is not None:
            x = self.downsampler(x, first_len=first_len, ctx=ctx)
        return x + shortcut


class WanResidualUpBlock(nn.Module):
    """A Wan2.2 decoder level: ``num_res_blocks + 1`` residual blocks and an
    up-sampler to ``out_dim`` channels (``up_flag``), with a ``DupUp3D``
    shortcut of the level's input added at the end."""

    def __init__(self, in_dim: int, out_dim: int, num_res_blocks: int,
                 temperal_upsample: bool = False, up_flag: bool = False, *,
                 device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.avg_shortcut = (DupUp3D(in_dim, out_dim,
                                     factor_t=2 if temperal_upsample else 1,
                                     factor_s=2) if up_flag else None)
        self.resnets = nn.ModuleList([
            WanResidualBlock(in_dim if i == 0 else out_dim, out_dim, **kw)
            for i in range(num_res_blocks + 1)
        ])
        self.upsampler = None
        if up_flag:
            mode = "upsample3d" if temperal_upsample else "upsample2d"
            self.upsampler = WanResample(out_dim, mode,
                                         upsample_out_dim=out_dim, **kw)

    def forward(self, x: torch.Tensor, first_len: int = 1,
                ctx: StreamCache | None = None) -> torch.Tensor:
        x_copy = x
        for resnet in self.resnets:
            x = resnet(x, ctx)
        if self.upsampler is not None:
            x = self.upsampler(x, first_len=first_len, ctx=ctx)
        if self.avg_shortcut is not None:
            x = x + self.avg_shortcut(x_copy, first_len=first_len)
        return x


class WanEncoder3d(nn.Module):
    """Pixel -> latent pyramid. Wan2.1 flat layout: per level
    ``num_res_blocks`` residual blocks (an attention block after each at
    the scales in ``attn_scales``), then a down-sampler except at the last
    level. Wan2.2 (``is_residual``): one ``WanResidualDownBlock`` a level.
    Then the mid block; RMSNorm, SiLU and ``conv_out`` to 2 * z_dim."""

    def __init__(self, in_channels: int, dim: int, z_dim: int,
                 dim_mult: tuple[int, ...], num_res_blocks: int,
                 attn_scales: tuple[float, ...],
                 temperal_downsample: tuple[bool, ...],
                 is_residual: bool = False, *, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        dims = [dim * u for u in [1, *dim_mult]]
        self.conv_in = CausalConv3d(in_channels, dims[0], 3, padding=1, **kw)
        blocks: list[nn.Module] = []
        scale = 1.0
        for i, (in_dim, out_dim) in enumerate(zip(dims[:-1], dims[1:],
                                                  strict=True)):
            if is_residual:
                last = i == len(dim_mult) - 1
                blocks.append(WanResidualDownBlock(
                    in_dim, out_dim, num_res_blocks,
                    temperal_downsample=(temperal_downsample[i]
                                         if not last else False),
                    down_flag=not last, **kw))
                continue
            for _ in range(num_res_blocks):
                blocks.append(WanResidualBlock(in_dim, out_dim, **kw))
                if scale in attn_scales:
                    blocks.append(WanAttentionBlock(out_dim, **kw))
                in_dim = out_dim
            if i != len(dim_mult) - 1:
                mode = ("downsample3d" if temperal_downsample[i] else
                        "downsample2d")
                blocks.append(WanResample(out_dim, mode, **kw))
                scale /= 2.0
        self.down_blocks = nn.ModuleList(blocks)
        self.mid_block = WanMidBlock(dims[-1], **kw)
        self.norm_out = WanRMSNorm(dims[-1], **kw)
        self.conv_out = CausalConv3d(dims[-1], z_dim, 3, padding=1, **kw)

    def forward(self, x: torch.Tensor, first_len: int = 1,
                ctx: StreamCache | None = None) -> torch.Tensor:
        """x [B, T, H, W, C] -> [B, T', H', W', 2 z_dim]. A chunk whose
        frames a stride-2 time conv consumes without an output (the short
        last chunk of a clip) ends there with no frames."""
        x = self.conv_in(x, ctx=ctx)
        for block in self.down_blocks:
            if isinstance(block, WanResidualBlock):
                x = block(x, ctx)
            elif isinstance(block, (WanResample, WanResidualDownBlock)):
                x = block(x, first_len=first_len, ctx=ctx)
                if x.shape[1] == 0:
                    return x
            else:
                x = block(x)
        x = self.mid_block(x, ctx)
        return self.conv_out(F.silu(self.norm_out(x)), ctx=ctx)


class WanDecoder3d(nn.Module):
    """Latent -> pixel pyramid: the Wan2.1 layout's ``WanUpBlock``s (each
    level after the first takes half its width from an up-sampler), or
    Wan2.2's ``WanResidualUpBlock``s (``is_residual``)."""

    def __init__(self, dim: int, z_dim: int, dim_mult: tuple[int, ...],
                 num_res_blocks: int, temperal_upsample: tuple[bool, ...],
                 out_channels: int = 3, is_residual: bool = False, *,
                 device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        dims = [dim * u for u in [dim_mult[-1], *dim_mult[::-1]]]
        self.conv_in = CausalConv3d(z_dim, dims[0], 3, padding=1, **kw)
        self.mid_block = WanMidBlock(dims[0], **kw)
        up_blocks: list[nn.Module] = []
        for i, (in_dim, out_dim) in enumerate(zip(dims[:-1], dims[1:],
                                                  strict=True)):
            up_flag = i != len(dim_mult) - 1
            if is_residual:
                up_blocks.append(WanResidualUpBlock(
                    in_dim, out_dim, num_res_blocks,
                    temperal_upsample=(temperal_upsample[i] if up_flag
                                       else False),
                    up_flag=up_flag, **kw))
                continue
            if i > 0:
                in_dim = in_dim // 2
            mode = None
            if up_flag:
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


class DiagonalGaussianDistribution:
    """The encoder's posterior, split from its channels-last output [B, T,
    H, W, 2 z] as in the JAX package: mean and logvar (clipped to [-30,
    20]), each [B, T, H, W, z]."""

    def __init__(self, parameters: torch.Tensor):
        self.parameters = parameters
        self.mean, logvar = parameters.chunk(2, dim=-1)
        self.logvar = logvar.clamp(-30.0, 20.0)
        self.std = torch.exp(0.5 * self.logvar)

    def sample(self, generator: torch.Generator | None = None
               ) -> torch.Tensor:
        """mean + std * N(0, 1), the noise from ``generator`` (on the
        posterior's device)."""
        noise = torch.randn(self.mean.shape, generator=generator,
                            dtype=self.mean.dtype, device=self.mean.device)
        return self.mean + self.std * noise

    def mode(self) -> torch.Tensor:
        return self.mean


class AutoencoderKLWan(nn.Module):
    """Wan VAE (2.1, or 2.2 with ``is_residual`` and ``patch_size``); the
    API is NCDHW (the posterior of :meth:`encode` is channels-last, as in
    the JAX package). With ``patch_size`` the configured ``in_channels`` /
    ``out_channels`` are the patchified counts (3 p^2)."""

    # a checkpoint may hold the decoder half alone, as the JAX loader
    # accepts: these parts then load as None (``encode`` refuses)
    droppable_checkpoint_parts = ("encoder", "quant_conv")

    def __init__(self, config: WanVAEArchConfig, *, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.config = config
        self.z_dim = config.z_dim
        self.encoder = WanEncoder3d(
            config.in_channels, config.base_dim, config.z_dim * 2,
            config.dim_mult, config.num_res_blocks, config.attn_scales,
            config.temperal_downsample, config.is_residual, **kw)
        self.quant_conv = CausalConv3d(config.z_dim * 2, config.z_dim * 2, 1,
                                       **kw)
        self.post_quant_conv = CausalConv3d(config.z_dim, config.z_dim, 1, **kw)
        self.decoder = WanDecoder3d(
            config.decoder_base_dim or config.base_dim, config.z_dim,
            config.dim_mult, config.num_res_blocks,
            tuple(config.temperal_downsample[::-1]), config.out_channels,
            config.is_residual, **kw)

    def _latent_stats(self, latents: torch.Tensor
                      ) -> tuple[torch.Tensor, torch.Tensor]:
        shape = (1, -1, 1, 1, 1)
        mean = torch.as_tensor(self.config.latents_mean_arr(),
                               device=latents.device).reshape(shape)
        std = torch.as_tensor(self.config.latents_std_arr(),
                              device=latents.device).reshape(shape)
        return mean, std

    def normalize_latents(self, latents: torch.Tensor) -> torch.Tensor:
        mean, std = self._latent_stats(latents)
        return (latents - mean) / std

    def denormalize_latents(self, latents: torch.Tensor) -> torch.Tensor:
        mean, std = self._latent_stats(latents)
        return latents.float() * std + mean

    def encode(self, x: torch.Tensor, *,
               chunk_frames: int | None = None
               ) -> DiagonalGaussianDistribution:
        """Pixels x [B, C, T, H, W] in [-1, 1] -> the latent posterior
        (channels-last). Frame 0 encodes alone, then ``chunk_frames``
        frames at a time (``scale_factor_temporal`` by default; a multiple
        of it), each conv carrying its causal context from the chunk
        before; ``chunk_frames`` >= T - 1 encodes the clip in one pass, as
        does a Wan2.2-layout clip of other than 1 + ``scale_factor_temporal``
        k frames. A ``patch_size`` VAE patchifies the pixels first."""
        if self.encoder is None:
            raise RuntimeError("this VAE was loaded from a checkpoint "
                               "without its encoder half")
        step = self.config.scale_factor_temporal
        chunk = step if chunk_frames is None else int(chunk_frames)
        x = pixel_patchify(x, self.config.patch_size).permute(0, 2, 3, 4, 1)
        t = x.shape[1]
        if chunk >= t - 1 or (self.config.is_residual and (t - 1) % step):
            out = self.encoder(x)
        else:
            if chunk <= 0 or chunk % step:
                raise ValueError(f"chunk_frames {chunk} is not a positive "
                                 f"multiple of {step}")
            ctx = StreamCache(None)
            outs = [self.encoder(x[:, :1], first_len=1, ctx=ctx)]
            for start in range(1, t, chunk):
                ctx = StreamCache(ctx.out)
                out = self.encoder(x[:, start:start + chunk], first_len=0,
                                   ctx=ctx)
                if out.shape[1]:  # a short last chunk may end with none
                    outs.append(out)
            out = torch.cat(outs, dim=1)
        return DiagonalGaussianDistribution(self.quant_conv(out))

    def encode_latents(self, x: torch.Tensor,
                       generator: torch.Generator | None = None
                       ) -> torch.Tensor:
        """The posterior's sample (with ``generator``) or mode, NCDHW."""
        dist = self.encode(x)
        z = dist.sample(generator) if generator is not None else dist.mode()
        return z.permute(0, 4, 1, 2, 3)

    def decode(self, z: torch.Tensor, *,
               chunk_frames: int | None = None) -> torch.Tensor:
        """z [B, C, T, H, W] (denormalized) -> pixels [B, 3, T', H', W'] in
        fp32 (unpatchified where the VAE has ``patch_size``), clipped to
        [-1, 1] where the config says ``clip_output``. ``chunk_frames``
        latent frames decode at a time; by default clips whose
        full-resolution activations pass ~7e8 elements are chunked."""
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
        out = pixel_unpatchify(out.float().permute(0, 4, 1, 2, 3),
                               self.config.patch_size)
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

    def spatial_tiled_decode(self, z: torch.Tensor, *,
                             tile_latent_min: tuple[int, int] = (32, 32),
                             tile_latent_stride: tuple[int, int] = (24, 24),
                             shard_tiles: bool = False) -> torch.Tensor:
        """Overlapping spatial tiles of z [B, C, T, h, w] (edge-padded to
        whole tiles), decoded as one batch and crossfaded with linear ramps
        over the overlap, then cut to the clip's pixels (the spatial factor
        times ``patch_size``). A clip within one tile decodes whole.

        With ``shard_tiles`` the tiles, stacked on the batch, are padded
        (with copies of the first) to a multiple of the mesh's ranks; each
        rank decodes its contiguous share and the decoded tiles are
        all-gathered over every rank before the blend."""
        b, _, _, lh, lw = z.shape
        th, tw = tile_latent_min
        sh, sw = tile_latent_stride
        if lh <= th and lw <= tw:
            return self.decode(z)
        n_h = max(1, -(-(lh - th) // sh) + 1)
        n_w = max(1, -(-(lw - tw) // sw) + 1)
        pad_h = (n_h - 1) * sh + th - lh
        pad_w = (n_w - 1) * sw + tw - lw
        zp = F.pad(z, (0, pad_w, 0, pad_h, 0, 0), mode="replicate") if (
            pad_h or pad_w) else z
        tiles = [zp[..., i * sh:i * sh + th, j * sw:j * sw + tw]
                 for i in range(n_h) for j in range(n_w)]
        stacked = torch.cat(tiles, dim=0)  # [n_tiles * B, ...]
        if shard_tiles and get_mesh().size > 1:
            mesh = get_mesh()
            n_total = stacked.shape[0]
            pad_tiles = -n_total % mesh.size
            if pad_tiles:
                stacked = torch.cat([stacked, stacked[:pad_tiles]], dim=0)
            per = stacked.shape[0] // mesh.size
            dec = self.decode(stacked[mesh.rank * per:(mesh.rank + 1) * per])
            dec = world_all_gather(dec.contiguous())[:n_total]
        else:
            dec = self.decode(stacked)
        sr = self.config.spatial_compression_ratio * (
            self.config.patch_size or 1)
        dec_tiles = [dec[k * b:(k + 1) * b] for k in range(n_h * n_w)]

        def blend(a, bb, ext, axis):
            ext = min(ext, a.shape[axis], bb.shape[axis])
            if ext <= 0:
                return bb
            shape = [1] * a.ndim
            shape[axis] = ext
            ramp = (torch.arange(ext, dtype=torch.float32, device=a.device)
                    / ext).reshape(shape)
            mixed = (a.narrow(axis, a.shape[axis] - ext, ext) * (1 - ramp)
                     + bb.narrow(axis, 0, ext) * ramp)
            return torch.cat([mixed, bb.narrow(axis, ext,
                                               bb.shape[axis] - ext)],
                             dim=axis)

        rows = []
        for i in range(n_h):
            row = prev = None
            for j in range(n_w):
                tile = dec_tiles[i * n_w + j]
                if row is None:
                    row = tile
                else:
                    row = torch.cat([row[..., :j * sw * sr],
                                     blend(prev, tile, (tw - sw) * sr, 4)],
                                    dim=4)
                prev = tile
            rows.append(row)
        out = prev = None
        for i, row in enumerate(rows):
            if out is None:
                out = row
            else:
                out = torch.cat([out[:, :, :, :i * sh * sr],
                                 blend(prev, row, (th - sh) * sr, 3)], dim=3)
            prev = row
        return out[:, :, :, :lh * sr, :lw * sr]

    def parallel_tiled_decode(self, z: torch.Tensor, **kwargs) -> torch.Tensor:
        """Spatially tiled decode with the tiles shared over the mesh's
        ranks."""
        return self.spatial_tiled_decode(z, shard_tiles=True, **kwargs)

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
