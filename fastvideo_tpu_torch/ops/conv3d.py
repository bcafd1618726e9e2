"""Causal 3D convolution for the VAE decoder (port of
fastvideo_tpu/ops/conv3d.py).

``conv3d_ndhwc`` keeps the JAX layouts: x [B, T, H, W, C] channels-last,
w [kt, 3, 3, C, Co]. On a CUDA tensor it launches the hand-written sm_90a
implicit-GEMM kernel ``csrc/conv3d.cu`` (K3), which replaces both Pallas
kernels of the JAX package ("kf" ``_conv_kernel_thcw_kf`` and "tap"
``_conv_kernel``): on the TPU they are layouts of one function, so every
direct conv mode name the JAX package accepts routes to K3 here. On a CPU
tensor it runs :func:`conv3d_ndhwc_plain`, a tap-by-tap fp32 sum. The
"wino" mode is another function, an XLA Winograd conv in JAX: it runs
``ops/winograd.py`` in plain PyTorch on both devices.

K3 has two schedules, chosen by :func:`conv_schedule` (the CUDA source
applies the same rule): bf16 runs the Hopper one (``csrc/conv3d_sm90.cuh``:
wgmma, TMA boxes of x that hold three taps each, a ring of stages), for
which the wrapper lays the weight out once a call (:func:`sm90_weight`),
pads the channels to a multiple of 32 (only conv_in's 16 and the tiny
models') and picks the voxel patch of a block (:func:`conv_tile_w`); fp32
runs the same frame with 3xTF32 products ("tf32x3", ``csrc/
conv3d_tf32_sm90.cuh``): each operand split into a TF32 head and tail
(:func:`tf32_round`; the weight on the host, :func:`sm90_weight_tf32`),
three TF32 products a pair, each stage's sum drained into an fp32 total,
which hold the fp32 sum where one TF32 product leaves it by about 1e-3.
Both skip the time taps that read only the causal pad
(:func:`live_time_taps`).

The W8A8 modes "kf_int8" and "auto_int8" route as the JAX package does
(``conv3d_ndhwc``'s int8 branch): where C and Co are multiples of 32 (and,
for "auto_int8", C >= 64 and W >= 256) the input, after the optional
RMSNorm+SiLU prologue, is quantized with one fp32 scale for the whole
tensor and the weight with one scale per Co; :func:`conv3d_int8` then
accumulates int8 x int8 in int32 and writes ``acc * (sw * sx) + b`` in fp32,
cast to the input dtype. On a CUDA tensor that is the hand-written kernel
``csrc/conv3d_int8.cu`` (K4, replacing ``_conv_kernel_thcw_kf_int8``): K3's
Hopper schedule with s8 wgmma and int32 sums, for which the wrapper lays
the int8 weight out in bulk-copy blocks (:func:`sm90_weight_int8`) and
picks the patch
(:func:`conv_tile_w`) and the N tile (:func:`conv_int8_tile_n`); on a CPU
tensor :func:`conv3d_int8_plain`. Every other conv keeps K3, as JAX keeps
its bf16 kernel.

Both kernels serve an fp32 decode (``vae_decode_precision="fp32"``) as the
JAX kernels do: K3 takes fp32 operands (3xTF32 products, fp32 sums and
output) and K4 writes fp32 when the input is fp32.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from fastvideo_tpu_torch import envs
from fastvideo_tpu_torch.layers.quantization.int8 import div127, int8_mm
from fastvideo_tpu_torch.ops import _build

NAME = "conv3d"
NAME_INT8 = "conv3d_int8"
# FASTVIDEO_VAE_CONV3D values: the direct ones name TPU layouts of one conv
# (K3); "wino" is the Winograd conv of ops/winograd.py
CONV3D_MODES = ("auto", "tap", "kf", "thcw", "nb", "dw", "dhw", "full",
                "hoist", "dma", "shift3", "tfold", "wino")
INT8_MODES = ("kf_int8", "auto_int8")
# operand dtype -> the kernels' dtype code
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# K3's Hopper schedule (csrc/conv3d_sm90.cuh): output voxels a block, the
# channels of one K stage, the patch widths a block may take
CONV_BLOCK = 128
CONV_CHUNK = 32
CONV_TILE_WIDTHS = (128, 64, 32, 16, 8)
# the fp32 channels of one K stage of the 3xTF32 schedule (csrc/
# conv3d_tf32_sm90.cuh: kConvChunkF32), and the low bits TF32 drops
CONV_CHUNK_F32 = 16
TF32_DROPPED_BITS = 13


def conv_schedule(dtype: torch.dtype, c: int, co: int) -> str:
    """K3's schedule for operands of ``dtype`` with C in and Co out
    channels: "sm90" (wgmma, TMA) for bf16, every decoder conv at every
    width; "tf32x3" for fp32 (the same frame with three TF32 products a
    pair, as wgmma has no fp32 operand). The CUDA source's ``conv_route``
    states the same rule; C and Co do not choose it."""
    del c, co
    return "sm90" if dtype == torch.bfloat16 else "tf32x3"


def conv_tf32_tile_n(co: int) -> int:
    """Output channels of one block of the 3xTF32 schedule (csrc/
    conv3d_tf32_sm90.cuh:conv_tf32_tile_n): 8 for conv_out's 3, else 96
    (96; 192 and 384: two and four tiles)."""
    return 8 if co <= 8 else 96


def live_time_taps(t: int, kt: int, time_pad: int, t_in: int) -> range:
    """The time taps dt of output frame ``t`` that read a real input frame
    (t + dt - time_pad in [0, t_in)); the kernels skip the others, which
    read only the causal pad (or past the end) and add nothing."""
    return range(max(0, time_pad - t), min(kt, t_in + time_pad - t))


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """fp32 ``x`` rounded to TF32 (10 mantissa bits), to nearest with ties
    away from zero, as ``cvt.rna.tf32.f32`` does: the low 13 bits cleared
    after adding half of their range to the magnitude."""
    half = 1 << (TF32_DROPPED_BITS - 1)
    mask = -(1 << TF32_DROPPED_BITS)
    bits = x.float().contiguous().view(torch.int32)
    return ((bits + half) & mask).view(torch.float32)


def tf32_split(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(hi, lo) = (tf32(x), tf32(x - tf32(x))): the 3xTF32 schedule's head
    and tail of an fp32 operand; hi + lo holds x to about 2^-22."""
    hi = tf32_round(x)
    return hi, tf32_round(x.float() - hi)


def conv3d_tf32x3_plain(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                        *, time_pad: int, products: int = 3) -> torch.Tensor:
    """Plain emulation of the 3xTF32 schedule's arithmetic: the conv of the
    TF32 heads and tails, hi_x hi_w + hi_x lo_w + lo_x hi_w (``products``
    1: hi_x hi_w alone, a single TF32 product), each product exact and
    summed in fp64, plus the bias; fp32 out."""
    xh, xl = tf32_split(x)
    wh, wl = tf32_split(w)
    pairs = [(xh, wh), (xh, wl), (xl, wh)][:products]
    acc = 0.0
    for xa, wa in pairs:
        acc = acc + _conv_taps(xa.double(), wa.double(), time_pad)
    return (acc + b.double()).float()


def conv_tile_n(co: int) -> int:
    """Output channels of one block of the Hopper schedule (csrc/
    conv3d_sm90.cuh:conv_tile_n): 8 for conv_out's 3, 128 where it divides
    Co (384: three tiles), else 96 (96; 192: two tiles)."""
    return 8 if co <= 8 else (128 if co % 128 == 0 else 96)


def conv_int8_tile_n(co: int) -> int:
    """Output channels of one block of K4's Hopper schedule (csrc/
    conv3d_int8.cu:conv8_tile_n), for Co a multiple of 32: 192 where it
    divides Co (192; 384: two tiles), else 96 (96; the route's edges 32
    and 64 pad to 96)."""
    return 192 if co % 192 == 0 else 96


def conv_tile_w(h: int, w: int) -> int:
    """Width bw of the bw x (128 / bw) voxel patch a block of the Hopper
    schedule owns: the one whose patches cover H x W with the fewest
    padded voxels, the widest among equals (fewer halo columns): 64 x 2 at
    W = 832, 16 x 8 at W = 848."""
    best = None
    for bw in CONV_TILE_WIDTHS:
        bh = CONV_BLOCK // bw
        area = -(-w // bw) * bw * (-(-h // bh) * bh)
        if best is None or area < best[0]:
            best = (area, bw)
    return best[1]


def sm90_weight(w: torch.Tensor, bn: int) -> torch.Tensor:
    """w [kt, 3, 3, C, Co] as the Hopper schedules' B operand: [kt * 3 *
    nC, 3, Co_pad, 32], stage (dt, dh, 32-channel chunk c) at (dt * 3 + dh)
    * nC + c, then tap dw, output channel, channel; zeros past C (nC =
    ceil(C / 32)) and past Co (Co_pad a multiple of ``bn``): each output
    channel's 32 channels of a stage are contiguous, the K-major B of
    wgmma. K3 takes it in bf16; K4 regroups the int8 form
    (:func:`sm90_weight_int8`)."""
    kt, _, _, c, co = w.shape
    cp = -(-c // CONV_CHUNK) * CONV_CHUNK
    co_pad = -(-co // bn) * bn
    wp = F.pad(w, (0, co_pad - co, 0, cp - c))
    wp = wp.reshape(kt, 3, 3, cp // CONV_CHUNK, CONV_CHUNK, co_pad)
    return wp.permute(0, 1, 3, 2, 5, 4).reshape(
        kt * 3 * (cp // CONV_CHUNK), 3, co_pad, CONV_CHUNK).contiguous()


def sm90_weight_tf32(w: torch.Tensor, bn: int
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """fp32 w [kt, 3, 3, C, Co] as the 3xTF32 schedule's two B operands,
    its TF32 heads and tails (:func:`tf32_split`), each [kt * 3 * nC, 3,
    Co_pad, 16]: stage (dt, dh, 16-channel chunk c) at (dt * 3 + dh) * nC +
    c, then tap dw, output channel, channel, zeros past C (nC = ceil(C /
    16)) and past Co (Co_pad a multiple of ``bn``): :func:`sm90_weight`'s
    layout with 16 fp32 channels to a 64-byte row in place of 32 bf16."""
    kt, _, _, c, co = w.shape
    cp = -(-c // CONV_CHUNK_F32) * CONV_CHUNK_F32
    co_pad = -(-co // bn) * bn
    out = []
    for part in tf32_split(w):
        wp = F.pad(part, (0, co_pad - co, 0, cp - c))
        wp = wp.reshape(kt, 3, 3, cp // CONV_CHUNK_F32, CONV_CHUNK_F32,
                        co_pad)
        out.append(wp.permute(0, 1, 3, 2, 5, 4).reshape(
            kt * 3 * (cp // CONV_CHUNK_F32), 3, co_pad,
            CONV_CHUNK_F32).contiguous())
    return out[0], out[1]


def sm90_weight_int8(wq: torch.Tensor, bn: int) -> torch.Tensor:
    """int8 wq [kt, 3, 3, C, Co] as K4's B operand: [Co_pad / bn, kt * nC,
    9, bn, 32], N tile, stage (dt, 32-channel chunk c) at dt * nC + c, tap
    (dh, dw) at 3 dh + dw, output channel, channel (zeros past Co, Co_pad a
    multiple of ``bn``), so that each (N tile, stage) is one contiguous
    block of 9 bn 32 bytes that one bulk copy brings into shared memory as
    it is; hence the 32-byte swizzle the kernel's descriptors read is
    applied here: in each 8-row group the 16-byte halves of rows 4..7 are
    swapped (chunk c of row r at c ^ bit 2 of r; csrc/conv3d_int8.cu:
    desc32)."""
    kt, c = wq.shape[0], wq.shape[3]
    nc = -(-c // CONV_CHUNK)
    wb = sm90_weight(wq, bn)  # [kt * 3 * nC, 3, Co_pad, 32], (dt, dh, c)
    co_pad = wb.shape[2]
    wb = wb.reshape(kt, 3, nc, 3, co_pad // bn, bn // 8, 2, 4, 2, 16)
    wb = torch.cat([wb[..., :1, :, :, :], wb[..., 1:, :, :, :].flip(-2)],
                   dim=6)
    return wb.permute(4, 0, 2, 1, 3, 5, 6, 7, 8, 9).reshape(
        co_pad // bn, kt * nc, 9, bn, 32).contiguous()


def vae_conv3d_mode() -> str:
    """The conv mode from ``FASTVIDEO_VAE_CONV3D`` (default "auto")."""
    mode = envs.FASTVIDEO_VAE_CONV3D or "auto"
    if mode not in CONV3D_MODES + INT8_MODES:
        raise ValueError(f"unknown FASTVIDEO_VAE_CONV3D={mode!r}; known: "
                         f"{CONV3D_MODES + INT8_MODES}")
    return mode


def int8_ok(cin: int, cout: int, w_dim: int, mode: str) -> bool:
    """The JAX package's rule for the int8 route of an int8 mode."""
    return (cin % 32 == 0 and cout % 32 == 0
            and (mode == "kf_int8" or (cin >= 64 and w_dim >= 256)))


def supports(kernel_size: tuple[int, int, int], stride: tuple[int, int, int],
             padding: tuple[int, int, int], cin: int, cout: int,
             w_dim: int | None = None, mode: str | None = None,
             h_dim: int | None = None) -> bool:
    """Convs that go through :func:`conv3d_ndhwc`, as in the JAX package's
    ``supports``; everything else stays a plain PyTorch conv. "wino" takes
    ``winograd.supports``. Co not a multiple of 8 (conv_out's 3 channels)
    is taken in the modes whose TPU kernel streams Co on the M dim, at W >=
    256 and C >= 64."""
    if mode == "wino":
        from fastvideo_tpu_torch.ops import winograd

        return winograd.supports(kernel_size, stride, padding, cin, cout,
                                 h_dim=h_dim, w_dim=w_dim)
    kt, kh, kw = kernel_size
    base = (kh == 3 and kw == 3 and kt in (1, 3) and tuple(stride) == (1, 1, 1)
            and padding[1] == 1 and padding[2] == 1 and cin % 8 == 0)
    if not base:
        return False
    if cout % 8 == 0:
        return True
    return (mode in ("thcw", "kf", "auto", "auto_int8", "kf_int8")
            and w_dim is not None and w_dim >= 256 and cin >= 64)


def rms_silu_prologue(x: torch.Tensor, gamma: torch.Tensor) -> torch.Tensor:
    """silu(x * sqrt(C) / ||x|| * gamma): the WanRMSNorm + SiLU that the JAX
    kernel can fuse in front of the conv (statistics in fp32)."""
    c = x.shape[-1]
    sq = x.float().square().sum(dim=-1, keepdim=True)
    inv = (c**0.5 * torch.rsqrt(sq.clamp_min(1e-24))).to(x.dtype)
    return F.silu(x * inv * gamma.to(x.dtype))


def conv3d_ndhwc_plain(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, *,
                       time_pad: int,
                       gamma: torch.Tensor | None = None) -> torch.Tensor:
    """Plain PyTorch version of K3: the sum over the kt*9 taps of
    [voxels, C] @ [C, Co] products, accumulated in fp32."""
    _build.count_plain(NAME)
    if gamma is not None:
        x = rms_silu_prologue(x, gamma)
    acc = _conv_taps(x.float(), w.float(), time_pad)
    return (acc + b.float()).to(x.dtype)


def _conv_taps(x: torch.Tensor, w: torch.Tensor,
               time_pad: int) -> torch.Tensor:
    """The sum over the kt*9 taps of [voxels, C] @ [C, Co] products, in
    x's dtype: the causal conv without its bias."""
    kt = w.shape[0]
    bsz, t, h, wd, c = x.shape
    co = w.shape[-1]
    t_out = t + time_pad - kt + 1
    xp = F.pad(x, (0, 0, 1, 1, 1, 1, time_pad, 0))
    acc = torch.zeros((bsz, t_out, h, wd, co), dtype=x.dtype,
                      device=x.device)
    for dt in range(kt):
        for dh in range(3):
            for dw in range(3):
                tap = xp[:, dt:dt + t_out, dh:dh + h, dw:dw + wd]
                acc += torch.matmul(tap, w[dt, dh, dw])
    return acc


def quantize_int8(x: torch.Tensor, dims: tuple[int, ...] | None = None
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric int8 with one fp32 scale over ``dims`` (None: the whole
    tensor): (q, s) with x ~= q * s, s = max(amax, 1e-8) / 127 kept with
    the reduced dims, as JAX's ``_quantize_int8``. The whole-tensor form
    takes its amax with ``aminmax`` (no temporary) and quantizes one slice
    of dim 1 at a time, so a full-size decode chunk needs no fp32 copy of
    itself."""
    if dims is None:
        lo, hi = torch.aminmax(x)
        amax = torch.maximum(lo.abs(), hi.abs()).float()
        s = div127(amax.clamp_min(1e-8)).reshape((1,) * x.ndim)
        q = torch.empty(x.shape, dtype=torch.int8, device=x.device)
        for i in range(x.shape[1]):
            xf = x[:, i].to(torch.float32, copy=True)
            q[:, i] = xf.div_(s[:, 0]).round_().clamp_(-127, 127)
        return q, s
    amax = x.abs().amax(dim=dims, keepdim=True).float()
    s = div127(amax.clamp_min(1e-8))
    q = torch.round(x.float() / s).clamp_(-127, 127).to(torch.int8)
    return q, s


def conv3d_int8_plain(xq: torch.Tensor, wq: torch.Tensor, scale: torch.Tensor,
                      bias: torch.Tensor, *, time_pad: int,
                      out_dtype: torch.dtype) -> torch.Tensor:
    """Plain PyTorch version of K4: the sum over the kt*9 taps of exact int32
    [voxels, C] @ [C, Co] products (``int8_mm``), then
    ``acc * scale + bias`` in fp32."""
    _build.count_plain(NAME_INT8)
    kt = wq.shape[0]
    bsz, t, h, wd, c = xq.shape
    co = wq.shape[-1]
    t_out = t + time_pad - kt + 1
    xp = F.pad(xq, (0, 0, 1, 1, 1, 1, time_pad, 0))
    acc = torch.zeros((bsz * t_out * h * wd, co), dtype=torch.int32,
                      device=xq.device)
    for dt in range(kt):
        for dh in range(3):
            for dw in range(3):
                tap = xp[:, dt:dt + t_out, dh:dh + h, dw:dw + wd]
                acc += int8_mm(tap.reshape(-1, c), wq[dt, dh, dw].t())
    out = acc.float() * scale.float() + bias.float()
    return out.to(out_dtype).reshape(bsz, t_out, h, wd, co)


def _conv3d_int8_cuda(xq, wq, scale, bias, time_pad, out_dtype):
    _build.refuse_grad(NAME_INT8, scale, bias)
    _build.check_device(xq, NAME_INT8)
    if xq.dtype != torch.int8 or wq.dtype != torch.int8:
        raise _build.KernelError(
            f"conv3d_int8: takes int8 x and w, got {xq.dtype}, {wq.dtype}")
    if scale.dtype != torch.float32 or bias.dtype != torch.float32:
        raise _build.KernelError(
            f"conv3d_int8: takes fp32 scale and bias, got {scale.dtype}, "
            f"{bias.dtype}")
    if out_dtype not in _DTYPE_CODES:
        raise _build.KernelError(
            f"conv3d_int8: writes bfloat16 or float32, asked for {out_dtype}")
    kt, kh, kw, c, co = wq.shape
    if ((kh, kw) != (3, 3) or kt not in (1, 3) or c % 32 or co % 32
            or xq.shape[-1] != c or scale.shape != (co,)
            or bias.shape != (co,)):
        raise _build.KernelError(
            f"conv3d_int8: unsupported kernel {tuple(wq.shape)} for input "
            f"{tuple(xq.shape)} (C and Co must be multiples of 32)")
    xq = xq.contiguous()
    if xq.data_ptr() % 16:
        xq = xq.clone()
    bn = conv_int8_tile_n(co)
    wb = sm90_weight_int8(wq, bn)
    bsz, t, h, wd, _ = xq.shape
    t_out = t + time_pad - kt + 1
    y = torch.empty((bsz, t_out, h, wd, co), dtype=out_dtype,
                    device=xq.device)
    _build.launch(NAME_INT8, "fvt_conv3d_int8_sm90", xq.data_ptr(),
                  wb.data_ptr(), scale.contiguous().data_ptr(),
                  bias.contiguous().data_ptr(), y.data_ptr(),
                  _DTYPE_CODES[out_dtype], bsz, t, h, wd, c, co, kt, time_pad,
                  bn, conv_tile_w(h, wd), _build.stream_ptr(xq))
    return y


def conv3d_int8(xq: torch.Tensor, wq: torch.Tensor, scale: torch.Tensor,
                bias: torch.Tensor, *, time_pad: int,
                out_dtype: torch.dtype) -> torch.Tensor:
    """K4: causal conv of int8 xq [B, T, H, W, C] with int8 wq [kt, 3, 3, C,
    Co], int32 sums, out = (acc * scale[co] + bias[co]) in fp32 cast to
    ``out_dtype`` (bfloat16 or float32); ``time_pad`` zero frames in front,
    SAME spatial pad."""
    if xq.is_cuda:
        return _conv3d_int8_cuda(xq, wq, scale, bias, time_pad, out_dtype)
    if xq.device.type == "cpu":
        return conv3d_int8_plain(xq, wq, scale, bias, time_pad=time_pad,
                                 out_dtype=out_dtype)
    raise _build.KernelError(f"{NAME_INT8}: unsupported device {xq.device}")


def _conv3d_cuda(x, w, b, time_pad, gamma):
    _build.refuse_grad(NAME, x, w, b)
    _build.check_device(x, NAME)
    if gamma is not None:
        raise _build.KernelError(
            "conv3d: the fused RMSNorm+SiLU prologue is not ported to CUDA "
            "(it is off by default: FASTVIDEO_VAE_FUSE_NORM=0)")
    if x.dtype not in _DTYPE_CODES or any(t.dtype != x.dtype for t in (w, b)):
        raise _build.KernelError(
            f"conv3d: takes bfloat16 or float32 operands of one dtype, got "
            f"{[t.dtype for t in (x, w, b)]}")
    kt, kh, kw, c, co = w.shape
    if (kh, kw) != (3, 3) or kt not in (1, 3) or c % 8 or x.shape[-1] != c:
        raise _build.KernelError(
            f"conv3d: unsupported kernel {tuple(w.shape)} for input "
            f"{tuple(x.shape)}")
    bsz, t, h, wd, _ = x.shape
    t_out = t + time_pad - kt + 1
    y = torch.empty((bsz, t_out, h, wd, co), dtype=x.dtype, device=x.device)
    b = b.contiguous()
    if conv_schedule(x.dtype, c, co) == "tf32x3":
        cp = -(-c // CONV_CHUNK_F32) * CONV_CHUNK_F32
        if cp != c:  # zero channels up to the 16 of a stage (tiny models)
            x = F.pad(x, (0, cp - c))
        x = x.contiguous()
        if x.data_ptr() % 16:
            x = x.clone()
        bn = conv_tf32_tile_n(co)
        w_hi, w_lo = sm90_weight_tf32(w, bn)
        _build.launch(NAME, "fvt_conv3d_tf32", x.data_ptr(), w_hi.data_ptr(),
                      w_lo.data_ptr(), b.data_ptr(), y.data_ptr(), bsz, t, h,
                      wd, cp, co, kt, time_pad, bn, conv_tile_w(h, wd),
                      _build.stream_ptr(x))
        return y
    cp = -(-c // CONV_CHUNK) * CONV_CHUNK
    if cp != c:  # zero channels up to the 32 of a stage (conv_in's 16)
        x = F.pad(x, (0, cp - c))
    x = x.contiguous()
    if x.data_ptr() % 16:
        x = x.clone()
    bn = conv_tile_n(co)
    wb = sm90_weight(w, bn)
    _build.launch(NAME, "fvt_conv3d_sm90", x.data_ptr(), wb.data_ptr(),
                  b.data_ptr(), y.data_ptr(), bsz, t, h, wd, cp, co, kt,
                  time_pad, bn, conv_tile_w(h, wd), _build.stream_ptr(x))
    return y


def conv3d_ndhwc(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, *,
                 time_pad: int, gamma: torch.Tensor | None = None,
                 mode: str = "auto") -> torch.Tensor:
    """Causal 3D conv on [B, T, H, W, C] with kernel [kt, 3, 3, C, Co].

    ``time_pad`` zero frames go in front (causal); spatial padding is SAME.
    With ``gamma``, computes ``conv(silu(rmsnorm(x) * sqrt(C) * gamma))``.
    ``mode`` is any FASTVIDEO_VAE_CONV3D name: "wino" computes the
    Winograd conv of ``ops/winograd.py`` on either device (JAX falls back
    to "auto" where XLA fails to compile it on the TPU; eager PyTorch has
    no such failure, and ``winograd.supports`` keeps JAX's routing); the
    int8 modes take K4 where :func:`int8_ok` allows (the prologue runs
    before the quantization); every other conv goes through K3.
    """
    if mode not in CONV3D_MODES + INT8_MODES:
        raise ValueError(f"conv3d_ndhwc: mode {mode!r} is not one of "
                         f"{CONV3D_MODES + INT8_MODES}")
    if mode == "wino":
        from fastvideo_tpu_torch.ops.winograd import conv3d_winograd_ndhwc

        return conv3d_winograd_ndhwc(x, w, b, time_pad=time_pad, gamma=gamma)
    if mode in INT8_MODES and int8_ok(x.shape[-1], w.shape[-1], x.shape[3],
                                      mode):
        if x.is_cuda:  # the quantization would cut the graph before K4
            _build.refuse_grad(NAME_INT8, x, w, b)
        if gamma is not None:
            x = rms_silu_prologue(x, gamma)
        xq, sx = quantize_int8(x)
        wq, sw = quantize_int8(w, dims=(0, 1, 2, 3))
        scale = sw.reshape(-1) * sx.reshape(())
        return conv3d_int8(xq, wq, scale, b.float(), time_pad=time_pad,
                           out_dtype=x.dtype)
    if x.is_cuda:
        return _conv3d_cuda(x, w, b, time_pad, gamma)
    if x.device.type == "cpu":
        return conv3d_ndhwc_plain(x, w, b, time_pad=time_pad, gamma=gamma)
    raise _build.KernelError(f"{NAME}: unsupported device {x.device}")
