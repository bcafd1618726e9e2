"""Causal 3D convolution for the VAE decoder (port of
fastvideo_tpu/ops/conv3d.py).

``conv3d_ndhwc`` keeps the JAX layouts: x [B, T, H, W, C] channels-last,
w [kt, 3, 3, C, Co]. On a CUDA tensor it launches the hand-written sm_90a
implicit-GEMM kernel ``csrc/conv3d.cu`` (K3), which replaces both Pallas
kernels of the JAX package ("kf" ``_conv_kernel_thcw_kf`` and "tap"
``_conv_kernel``): on the TPU they are two layouts of one function, so
every conv mode name the JAX package accepts routes to K3 here. On a CPU
tensor it runs :func:`conv3d_ndhwc_plain`, a tap-by-tap fp32 sum.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from fastvideo_tpu_torch import envs
from fastvideo_tpu_torch.ops import _build

NAME = "conv3d"
# FASTVIDEO_VAE_CONV3D values: each names a TPU layout of the same conv
CONV3D_MODES = ("auto", "tap", "kf", "thcw", "nb", "dw", "dhw", "full",
                "hoist", "dma", "shift3", "tfold", "wino")
INT8_MODES = ("kf_int8", "auto_int8")


def vae_conv3d_mode() -> str:
    """The conv mode from ``FASTVIDEO_VAE_CONV3D`` (default "auto")."""
    mode = envs.FASTVIDEO_VAE_CONV3D or "auto"
    if mode in INT8_MODES:
        raise NotImplementedError(
            f"FASTVIDEO_VAE_CONV3D={mode}: the W8A8 conv (Pallas "
            "_conv_kernel_thcw_kf_int8) is not ported yet")
    if mode not in CONV3D_MODES:
        raise ValueError(f"unknown FASTVIDEO_VAE_CONV3D={mode!r}; known: "
                         f"{CONV3D_MODES}")
    return mode


def supports(kernel_size: tuple[int, int, int], stride: tuple[int, int, int],
             padding: tuple[int, int, int], cin: int, cout: int,
             w_dim: int | None = None, mode: str | None = None,
             h_dim: int | None = None) -> bool:
    """Convs that go through K3, as in the JAX package's ``supports``;
    everything else stays a plain PyTorch conv. Co not a multiple of 8
    (conv_out's 3 channels) is taken in the modes whose TPU kernel streams
    Co on the M dim, at W >= 256 and C >= 64."""
    del h_dim
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
    kt = w.shape[0]
    bsz, t, h, wd, c = x.shape
    co = w.shape[-1]
    t_out = t + time_pad - kt + 1
    xp = F.pad(x.float(), (0, 0, 1, 1, 1, 1, time_pad, 0))
    wf = w.float()
    acc = torch.zeros((bsz, t_out, h, wd, co), dtype=torch.float32,
                      device=x.device)
    for dt in range(kt):
        for dh in range(3):
            for dw in range(3):
                tap = xp[:, dt:dt + t_out, dh:dh + h, dw:dw + wd]
                acc += torch.matmul(tap, wf[dt, dh, dw])
    return (acc + b.float()).to(x.dtype)


def _conv3d_cuda(x, w, b, time_pad, gamma):
    _build.check_device(x, NAME)
    if gamma is not None:
        raise _build.KernelError(
            "conv3d: the fused RMSNorm+SiLU prologue is not ported to CUDA "
            "(it is off by default: FASTVIDEO_VAE_FUSE_NORM=0)")
    if any(t.dtype != torch.bfloat16 for t in (x, w, b)):
        raise _build.KernelError(
            f"conv3d: takes bfloat16 operands, got "
            f"{[t.dtype for t in (x, w, b)]}")
    kt, kh, kw, c, co = w.shape
    if (kh, kw) != (3, 3) or kt not in (1, 3) or c % 8 or x.shape[-1] != c:
        raise _build.KernelError(
            f"conv3d: unsupported kernel {tuple(w.shape)} for input "
            f"{tuple(x.shape)}")
    x = x.contiguous()
    if x.data_ptr() % 16:
        x = x.clone()
    w = w.contiguous()
    b = b.contiguous()
    bsz, t, h, wd, _ = x.shape
    t_out = t + time_pad - kt + 1
    y = torch.empty((bsz, t_out, h, wd, co), dtype=x.dtype, device=x.device)
    _build.launch(NAME, "fvt_conv3d_ndhwc", x.data_ptr(), w.data_ptr(),
                  b.data_ptr(), y.data_ptr(), bsz, t, h, wd, c, co, kt,
                  time_pad, _build.stream_ptr(x))
    return y


def conv3d_ndhwc(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, *,
                 time_pad: int, gamma: torch.Tensor | None = None,
                 mode: str = "auto") -> torch.Tensor:
    """Causal 3D conv on [B, T, H, W, C] with kernel [kt, 3, 3, C, Co].

    ``time_pad`` zero frames go in front (causal); spatial padding is SAME.
    With ``gamma``, computes ``conv(silu(rmsnorm(x) * sqrt(C) * gamma))``.
    ``mode`` is any FASTVIDEO_VAE_CONV3D name: all compute this function
    through K3.
    """
    if mode in INT8_MODES or mode not in CONV3D_MODES:
        raise ValueError(f"conv3d_ndhwc: mode {mode!r} is not one of "
                         f"{CONV3D_MODES}")
    if x.is_cuda:
        return _conv3d_cuda(x, w, b, time_pad, gamma)
    if x.device.type == "cpu":
        return conv3d_ndhwc_plain(x, w, b, time_pad=time_pad, gamma=gamma)
    raise _build.KernelError(f"{NAME}: unsupported device {x.device}")
