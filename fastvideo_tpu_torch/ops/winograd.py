"""Winograd F(2x2, 3x3) causal conv3d (port of fastvideo_tpu/ops/winograd.py).

``FASTVIDEO_VAE_CONV3D=wino`` selects it in the JAX package, where it is
XLA-level (no Pallas kernel), so here it is plain PyTorch on both devices:
each 2x2 output tile of a frame is computed from its 4x4 input window as
``A^T [(G w G^T) * (B^T d B)] A``, 16 multiplies instead of 36, with the
temporal taps summed directly. The 16-point batched product is one
``torch.matmul`` a time tap, as JAX leaves it to XLA.

Numerics follow the JAX module: U = G w G^T in fp32; the input transform's
adds in fp32, cast to bf16 for the product when x is bf16 (about 1e-2 from
the direct conv at unit-normal inputs); fp32 sums of exact products (the
operands are cast to fp32 for the matmul, as JAX's
``preferred_element_type=float32`` keeps bf16 products exact); the output
transform in fp32, cast to x's dtype, then the bias added in that dtype.
"""

from __future__ import annotations

import torch

from fastvideo_tpu_torch.ops.conv3d import rms_silu_prologue

# F(2x2, 3x3): out = A^T [ (G w G^T) * (B^T d B) ] A
_G = ((1.0, 0.0, 0.0), (0.5, 0.5, 0.5), (0.5, -0.5, 0.5), (0.0, 0.0, 1.0))


def _transform_weights(w: torch.Tensor) -> torch.Tensor:
    """w [kt, 3, 3, C, Co] -> U [16, kt, C, Co] in fp32."""
    g = torch.tensor(_G, dtype=torch.float32, device=w.device)
    u = torch.einsum("ah,khwco->kawco", g, w.float())
    u = torch.einsum("bw,kawco->kabco", g, u)
    kt, _, _, c, co = u.shape
    return u.reshape(kt, 16, c, co).transpose(0, 1)


def _input_transform(x: torch.Tensor) -> torch.Tensor:
    """x [F, H+2, W+2, C] (spatially padded, H and W even) -> V [16, F, nt,
    C]: the 16 strided views d[a][b] = x[:, a::2, b::2][:H/2, :W/2] are the
    4x4 windows of every 2x2-output tile, combined by B^T d B (0/+-1 adds)
    in fp32, then cast to the product's dtype (bf16 for a bf16 x)."""
    f, hp, wp, c = x.shape
    nh, nw = (hp - 2) // 2, (wp - 2) // 2
    xf = x.float()
    d = [[xf[:, a:a + 2 * nh:2, b:b + 2 * nw:2] for b in range(4)]
         for a in range(4)]
    e = [[d[0][b] - d[2][b] for b in range(4)],
         [d[1][b] + d[2][b] for b in range(4)],
         [d[2][b] - d[1][b] for b in range(4)],
         [d[1][b] - d[3][b] for b in range(4)]]
    v = []
    for a in range(4):
        v += [e[a][0] - e[a][2], e[a][1] + e[a][2], e[a][2] - e[a][1],
              e[a][1] - e[a][3]]
    out = torch.stack(v, dim=0).to(x.dtype)  # [16, F, nh, nw, C]
    return out.reshape(16, f, nh * nw, c)


def _output_transform(m: torch.Tensor, nh: int, nw: int,
                      out_dtype: torch.dtype) -> torch.Tensor:
    """m [16, T, nt, Co] fp32 -> y [T, H, W, Co] in ``out_dtype``."""
    _, t, _, co = m.shape
    mm = m.reshape(4, 4, t, nh * nw, co)
    g = [mm[0] + mm[1] + mm[2], mm[1] - mm[2] - mm[3]]
    y = torch.stack([torch.stack([g[p][0] + g[p][1] + g[p][2],
                                  g[p][1] - g[p][2] - g[p][3]])
                     for p in range(2)])  # [2 (p), 2 (q), T, nt, Co]
    y = y.reshape(2, 2, t, nh, nw, co).permute(2, 3, 0, 4, 1, 5)
    return y.reshape(t, 2 * nh, 2 * nw, co).to(out_dtype)


def _conv3d_wino_single(x: torch.Tensor, u: torch.Tensor, b: torch.Tensor,
                        kt: int) -> torch.Tensor:
    """x [T_out + kt - 1, H + 2, W + 2, C] padded; u [16, kt, C, Co]."""
    tp, hp, wp, _ = x.shape
    t_out, nh, nw = tp - kt + 1, (hp - 2) // 2, (wp - 2) // 2
    v = _input_transform(x)
    m = None
    for dt in range(kt):
        part = torch.matmul(v[:, dt:dt + t_out].float(),
                            u[:, dt].to(v.dtype).float()[:, None])
        m = part if m is None else m + part
    y = _output_transform(m, nh, nw, x.dtype)
    return y + b.to(x.dtype)


def conv3d_winograd_ndhwc(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                          *, time_pad: int,
                          gamma: torch.Tensor | None = None) -> torch.Tensor:
    """Causal 3D conv on [B, T, H, W, C] with kernel [kt, 3, 3, C, Co], the
    contract of ``ops.conv3d.conv3d_ndhwc`` (stride 1, SAME spatial padding,
    ``time_pad`` causal zeros, the optional RMSNorm+SiLU prologue), computed
    with Winograd F(2x2, 3x3) on the spatial taps. H and W must be even:
    the JAX function returns a frame two rows or columns short otherwise,
    so this one raises."""
    if x.shape[2] % 2 or x.shape[3] % 2:
        raise ValueError(f"winograd conv3d needs even H and W, got "
                         f"{tuple(x.shape[2:4])}")
    kt = w.shape[0]
    if gamma is not None:
        x = rms_silu_prologue(x, gamma)
    xp = torch.nn.functional.pad(x, (0, 0, 1, 1, 1, 1, time_pad, 0))
    u = _transform_weights(w)
    return torch.stack([_conv3d_wino_single(xp[i], u, b, kt)
                        for i in range(x.shape[0])])


def supports(kernel_size: tuple[int, int, int], stride: tuple[int, int, int],
             padding: tuple[int, int, int], cin: int, cout: int,
             h_dim: int | None = None, w_dim: int | None = None) -> bool:
    """The JAX module's rule, kept as it is so that "wino" routes the same
    convs as in JAX: 3x3 spatial taps, kt 1 or 3, stride 1, SAME spatial
    padding, even H and W, and not the 96-channel stages at 480x832 and
    above (XLA fails to compile those on the TPU, so JAX's VAE runs them as
    a plain conv, and so does the port's)."""
    kt, kh, kw = kernel_size
    if (kh != 3 or kw != 3 or kt not in (1, 3) or tuple(stride) != (1, 1, 1)
            or padding[1] != 1 or padding[2] != 1 or h_dim is None
            or w_dim is None or h_dim % 2 or w_dim % 2):
        return False
    return not (cin <= 96 and h_dim * w_dim >= 480 * 832)
