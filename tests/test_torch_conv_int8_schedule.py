"""The host side of the int8 conv's Hopper schedule (K4), on the CPU: the
kernel's decomposition of the conv emulated in exact integers (per block
a bw x bh voxel patch of one output frame and one N tile; per stage (dt,
32-channel chunk) ONE box of x of {32, bw + 2, bh + 2} with every
coordinate outside x read as zero, as TMA fills it, whose rows (hh + dh)
(bw + 2) + ww + dw are tap (dh, dw) of voxel (hh, ww), times the stage's
nine tap tiles of the weight as ``sm90_weight_int8`` lays them out,
un-swizzled as the kernel's descriptors read them; time taps on the
causal pad skipped; then
float(acc) * scale + bias, each rounded in fp32) is bit for bit
``conv3d_int8_plain``, and equals the JAX ``conv3d_ndhwc`` in "kf_int8"
(Pallas in interpret mode, on the operands both sides quantize alike)
within the one fp32 rounding XLA saves where it fuses the epilogue into
an FMA. Also: the int8 weight layout, the N-tile and stage rules, that
they are the CUDA source's own, and the entry a CUDA-typed call takes."""

import importlib
import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastvideo_tpu_torch.ops import _build
from fastvideo_tpu_torch.ops import conv3d as tconv

jconv = importlib.import_module("fastvideo_tpu.ops.conv3d")

torch.set_num_threads(2)

CHUNK = tconv.CONV_CHUNK
CSRC = os.path.join(os.path.dirname(os.path.dirname(__file__)),
                    "fastvideo_tpu_torch", "csrc")


def _source(name: str) -> str:
    with open(os.path.join(CSRC, name)) as fh:
        return fh.read()


def _box(x, b, t, h0, w0, c0, bh, bwp):
    """x[b, t, h0:h0+bh, w0:w0+bwp, c0:c0+32] with every coordinate outside
    x (negative ones too) read as zero."""
    _, tt, hh, ww, _ = x.shape
    out = x.new_zeros(bh, bwp, CHUNK)
    if not 0 <= t < tt:
        return out
    hs, he = max(h0, 0), min(h0 + bh, hh)
    ws, we = max(w0, 0), min(w0 + bwp, ww)
    if hs < he and ws < we:
        out[hs - h0:he - h0, ws - w0:we - w0] = \
            x[b, t, hs:he, ws:we, c0:c0 + CHUNK]
    return out


def _unswizzle(tile):
    """A stage's [9, bn, 32] weight block as the 32-byte-swizzled
    descriptor reads it: chunk c of row n at c ^ bit 2 of n."""
    t = tile.reshape(9, -1, 2, 4, 2, 16)
    return torch.cat([t[:, :, :1], t[:, :, 1:].flip(-2)],
                     dim=2).reshape(9, -1, CHUNK)


def _emulate(xq, wq, scale, bias, time_pad, out_dtype):
    """K4's Hopper schedule in exact integers (see the module docstring)."""
    bsz, t, h, wd, c = xq.shape
    kt, co = wq.shape[0], wq.shape[-1]
    bn, bw = tconv.conv_int8_tile_n(co), tconv.conv_tile_w(h, wd)
    bh = tconv.CONV_BLOCK // bw
    wb = tconv.sm90_weight_int8(wq, bn).long()  # [nN, kt * nc, 9, bn, 32]
    nc = c // CHUNK
    t_out = t + time_pad - kt + 1
    m = torch.arange(tconv.CONV_BLOCK)
    row0 = (m // bw) * (bw + 2) + m % bw  # the kernel's ldmatrix rows
    x64 = xq.long()
    y = torch.zeros(bsz, t_out, h, wd, co)
    for b in range(bsz):
        for to in range(t_out):
            for h0 in range(0, h, bh):
                for w0 in range(0, wd, bw):
                    for nt in range(wb.shape[0]):
                        acc = torch.zeros(tconv.CONV_BLOCK, bn,
                                          dtype=torch.int64)
                        for dt in range(max(0, time_pad - to),
                                        min(kt, t + time_pad - to)):
                            for cc in range(nc):
                                box = _box(x64, b, to + dt - time_pad,
                                           h0 - 1, w0 - 1, cc * CHUNK,
                                           bh + 2, bw + 2).reshape(-1, CHUNK)
                                wt = _unswizzle(wb[nt, dt * nc + cc])
                                for dh in range(3):
                                    for dw in range(3):
                                        acc += (box[row0 + dh * (bw + 2)
                                                    + dw]
                                                @ wt[3 * dh + dw].T)
                        n0 = nt * bn
                        ne = min(bn, co - n0)
                        he, we = min(bh, h - h0), min(bw, wd - w0)
                        acc = acc.reshape(bh, bw, bn)[:he, :we, :ne]
                        assert acc.abs().max() < 2**31  # int32 holds it
                        y[b, to, h0:h0 + he, w0:w0 + we, n0:n0 + ne] = (
                            acc.to(torch.int32).float()
                            * scale[n0:n0 + ne] + bias[n0:n0 + ne])
    return y.to(out_dtype)


def _quantized(seed, t, h, w, c, co, kt):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((1, t, h, w, c), dtype=np.float32)
    wt = rng.standard_normal((kt, 3, 3, c, co), dtype=np.float32) * 0.05
    b = rng.standard_normal((co,), dtype=np.float32) * 0.1
    tx, tw = torch.from_numpy(x), torch.from_numpy(wt)
    xq, sx = tconv.quantize_int8(tx)
    wq, sw = tconv.quantize_int8(tw, dims=(0, 1, 2, 3))
    return (x, wt, b), (xq, wq, sw.reshape(-1) * sx.reshape(()),
                        torch.from_numpy(b))


@pytest.mark.parametrize("kt,time_pad,t,h,w,c,co,out", [
    (3, 2, 2, 3, 20, 32, 32, torch.float32),   # the route's smallest: Co
                                               # 32 in an N tile of 96
    (3, 0, 4, 2, 10, 96, 96, torch.bfloat16),  # up3's channels, a W tail
    (3, 1, 2, 4, 12, 64, 192, torch.float32),  # an N tile of 192
    (1, 0, 2, 5, 8, 96, 384, torch.bfloat16),  # kt 1, two N tiles of 192
    (1, 2, 1, 2, 16, 32, 96, torch.float32),   # kt 1 behind 2 pad frames
    (3, 2, 1, 9, 24, 64, 64, torch.bfloat16),  # the first chunk: 2 pad taps
], ids=["c32_co32", "c96_like", "n192", "kt1_co384", "kt1_pad2",
        "first_chunk"])
def test_tap_boxes_give_plain_bit_for_bit_and_jax(kt, time_pad, t, h, w, c,
                                                  co, out):
    (x, wt, b), (xq, wq, scale, bias) = _quantized(kt * 100 + c + co, t, h,
                                                   w, c, co, kt)
    got = _emulate(xq, wq, scale, bias, time_pad, out)
    want = tconv.conv3d_int8_plain(xq, wq, scale, bias, time_pad=time_pad,
                                   out_dtype=out)
    assert got.dtype == want.dtype == out
    assert torch.equal(got, want)
    if out == torch.float32:  # JAX computes in x's dtype: an fp32 decode
        jwant = np.asarray(jconv.conv3d_ndhwc(
            jnp.asarray(x), jnp.asarray(wt), jnp.asarray(b),
            time_pad=time_pad, mode="kf_int8"))
        # exact int32 sums on both sides; XLA may fuse acc * scale + b
        # into an FMA (tests/test_torch_ops_conv3d_int8.py's tolerance)
        np.testing.assert_allclose(got.numpy(), jwant, atol=1e-5,
                                   rtol=1e-5)


def test_int8_weight_layout():
    """sm90_weight_int8: N tile, stage (dt, chunk), tap (dh, dw), output
    channel, channel with the 32-byte swizzle; zeros past Co; each (tile,
    stage) block contiguous."""
    rng = np.random.default_rng(9)
    wq = torch.from_numpy(rng.integers(-127, 128, (3, 3, 3, 64, 200),
                                       dtype=np.int8))
    wb = tconv.sm90_weight_int8(wq, 96)
    assert wb.shape == (3, 3 * 2, 9, 96, 32) and wb.is_contiguous()
    assert wb.dtype == torch.int8
    for dt, dh, dw, ci, o in ((0, 0, 0, 0, 0), (2, 1, 2, 63, 199),
                              (1, 2, 1, 33, 100), (0, 1, 0, 17, 4),
                              (2, 2, 2, 48, 7)):
        nt, n = divmod(o, 96)
        chunk = ((ci % 32) // 16) ^ ((n >> 2) & 1)
        assert wb[nt, dt * 2 + ci // 32, 3 * dh + dw, n,
                  16 * chunk + ci % 16] == wq[dt, dh, dw, ci, o]
    assert (wb[2, :, :, 200 - 192:] == 0).all()


@pytest.mark.parametrize("co,bn", [(32, 96), (64, 96), (96, 96), (192, 192),
                                   (384, 192), (128, 96), (576, 192)])
def test_n_tile_rule(co, bn):
    assert tconv.conv_int8_tile_n(co) == bn


def test_host_rules_match_the_source():
    """The N tile, the stage's 32 channels and their order, the patch
    widths and the swizzle are the CUDA source's own, and the entry takes
    the arguments the wrapper passes."""
    cu = _source("conv3d_int8.cu")
    m = re.search(r"conv8_tile_n\(int Co\) \{ return Co % (\d+) == 0 \? "
                  r"(\d+) : (\d+); \}", cu)
    div, div_n, other = (int(g) for g in m.groups())
    for co in range(32, 1600, 32):
        assert tconv.conv_int8_tile_n(co) == (div_n if co % div == 0
                                              else other), co
    assert int(re.search(r"kConvChunk = (\d+);", _source(
        "conv3d_sm90.cuh")).group(1)) == CHUNK
    assert "dt = dt_lo + i / p.n_c, c = i % p.n_c" in cu  # the stages
    assert "desc32(bt + tap * BN * kConvChunk)" in cu  # the taps in a block
    assert "a_off[3 * dh + dw]" in cu
    assert "row0 + dh * (bw + 2) + dw" in cu  # the x box's tap rows
    assert "bw < 8 || bw > 128" in cu
    assert "3ull << 62" in cu and "256 >> 4" in cu  # 32-byte swizzle, SBO
    assert "(((j >> 1) ^ ((row >> 2) & 1)) << 4)" in cu
    assert "conv3d_int8" in _build.PTXAS_VERBOSE
    entry = "fvt_conv3d_int8_sm90"
    n_args = len(_build._SIGNATURES[entry])
    decl = re.search(r'extern "C" int ' + entry + r"\((.*?)\)\s*\{", cu,
                     re.S).group(1)
    assert decl.count(",") + 1 == n_args


class _CudaTyped(torch.Tensor):
    """A CPU tensor that reports itself as a CUDA tensor, to drive the
    wrapper's CUDA dispatch without a card."""

    @property
    def is_cuda(self):
        return True


@pytest.mark.parametrize("c,co,w,out", [(96, 96, 256, torch.bfloat16),
                                        (32, 192, 20, torch.float32)])
def test_cuda_call_takes_the_hopper_entry(c, co, w, out, monkeypatch):
    """On a CUDA tensor K4 launches its Hopper entry with the laid-out
    weight and the host's N tile and patch, counted as K4; the plain
    version never runs."""
    seen = []

    def fake_launch(name, fn, *args):
        seen.append((name, fn, args))
        _build.count_launch(name)

    monkeypatch.setattr(_build, "check_device", lambda t, name: None)
    monkeypatch.setattr(_build, "stream_ptr", lambda t: 0)
    monkeypatch.setattr(_build, "launch", fake_launch)
    xq = torch.ones(1, 3, 6, w, c, dtype=torch.int8).as_subclass(_CudaTyped)
    wq = torch.ones(3, 3, 3, c, co, dtype=torch.int8)
    ones = torch.ones(co)
    before = dict(_build.PLAIN_CALLS)
    y = tconv.conv3d_int8(xq, wq, ones, ones, time_pad=2, out_dtype=out)
    assert y.shape == (1, 3, 6, w, co) and y.dtype == out
    assert _build.PLAIN_CALLS == before
    (name, fn, args), = seen
    assert (name, fn) == ("conv3d_int8", "fvt_conv3d_int8_sm90")
    assert len(args) == len(_build._SIGNATURES[fn])
    # xq, w, scale, bias, y, out dtype, B, T, H, W, C, Co, kt, time_pad,
    # bn, bw
    assert args[5:16] == (int(out == torch.bfloat16), 1, 3, 6, w, c, co, 3,
                          2, tconv.conv_int8_tile_n(co),
                          tconv.conv_tile_w(6, w))
