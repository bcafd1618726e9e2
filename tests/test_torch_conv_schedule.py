"""The host side of K3's Hopper schedule, on the CPU: the kernel's
decomposition of the conv into tap boxes, emulated in plain fp32 (per
block a bw x bh voxel patch of one output frame and one N tile; per stage
(dt, dh, 32-channel chunk) ONE box of x of {32, bw + 2, bh} with every
coordinate outside x read as zero, as TMA fills it, whose rows hh (bw + 2)
+ ww + dw are tap dw of voxel (hh, ww), times the stage's three dw slices
of the weight as ``sm90_weight`` lays it out), equals
``conv3d_ndhwc_plain`` and the JAX ``conv3d_ndhwc`` (Pallas in interpret
mode, as ``test_torch_ops_conv3d.py`` runs it). Also: the patch and N-tile
rules, that they and the route are the CUDA sources' own, and the entry a
CUDA-typed call takes."""

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

ATOL, RTOL = 2e-5, 1e-4  # fp32 both sides: summation order only

CSRC = os.path.join(os.path.dirname(os.path.dirname(__file__)),
                    "fastvideo_tpu_torch", "csrc")


def _source(name: str) -> str:
    with open(os.path.join(CSRC, name)) as fh:
        return fh.read()


def _box(x, b, t, h0, w0, c0, bh, bwp):
    """x[b, t, h0:h0+bh, w0:w0+bwp, c0:c0+32] with every coordinate outside
    x (negative ones too) read as zero."""
    _, tt, hh, ww, cc = x.shape
    out = x.new_zeros(bh, bwp, tconv.CONV_CHUNK)
    if not 0 <= t < tt:
        return out
    hs, he = max(h0, 0), min(h0 + bh, hh)
    ws, we = max(w0, 0), min(w0 + bwp, ww)
    ce = min(c0 + tconv.CONV_CHUNK, cc)
    if hs < he and ws < we and c0 < ce:
        out[hs - h0:he - h0, ws - w0:we - w0, :ce - c0] = \
            x[b, t, hs:he, ws:we, c0:ce]
    return out


def _emulate(x, w, bias, time_pad):
    """K3's Hopper schedule in plain fp32 (see the module docstring); time
    taps on the causal pad are skipped, as the kernel skips them."""
    bsz, t, h, wd, c = x.shape
    kt, co = w.shape[0], w.shape[-1]
    bn, bw = tconv.conv_tile_n(co), tconv.conv_tile_w(h, wd)
    bh = tconv.CONV_BLOCK // bw
    wb = tconv.sm90_weight(w, bn)
    nc = wb.shape[0] // (kt * 3)
    t_out = t + time_pad - kt + 1
    m = torch.arange(tconv.CONV_BLOCK)
    row0 = (m // bw) * (bw + 2) + m % bw  # the kernel's ldmatrix rows
    y = torch.zeros(bsz, t_out, h, wd, co)
    for b in range(bsz):
        for to in range(t_out):
            for h0 in range(0, h, bh):
                for w0 in range(0, wd, bw):
                    for n0 in range(0, co, bn):
                        acc = torch.zeros(tconv.CONV_BLOCK, bn)
                        for dt in range(max(0, time_pad - to),
                                        min(kt, t + time_pad - to)):
                            for dh in range(3):
                                for cc in range(nc):
                                    box = _box(x, b, to + dt - time_pad,
                                               h0 + dh - 1, w0 - 1,
                                               cc * tconv.CONV_CHUNK, bh,
                                               bw + 2).reshape(-1, 32)
                                    wt = wb[(dt * 3 + dh) * nc + cc, :,
                                            n0:n0 + bn]
                                    for dw in range(3):
                                        acc += box[row0 + dw] @ wt[dw].T
                        out = (acc + torch.nn.functional.pad(
                            bias, (0, bn))[n0:n0 + bn]).reshape(bh, bw, bn)
                        he, we = min(bh, h - h0), min(bw, wd - w0)
                        ne = min(bn, co - n0)
                        y[b, to, h0:h0 + he, w0:w0 + we, n0:n0 + ne] = \
                            out[:he, :we, :ne]
    return y


@pytest.mark.parametrize("kt,time_pad,t,h,w,c,co", [
    (3, 2, 2, 5, 20, 16, 40),   # conv_in's 16 channels, a W and Co tail
    (3, 0, 4, 3, 10, 96, 8),    # 96 channels: three chunks a tap
    (1, 0, 2, 9, 24, 48, 3),    # kt 1; conv_out's 3 channels (N tile 8)
    (3, 2, 1, 4, 12, 32, 130),  # the first chunk (2 pad taps); 2 N tiles
], ids=["conv_in_like", "c96_like", "kt1_co3", "first_chunk"])
def test_tap_boxes_give_plain_and_jax(kt, time_pad, t, h, w, c, co):
    rng = np.random.default_rng(kt * 100 + c + co)
    x = rng.standard_normal((1, t, h, w, c), dtype=np.float32)
    wt = rng.standard_normal((kt, 3, 3, c, co), dtype=np.float32) * 0.05
    b = rng.standard_normal((co,), dtype=np.float32) * 0.1
    tx, tw, tb = (torch.from_numpy(a) for a in (x, wt, b))
    got = _emulate(tx, tw, tb, time_pad)
    want = tconv.conv3d_ndhwc_plain(tx, tw, tb, time_pad=time_pad)
    torch.testing.assert_close(got, want, atol=ATOL, rtol=RTOL)
    jwant = jconv.conv3d_ndhwc(jnp.asarray(x), jnp.asarray(wt),
                               jnp.asarray(b), time_pad=time_pad, mode="tap")
    np.testing.assert_allclose(got.numpy(), np.asarray(jwant), atol=ATOL,
                               rtol=RTOL)


@pytest.mark.parametrize("h,w,bw", [
    (480, 832, 64), (480, 848, 16), (240, 416, 32), (240, 424, 8),
    (120, 208, 16), (120, 212, 32), (60, 104, 8), (60, 106, 16),
    (1, 128, 128), (5, 7, 16)])
def test_patch_rule(h, w, bw):
    """The decoder's widths at 480x832 and 480x848 take patches that cover
    them with the fewest padded voxels, the widest among equals."""
    assert tconv.conv_tile_w(h, w) == bw
    bh = tconv.CONV_BLOCK // bw
    waste = -(-w // bw) * bw * (-(-h // bh) * bh)
    for other in tconv.CONV_TILE_WIDTHS:
        oh = tconv.CONV_BLOCK // other
        assert waste <= -(-w // other) * other * (-(-h // oh) * oh)


@pytest.mark.parametrize("co,bn", [(384, 128), (192, 96), (96, 96),
                                   (3, 8), (8, 8), (40, 96), (256, 128)])
def test_n_tile_rule(co, bn):
    assert tconv.conv_tile_n(co) == bn


def test_weight_layout():
    """sm90_weight: stage (dt, dh, chunk), tap dw, output channel, channel,
    zeros past C and Co."""
    rng = np.random.default_rng(7)
    w = torch.from_numpy(rng.standard_normal((3, 3, 3, 40, 5)).astype(
        np.float32))
    wb = tconv.sm90_weight(w, 8)
    assert wb.shape == (3 * 3 * 2, 3, 8, 32) and wb.is_contiguous()
    for dt, dh, dw, ci, o in ((0, 0, 0, 0, 0), (2, 1, 2, 39, 4),
                              (1, 2, 1, 33, 3)):
        assert wb[(dt * 3 + dh) * 2 + ci // 32, dw, o, ci % 32] == \
            w[dt, dh, dw, ci, o]
    assert (wb[:, :, 5:] == 0).all() and (wb[1::2, :, :, 8:] == 0).all()


def test_host_rules_match_the_sources():
    """The route, N tile, block, chunk and patch widths are the CUDA
    sources' own, and the entries take the arguments the wrapper passes."""
    cu, cuh = _source("conv3d.cu"), _source("conv3d_sm90.cuh")
    route = re.search(r"int conv_route\(int dtype\) \{ return dtype == 1 "
                      r"\? 1 : 2; \}", cu)
    assert route is not None
    assert tconv.conv_schedule(torch.bfloat16, 96, 96) == "sm90"
    assert tconv.conv_schedule(torch.float32, 96, 96) == "tf32x3"
    assert tconv._DTYPE_CODES[torch.bfloat16] == 1
    m = re.search(r"return Co <= (\d+) \? (\d+) : \(Co % (\d+) == 0 \? (\d+) "
                  r": (\d+)\);", cuh)
    lo, lo_n, div, div_n, other = (int(g) for g in m.groups())
    for co in range(1, 800):
        want = lo_n if co <= lo else (div_n if co % div == 0 else other)
        assert tconv.conv_tile_n(co) == want, co
    assert int(re.search(r"kConvBM = (\d+);", cuh).group(1)) == \
        tconv.CONV_BLOCK
    assert int(re.search(r"kConvChunk = (\d+);", cuh).group(1)) == \
        tconv.CONV_CHUNK
    assert "bw < 8 || bw > 128" in cu
    assert (min(tconv.CONV_TILE_WIDTHS), max(tconv.CONV_TILE_WIDTHS)) == \
        (8, 128)
    assert "conv3d" in _build.PTXAS_VERBOSE
    for entry in ("fvt_conv3d_sm90", "fvt_conv3d_tf32"):
        n_args = len(_build._SIGNATURES[entry])
        decl = re.search(r'extern "C" int ' + entry + r"\((.*?)\)\s*\{", cu,
                         re.S).group(1)
        assert decl.count(",") + 1 == n_args, entry


class _CudaTyped(torch.Tensor):
    """A CPU tensor that reports itself as a CUDA tensor, to drive the
    wrapper's CUDA dispatch without a card."""

    @property
    def is_cuda(self):
        return True


@pytest.mark.parametrize("dtype,c,co", [(torch.bfloat16, 96, 96),
                                        (torch.bfloat16, 16, 384),
                                        (torch.float32, 96, 3)])
def test_cuda_call_takes_its_schedules_entry(dtype, c, co, monkeypatch):
    """On a CUDA tensor a bf16 conv launches the Hopper entry with the laid
    out weight, channels padded to 32, the host's N tile and patch; fp32
    the 3xTF32 entry with the weight's TF32 heads and tails, channels
    padded to 16; counted as K3; the plain version never runs."""
    seen = []

    def fake_launch(name, fn, *args):
        seen.append((name, fn, args))
        _build.count_launch(name)

    monkeypatch.setattr(_build, "check_device", lambda t, name: None)
    monkeypatch.setattr(_build, "stream_ptr", lambda t: 0)
    monkeypatch.setattr(_build, "launch", fake_launch)
    x = torch.zeros(1, 3, 6, 20, c, dtype=dtype).as_subclass(_CudaTyped)
    w = torch.zeros(3, 3, 3, c, co, dtype=dtype)
    b = torch.zeros(co, dtype=dtype)
    before = dict(_build.PLAIN_CALLS)
    y = tconv.conv3d_ndhwc(x, w, b, time_pad=2)
    assert y.shape == (1, 3, 6, 20, co)
    assert _build.PLAIN_CALLS == before
    (name, fn, args), = seen
    assert name == "conv3d"
    if dtype == torch.bfloat16:
        assert fn == "fvt_conv3d_sm90"
        # x, w, bias, y, B, T, H, W, C (padded), Co, kt, time_pad, bn, bw
        assert args[4:14] == (1, 3, 6, 20, max(c, 32), co, 3, 2,
                              tconv.conv_tile_n(co),
                              tconv.conv_tile_w(6, 20))
    else:
        assert fn == "fvt_conv3d_tf32"
        # x, w_hi, w_lo, bias, y, B, T, H, W, C (padded), Co, kt,
        # time_pad, bn, bw
        assert args[5:15] == (1, 3, 6, 20, max(c, 16), co, 3, 2,
                              tconv.conv_tf32_tile_n(co),
                              tconv.conv_tile_w(6, 20))
