"""The host side of K3's fp32 form, the 3xTF32 schedule, on the CPU: the
TF32 rounding (round to nearest, ties away, as ``cvt.rna.tf32.f32``), the
three-product conv emulated on it against the plain fp32 conv and the JAX
``conv3d_ndhwc`` (Pallas interpret mode) within the card's gate, one TF32
product missing that gate, the weight's head and tail layout, the rule
that skips the time taps on the causal pad, and the Python rules against
the CUDA sources."""

import importlib
import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastvideo_tpu_torch.ops import _build
from fastvideo_tpu_torch.ops import conv3d as tconv

# the JAX package's ops/__init__ re-exports functions under these names
jconv = importlib.import_module("fastvideo_tpu.ops.conv3d")

torch.set_num_threads(2)

CSRC = os.path.join(os.path.dirname(os.path.dirname(__file__)),
                    "fastvideo_tpu_torch", "csrc")
# chip_smoke.py's gate for the fp32 conv against its plain version
GATE_ATOL, GATE_RTOL = 5e-5, 1e-5


def _source(name: str) -> str:
    with open(os.path.join(CSRC, name)) as fh:
        return fh.read()


def _inputs(seed, t, h, w, c, co, kt):
    """Order-1 inputs and outputs, as the decoder's convs see them: x ~
    N(0, 1), w ~ N(0, 1 / fan_in)."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((1, t, h, w, c), dtype=np.float32)
    wt = (rng.standard_normal((kt, 3, 3, c, co), dtype=np.float32) /
          np.sqrt(kt * 9 * c, dtype=np.float32))
    b = rng.standard_normal((co,), dtype=np.float32) * 0.1
    return x, wt, b


def _rna_tf32(x: np.ndarray) -> np.ndarray:
    """TF32 by its definition: the nearest value with 10 mantissa bits,
    ties away from zero (numpy, on the exponent and mantissa)."""
    m, e = np.frexp(x.astype(np.float64))  # x = m 2^e, 0.5 <= |m| < 1
    scaled = m * 2.0**11  # 11 significant bits, the leading one included
    r = np.sign(scaled) * np.floor(np.abs(scaled) + 0.5)
    return (r * 2.0**(e - 11)).astype(np.float32)


def test_tf32_round_is_round_to_nearest_ties_away():
    rng = np.random.default_rng(0)
    x = np.concatenate([rng.standard_normal(20000).astype(np.float32),
                        (rng.standard_normal(2000) * 1e-30).astype(
                            np.float32),
                        (rng.standard_normal(2000) * 1e30).astype(
                            np.float32)])
    got = tconv.tf32_round(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, _rna_tf32(x))
    bits = torch.from_numpy(got).view(torch.int32)
    assert (bits & ((1 << tconv.TF32_DROPPED_BITS) - 1) == 0).all()
    # exact ties (the dropped bits 0x1000) round away from zero
    tie = np.array([1.0 + 2.0**-11, -(1.0 + 2.0**-11), 1.0 + 3 * 2.0**-11],
                   dtype=np.float32)
    np.testing.assert_array_equal(
        tconv.tf32_round(torch.from_numpy(tie)).numpy(),
        np.array([1.0 + 2.0**-10, -(1.0 + 2.0**-10), 1.0 + 2 * 2.0**-10],
                 dtype=np.float32))


def test_tf32_split_holds_the_fp32_value():
    """hi + lo is x within about 2^-22 relative; each part is a TF32
    value."""
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.standard_normal(50000).astype(np.float32))
    hi, lo = tconv.tf32_split(x)
    for part in (hi, lo):
        assert torch.equal(tconv.tf32_round(part), part)
    err = (hi.double() + lo.double() - x.double()).abs()
    assert (err <= 2.0**-22 * x.double().abs()).all()
    assert ((hi.double() - x.double()).abs() <=
            2.0**-11 * x.double().abs()).all()


@pytest.mark.parametrize("t,h,w,c,co,kt,time_pad", [
    (3, 4, 8, 16, 8, 3, 2),     # the first chunk's causal pad
    (4, 5, 6, 32, 24, 3, 0),    # a later chunk: every tap real
    (2, 3, 7, 48, 5, 1, 0),     # a resample's kt 1, an odd Co
])
def test_three_products_hold_the_gate_one_does_not(t, h, w, c, co, kt,
                                                   time_pad):
    """The 3xTF32 arithmetic (heads and tails, products exact, the lo-lo
    product left out) is within the card's gate, 5e-5 + 1e-5 |plain|, of
    the plain fp32 conv and of the JAX conv3d; one TF32 product a pair
    misses it."""
    x, wt, b = _inputs(2, t, h, w, c, co, kt)
    tx, tw, tb = (torch.from_numpy(a) for a in (x, wt, b))
    plain = tconv.conv3d_ndhwc_plain(tx, tw, tb, time_pad=time_pad)
    three = tconv.conv3d_tf32x3_plain(tx, tw, tb, time_pad=time_pad)
    one = tconv.conv3d_tf32x3_plain(tx, tw, tb, time_pad=time_pad,
                                    products=1)
    jax_out = np.asarray(jconv.conv3d_ndhwc(
        jnp.asarray(x), jnp.asarray(wt), jnp.asarray(b), time_pad=time_pad,
        mode="kf"))
    for want in (plain.numpy(), jax_out):
        np.testing.assert_allclose(three.numpy(), want, atol=GATE_ATOL,
                                   rtol=GATE_RTOL)
        miss = np.abs(one.numpy() - want) > GATE_ATOL + GATE_RTOL * np.abs(
            want)
        assert miss.any()


def test_tf32_weight_layout_gives_back_the_weight():
    """sm90_weight_tf32's two B operands, read back by their layout
    ([kt * 3 * nC, 3, Co_pad, 16]: stage (dt, dh, chunk), dw, co, channel),
    are the weight's TF32 head and tail, zero past C and Co, and give the
    plain conv back."""
    kt, c, co, bn = 3, 24, 40, 96
    x, wt, b = _inputs(4, 3, 4, 6, c, co, kt)
    tw = torch.from_numpy(wt)
    w_hi, w_lo = tconv.sm90_weight_tf32(tw, bn)
    nc = -(-c // tconv.CONV_CHUNK_F32)
    assert w_hi.shape == w_lo.shape == (kt * 3 * nc, 3, bn,
                                        tconv.CONV_CHUNK_F32)
    assert w_hi.is_contiguous() and w_hi.dtype == torch.float32

    def back(wb):
        cp = nc * tconv.CONV_CHUNK_F32
        full = wb.reshape(kt, 3, nc, 3, bn, tconv.CONV_CHUNK_F32).permute(
            0, 1, 3, 2, 5, 4).reshape(kt, 3, 3, cp, bn)
        assert (full[..., c:, :] == 0).all() and (full[..., co:] == 0).all()
        return full[..., :c, :co]

    hi, lo = tconv.tf32_split(tw)
    assert torch.equal(back(w_hi), hi) and torch.equal(back(w_lo), lo)
    tx, tb = torch.from_numpy(x), torch.from_numpy(b)
    got = tconv.conv3d_ndhwc_plain(tx, back(w_hi) + back(w_lo), tb,
                                   time_pad=2)
    want = tconv.conv3d_ndhwc_plain(tx, tw, tb, time_pad=2)
    torch.testing.assert_close(got, want, atol=GATE_ATOL, rtol=GATE_RTOL)


@pytest.mark.parametrize("kt,time_pad,t_in", [(3, 2, 1), (3, 2, 4),
                                              (3, 0, 10), (1, 0, 3),
                                              (3, 1, 2)])
def test_live_time_taps_skip_only_the_pad(kt, time_pad, t_in):
    """The taps the kernels walk are those that read a real frame, and the
    conv summed over them alone is the conv."""
    t_out = t_in + time_pad - kt + 1
    for t in range(t_out):
        want = [dt for dt in range(kt) if 0 <= t + dt - time_pad < t_in]
        assert list(tconv.live_time_taps(t, kt, time_pad, t_in)) == want
    x, wt, b = _inputs(6, t_in, 3, 4, 8, 4, kt)
    tx, tw = torch.from_numpy(x), torch.from_numpy(wt)
    full = tconv.conv3d_ndhwc_plain(tx, tw, torch.zeros(4),
                                    time_pad=time_pad)
    xp = torch.nn.functional.pad(tx, (0, 0, 1, 1, 1, 1))
    for t in range(t_out):
        acc = torch.zeros(3, 4, 4)
        for dt in tconv.live_time_taps(t, kt, time_pad, t_in):
            for dh in range(3):
                for dw in range(3):
                    acc += xp[0, t + dt - time_pad, dh:dh + 3,
                              dw:dw + 4] @ tw[dt, dh, dw]
        torch.testing.assert_close(acc, full[0, t], atol=1e-5, rtol=1e-5)


def test_host_rules_match_the_sources():
    """The stage's channels, the N tile rule, the route and the dropped
    bits are the CUDA sources' own."""
    cuh, cu = _source("conv3d_tf32_sm90.cuh"), _source("conv3d.cu")
    assert int(re.search(r"kConvChunkF32 = (\d+);", cuh).group(1)) == \
        tconv.CONV_CHUNK_F32
    m = re.search(r"conv_tf32_tile_n\(int Co\) \{ return Co <= (\d+) \? "
                  r"(\d+) : (\d+); \}", cuh)
    lo, lo_n, other = (int(g) for g in m.groups())
    for co in range(1, 800):
        assert tconv.conv_tf32_tile_n(co) == (lo_n if co <= lo else other)
    assert "cvt.rna.tf32.f32" in cuh
    assert tconv.TF32_DROPPED_BITS == 23 - 10
    assert "dtype == 1 ? 1 : 2" in cu
    assert "dt_lo = max(0, p.time_pad - t)" in cuh
    assert "dt_hi = min(p.kt, p.T + p.time_pad - t)" in cuh
    assert "fvt_conv3d_tf32" in _build._SIGNATURES
