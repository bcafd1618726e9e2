"""The port's int8 conv modes (``conv3d_ndhwc`` under "kf_int8" and
"auto_int8": the quantizers, the routing rule and the plain version of K4)
against the JAX ``conv3d_ndhwc`` in the same modes, its Pallas int8 kernel
run in interpret mode on the CPU, in fp32."""

import importlib
import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastvideo_tpu_torch.ops import _build
from fastvideo_tpu_torch.ops import conv3d as tconv

# the JAX package's ops/__init__ re-exports functions under these names
jconv = importlib.import_module("fastvideo_tpu.ops.conv3d")

torch.set_num_threads(2)

# both sides sum int8 products exactly in int32; the fp32 epilogue
# acc * scale + b may round differently where XLA fuses it into an FMA
ATOL, RTOL = 1e-5, 1e-5


def _inputs(seed, t, h, w, c, co, kt, gamma):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((1, t, h, w, c), dtype=np.float32)
    wt = rng.standard_normal((kt, 3, 3, c, co), dtype=np.float32) * 0.05
    b = rng.standard_normal((co,), dtype=np.float32) * 0.1
    g = (rng.standard_normal((c,), dtype=np.float32) * 0.2 + 1.0
         if gamma else None)
    return x, wt, b, g


def _both(x, wt, b, g, time_pad, mode):
    want = jconv.conv3d_ndhwc(jnp.asarray(x), jnp.asarray(wt), jnp.asarray(b),
                              time_pad=time_pad, mode=mode,
                              gamma=None if g is None else jnp.asarray(g))
    got = tconv.conv3d_ndhwc(torch.from_numpy(x), torch.from_numpy(wt),
                             torch.from_numpy(b), time_pad=time_pad, mode=mode,
                             gamma=None if g is None else torch.from_numpy(g))
    return got.numpy(), np.asarray(want)


@pytest.mark.parametrize("mode,c,co,w", [("kf_int8", 32, 32, 8),
                                         ("auto_int8", 64, 32, 256)])
@pytest.mark.parametrize("kt,time_pad,gamma", [(3, 2, False), (3, 0, True),
                                               (1, 0, False), (1, 2, True)])
def test_int8_conv_matches_jax(mode, c, co, w, kt, time_pad, gamma):
    x, wt, b, g = _inputs(0, 3, 2, w, c, co, kt, gamma)
    before = _build.PLAIN_CALLS["conv3d_int8"]
    got, want = _both(x, wt, b, g, time_pad, mode)
    assert _build.PLAIN_CALLS["conv3d_int8"] == before + 1
    assert got.shape == want.shape == (1, 3 + time_pad - kt + 1, 2, w, co)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("mode,c,co,w,int8", [
    ("kf_int8", 48, 32, 8, False),     # C not a multiple of 32
    ("kf_int8", 32, 40, 8, False),     # Co not a multiple of 32
    ("auto_int8", 32, 32, 256, False),  # C < 64
    ("auto_int8", 64, 32, 255, False),  # W < 256
    ("auto_int8", 64, 32, 256, True),
])
def test_int8_routing_edges_match_jax(mode, c, co, w, int8):
    x, wt, b, _ = _inputs(1, 2, 2, w, c, co, 3, False)
    before = dict(_build.PLAIN_CALLS)
    got, want = _both(x, wt, b, None, 2, mode)
    took = "conv3d_int8" if int8 else "conv3d"
    assert _build.PLAIN_CALLS[took] == before[took] + 1
    assert tconv.int8_ok(c, co, w, mode) == int8
    tol = (ATOL, RTOL) if int8 else (2e-5, 1e-4)  # the bf16 policy in fp32
    np.testing.assert_allclose(got, want, atol=tol[0], rtol=tol[1])


def test_int8_conv_is_exact_on_grid():
    """Activations and weights already on the int8 grid quantize
    losslessly and the int32 sums are exact: the port gives the fp32
    epilogue of the exact integer conv, as JAX does."""
    rng = np.random.default_rng(0)
    t, h, w, c, co = 3, 4, 16, 32, 32
    xi = rng.integers(-127, 128, (1, t, h, w, c)).astype(np.float32)
    xi.flat[0] = 127.0  # sx = 1
    wi = rng.integers(-127, 128, (3, 3, 3, c, co)).astype(np.float32)
    wi[0, 0, 0, 0, :] = 127.0
    wsc = (np.arange(co, dtype=np.float32) % 7 + 1.0) * 2.0**-10
    b = rng.normal(size=(co,)).astype(np.float32)
    x, wt = torch.from_numpy(xi), torch.from_numpy(wi * wsc)
    xq, sx = tconv.quantize_int8(x)
    wq, sw = tconv.quantize_int8(wt, dims=(0, 1, 2, 3))
    assert torch.equal(xq.float(), x) and sx.item() == 1.0
    assert torch.equal(wq.float(), torch.from_numpy(wi))
    got, want = _both(xi, wi * wsc, b, None, 2, "kf_int8")
    # the exact integer conv through the same fp32 epilogue
    acc = torch.nn.functional.conv3d(
        torch.nn.functional.pad(x.double().permute(0, 4, 1, 2, 3),
                                (1, 1, 1, 1, 2, 0)),
        torch.from_numpy(wi).double().permute(4, 3, 0, 1, 2))
    acc = acc.permute(0, 2, 3, 4, 1).to(torch.int32)
    exact = (acc.float() * (sw.reshape(-1) * sx.reshape(())) +
             torch.from_numpy(b)).numpy()
    np.testing.assert_array_equal(got, exact)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_quantize_int8_is_bit_exact(dtype):
    """The whole-tensor (per-slice loop) and per-Co quantizers against
    JAX's ``_quantize_int8``, on a tensor whose scale ties values."""
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.standard_normal((2, 5, 3, 4, 32),
                                             dtype=np.float32)).to(dtype)
    w = torch.from_numpy(rng.standard_normal((3, 3, 3, 32, 64),
                                             dtype=np.float32)).to(dtype)
    w[..., 5] = 0.0  # scale 1e-8 / 127
    jx = jnp.asarray(x.float().numpy()).astype(
        jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32)
    jw = jnp.asarray(w.float().numpy()).astype(jx.dtype)
    for t, j, dims in ((x, jx, None), (w, jw, (0, 1, 2, 3))):
        q, s = tconv.quantize_int8(t, dims)
        jq, js = jconv._quantize_int8(j, axes=dims)
        np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
        np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    x_before = x.clone()
    tconv.quantize_int8(x)
    assert torch.equal(x, x_before)  # the input is left as it was


def test_int8_modes_are_accepted(monkeypatch):
    for mode in tconv.INT8_MODES:
        monkeypatch.setenv("FASTVIDEO_VAE_CONV3D", mode)
        assert tconv.vae_conv3d_mode() == mode
    monkeypatch.setenv("FASTVIDEO_VAE_CONV3D", "int4")
    with pytest.raises(ValueError, match="unknown FASTVIDEO_VAE_CONV3D"):
        tconv.vae_conv3d_mode()


def test_supports_matches_jax_in_the_int8_modes():
    grid = itertools.product(
        [(3, 3, 3), (1, 3, 3), (3, 1, 1)], [(1, 1, 1), (0, 1, 1)],
        [16, 64, 96], [3, 32, 96], [None, 104, 256], list(tconv.INT8_MODES))
    for ks, pad, cin, cout, w_dim, mode in grid:
        assert tconv.supports(ks, (1, 1, 1), pad, cin, cout, w_dim=w_dim,
                              mode=mode) == jconv.supports(
                                  ks, (1, 1, 1), pad, cin, cout, w_dim=w_dim,
                                  mode=mode)


def test_plain_int8_conv_counts_one_plain_call():
    rng = np.random.default_rng(5)
    xq = torch.from_numpy(rng.integers(-127, 128, (2, 3, 2, 5, 32),
                                       dtype=np.int8))
    wq = torch.from_numpy(rng.integers(-127, 128, (3, 3, 3, 32, 32),
                                       dtype=np.int8))
    scale, bias = torch.full((32,), 1e-3), torch.zeros(32)
    before = dict(_build.PLAIN_CALLS), dict(_build.LAUNCHES)
    out = tconv.conv3d_int8(xq, wq, scale, bias, time_pad=2,
                            out_dtype=torch.bfloat16)
    assert out.dtype == torch.bfloat16 and out.shape == (2, 3, 2, 5, 32)
    assert _build.PLAIN_CALLS["conv3d_int8"] == before[0]["conv3d_int8"] + 1
    assert dict(_build.LAUNCHES) == before[1]
