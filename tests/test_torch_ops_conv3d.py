"""Port conv3d_ndhwc (plain version of K3, CPU) against the JAX
``conv3d_ndhwc`` in its "tap" and "kf" modes (Pallas interpret mode), and
the port's ``supports`` gate against the JAX one, in fp32."""

import importlib
import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastvideo_tpu_torch.ops import conv3d as tconv
from fastvideo_tpu_torch.ops import winograd as twino

# the JAX package's ops/__init__ re-exports functions under these names
jconv = importlib.import_module("fastvideo_tpu.ops.conv3d")

torch.set_num_threads(2)

ATOL, RTOL = 2e-5, 1e-4  # fp32 both sides: summation order only


def _inputs(seed, t, h, w, c, co, kt, gamma):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((1, t, h, w, c), dtype=np.float32)
    wt = rng.standard_normal((kt, 3, 3, c, co), dtype=np.float32) * 0.05
    b = rng.standard_normal((co,), dtype=np.float32) * 0.1
    g = (rng.standard_normal((c,), dtype=np.float32) * 0.2 + 1.0
         if gamma else None)
    return x, wt, b, g


@pytest.mark.parametrize("mode", ["tap", "kf"])
@pytest.mark.parametrize("kt,time_pad,gamma", [(3, 2, False), (3, 0, True),
                                               (1, 0, False), (1, 2, True)])
def test_conv3d_matches_jax(mode, kt, time_pad, gamma):
    x, wt, b, g = _inputs(0, 3, 4, 8, 16, 8, kt, gamma)
    want = jconv.conv3d_ndhwc(jnp.asarray(x), jnp.asarray(wt), jnp.asarray(b),
                              time_pad=time_pad, mode=mode,
                              gamma=None if g is None else jnp.asarray(g))
    got = tconv.conv3d_ndhwc(torch.from_numpy(x), torch.from_numpy(wt),
                             torch.from_numpy(b), time_pad=time_pad,
                             gamma=None if g is None else torch.from_numpy(g))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=RTOL)


def test_conv3d_ragged_cout_matches_jax():
    """conv_out's shape class: Co=3 at W=256, C=64 (JAX "kf")."""
    x, wt, b, _ = _inputs(1, 2, 2, 256, 64, 3, 3, False)
    want = jconv.conv3d_ndhwc(jnp.asarray(x), jnp.asarray(wt), jnp.asarray(b),
                              time_pad=2, mode="kf")
    got = tconv.conv3d_ndhwc(torch.from_numpy(x), torch.from_numpy(wt),
                             torch.from_numpy(b), time_pad=2)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=RTOL)


def test_every_mode_name_gives_the_same_output(monkeypatch):
    x, wt, b, _ = _inputs(2, 3, 4, 8, 16, 8, 3, False)
    args = (torch.from_numpy(x), torch.from_numpy(wt), torch.from_numpy(b))
    ref = tconv.conv3d_ndhwc(*args, time_pad=2)
    for mode in tconv.CONV3D_MODES:
        got = tconv.conv3d_ndhwc(*args, time_pad=2, mode=mode)
        if mode == "wino":  # JAX's Winograd conv: the same conv computed
            # another way, equal in fp32 up to rounding
            # (test_torch_ops_winograd.py holds it to JAX)
            assert torch.equal(got, twino.conv3d_winograd_ndhwc(
                *args, time_pad=2))
            torch.testing.assert_close(got, ref, atol=2e-5, rtol=1e-4)
        else:  # TPU layouts of one direct conv: K3's plain version
            assert torch.equal(got, ref)
        monkeypatch.setenv("FASTVIDEO_VAE_CONV3D", mode)
        assert tconv.vae_conv3d_mode() == mode
    # the int8 modes are their own route (test_torch_ops_conv3d_int8.py);
    # a name the JAX package does not know is refused
    monkeypatch.setenv("FASTVIDEO_VAE_CONV3D", "kf_int4")
    with pytest.raises(ValueError, match="unknown FASTVIDEO_VAE_CONV3D"):
        tconv.vae_conv3d_mode()


def test_supports_matches_jax():
    grid = itertools.product(
        [(3, 3, 3), (1, 3, 3), (3, 1, 1), (1, 1, 1)],
        [(1, 1, 1), (1, 2, 2)],
        [(1, 1, 1), (0, 1, 1), (1, 0, 0), (2, 1, 1)],
        [12, 16, 64, 96],
        [3, 8, 96],
        [None, 104, 256, 832],
        [None, "tap", "kf", "thcw", "auto"])
    for ks, st, pad, cin, cout, w_dim, mode in grid:
        assert tconv.supports(ks, st, pad, cin, cout, w_dim=w_dim,
                              mode=mode) == jconv.supports(
                                  ks, st, pad, cin, cout, w_dim=w_dim,
                                  mode=mode), (ks, st, pad, cin, cout, w_dim,
                                               mode)
