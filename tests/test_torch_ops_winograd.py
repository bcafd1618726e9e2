"""The port's Winograd conv (``FASTVIDEO_VAE_CONV3D=wino``) against the JAX
``fastvideo_tpu.ops.winograd.conv3d_winograd_ndhwc`` (XLA on the CPU), at
tiny shapes with the same numpy-seeded inputs: kt 1 and 3, time_pad 0 to
2, with and without the RMSNorm+SiLU prologue, fp32 and bf16 weights, fp32
and bf16 activations (the prologue in fp32 only: its bf16 SiLU rounds
differently in the two frameworks, which is not the Winograd conv's).
Also: ``conv3d_ndhwc(mode="wino")`` is that function (and no K3 launch on
a CUDA tensor), ``supports`` is JAX's rule, and odd frames raise."""

import importlib
import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastvideo_tpu_torch.ops import _build
from fastvideo_tpu_torch.ops import conv3d as tconv
from fastvideo_tpu_torch.ops import winograd as twino

jwino = importlib.import_module("fastvideo_tpu.ops.winograd")
jconv = importlib.import_module("fastvideo_tpu.ops.conv3d")

torch.set_num_threads(2)

# fp32 activations: both sides compute the same transforms in fp32 and
# differ in the order of the product's fp32 sums only
ATOL32, RTOL32 = 2e-5, 1e-4
# bf16 activations: the transformed input is rounded to bf16 on both sides
# from the same fp32 values, but the fp32 sums' order can move the output's
# bf16 rounding, and the bias is added in bf16: two bf16 ulps relative
ATOL16, RTOL16 = 2.0**-7, 2.0**-7


def _inputs(seed, bsz, t, h, w, c, co, kt, x_dtype, w_dtype, fuse):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((bsz, t, h, w, c), dtype=np.float32)
    wt = rng.standard_normal((kt, 3, 3, c, co), dtype=np.float32) * 0.1
    b = rng.standard_normal((co,), dtype=np.float32) * 0.1
    gamma = (rng.standard_normal((c,), dtype=np.float32) * 0.2 + 1.0
             if fuse else None)
    jx = jnp.asarray(x).astype(x_dtype)
    tx = torch.from_numpy(np.array(jx.astype(jnp.float32))).to(
        torch.bfloat16 if x_dtype == jnp.bfloat16 else torch.float32)
    jw = jnp.asarray(wt).astype(w_dtype)
    tw = torch.from_numpy(np.array(jw.astype(jnp.float32))).to(
        torch.bfloat16 if w_dtype == jnp.bfloat16 else torch.float32)
    jg = None if gamma is None else jnp.asarray(gamma)
    tg = None if gamma is None else torch.from_numpy(gamma)
    return (jx, jw, jnp.asarray(b), jg), (tx, tw, torch.from_numpy(b), tg)


CASES = [  # kt, time_pad, fuse, x dtype, w dtype
    (3, 2, False, jnp.float32, jnp.float32),
    (3, 0, False, jnp.float32, jnp.bfloat16),
    (3, 1, True, jnp.float32, jnp.float32),
    (1, 0, False, jnp.float32, jnp.float32),
    (1, 2, True, jnp.float32, jnp.bfloat16),
    (3, 2, False, jnp.bfloat16, jnp.bfloat16),
    (1, 1, False, jnp.bfloat16, jnp.float32),
]


@pytest.mark.parametrize("kt,time_pad,fuse,x_dtype,w_dtype", CASES,
                         ids=["kt3_pad2", "kt3_pad0_w16", "kt3_pad1_gamma",
                              "kt1_pad0", "kt1_pad2_gamma_w16",
                              "kt3_bf16", "kt1_pad1_bf16"])
def test_winograd_matches_jax(kt, time_pad, fuse, x_dtype, w_dtype):
    t = 4 - time_pad + kt - 1 if kt == 3 else 3
    (jx, jw, jb, jg), (tx, tw, tb, tg) = _inputs(
        kt * 10 + time_pad, 2, t, 6, 10, 16, 24, kt, x_dtype, w_dtype, fuse)
    want = np.asarray(jwino.conv3d_winograd_ndhwc(
        jx, jw, jb, time_pad=time_pad, gamma=jg).astype(jnp.float32))
    got = twino.conv3d_winograd_ndhwc(tx, tw, tb, time_pad=time_pad,
                                      gamma=tg)
    assert got.dtype == tx.dtype and got.shape == want.shape
    atol, rtol = ((ATOL16, RTOL16) if x_dtype == jnp.bfloat16 else
                  (ATOL32, RTOL32))
    np.testing.assert_allclose(got.float().numpy(), want, atol=atol,
                               rtol=rtol)
    # the conv's entry in the "wino" mode is this function, as in JAX
    via_mode = tconv.conv3d_ndhwc(tx, tw, tb, time_pad=time_pad, gamma=tg,
                                  mode="wino")
    assert torch.equal(via_mode, got)
    jmode = np.asarray(jconv.conv3d_ndhwc(
        jx, jw, jb, time_pad=time_pad, gamma=jg,
        mode="wino").astype(jnp.float32))
    np.testing.assert_array_equal(jmode, want)


def test_winograd_is_not_the_direct_conv():
    """bf16 activations: the Winograd conv's bf16 transformed input leaves
    it about 1e-2 from the direct conv, which K3's plain version computes
    (the port once ran K3 for "wino")."""
    (_, _, _, _), (tx, tw, tb, _) = _inputs(7, 1, 3, 8, 8, 32, 32, 3,
                                            jnp.bfloat16, jnp.float32, False)
    wino = tconv.conv3d_ndhwc(tx, tw, tb, time_pad=2, mode="wino").float()
    direct = tconv.conv3d_ndhwc_plain(tx.float(), tw, tb,
                                      time_pad=2).float()
    err = (wino - direct).abs().max().item()
    assert 1e-4 < err < 0.05 * direct.abs().max().item()


class _CudaTyped(torch.Tensor):
    """A CPU tensor that reports itself as a CUDA tensor, to drive the
    wrapper's CUDA dispatch without a card."""

    @property
    def is_cuda(self):
        return True


def test_cuda_call_in_wino_mode_launches_no_kernel(monkeypatch):
    """On a CUDA tensor "wino" computes the Winograd conv in PyTorch: no
    K3 (or K4) launch, no plain K3."""
    seen = []
    monkeypatch.setattr(_build, "check_device", lambda t, name: None)
    monkeypatch.setattr(_build, "stream_ptr", lambda t: 0)
    monkeypatch.setattr(_build, "launch",
                        lambda name, fn, *args: seen.append((name, fn)))
    (_, _, _, _), (tx, tw, tb, _) = _inputs(3, 1, 3, 4, 6, 32, 32, 3,
                                            jnp.bfloat16, jnp.bfloat16, False)
    before = dict(_build.PLAIN_CALLS)
    got = tconv.conv3d_ndhwc(tx.as_subclass(_CudaTyped), tw, tb, time_pad=2,
                             mode="wino")
    assert seen == [] and _build.PLAIN_CALLS == before
    want = twino.conv3d_winograd_ndhwc(tx, tw, tb, time_pad=2)
    torch.testing.assert_close(got.as_subclass(torch.Tensor), want,
                               atol=0, rtol=0)


def test_supports_matches_jax():
    grid = itertools.product(
        [(3, 3, 3), (1, 3, 3), (3, 1, 1)], [(1, 1, 1), (1, 2, 2)],
        [(2, 1, 1), (0, 1, 1), (1, 0, 0)], [16, 96, 192], [3, 96],
        [None, 60, 479, 480], [None, 104, 832])
    for ks, st, pad, cin, cout, h_dim, w_dim in grid:
        assert tconv.supports(ks, st, pad, cin, cout, w_dim=w_dim,
                              mode="wino", h_dim=h_dim) == jconv.supports(
            ks, st, pad, cin, cout, w_dim=w_dim, mode="wino",
            h_dim=h_dim), (ks, st, pad, cin, cout, h_dim, w_dim)


def test_odd_frame_raises():
    x = torch.zeros(1, 2, 5, 6, 8)
    w = torch.zeros(3, 3, 3, 8, 8)
    with pytest.raises(ValueError, match="even H and W"):
        tconv.conv3d_ndhwc(x, w, torch.zeros(8), time_pad=2, mode="wino")
