"""The port's Sliding Tile Attention and Sparse-Linear Attention (ops and
backends, on the CPU through the plain version of the padded sparse kernel)
against the JAX ``fastvideo_tpu.ops.sta`` / ``ops.sla`` with their Pallas
kernel in interpret mode. fp32 on both sides."""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastvideo_tpu.attention.backends.abstract import AttentionMetadata
from fastvideo_tpu.attention.backends.sla import (
    SLAAttentionBackend as JaxSLABackend)
from fastvideo_tpu.attention.backends.sta import (
    SlidingTileAttentionBackend as JaxSTABackend)
from fastvideo_tpu_torch.attention.backends.abstract import (
    AttentionMetadata as TorchAttentionMetadata)
from fastvideo_tpu_torch.attention.backends.sla import SLAAttentionBackend
from fastvideo_tpu_torch.attention.backends.sta import (
    SlidingTileAttentionBackend)
from fastvideo_tpu_torch.attention.selector import (get_attn_backend,
                                                    resolve_backend_name)
from fastvideo_tpu_torch.ops import _build
from fastvideo_tpu_torch.ops import sla as tsla
from fastvideo_tpu_torch.ops import sta as tsta

jsta = importlib.import_module("fastvideo_tpu.ops.sta")
jsla = importlib.import_module("fastvideo_tpu.ops.sla")

torch.set_num_threads(2)

ATOL, RTOL = 2e-5, 1e-4  # fp32 both sides: summation order only


def _qkv(seed, s, h, d):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal((1, s, h, d)).astype(np.float32)
                 for _ in range(3))


@pytest.mark.parametrize("grid,tile,windows", [
    ((21, 30, 53), (4, 8, 8), ((3, 3, 3),)),
    ((5, 9, 11), (2, 4, 4), ((3, 3, 3), (1, 3, 5), (5, 1, 1))),
    ((4, 6, 6), (2, 2, 2), ((1, 3, 3), (3, 1, 1))),
])
def test_window_indices_equal_jax(grid, tile, windows):
    got = tsta.sta_window_indices(grid, tile, windows)
    want = jsta.sta_window_indices(grid, tile, windows)
    assert got.dtype == want.dtype == np.int32
    np.testing.assert_array_equal(got, want)


def test_main_path_window_geometry():
    """480x848: 168 padded (4, 8, 8) tiles, at most 27 window tiles, ragged
    rows padded with -1, every row holding its own tile."""
    idx = tsta.sta_window_indices((21, 30, 53), (4, 8, 8), ((3, 3, 3),))
    assert idx.shape == (1, 168, 27)
    assert (idx == -1).any() and (idx >= 0).sum() == 3040
    assert all(qi in idx[0, qi] for qi in range(168))


def test_sliding_tile_attention_matches_jax():
    """Per-head windows on a grid with partial tiles (sentinel slots and
    per-tile valid counts both in play)."""
    grid, tile = (5, 9, 11), (2, 4, 4)
    windows = ((3, 3, 3), (1, 3, 5))
    q, k, v = _qkv(0, 5 * 9 * 11, 2, 32)
    want = jsta.sliding_tile_attention(
        *(jnp.asarray(a) for a in (q, k, v)), grid, windows, tile)
    before = _build.PLAIN_CALLS["vsa_sparse_padded_fwd"]
    got = tsta.sliding_tile_attention(
        *(torch.from_numpy(a) for a in (q, k, v)), grid, windows, tile)
    assert _build.PLAIN_CALLS["vsa_sparse_padded_fwd"] == before + 1
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=RTOL)


@pytest.mark.parametrize("extra", [
    {},
    {"STA_window": (1, 3, 3), "STA_tile": (2, 4, 4)},
    {"STA_window": [(3, 1, 1), (1, 3, 3)], "STA_tile": (2, 2, 4)},
], ids=["defaults", "one_window", "per_head_windows"])
def test_sta_backend_matches_jax(extra):
    """The backend pads its output back to the input length (here 7 extra
    rows, as a sequence-parallel pad would leave)."""
    grid = (5, 9, 11)
    q, k, v = _qkv(1, 5 * 9 * 11 + 7, 2, 16)
    want = JaxSTABackend(2, 16).forward(
        *(jnp.asarray(a) for a in (q, k, v)),
        AttentionMetadata(extra=dict(extra)), grid=grid)
    got = SlidingTileAttentionBackend(2, 16).forward(
        *(torch.from_numpy(a) for a in (q, k, v)),
        TorchAttentionMetadata(extra=dict(extra)), grid=grid)
    assert got.shape == (1, 5 * 9 * 11 + 7, 2, 16)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=RTOL)


def test_sla_block_map_matches_jax():
    q, k, _ = _qkv(2, 384, 2, 16)
    qt, kt = q.transpose(0, 2, 1, 3), k.transpose(0, 2, 1, 3)
    want, want_k = jsla.sla_block_map(jnp.asarray(qt), jnp.asarray(kt), 0.5)
    got, got_k = tsla.sla_block_map(torch.from_numpy(qt),
                                    torch.from_numpy(kt), 0.5)
    assert got_k == want_k == 3 and got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("feature_map", ["softmax", "elu", "relu"])
def test_linear_attention_matches_jax(feature_map):
    q, k, v = (a.transpose(0, 2, 1, 3) for a in _qkv(3, 96, 2, 16))
    want = jsla.linear_attention(*(jnp.asarray(a) for a in (q, k, v)),
                                 feature_map)
    got = tsla.linear_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                                feature_map)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=RTOL)


def test_linear_attention_rejects_unknown_feature_map():
    q = torch.zeros(1, 1, 64, 8)
    with pytest.raises(ValueError, match="feature map"):
        tsla.linear_attention(q, q, q, "gelu")


@pytest.mark.parametrize("feature_map,proj,bias", [
    ("softmax", False, False),
    ("softmax", True, True),
    ("elu", True, False),
    ("relu", True, True),
])
def test_sla_attention_matches_jax(feature_map, proj, bias):
    d = 16
    q, k, v = _qkv(4, 320, 2, d)
    rng = np.random.default_rng(5)
    w = (rng.standard_normal((d, d)) * d**-0.5).astype(np.float32)
    b = rng.standard_normal(d).astype(np.float32)
    kw = dict(topk_ratio=0.4, feature_map=feature_map)
    want = jsla.sla_attention(
        *(jnp.asarray(a) for a in (q, k, v)),
        proj_weight=jnp.asarray(w) if proj else None,
        proj_bias=jnp.asarray(b) if bias else None, **kw)
    got = tsla.sla_attention(
        *(torch.from_numpy(a) for a in (q, k, v)),
        proj_weight=torch.from_numpy(w) if proj else None,
        proj_bias=torch.from_numpy(b) if bias else None, **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=RTOL)


def test_sla_backend_matches_jax():
    d = 16
    q, k, v = _qkv(6, 256, 2, d)
    w = (np.random.default_rng(7).standard_normal((d, d)) *
         d**-0.5).astype(np.float32)
    extra = {"sla_topk_ratio": 0.5, "sla_feature_map": "elu"}
    want = JaxSLABackend(2, d).forward(
        *(jnp.asarray(a) for a in (q, k, v)),
        AttentionMetadata(extra=dict(extra, sla_proj_weight=jnp.asarray(w))))
    got = SLAAttentionBackend(2, d).forward(
        *(torch.from_numpy(a) for a in (q, k, v)),
        TorchAttentionMetadata(extra=dict(
            extra, sla_proj_weight=torch.from_numpy(w))), grid=(4, 8, 8))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=RTOL)


def test_sla_needs_whole_tiles():
    q = torch.zeros(1, 100, 1, 8)
    with pytest.raises(ValueError, match="divisible by 64"):
        tsla.sla_attention(q, q, q)


@pytest.mark.parametrize("name,cls", [
    ("SLIDING_TILE_ATTN", SlidingTileAttentionBackend),
    ("SLA_ATTN", SLAAttentionBackend),
    ("SLA", SLAAttentionBackend),
])
def test_selector_knows_the_backends(name, cls, monkeypatch):
    monkeypatch.setenv("FASTVIDEO_ATTENTION_BACKEND", name)
    assert resolve_backend_name() == cls.name
    assert isinstance(get_attn_backend(2, 16), cls)
    # a layer that supports FLASH_ATTN only (cross-attention) keeps it
    assert get_attn_backend(2, 16,
                            supported=("FLASH_ATTN",)).name == "FLASH_ATTN"
