"""The port's block-sparse attention over padded tiles (the plain version of
the padded kernel, on the CPU) against the JAX ``fastvideo_tpu.ops.vsa``
functions with their Pallas kernels in interpret mode: partial tiles, ``-1``
index sentinels, the log-sum-exp, VSA on a grid with no exact tile, the
backend with and without ``pre_tiled``, and the two environment flags that
change the tile geometry and the query grouping. fp32 on both sides."""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastvideo_tpu.attention.backends import vsa as jbackend
from fastvideo_tpu.attention.backends.abstract import AttentionMetadata
from fastvideo_tpu_torch.attention.backends import vsa as tbackend
from fastvideo_tpu_torch.attention.backends.abstract import (
    AttentionMetadata as TorchAttentionMetadata)
from fastvideo_tpu_torch.ops import _build
from fastvideo_tpu_torch.ops import vsa as tvsa

jvsa = importlib.import_module("fastvideo_tpu.ops.vsa")

torch.set_num_threads(2)

ATOL, RTOL = 2e-5, 1e-4  # fp32 both sides: summation order only


def _to_j(*arrays):
    return tuple(jnp.asarray(a) for a in arrays)


def _to_t(*arrays):
    return tuple(torch.from_numpy(np.asarray(a)) for a in arrays)


def _padded_inputs(seed, h, nb, e, d, topk, sentinels):
    """q/k/v [1, h, nb*e, d], per-tile valid counts (tile 0 full, the rest
    partial) and index rows; with ``sentinels`` each row keeps 1..topk real
    tiles and pads with -1."""
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((1, h, nb * e, d)).astype(np.float32)
               for _ in range(3))
    sizes = rng.integers(1, e + 1, nb).astype(np.int32)
    sizes[0] = e
    idx = np.stack([rng.permutation(nb)[:topk]
                    for _ in range(h * nb)]).reshape(1, h, nb, topk)
    if sentinels:
        keep = rng.integers(1, topk + 1, (1, h, nb, 1))
        idx = np.where(np.arange(topk) < keep, idx, -1)
    return q, k, v, idx.astype(np.int32), sizes


@pytest.mark.parametrize("sentinels", [False, True],
                         ids=["top_k_rows", "sentinel_rows"])
def test_block_sparse_attention_matches_jax(sentinels):
    e = 64
    q, k, v, idx, sizes = _padded_inputs(0, 2, 5, e, 32, 3, sentinels)
    want = jvsa.block_sparse_attention(*_to_j(q, k, v, idx, sizes),
                                       tile_elems=e)
    before = _build.PLAIN_CALLS["vsa_sparse_padded_fwd"]
    got = tvsa.block_sparse_attention(*_to_t(q, k, v, idx, sizes),
                                      tile_elems=e)
    assert _build.PLAIN_CALLS["vsa_sparse_padded_fwd"] == before + 1
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=RTOL)
    # and the dense-math reference of the JAX package
    ref = jvsa._sparse_attention_reference(*_to_j(q, k, v, idx, sizes),
                                           32**-0.5, e)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL,
                               rtol=RTOL)


def test_trainable_forward_and_lse_match_jax():
    """Output against block_sparse_attention_trainable, the LSE against the
    kernel under it (its 128 lanes hold one value)."""
    e, topk = 64, 3
    q, k, v, idx, sizes = _padded_inputs(1, 2, 4, e, 32, topk, True)
    jq, jk, jv, jidx, jsizes = _to_j(q, k, v, idx, sizes)
    want = jvsa.block_sparse_attention_trainable(jq, jk, jv, jidx, jsizes,
                                                 tile_elems=e)
    idx_pad = np.zeros((1, 2, 8, 128), np.int32)
    idx_pad[:, :, :4, :topk] = idx
    _, want_lse = jvsa._block_sparse_fwd_lse(
        jq, jk, jv, jnp.asarray(idx_pad), jsizes, scale=32**-0.5, topk=topk,
        tile_elems=e)
    got, lse = tvsa.block_sparse_attention(
        *_to_t(q, k, v, idx, sizes), tile_elems=e, return_lse=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=RTOL)
    assert lse.shape == (1, 2, 4 * e) and lse.dtype == torch.float32
    np.testing.assert_allclose(lse.numpy(), np.asarray(want_lse)[..., 0],
                               atol=ATOL, rtol=RTOL)


def test_all_masked_row_is_zero_by_the_plain_definition():
    """A query tile whose every slot is a sentinel: output 0 and the finite
    empty-row LSE, never NaN. (The JAX kernel's finite mask value gives such
    a row an average of tile 0 instead; no caller produces one.)"""
    e, nb, h, d = 16, 4, 2, 8
    q, k, v, idx, sizes = _padded_inputs(2, h, nb, e, d, 2, True)
    idx[:, :, 1] = -1
    out, lse = tvsa.block_sparse_attention(*_to_t(q, k, v, idx, sizes),
                                           tile_elems=e, return_lse=True)
    assert torch.isfinite(out).all() and torch.isfinite(lse).all()
    assert (out[:, :, e:2 * e] == 0).all()
    assert (lse[:, :, e:2 * e] == tvsa.MASK_VALUE).all()
    # the other rows against dense masked softmax attention
    tq, tk, tv = _to_t(q, k, v)
    col_tile = np.arange(nb * e) // e
    valid = (np.arange(nb * e) % e) < sizes[col_tile]
    for hi in range(h):
        allowed = np.zeros((nb, nb), bool)
        for qi in range(nb):
            allowed[qi, idx[0, hi, qi][idx[0, hi, qi] >= 0]] = True
        mask = torch.from_numpy(
            np.repeat(allowed[:, col_tile], e, axis=0) & valid[None])
        sc = (tq[0, hi] @ tk[0, hi].T) * d**-0.5
        sc = sc.masked_fill(~mask, float("-inf"))
        rows = mask.any(dim=1)
        want = torch.softmax(sc[rows], dim=-1) @ tv[0, hi]
        torch.testing.assert_close(out[0, hi][rows], want, atol=ATOL,
                                   rtol=RTOL)
        torch.testing.assert_close(lse[0, hi][rows],
                                   torch.logsumexp(sc[rows], dim=-1),
                                   atol=ATOL, rtol=RTOL)


def test_video_sparse_attn_padded_grid_matches_jax_kernels():
    """No exact tile: per-tile top-k over padded tiles, against the JAX
    composition on its Pallas path (use_pallas=True)."""
    grid, tile = (3, 5, 7), (2, 4, 8)
    _, _, sizes, _, padded = jvsa.tile_layout(grid, tile)
    e = 64
    rng = np.random.default_rng(3)
    q, k, v, g = (rng.standard_normal((1, 2, padded, 32)).astype(np.float32)
                  for _ in range(4))
    want = jvsa.video_sparse_attn(*_to_j(q, k, v, sizes), 3,
                                  gate_compress=jnp.asarray(g), tile_elems=e)
    got = tvsa.video_sparse_attn(*_to_t(q, k, v, sizes), 3,
                                 gate_compress=torch.from_numpy(g),
                                 tile_elems=e)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=RTOL)


def _backend_pair(heads, d):
    return (jbackend.VideoSparseAttentionBackend(heads, d),
            tbackend.VideoSparseAttentionBackend(heads, d))


def _run_backends(grid, q, k, v, gate, sparsity, pre_tiled=False):
    jb, tb = _backend_pair(q.shape[2], q.shape[3])
    jbackend.resolve_vsa_tile.cache_clear()  # the JAX one caches per grid
    want = jb.forward(*_to_j(q, k, v), AttentionMetadata(
        extra={"VSA_sparsity": sparsity}), grid=grid,
        gate=jnp.asarray(gate), pre_tiled=pre_tiled)
    got = tb.forward(*_to_t(q, k, v), TorchAttentionMetadata(
        extra={"VSA_sparsity": sparsity}), grid=grid,
        gate=torch.from_numpy(gate), pre_tiled=pre_tiled)
    return got.numpy(), np.asarray(want)


@pytest.mark.parametrize("pre_tiled", [False, True])
def test_backend_padded_grid_matches_jax(pre_tiled, monkeypatch):
    """Grid (5, 9, 11) has no exact tile: padded (4, 8, 8) tiles. With
    ``pre_tiled`` the inputs are already tile-major with garbage in the
    padded slots, which the backend zeroes before use."""
    monkeypatch.delenv("FASTVIDEO_VSA_TILE", raising=False)
    grid = (5, 9, 11)
    assert tbackend.resolve_vsa_tile(grid) == ((4, 8, 8), False)
    _, _, _, _, padded = jvsa.tile_layout(grid, (4, 8, 8))
    s = padded if pre_tiled else grid[0] * grid[1] * grid[2]
    rng = np.random.default_rng(4)
    q, k, v, gate = (rng.standard_normal((1, s, 2, 16)).astype(np.float32)
                     for _ in range(4))
    got, want = _run_backends(grid, q, k, v, gate, 0.5, pre_tiled)
    assert got.shape == want.shape == (1, s, 2, 16)
    if pre_tiled:  # the padded query rows are discarded by the model
        keep = jvsa.tile_valid_mask(grid, (4, 8, 8))
        got, want = got[:, keep], want[:, keep]
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("forced,geometry", [
    ("2,4,4", ((2, 4, 4), True)),    # divides (4, 8, 16): the full-tile route
    ("3,4,4", ((3, 4, 4), False)),   # does not divide: the padded route
])
def test_forced_vsa_tile_is_read_at_call_time(forced, geometry, monkeypatch):
    grid = (4, 8, 16)
    monkeypatch.delenv("FASTVIDEO_VSA_TILE", raising=False)
    auto = tbackend.resolve_vsa_tile(grid)
    assert auto == ((2, 8, 8), True)
    rng = np.random.default_rng(5)
    q, k, v, gate = (rng.standard_normal((1, 512, 2, 16)).astype(np.float32)
                     for _ in range(4))
    got_auto, want_auto = _run_backends(grid, q, k, v, gate, 0.5)
    np.testing.assert_allclose(got_auto, want_auto, atol=ATOL, rtol=RTOL)

    monkeypatch.setenv("FASTVIDEO_VSA_TILE", forced)
    assert tbackend.resolve_vsa_tile(grid) == geometry
    jbackend.resolve_vsa_tile.cache_clear()
    assert jbackend.resolve_vsa_tile(grid) == geometry
    got, want = _run_backends(grid, q, k, v, gate, 0.5)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)
    assert np.abs(got - got_auto).max() > 1e-3  # the geometry changed

    monkeypatch.delenv("FASTVIDEO_VSA_TILE")
    assert tbackend.resolve_vsa_tile(grid) == auto
    jbackend.resolve_vsa_tile.cache_clear()


def test_forced_vsa_tile_rejects_malformed(monkeypatch):
    monkeypatch.setenv("FASTVIDEO_VSA_TILE", "4,8")
    with pytest.raises(ValueError, match="FASTVIDEO_VSA_TILE"):
        tbackend.resolve_vsa_tile((4, 8, 16))


@pytest.mark.parametrize("forced", [None, "1", "2", "4", "5"])
def test_forced_q_group_matches_jax(forced, monkeypatch):
    if forced is None:
        monkeypatch.delenv("FASTVIDEO_VSA_QGROUP", raising=False)
    else:
        monkeypatch.setenv("FASTVIDEO_VSA_QGROUP", forced)
    for nb, e, exact in [(8, 32, True), (117, 280, True), (12, 512, True),
                         (8, 32, False)]:
        assert tbackend.q_group(nb, e, exact) == jbackend._q_group(nb, e,
                                                                   exact)
    # grid (4, 8, 16) with forced (1, 4, 4) tiles: 32 tiles of 16 tokens
    monkeypatch.setenv("FASTVIDEO_VSA_TILE", "1,4,4")
    rng = np.random.default_rng(6)
    q, k, v, gate = (rng.standard_normal((1, 512, 2, 16)).astype(np.float32)
                     for _ in range(4))
    got, want = _run_backends((4, 8, 16), q, k, v, gate, 0.6)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)
    jbackend.resolve_vsa_tile.cache_clear()
