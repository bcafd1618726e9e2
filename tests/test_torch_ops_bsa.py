"""The port's BSA (fastvideo_tpu_torch/ops/bsa.py) against the JAX
package's: query pruning on padded grids, where zero padding rows and zero
tile centres give NaN similarities that ``jax.lax.top_k`` ranks above every
number (an all-NaN tile keeps its first slots); key-tile selection;
the nearest fill with equidistant ties; K9b's plain version at q_rows 8, 32
and 64 (the JAX side runs its Pallas kernel in interpret mode); and the
BSA_ATTN backend on a padded and an exact grid. Inputs are numpy-seeded
fp32; indices and masks must be equal, outputs within atol 3e-5 + rtol
3e-4 (fp32 summation order, the JAX package's own BSA bound)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastvideo_tpu.attention.backends.abstract import (
    AttentionMetadata as JaxMetadata)
from fastvideo_tpu.attention.backends.bsa import BSAAttentionBackend as JaxBSA
from fastvideo_tpu.ops import bsa as jax_bsa
from fastvideo_tpu.ops import vsa as jax_vsa
from fastvideo_tpu_torch.attention.backends.abstract import AttentionMetadata
from fastvideo_tpu_torch.attention.selector import get_attn_backend
from fastvideo_tpu_torch.ops import _build, bsa, nabla, vsa

torch.set_num_threads(2)
ATOL, RTOL = 3e-5, 3e-4
PADDED_GRID = (5, 10, 14)  # no exact (4, 4, 4) tile: 24 tiles, 1,536 slots


def _rand(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def test_top_k_orders_nan_as_jax_does():
    """jax.lax.top_k orders by IEEE total order. The NaN of a zero row's
    similarity is 0/0, whose sign bit the CPU sets and -sim clears, so it
    ranks above every number; ties go to the lower index."""
    with np.errstate(invalid="ignore"):
        nan = np.float32(0.0) / np.float32(0.0)
    sims = np.array([[0.5, nan, -0.2, 0.9, nan, 0.1],
                     [nan] * 6,
                     [-1.0, -2.0, -2.0, -1.0, -2.0, 0.0]], np.float32)
    want = np.asarray(jax.lax.top_k(-jnp.asarray(sims), 3)[1])
    got = bsa.top_k_indices(-torch.from_numpy(sims), 3)
    assert got.tolist() == want.tolist() == [[1, 4, 2], [0, 1, 2], [1, 2, 4]]


def _padded_blocks(seed, grid=PADDED_GRID, h=2, d=16):
    """Tile-ordered [B, H, N, 64, D] queries of ``grid``, with zero vectors
    in the padding slots (as tile_tokens leaves them, after each tile's
    real tokens)."""
    t, hh, w = grid
    x = _rand(seed, 1, t * hh * w, h, d)
    xt = np.array(jax_vsa.tile_tokens(jnp.asarray(x), grid))
    assert np.array_equal(
        xt, vsa.tile_tokens(torch.from_numpy(x), grid).numpy())
    n = xt.shape[1] // 64
    return xt.transpose(0, 2, 1, 3).reshape(1, h, n, 64, d)


@pytest.mark.parametrize("keep_ratio", [0.5, 0.25])
@pytest.mark.parametrize("grid", [PADDED_GRID, (4, 8, 7)],
                         ids=["zero_centres", "zero_rows"])
def test_prune_queries_matches_jax_on_padded_tiles(grid, keep_ratio):
    """(5, 10, 14): 18 of the 24 tiles hold at most 32 tokens, so their
    centre slot is padding and every similarity NaN. (4, 8, 7): tiles of 48
    tokens, a real centre and 16 zero rows with NaN similarities."""
    qb = _padded_blocks(1, grid)
    centre_pad = (qb[:, :, :, 32] == 0).all(-1)
    row_pad = (qb == 0).all(-1)
    if grid == PADDED_GRID:
        assert centre_pad.sum() == 2 * 18
    else:
        assert not centre_pad.any() and row_pad.any()
    js, jidx, jkeep = jax_bsa.prune_queries(jnp.asarray(qb), keep_ratio)
    ts, tidx, tkeep = bsa.prune_queries(torch.from_numpy(qb), keep_ratio)
    assert tkeep == jkeep == int(64 * keep_ratio)
    assert tidx.dtype == torch.int32
    np.testing.assert_array_equal(tidx.numpy(), np.asarray(jidx))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    # a tile whose centre is padding keeps its first slots, and padding
    # slots are kept before real tokens
    assert (tidx.numpy()[centre_pad] == np.arange(tkeep)).all()
    kept_pad = np.take_along_axis(row_pad, tidx.numpy().astype(int), -1)
    if grid == PADDED_GRID and keep_ratio == 0.5:
        assert kept_pad.sum() == 2 * 260  # 260 a head, as JAX keeps them
    if grid != PADDED_GRID:
        assert kept_pad.sum() == row_pad.sum()


@pytest.mark.parametrize("thr,min_blocks", [(0.9, 1), (0.5, 3), (1.0, 1)])
def test_select_kv_blocks_matches_jax(thr, min_blocks):
    qb = _padded_blocks(2) * 8  # a peaked block map: counts vary by row
    kb = _padded_blocks(3) * 8
    sq, _, _ = jax_bsa.prune_queries(jnp.asarray(qb), 0.5)
    want = np.asarray(jax_bsa.select_kv_blocks(sq, jnp.asarray(kb), thr,
                                               min_blocks))
    got = bsa.select_kv_blocks(torch.from_numpy(np.array(sq)),
                               torch.from_numpy(kb), thr, min_blocks)
    np.testing.assert_array_equal(got.numpy(), want)
    counts = got.sum(-1)
    assert (counts >= min_blocks).all()
    if thr < 1.0:
        assert len(set(counts.flatten().tolist())) > 1


def test_reconstruct_pruned_ties_go_to_the_lower_kept_position():
    rng = np.random.default_rng(4)
    out = rng.standard_normal((1, 1, 2, 3, 4)).astype(np.float32)
    # kept positions 1, 3, 7 and 0, 2, 6: positions 2 (1|3), 5 (3|7) and
    # 1 (0|2), 4 (2|6) are equidistant from two kept ones
    keep = np.array([[[[1, 3, 7], [0, 2, 6]]]], np.int32)
    want = np.asarray(jax_bsa.reconstruct_pruned(jnp.asarray(out),
                                                 jnp.asarray(keep), 8))
    got = bsa.reconstruct_pruned(torch.from_numpy(out),
                                 torch.from_numpy(keep), 8).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got[0, 0, 0, [2, 5]], out[0, 0, 0, [0, 1]])
    np.testing.assert_array_equal(got[0, 0, 1, [1, 4]], out[0, 0, 1, [0, 1]])


@pytest.mark.parametrize("q_rows", [8, 32, 64])
def test_masked_sparse_qtile_plain_matches_jax(q_rows):
    h, n, d = 2, 5, 32
    q = _rand(5, 1, h, n * q_rows, d)
    k = _rand(6, 1, h, n * 64, d)
    v = _rand(7, 1, h, n * 64, d)
    rng = np.random.default_rng(q_rows)
    mask = np.zeros((1, h, n, n), bool)
    for hi in range(h):
        for qi in range(n):  # rows keep 1 .. n tiles
            mask[0, hi, qi, rng.choice(n, (qi + hi) % n + 1,
                                       replace=False)] = True
    sizes = np.full(n, 64, np.int32)
    want = np.asarray(jax_bsa._masked_sparse_qtile(
        *(jnp.asarray(x) for x in (q, k, v, mask, sizes)), q_rows,
        scale=d**-0.5))
    before = _build.PLAIN_CALLS[nabla.QTILE_NAME]
    got = bsa._masked_sparse_qtile(
        *(torch.from_numpy(x) for x in (q, k, v, mask, sizes)), q_rows,
        scale=d**-0.5)
    assert _build.PLAIN_CALLS[nabla.QTILE_NAME] == before + 1
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("grid", [PADDED_GRID, (4, 8, 8)],
                         ids=["padded_grid", "exact_grid"])
def test_bsa_backend_matches_jax(grid):
    """BSA_ATTN given the (t, h, w) grid: tiles, prunes, selects, attends
    (zero padding keys included), fills and untiles; the extra rows past the
    grid's tokens come back as zeros."""
    h, d = 2, 16
    s = grid[0] * grid[1] * grid[2]
    q, k, v = (_rand(10 + i, 1, s + 3, h, d) for i in range(3))
    extra = {"bsa_query_keep_ratio": 0.5, "bsa_cumulative_threshold": 0.8,
             "bsa_min_kv_blocks": 2}
    want = np.asarray(JaxBSA(h, d).forward(
        *(jnp.asarray(x) for x in (q, k, v)), JaxMetadata(extra=extra),
        grid=grid))
    be = get_attn_backend(h, d, requested="BSA")
    assert be.name == "BSA_ATTN" and be.needs_grid
    got = be.forward(*(torch.from_numpy(x) for x in (q, k, v)),
                     AttentionMetadata(extra=extra), grid=grid)
    assert got.shape == (1, s + 3, h, d)
    assert (got[:, s:] == 0).all()
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=RTOL)


def test_bsa_without_pruning_or_sparsity_is_dense():
    """keep ratio 1 and every key tile: dense attention."""
    q, k, v = (torch.from_numpy(_rand(20 + i, 1, 4 * 64, 2, 16))
               for i in range(3))
    got = bsa.bsa_attention(q, k, v, query_keep_ratio=1.0,
                            kv_cumulative_threshold=1.0, min_kv_blocks=4)
    dense = torch.nn.functional.scaled_dot_product_attention(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2))
    np.testing.assert_allclose(got.numpy(), dense.transpose(1, 2).numpy(),
                               atol=ATOL, rtol=RTOL)
