"""Port VSA (tile helpers, the plain version of K2, the whole composition)
against the JAX ``fastvideo_tpu.ops.vsa`` (Pallas kernels in interpret
mode), in fp32 unless stated."""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastvideo_tpu_torch.attention.backends.vsa import q_group, vsa_topk
from fastvideo_tpu_torch.ops import vsa as tvsa

# the JAX package's ops/__init__ re-exports functions under these names
jvsa = importlib.import_module("fastvideo_tpu.ops.vsa")

torch.set_num_threads(2)

ATOL, RTOL = 2e-5, 1e-4  # fp32 both sides: summation order only


@pytest.mark.parametrize("grid", [(21, 30, 52), (21, 45, 80), (5, 16, 16),
                                  (1, 7, 11)])
def test_select_vsa_tile_matches_jax(grid):
    assert tvsa.select_vsa_tile(grid) == jvsa.select_vsa_tile(grid)


def test_main_path_tile_geometry():
    """480p: (7, 10, 4) tiles of 280 tokens, 117 tiles, groups of 3 tiles,
    top-24 at sparsity 0.8; the (1, 7, 11) grid has no exact tile."""
    assert tvsa.select_vsa_tile((21, 30, 52)) == (7, 10, 4)
    assert q_group(117, 280, True) == 3
    assert vsa_topk(0.8, 117) == 24
    assert tvsa.select_vsa_tile((1, 7, 11)) is None


def test_exact_tiling_round_trip_matches_jax():
    grid, tile = (2, 4, 6), (1, 2, 3)
    x = np.random.default_rng(0).standard_normal((2, 48, 3), dtype=np.float32)
    got = tvsa.tile_tokens_exact(torch.from_numpy(x), grid, tile)
    want = jvsa.tile_tokens_exact(jnp.asarray(x), grid, tile)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    back = tvsa.untile_tokens_exact(got, grid, tile)
    np.testing.assert_array_equal(back.numpy(), x)


def test_padded_tiling_round_trip_matches_jax():
    grid, tile = (3, 5, 7), (2, 2, 4)
    x = np.random.default_rng(1).standard_normal((1, 105, 2), dtype=np.float32)
    got = tvsa.tile_tokens(torch.from_numpy(x), grid, tile)
    want = jvsa.tile_tokens(jnp.asarray(x), grid, tile)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(
        tvsa.untile_tokens(got, grid, tile).numpy(), x)
    np.testing.assert_array_equal(tvsa.tile_valid_mask(grid, tile),
                                  jvsa.tile_valid_mask(grid, tile))


def _sparse_inputs(seed, h, nb, e, d, ng, topk, dtype=np.float32):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((1, h, nb * e, d)).astype(dtype)
               for _ in range(3))
    idx = np.stack([rng.permutation(nb)[:topk]
                    for _ in range(h * ng)]).reshape(1, h, ng, topk)
    return q, k, v, idx.astype(np.int32)


@pytest.mark.parametrize("h,nb,e,d,ng,topk", [
    (2, 6, 32, 32, 2, 4),    # query groups of 3 tiles
    (1, 6, 512, 16, 6, 5),   # topk 5: the Pallas kernel pads its index tail
], ids=["q_group3", "topk_no_divisor"])
def test_block_sparse_fast_matches_jax(h, nb, e, d, ng, topk):
    q, k, v, idx = _sparse_inputs(0, h, nb, e, d, ng, topk)
    want = jvsa.block_sparse_attention_fast(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(idx),
        tile_elems=e)
    got = tvsa.block_sparse_attention_fast(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        torch.from_numpy(idx), tile_elems=e)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=RTOL)


def test_video_sparse_attn_exact_grid_matches_jax():
    e, nb, d, h = 32, 6, 32, 2
    rng = np.random.default_rng(2)
    q, k, v, g = (rng.standard_normal((1, h, nb * e, d), dtype=np.float32)
                  for _ in range(4))
    sizes = np.full((nb,), e, np.int32)
    want = jvsa.video_sparse_attn(
        *(jnp.asarray(a) for a in (q, k, v)), jnp.asarray(sizes), 3,
        gate_compress=jnp.asarray(g), tile_elems=e, full_tiles=True,
        q_group=3)
    got = tvsa.video_sparse_attn(
        *(torch.from_numpy(a) for a in (q, k, v)), torch.from_numpy(sizes), 3,
        gate_compress=torch.from_numpy(g), tile_elems=e, full_tiles=True,
        q_group=3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=RTOL)


def test_video_sparse_attn_padded_grid_matches_jax_reference():
    """No exact tile: padded (2, 2, 4) tiles, per-tile selection, against
    the JAX composition with use_pallas=False."""
    grid, tile = (3, 5, 7), (2, 2, 4)
    _, _, sizes, _, padded = jvsa.tile_layout(grid, tile)
    e = 16
    rng = np.random.default_rng(3)
    q, k, v = (rng.standard_normal((1, 2, padded, 16), dtype=np.float32)
               for _ in range(3))
    want = jvsa.video_sparse_attn(
        *(jnp.asarray(a) for a in (q, k, v)), jnp.asarray(sizes), 4,
        tile_elems=e, use_pallas=False)
    got = tvsa.video_sparse_attn(
        *(torch.from_numpy(a) for a in (q, k, v)), torch.from_numpy(sizes), 4,
        tile_elems=e)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=RTOL)


def test_block_sparse_bf16_matches_jax():
    """bf16 in and out: both round the probabilities to bf16 before P@V
    and the output to bf16, in different orders; 3e-2 is about four bf16
    ulps at the outputs' unit scale."""
    q, k, v, idx = _sparse_inputs(4, 2, 6, 32, 32, 2, 4)
    to_j = (lambda a: jnp.asarray(a, jnp.bfloat16))
    to_t = (lambda a: torch.from_numpy(a).to(torch.bfloat16))
    want = jvsa.block_sparse_attention_fast(to_j(q), to_j(k), to_j(v),
                                            jnp.asarray(idx), tile_elems=32)
    got = tvsa.block_sparse_attention_fast(to_t(q), to_t(k), to_t(v),
                                           torch.from_numpy(idx),
                                           tile_elems=32)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), atol=3e-2,
                               rtol=0)
