"""The port's NABLA (fastvideo_tpu_torch/ops/nabla.py) against the JAX
package's: the adaptive block mask, the count-driven sparse attention
(K9a's plain version; the JAX side runs its Pallas kernel in interpret
mode) on masks whose rows keep from 0 or 1 up to every block, the whole
``nabla_attention`` and the NABLA_ATTN backend. Inputs are numpy-seeded
fp32; outputs are held to atol 2e-5 + rtol 2e-4 (fp32 summation order, as
the JAX package's own NABLA tests hold its kernel to dense attention)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastvideo_tpu.attention.backends.abstract import (
    AttentionMetadata as JaxMetadata)
from fastvideo_tpu.attention.backends.nabla import (
    NablaAttentionBackend as JaxNabla)
from fastvideo_tpu.ops import nabla as jax_nabla
from fastvideo_tpu_torch.attention.backends.abstract import AttentionMetadata
from fastvideo_tpu_torch.attention.selector import get_attn_backend
from fastvideo_tpu_torch.ops import _build, nabla

torch.set_num_threads(2)
ATOL, RTOL = 2e-5, 2e-4


def _qkv(seed, s=4 * 64, h=2, d=32):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal((1, s, h, d)).astype(np.float32)
                 for _ in range(3))


def _t(*xs):
    return tuple(torch.from_numpy(np.ascontiguousarray(x)) for x in xs)


def _j(*xs):
    return tuple(jnp.asarray(x) for x in xs)


def assert_masks_agree(got, want, mass, cut, ulps=4):
    """Masks equal; where a block differs, its sorted cumulative mass must lie
    within ``ulps`` fp32 ulps of the cut (the two frameworks may add the
    cumulative sum in another order), and nothing looser."""
    diff = got != want
    if not diff.any():
        return
    # the cumulative mass of each block in ascending order, in float64
    m = np.asarray(mass, np.float64)
    order = np.argsort(m, axis=-1, kind="stable")
    cum = np.cumsum(np.take_along_axis(m, order, -1), -1)
    at = np.empty_like(cum)
    np.put_along_axis(at, order, cum, -1)
    tol = ulps * np.spacing(np.float32(cut))
    assert (np.abs(at[diff] - cut) <= tol).all(), (
        f"{diff.sum()} blocks differ away from the cut")


def _block_map(q, k):
    b, s, h, d = q.shape
    nb = s // 64
    qa = q.reshape(b, nb, 64, h, d).mean(2).transpose(0, 2, 1, 3)
    ka = k.reshape(b, nb, 64, h, d).mean(2).transpose(0, 2, 1, 3)
    logits = qa.astype(np.float64) @ ka.transpose(0, 1, 3, 2) / np.sqrt(d)
    e = np.exp(logits - logits.max(-1, keepdims=True))
    return e / e.sum(-1, keepdims=True)


@pytest.mark.parametrize("with_sta", [False, True], ids=["no_sta", "sta"])
@pytest.mark.parametrize("thr", [0.5, 0.9])
def test_nabla_block_mask_matches_jax(thr, with_sta):
    q, k, _ = _qkv(3, s=6 * 64)
    # pooled means of unit normals are small: scale them up, so that the
    # block map is far from flat and rows keep different counts
    q, k = q * 8, k * 8
    sta = None
    if with_sta:
        sta = np.zeros((1, 2, 6, 6), bool)
        sta[..., np.arange(6), np.arange(6)] = True  # the diagonal window
    want = np.asarray(jax_nabla.nabla_block_mask(
        *_j(q, k), None if sta is None else jnp.asarray(sta), thr))
    got = nabla.nabla_block_mask(
        *_t(q, k), None if sta is None else torch.from_numpy(sta), thr)
    assert got.dtype == torch.bool and got.shape == (1, 2, 6, 6)
    assert_masks_agree(got.numpy(), want, _block_map(q, k), 1.0 - thr)
    assert got.any(-1).all()
    # the threshold keeps a different number of blocks across rows
    assert len(set(got.sum(-1).flatten().tolist())) > 1


def _count_mask(nq, nk, h=2, seed=0, empty_row=False):
    """Rows keeping 1, 2, ... up to nk blocks (cycling), chosen at random;
    optionally one row with none."""
    rng = np.random.default_rng(seed)
    mask = np.zeros((1, h, nq, nk), bool)
    for hi in range(h):
        for qi in range(nq):
            n = (qi + hi) % nk + 1
            mask[0, hi, qi, rng.choice(nk, n, replace=False)] = True
    if empty_row:
        mask[0, 0, 1] = False
    return mask


@pytest.mark.parametrize("case", ["full_tiles", "partial_tiles",
                                  "empty_row"])
def test_masked_block_sparse_attention_plain_matches_jax(case):
    q, k, v = _qkv(5, s=6 * 64)
    qt, kt, vt = (x.transpose(0, 2, 1, 3) for x in (q, k, v))
    mask = _count_mask(6, 6, empty_row=case == "empty_row")
    assert sorted(set(mask.sum(-1).flatten().tolist()))[-1] == 6
    sizes = np.full(6, 64, np.int32)
    if case == "partial_tiles":
        sizes[[1, 4]] = [40, 17]
        # zero tokens in the padding slots, as tile_tokens leaves them
        for t, n in ((1, 40), (4, 17)):
            kt[:, :, t * 64 + n:(t + 1) * 64] = 0
    want = np.asarray(jax_nabla.masked_block_sparse_attention(
        *_j(qt, kt, vt, mask, sizes)))
    before = _build.PLAIN_CALLS[nabla.NAME]
    got = nabla.masked_block_sparse_attention(*_t(qt, kt, vt, mask, sizes))
    assert _build.PLAIN_CALLS[nabla.NAME] == before + 1
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=RTOL)
    if case == "empty_row":  # a row with no block stores exactly 0
        assert (got[0, 0, 64:128] == 0).all()


def test_mask_indices_are_ascending_then_minus_one():
    mask = torch.from_numpy(_count_mask(6, 6))
    idx, counts = nabla.mask_indices(mask)
    assert idx.dtype == counts.dtype == torch.int32
    for row, n, m in zip(idx.reshape(-1, 6), counts.flatten(),
                         mask.reshape(-1, 6)):
        kept = row[:n]
        assert (kept == torch.nonzero(m).flatten()).all()
        assert (row[n:] == -1).all()


@pytest.mark.parametrize("thr", [0.7, 1.0])
def test_nabla_attention_matches_jax(thr):
    q, k, v = _qkv(7)
    want = np.asarray(jax_nabla.nabla_attention(*_j(q, k, v), thr=thr))
    got = nabla.nabla_attention(*_t(q, k, v), thr=thr)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=RTOL)


def test_nabla_backend_matches_jax():
    """NABLA_ATTN with the metadata keys (nabla_P, nabla_sta_mask)."""
    q, k, v = _qkv(9, h=2, d=16)
    sta = np.zeros((4, 4), bool)
    sta[0] = True
    be = get_attn_backend(2, 16, requested="NABLA")
    assert be.name == "NABLA_ATTN"
    want = np.asarray(JaxNabla(2, 16).forward(
        *_j(q, k, v), JaxMetadata(extra={"nabla_P": 0.6,
                                         "nabla_sta_mask": jnp.asarray(sta)})))
    got = be.forward(*_t(q, k, v), AttentionMetadata(
        extra={"nabla_P": 0.6, "nabla_sta_mask": torch.from_numpy(sta)}))
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=RTOL)


def test_nabla_needs_whole_blocks():
    q = torch.zeros(1, 100, 2, 16)
    with pytest.raises(ValueError, match="divisible by 64"):
        nabla.nabla_attention(q, q, q)
