"""The block-sparse backward in the port (the autograd Function over K7's
LSE forward and K7 bwd, on the CPU their plain versions) against the JAX
``block_sparse_attention_trainable`` and ``_block_sparse_bwd`` (Pallas in
interpret mode), on the ragged (2, 4, 5) grid with (2, 2, 2) tiles and a
-1 slot of ``tests/ops/test_vsa_bwd.py``; and the gradients of the whole
``video_sparse_attn`` on an exact grid with grouped query tiles and the
compression gate."""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastvideo_tpu_torch.ops import _build
from fastvideo_tpu_torch.ops import vsa as tvsa
from fastvideo_tpu_torch.ops.sparse_schedule import sparse_membership

# the JAX package's ops/__init__ rebinds some module names to functions
jvsa = importlib.import_module("fastvideo_tpu.ops.vsa")
torch.set_num_threads(2)

# fp32 throughout: summation order only
ATOL, RTOL = 2e-5, 1e-4


@pytest.fixture(scope="module")
def ragged():
    b, h, d, e, topk = 1, 2, 32, 8, 3
    _, _, sizes, _, padded = jvsa.tile_layout((2, 4, 5), (2, 2, 2))
    nb = padded // e
    rng = np.random.default_rng(0)
    q, k, v, g = (rng.standard_normal((b, h, padded, d)).astype(np.float32)
                  for _ in range(4))
    idx = np.stack([rng.choice(nb, topk, replace=False)
                    for _ in range(b * h * nb)]).reshape(b, h, nb, topk)
    idx = idx.astype(np.int32)
    idx[0, 0, 0, -1] = -1  # a sentinel slot
    return dict(q=q, k=k, v=v, g=g, idx=idx, sizes=np.asarray(sizes), e=e)


def test_trainable_grads_match_jax(ragged):
    r = ragged
    jsizes, jidx = jnp.asarray(r["sizes"]), jnp.asarray(r["idx"])

    def jloss(q, k, v):
        out = jvsa.block_sparse_attention_trainable(q, k, v, jidx, jsizes,
                                                    tile_elems=r["e"])
        return jnp.sum(out * r["g"])

    want = jax.grad(jloss, argnums=(0, 1, 2))(
        *(jnp.asarray(r[n]) for n in "qkv"))
    tq, tk, tv = (torch.from_numpy(r[n]).requires_grad_() for n in "qkv")
    before = dict(_build.PLAIN_CALLS)
    out = tvsa.block_sparse_attention_trainable(
        tq, tk, tv, torch.from_numpy(r["idx"]),
        torch.from_numpy(r["sizes"]), tile_elems=r["e"])
    (out * torch.from_numpy(r["g"])).sum().backward()
    for name in ("vsa_sparse_padded_fwd", "vsa_sparse_bwd_dq",
                 "vsa_sparse_bwd_dkv"):
        assert _build.PLAIN_CALLS[name] == before[name] + 1
    for name, got, w in zip("qkv", (tq.grad, tk.grad, tv.grad), want):
        np.testing.assert_allclose(got.numpy(), np.asarray(w), atol=ATOL,
                                   rtol=RTOL, err_msg=f"d{name}")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bwd_plain_matches_jax_bwd(ragged, dtype):
    """The plain backward against the JAX one on identical out, LSE and dO
    (the same rounding points: in bf16 within one bf16 ulp of the larger,
    2^-7 relative, plus a floor for sums near zero)."""
    r = ragged
    b, h, s, _ = r["q"].shape
    nb, topk = s // r["e"], r["idx"].shape[-1]
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    jq, jk, jv, jg = (jnp.asarray(r[n]).astype(jdt) for n in "qkvg")
    jsizes = jnp.asarray(r["sizes"])
    # the JAX kernels' index layout: 8-row, 128-lane padded
    idx_pad = np.zeros((b, h, 8 * -(-nb // 8), 128), np.int32)
    idx_pad[:, :, :nb, :topk] = r["idx"]
    kw = dict(scale=32**-0.5, topk=topk, tile_elems=r["e"])
    jout, jlse = jvsa._block_sparse_fwd_lse(jq, jk, jv, jnp.asarray(idx_pad),
                                            jsizes, **kw)
    want = jvsa._block_sparse_bwd(jq, jk, jv, jnp.asarray(idx_pad), jsizes,
                                  jout, jlse, jg, **kw)

    def torch_of(x):
        return torch.from_numpy(np.array(x.astype(jnp.float32))).to(
            getattr(torch, dtype))

    got = tvsa.block_sparse_attention_bwd_plain(
        torch_of(jq), torch_of(jk), torch_of(jv), torch.from_numpy(r["idx"]),
        torch.from_numpy(r["sizes"]), torch_of(jout),
        torch.from_numpy(np.array(jlse[..., 0])), torch_of(jg),
        scale=kw["scale"], tile_elems=r["e"])
    for name, t, w in zip("qkv", got, want):
        assert t.dtype == getattr(torch, dtype)
        w = np.asarray(w.astype(jnp.float32))
        if dtype == "float32":
            atol, rtol = ATOL, RTOL
        else:
            atol, rtol = 2.0**-6 * np.abs(w).std(), 2.0**-7
        np.testing.assert_allclose(t.float().numpy(), w, atol=atol,
                                   rtol=rtol, err_msg=f"d{name}")


def test_membership_is_the_transposed_sparsity(ragged):
    idx = torch.from_numpy(ragged["idx"])
    nb = idx.shape[2]
    member = sparse_membership(idx, nb)
    assert member.shape == (1, 2, nb, nb) and member.dtype == torch.uint8
    for hh in range(2):
        for qi in range(nb):
            for kt in range(nb):
                want = kt in [t for t in ragged["idx"][0, hh, qi] if t >= 0]
                assert bool(member[0, hh, kt, qi]) == want


def test_video_sparse_attn_grads_match_jax():
    """Exact (4, 4, 2)-token tiles of a (4, 8, 6) grid: 12 tiles of 32,
    grouped by 2 for the top-k, with the compression gate. Gradients flow
    through the compression branch and the gate as plain autograd, and
    through the sparse branch as the trainable op."""
    b, h, d, e, nb, topk, qg = 1, 2, 16, 32, 12, 4, 2
    rng = np.random.default_rng(3)
    q, k, v, gate, g = (rng.standard_normal((b, h, nb * e, d)).astype(
        np.float32) for _ in range(5))
    sizes = np.full((nb,), e, np.int32)

    def jloss(q, k, v, gate):
        out = jvsa.video_sparse_attn(q, k, v, jnp.asarray(sizes), topk,
                                     gate_compress=gate, tile_elems=e,
                                     full_tiles=True, q_group=qg)
        return jnp.sum(out * g)

    want = jax.grad(jloss, argnums=(0, 1, 2, 3))(
        *map(jnp.asarray, (q, k, v, gate)))
    ts = [torch.from_numpy(x).requires_grad_() for x in (q, k, v, gate)]
    before = dict(_build.PLAIN_CALLS)
    out = tvsa.video_sparse_attn(*ts[:3], torch.from_numpy(sizes), topk,
                                 gate_compress=ts[3], tile_elems=e,
                                 full_tiles=True, q_group=qg)
    (out * torch.from_numpy(g)).sum().backward()
    # under grad K2's place is taken by the trainable op
    assert _build.PLAIN_CALLS["vsa_sparse_fwd"] == before["vsa_sparse_fwd"]
    assert (_build.PLAIN_CALLS["vsa_sparse_bwd_dkv"] ==
            before["vsa_sparse_bwd_dkv"] + 1)
    for name, t, w in zip(["q", "k", "v", "gate"], ts, want):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w), atol=ATOL,
                                   rtol=RTOL, err_msg=f"d{name}")


@pytest.mark.parametrize("full_tiles", [True, False],
                         ids=["exact", "padded"])
def test_tables_cached_under_inference_mode_serve_a_backward(full_tiles):
    """The tile tables are cached per (grid, tile, device). A first call
    under ``torch.inference_mode`` (a generation before training, in one
    process) must not leave inference tensors behind: the trainable op
    saves the valid counts for its backward, which autograd refuses for an
    inference tensor."""
    grid = (2, 4, 6) if full_tiles else (2, 4, 5)
    tile, e = (2, 2, 2), 8
    tvsa.tile_tables.cache_clear()
    with torch.inference_mode():
        tvsa.tile_tables(grid, tile, torch.device("cpu"))
    _, sizes, _ = tvsa.tile_tables(grid, tile, torch.device("cpu"))
    assert not torch.is_inference(sizes)
    rng = np.random.default_rng(3)
    ts = [torch.from_numpy(rng.standard_normal(
        (1, 2, sizes.numel() * e, 16)).astype(np.float32)).requires_grad_()
        for _ in range(3)]
    tvsa.video_sparse_attn(*ts, sizes, 2, tile_elems=e,
                           full_tiles=full_tiles).square().sum().backward()
    assert all(torch.isfinite(t.grad).all() and t.grad.abs().sum() > 0
               for t in ts)
