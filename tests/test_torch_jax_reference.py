"""The JAX package's attention through its plain XLA references, for the
port's whole-pipeline tests.

On the CPU the JAX package runs its Pallas kernels in interpret mode, and
lowering and compiling an interpreted kernel (a loop over its grid) is
most of what a JAX training or generation step costs there. Tests that
hold a whole port pipeline against the JAX pipeline take the fixture
``jax_plain_attention``: VSA's sparse branch through the package's own
dense-math reference (``video_sparse_attn(use_pallas=False)``, the
reference of its tests and of its VJP fallback), flash attention through
``_reference_attention``'s softmax in plain XLA, under the kernel's own
structural mask (``_mask_tile`` over the whole score matrix) where it has
one, and the KV-cache attention (``flash_attention_kv_mask``) through the
same softmax over its valid keys. The kernels themselves stay held against
the port in interpret mode by the kernel tests (``test_torch_ops_*``,
``test_torch_flash_*``, ``test_torch_vsa_*``), and the tests below hold
each reference to its interpreted kernel.
"""

import functools
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from fastvideo_tpu.attention.backends import vsa as jax_vsa_backend
from fastvideo_tpu.ops import vsa as jax_vsa

jax_flash = importlib.import_module("fastvideo_tpu.ops.flash_attention")

_kernel_flash = jax_flash._flash_attention_bhsd
_kernel_kv_mask = jax_flash.flash_attention_kv_mask


def _masked_softmax(q, k, v, scale, mask):
    """[B, H, S, D] attention under a [Sq, Skv] (or [Skv]) key mask."""
    s = jnp.einsum("bhqd,bhkd->bhqk", q.astype(jnp.float32),
                   k.astype(jnp.float32)) * scale
    s = jnp.where(mask, s, jax_flash.DEFAULT_MASK_VALUE)
    p = jax.nn.softmax(s, axis=-1)
    return jnp.einsum("bhqk,bhkd->bhqd", p, v.astype(jnp.float32)).astype(
        q.dtype)


def _plain_flash(q, k, v, scale, causal, block_q, block_kv, kv_valid,
                 chunk_tokens=0, tf_clean_len=0):
    """``_flash_attention_bhsd`` through the plain softmax, under the
    kernel's structural mask where it has one."""
    if not (chunk_tokens or tf_clean_len):
        return jax_flash._reference_attention(q, k, v, scale, causal,
                                              kv_valid)
    sq, skv = q.shape[2], k.shape[2]
    col = jnp.arange(skv)[None, :]
    mask = jax_flash._mask_tile(jnp.broadcast_to(col < kv_valid, (sq, skv)),
                                0, 0, sq, skv, causal, chunk_tokens,
                                tf_clean_len)
    return _masked_softmax(q, k, v, scale, mask)


def _plain_kv_mask(q, k, v, kv_mask, *, scale=None, block_q=512,
                   block_kv=1024):
    if scale is None:
        scale = 1.0 / q.shape[-1] ** 0.5
    out = _masked_softmax(q.transpose(0, 2, 1, 3), k.transpose(0, 2, 1, 3),
                          v.transpose(0, 2, 1, 3), float(scale),
                          (kv_mask != 0)[None, :])
    return out.transpose(0, 2, 1, 3)


@pytest.fixture
def jax_plain_attention(monkeypatch):
    monkeypatch.setattr(jax_vsa_backend, "video_sparse_attn",
                        functools.partial(jax_vsa.video_sparse_attn,
                                          use_pallas=False))
    monkeypatch.setattr(jax_flash, "_flash_attention_bhsd", _plain_flash)
    monkeypatch.setattr(jax_flash, "flash_attention_kv_mask",
                        _plain_kv_mask)


def _close(got, want, tol):
    got, want = np.asarray(got), np.asarray(want)
    assert np.abs(got - want).max() <= tol * np.abs(want).max()


@pytest.mark.parametrize("kw", [dict(kv_valid=96), dict(causal=True),
                                dict(chunk_tokens=48),
                                dict(chunk_tokens=32, tf_clean_len=64)],
                         ids=["kv_valid", "causal", "chunk", "tf"])
def test_plain_flash_matches_the_interpreted_kernel(kw):
    rng = np.random.default_rng(len(kw))
    q, k, v = (jnp.asarray(rng.standard_normal((1, 128, 2, 16)),
                           jnp.float32) for _ in range(3))

    def loss(fn, q, k, v):
        return (fn(q, k, v) ** 2).sum()

    def run(q, k, v):
        return jax_flash.flash_attention(q, k, v, **kw)

    want, want_g = run(q, k, v), jax.grad(
        functools.partial(loss, run), argnums=(0, 1, 2))(q, k, v)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_flash, "_flash_attention_bhsd", _plain_flash)
        got, got_g = run(q, k, v), jax.grad(
            functools.partial(loss, run), argnums=(0, 1, 2))(q, k, v)
    _close(got, want, 1e-5)
    for g, w in zip(got_g, want_g):
        _close(g, w, 1e-4)


@pytest.mark.parametrize("full_tiles", [True, False])
def test_plain_vsa_matches_the_interpreted_kernel(full_tiles):
    rng = np.random.default_rng(int(full_tiles))
    q, k, v = (jnp.asarray(rng.standard_normal((1, 2, 256, 16)),
                           jnp.float32) for _ in range(3))
    sizes = jnp.full((4,), 64, jnp.int32)
    kw = dict(full_tiles=full_tiles, tile_elems=64)

    def grads(use_pallas):
        def loss(q, k, v):
            return (jax_vsa.video_sparse_attn(
                q, k, v, sizes, 2, use_pallas=use_pallas, **kw) ** 2).sum()

        out = jax_vsa.video_sparse_attn(q, k, v, sizes, 2,
                                        use_pallas=use_pallas, **kw)
        return out, jax.grad(loss, argnums=(0, 1, 2))(q, k, v)

    (want, want_g), (got, got_g) = grads(True), grads(False)
    _close(got, want, 1e-5)
    for g, w in zip(got_g, want_g):
        _close(g, w, 1e-4)


def test_plain_kv_mask_matches_the_interpreted_kernel():
    rng = np.random.default_rng(5)
    q, k, v = (jnp.asarray(rng.standard_normal((1, n, 2, 16)), jnp.float32)
               for n in (64, 256, 256))
    ok = jnp.asarray(rng.random(256) < 0.6)
    _close(_plain_kv_mask(q, k, v, ok, scale=0.3),
           _kernel_kv_mask(q, k, v, ok, scale=0.3), 1e-5)
