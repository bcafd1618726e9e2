"""Port flash attention (plain version of K1, CPU) against the JAX
``flash_attention`` (its Pallas kernel in interpret mode), in fp32."""

import importlib
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastvideo_tpu_torch.ops import _build
from fastvideo_tpu_torch.ops import flash_attention as tfa

# the JAX package's ops/__init__ re-exports functions under these names
jfa = importlib.import_module("fastvideo_tpu.ops.flash_attention")

torch.set_num_threads(2)

# fp32 on both sides: only the summation order differs
ATOL, RTOL = 2e-5, 1e-4


def _qkv(seed, b, sq, skv, h, d):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, sq, h, d), dtype=np.float32),
            rng.standard_normal((b, skv, h, d), dtype=np.float32),
            rng.standard_normal((b, skv, h, d), dtype=np.float32))


@pytest.mark.parametrize("shape,kw", [
    ((1, 200, 77, 2, 64), {}),                       # ragged lengths
    ((1, 150, 150, 2, 64), dict(causal=True, kv_valid=100)),
    ((2, 130, 130, 1, 384), {}),                     # VAE mid-block head dim
    ((1, 96, 160, 2, 32), dict(causal=True)),        # causal, Skv > Sq
    ((2, 300, 64, 3, 128), dict(kv_valid=50)),       # cross-attn head dim
], ids=["ragged", "causal_kv_valid", "d384", "causal_ragged",
        "d128_kv_valid"])
def test_flash_matches_jax(shape, kw):
    q, k, v = _qkv(0, *shape)
    want = jfa.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                               **kw)
    got = tfa.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                              torch.from_numpy(v), **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=RTOL)


def test_flash_lse_matches_jax():
    b, sq, skv, h, d = 1, 140, 90, 2, 64
    q, k, v = _qkv(1, b, sq, skv, h, d)
    scale = 1 / math.sqrt(d)
    t = (lambda x: jnp.asarray(x).transpose(0, 2, 1, 3))
    _, lse_want = jfa._flash_attention_fwd_bhsd(
        t(q), t(k), t(v), scale=scale, causal=True, block_q=256,
        block_kv=128, kv_valid=80)
    _, lse_got = tfa.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                                     torch.from_numpy(v), causal=True,
                                     kv_valid=80, return_lse=True)
    # the Pallas wrapper returns the LSE of its padded query rows too
    np.testing.assert_allclose(lse_got.numpy(), np.asarray(lse_want)[..., :sq],
                               atol=ATOL, rtol=RTOL)


def test_flash_row_without_valid_key_is_zero():
    """kv_valid=0 leaves every row without a key: the port returns 0 and an
    LSE of -inf. (The Pallas kernel masks with a finite value, so there a
    keyless row averages the zero-padded block instead; its
    ``l == 0 -> 0`` store at flash_attention.py:160-164 is what the port
    keeps, with exact masking.)"""
    q, k, v = _qkv(2, 1, 33, 20, 2, 32)
    out, lse = tfa.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                                   torch.from_numpy(v), kv_valid=0,
                                   return_lse=True)
    assert torch.equal(out, torch.zeros_like(out))
    assert torch.isneginf(lse).all()


def test_flash_cpu_runs_plain_version():
    q, k, v = (torch.from_numpy(a) for a in _qkv(3, 1, 8, 8, 1, 16))
    before = dict(_build.PLAIN_CALLS), dict(_build.LAUNCHES)
    tfa.flash_attention(q, k, v)
    assert _build.PLAIN_CALLS["flash_fwd"] == before[0]["flash_fwd"] + 1
    assert _build.LAUNCHES == before[1]


def test_flash_cuda_rejects_unaligned_head_dim(monkeypatch):
    """The CUDA route takes head dims that are multiples of 16 and raises
    otherwise; the plain version is not called."""
    monkeypatch.setattr(_build, "check_device", lambda t, name: None)
    q = torch.zeros(1, 8, 1, 24, dtype=torch.bfloat16)
    c = q.as_subclass(_CudaTyped)
    before = dict(_build.PLAIN_CALLS)
    with pytest.raises(_build.KernelError, match="multiple of 16"):
        tfa.flash_attention(c, c, c)
    assert _build.PLAIN_CALLS == before


class _CudaTyped(torch.Tensor):
    """A CPU tensor that reports itself as a CUDA tensor."""

    @property
    def is_cuda(self):
        return True
