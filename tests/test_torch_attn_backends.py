"""The port's remaining attention backends against the JAX package's:
TORCH_SDPA, SAGE_ATTN, VMOBA_ATTN (every chunk layout, both select modes)
and ATTN_QAT_TRAIN (forward and gradients against ``jax.grad``), and the
selector's names and aliases. These are XLA in JAX and plain PyTorch in
the port. Inputs are numpy-seeded fp32; each test states its bound."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastvideo_tpu.attention import selector as jax_selector
from fastvideo_tpu.attention.backends.abstract import (
    AttentionMetadata as JaxMetadata)
from fastvideo_tpu.ops import attn_qat as jax_qat
from fastvideo_tpu.ops import vmoba as jax_vmoba
from fastvideo_tpu_torch.attention import selector
from fastvideo_tpu_torch.attention.backends.abstract import AttentionMetadata
from fastvideo_tpu_torch.ops import attn_qat, vmoba

torch.set_num_threads(2)


def _qkv(seed, s=64, t=None, h=2, d=16):
    rng = np.random.default_rng(seed)
    t = s if t is None else t
    return (rng.standard_normal((1, s, h, d)).astype(np.float32),
            rng.standard_normal((1, t, h, d)).astype(np.float32),
            rng.standard_normal((1, t, h, d)).astype(np.float32))


def _both(name, h=2, d=16, causal=False):
    """The JAX and the port backend of one name."""
    return (jax_selector.get_attn_backend(h, d, requested=name,
                                          causal=causal),
            selector.get_attn_backend(h, d, requested=name, causal=causal))


def _run(pair, q, k, v, extra=None, **kw):
    jb, tb = pair
    want = np.asarray(jb.forward(*(jnp.asarray(x) for x in (q, k, v)),
                                 JaxMetadata(extra=dict(extra or {})), **kw))
    got = tb.forward(*(torch.from_numpy(x) for x in (q, k, v)),
                     AttentionMetadata(extra=dict(extra or {})), **kw)
    assert got.shape == want.shape
    return got.detach().numpy(), want


def test_every_backend_name_and_alias_resolves_as_in_jax():
    names = sorted(jax_selector._BACKENDS) + sorted(jax_selector._ALIASES)
    assert sorted(selector._BACKENDS) == sorted(jax_selector._BACKENDS)
    for name in names:
        assert selector.resolve_backend_name(name) == \
            jax_selector.resolve_backend_name(name), name
    with pytest.raises(ValueError, match="Unknown attention backend"):
        selector.resolve_backend_name("NO_SUCH_ATTN")


@pytest.mark.parametrize("name", ["TORCH_SDPA", "NABLA_ATTN", "BSA_ATTN",
                                  "SAGE_ATTN", "VMOBA_ATTN"])
def test_wan_cross_attention_takes_the_backend_jax_takes(name, monkeypatch):
    """The Wan text cross-attention allows FLASH_ATTN and TORCH_SDPA, as in
    JAX: another selected backend falls back to FLASH_ATTN."""
    from fastvideo_tpu_torch.models.dits.wan import WanT2VCrossAttention

    monkeypatch.setenv("FASTVIDEO_ATTENTION_BACKEND", name)
    want = jax_selector.get_attn_backend(
        2, 16, supported=("FLASH_ATTN", "TORCH_SDPA")).name
    got = WanT2VCrossAttention(32, 2).attn.backend.name
    assert got == want == ("TORCH_SDPA" if name == "TORCH_SDPA"
                           else "FLASH_ATTN")


@pytest.mark.parametrize("causal,kv_valid", [(False, None), (False, 40),
                                             (True, None), (True, 50)])
def test_sdpa_matches_jax(causal, kv_valid):
    """fp32 on both sides: within 2e-5 + 2e-5 relative."""
    q, k, v = _qkv(1)
    got, want = _run(_both("SDPA", causal=causal), q, k, v,
                     kv_valid=kv_valid)
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("causal,kv_valid,t", [(False, None, 48),
                                               (False, 30, 48),
                                               (True, None, 64)])
def test_sage_matches_jax(causal, kv_valid, t):
    """The int8 products are exact on both sides, so the scores agree to
    fp32 rounding of the scales: within 2e-5 + 2e-5 relative."""
    q, k, v = _qkv(2, s=64, t=t)
    got, want = _run(_both("SAGE_ATTN_THREE", causal=causal), q, k, v,
                     kv_valid=kv_valid)
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=2e-5)


def test_sage_slabs_cover_every_row(monkeypatch):
    """The query slabs (JAX takes every row at once) change the scores not
    at all (exact int8 products) and the output only by the rounding of
    the fp32 P @ V product: within 1e-6."""
    from fastvideo_tpu_torch.attention.backends import sage

    q, k, v = (torch.from_numpy(x) for x in _qkv(3, s=64, t=48))
    be = selector.get_attn_backend(2, 16, requested="SAGE_ATTN")
    whole = be.forward(q, k, v)
    monkeypatch.setattr(sage, "_SLAB", 48 * 7)  # 7-row slabs
    np.testing.assert_allclose(be.forward(q, k, v).numpy(), whole.numpy(),
                               atol=1e-6, rtol=0)


@pytest.mark.parametrize("mode", ["topk", "threshold"])
@pytest.mark.parametrize("chunk", [1, (2, 4), (2, 2, 4)],
                         ids=["temporal", "spatial", "spatio_temporal"])
def test_vmoba_matches_jax(chunk, mode):
    """Grid (4, 4, 8): temporal chunks of 32 tokens, spatial of 32,
    spatio-temporal of 16. fp32: within 2e-5 + 2e-4 relative."""
    grid = (4, 4, 8)
    q, k, v = _qkv(4, s=128)
    extra = {"vmoba_chunk_size": list(chunk) if isinstance(chunk, tuple)
             else chunk, "vmoba_topk": 2, "vmoba_select_mode": mode,
             "vmoba_threshold": 0.3}
    got, want = _run(_both("VMOBA"), q, k, v, extra, grid=grid)
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=2e-4)


@pytest.mark.parametrize("chunk", [1, (2, 4), (2, 2, 4)],
                         ids=["temporal", "spatial", "spatio_temporal"])
def test_vmoba_chunk_order_round_trips_and_matches_jax(chunk):
    grid = (4, 4, 8)
    x = _qkv(5, s=128)[0]
    want, want_len = jax_vmoba.chunk_reorder(jnp.asarray(x), grid, chunk)
    got, got_len = vmoba.chunk_reorder(torch.from_numpy(x), grid, chunk)
    assert got_len == want_len
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(
        vmoba.chunk_restore(got, grid, chunk).numpy(), x)


@pytest.mark.parametrize("mode", ["topk", "threshold"])
def test_vmoba_gate_mask_matches_jax(mode):
    q, k, _ = _qkv(6, s=128)
    want = np.asarray(jax_vmoba.vmoba_gate_mask(jnp.asarray(q),
                                                jnp.asarray(k), 16, 3, mode,
                                                0.4))
    got = vmoba.vmoba_gate_mask(torch.from_numpy(q), torch.from_numpy(k), 16,
                                3, mode, 0.4)
    np.testing.assert_array_equal(got.numpy(), want)


QAT_CASES = [dict(quant_p=True, smooth_k=False, s=96),
             dict(quant_p=False, smooth_k=True, s=64),
             dict(quant_p=True, smooth_k=True, s=100)]


@pytest.mark.parametrize("case", QAT_CASES,
                         ids=["quant_p_padded", "smooth_k", "both_padded"])
def test_attn_qat_forward_and_grads_match_jax(case):
    """ATTN_QAT_TRAIN: fake quantization with straight-through gradients.
    fp32: output within 2e-5 + 2e-4 relative; gradients of a weighted sum
    against jax.grad within 5e-5 + 1e-3 relative (rounding of the same
    fake-quantized grid)."""
    s = case["s"]
    q, k, v = _qkv(7, s=s)
    w = np.random.default_rng(8).standard_normal(q.shape).astype(np.float32)
    extra = {"qat_quant_p": case["quant_p"], "qat_smooth_k": case["smooth_k"]}
    got, want = _run(_both("ATTN_QAT_TRAIN"), q, k, v, extra)
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=2e-4)

    def jax_loss(q, k, v):
        out = jax_qat.qat_attention(q, k, v, quant_p=case["quant_p"],
                                    smooth_k=case["smooth_k"])
        return jnp.sum(out * jnp.asarray(w))

    jgrads = jax.grad(jax_loss, argnums=(0, 1, 2))(
        *(jnp.asarray(x) for x in (q, k, v)))
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    out = attn_qat.qat_attention(tq, tk, tv, quant_p=case["quant_p"],
                                 smooth_k=case["smooth_k"])
    (out * torch.from_numpy(w)).sum().backward()
    for t, g in zip((tq, tk, tv), jgrads):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(g), atol=5e-5,
                                   rtol=1e-3)


def test_fake_quant_gradient_is_straight_through():
    x = torch.linspace(-3, 3, 64, requires_grad=True)
    scale = torch.full((64,), 0.05)
    y = attn_qat.fake_quant_int8(x, scale)
    assert not torch.equal(y.detach(), x.detach())
    y.backward(torch.arange(64.0))
    assert torch.equal(x.grad, torch.arange(64.0))
