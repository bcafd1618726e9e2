"""Flash attention's backward in the port (the autograd Function over K1 and
K6, on the CPU its plain versions) against ``jax.grad`` of the JAX
``flash_attention``, whose Pallas backward runs in interpret mode here, and
``flash_attention_bwd_plain`` against the JAX ``_flash_attention_bwd_bhsd``
on the same out, LSE and output gradient."""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastvideo_tpu_torch.ops import _build
from fastvideo_tpu_torch.ops import flash_attention as tfa

# the JAX package's ops/__init__ rebinds the name to the function
jfa = importlib.import_module("fastvideo_tpu.ops.flash_attention")
torch.set_num_threads(2)

# fp32 throughout: the two sides differ in summation order only
ATOL, RTOL = 2e-5, 1e-4


def _inputs(seed, b, sq, skv, h, d):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32)
            for shape in ((b, sq, h, d), (b, skv, h, d), (b, skv, h, d),
                          (b, sq, h, d))]


@pytest.mark.parametrize("sq,skv,causal,kv_valid", [
    (150, 150, False, None),   # dense
    (150, 150, True, None),    # causal
    (90, 200, False, 137),     # a masked tail of keys
])
def test_grads_match_jax(sq, skv, causal, kv_valid):
    q, k, v, g = _inputs(0, 1, sq, skv, 2, 32)

    def jloss(q, k, v):
        out = jfa.flash_attention(q, k, v, causal=causal, kv_valid=kv_valid)
        return jnp.sum(out * g)

    want = jax.grad(jloss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    before = dict(_build.PLAIN_CALLS)
    out = tfa.flash_attention(tq, tk, tv, causal=causal, kv_valid=kv_valid)
    (out * torch.from_numpy(g)).sum().backward()
    # the backward went through K6's plain version, once for each kernel
    for name in ("flash_bwd_dq", "flash_bwd_dkv"):
        assert _build.PLAIN_CALLS[name] == before[name] + 1
    for name, got, w in zip("qkv", (tq.grad, tk.grad, tv.grad), want):
        np.testing.assert_allclose(got.numpy(), np.asarray(w), atol=ATOL,
                                   rtol=RTOL, err_msg=f"d{name}")


def test_row_with_no_valid_key_has_zero_gradient():
    """kv_valid = 0: every row is empty, its output 0 and its LSE -inf;
    masking p before the exponent keeps every gradient exactly 0."""
    q, k, v, g = _inputs(1, 1, 40, 50, 2, 16)
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    out, lse = tfa.flash_attention(tq, tk, tv, kv_valid=0, return_lse=True)
    assert torch.all(out == 0) and torch.all(torch.isneginf(lse))
    (out * torch.from_numpy(g)).sum().backward()
    for t in (tq, tk, tv):
        assert torch.all(t.grad == 0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal,kv_valid", [(False, 111), (True, 130)])
def test_bwd_plain_matches_jax_bwd(dtype, causal, kv_valid):
    """The plain backward against the JAX one on identical out, LSE and dO:
    the same rounding points, so in bf16 the results agree within one bf16
    ulp of the larger (2^-7 relative) plus a floor for sums near zero."""
    q, k, v, g = _inputs(2, 2, 70, 130, 2, 32)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    jq, jk, jv, jg = (jnp.asarray(x).astype(jdt).transpose(0, 2, 1, 3)
                      for x in (q, k, v, g))
    scale = 32**-0.5
    kw = dict(scale=scale, causal=causal, block_q=128, block_kv=128,
              kv_valid=kv_valid)
    jout, jlse = jfa._flash_attention_fwd_bhsd(jq, jk, jv, **kw)
    jlse = jlse[:, :, :q.shape[1]]
    want = jfa._flash_attention_bwd_bhsd(jq, jk, jv, jout, jlse, jg, **kw)

    def torch_of(x):  # [B, H, S, D] JAX array -> [B, S, H, D] tensor
        return torch.from_numpy(
            np.array(x.astype(jnp.float32))).transpose(1, 2).to(
                getattr(torch, dtype))

    got = tfa.flash_attention_bwd_plain(
        torch_of(jq), torch_of(jk), torch_of(jv), torch_of(jout),
        torch.from_numpy(np.array(jlse)), torch_of(jg), scale=scale,
        causal=causal, kv_valid=kv_valid)
    for name, t, w in zip("qkv", got, want):
        assert t.dtype == getattr(torch, dtype)
        w = np.asarray(w.astype(jnp.float32)).transpose(0, 2, 1, 3)
        if dtype == "float32":
            atol, rtol = ATOL, RTOL
        else:
            atol, rtol = 2.0**-6 * np.abs(w).std(), 2.0**-7
        np.testing.assert_allclose(t.float().numpy(), w, atol=atol,
                                   rtol=rtol, err_msg=f"d{name}")


def test_no_grad_call_stays_off_the_autograd_function():
    """Without grad the forward is K1's alone: no LSE is saved and the
    output has no graph."""
    q, k, v, _ = _inputs(3, 1, 20, 20, 1, 16)
    out = tfa.flash_attention(*map(torch.from_numpy, (q, k, v)))
    assert out.grad_fn is None
