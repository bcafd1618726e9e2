"""The causal Wan training forward's chunk-causal and teacher-forcing masks
in the port's flash attention (K1 struct / K6 struct; on the CPU their
plain versions) against the JAX ``flash_attention(chunk_tokens=,
tf_clean_len=)`` and its ``jax.vjp``, whose Pallas kernels run in interpret
mode here, and against a dense oracle built from the rule itself. Chunk and
clean/noisy borders fall inside the JAX kernel's 128-row tiles."""

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

# (S, chunk_tokens, tf_clean_len, kv_valid): chunks of 40 and 56 tokens
# and a clean/noisy border at 100 or 96 cut JAX's 128-row tiles; a masked
# tail of keys
CASES = {
    "chunk": (200, 40, 0, None),
    "chunk_kv_valid": (200, 56, 0, 150),
    "tf": (200, 40, 100, None),
    "tf_kv_valid": (192, 32, 96, 180),
}
H, D = 2, 32


def _tol(dtype, want):
    """fp32: the two sides differ in summation order only. bf16: both round
    p to bf16 before P V (and p, dS before the backward's products) and
    the outputs to bf16, so they agree within two bf16 ulps (2^-6
    relative) plus 2^-5 of the reference's std for values near zero, where
    the order of the fp32 sums shows."""
    if dtype == "float32":
        return 2e-5, 1e-4
    return 2.0**-5 * np.abs(want).std(), 2.0**-6


def _inputs(seed, s, dtype):
    rng = np.random.default_rng(seed)
    xs = [rng.standard_normal((1, s, H, D)).astype(np.float32)
          for _ in range(4)]
    if dtype == "bfloat16":  # the same bf16 values on both sides
        xs = [np.array(jnp.asarray(x).astype(jnp.bfloat16).astype(
            jnp.float32)) for x in xs]
    return xs


def _torch(x, dtype):
    return torch.from_numpy(x).to(getattr(torch, dtype))


def _np(x):
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def oracle_mask(s, ct, clean_len, kv_valid):
    """[S, S] visibility straight from the rule: chunk-causal, key c of
    query r when c // ct <= r // ct; teacher forcing over [clean | noisy],
    a clean query sees clean keys of its chunk and earlier, a noisy query
    its own noisy chunk and the clean keys of strictly earlier chunks."""
    m = np.zeros((s, s), bool)
    for r in range(s):
        for c in range(kv_valid):
            if clean_len == 0:
                m[r, c] = c // ct <= r // ct
            elif r < clean_len:
                m[r, c] = c < clean_len and c // ct <= r // ct
            else:
                chunk = (r - clean_len) // ct
                m[r, c] = ((c >= clean_len and
                            (c - clean_len) // ct == chunk) or
                           (c < clean_len and c // ct < chunk))
    return m


def _dense(q, k, v, mask):
    """Masked softmax attention in fp64 numpy over [1, S, H, D]."""
    s = np.einsum("bqhd,bkhd->bhqk", q, k).astype(np.float64) * D**-0.5
    s = np.where(mask, s, -np.inf)
    p = np.exp(s - s.max(-1, keepdims=True))
    p /= p.sum(-1, keepdims=True)
    return np.einsum("bhqk,bkhd->bqhd", p, v)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", list(CASES))
def test_forward_matches_jax_and_the_rule(case, dtype):
    s, ct, clean_len, kv_valid = CASES[case]
    q, k, v, _ = _inputs(0, s, dtype)
    jdt = getattr(jnp, dtype)
    want = _np(jfa.flash_attention(
        *(jnp.asarray(x).astype(jdt) for x in (q, k, v)), chunk_tokens=ct,
        tf_clean_len=clean_len, kv_valid=kv_valid))
    before = dict(_build.PLAIN_CALLS)
    got = tfa.flash_attention(*(_torch(x, dtype) for x in (q, k, v)),
                              chunk_tokens=ct, tf_clean_len=clean_len,
                              kv_valid=kv_valid)
    assert _build.PLAIN_CALLS["flash_fwd_struct"] == \
        before["flash_fwd_struct"] + 1
    assert _build.PLAIN_CALLS["flash_fwd"] == before["flash_fwd"]
    assert got.dtype == getattr(torch, dtype)
    atol, rtol = _tol(dtype, want)
    np.testing.assert_allclose(got.float().numpy(), want, atol=atol,
                               rtol=rtol)
    # the rule itself, in fp64: fp32 within summation order, bf16 within
    # the rounding of p and of the output as above
    oracle = _dense(q, k, v, oracle_mask(s, ct, clean_len, kv_valid or s))
    atol, rtol = _tol(dtype, oracle)
    np.testing.assert_allclose(got.float().numpy(), oracle, atol=atol,
                               rtol=rtol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", list(CASES))
def test_gradients_match_jax_vjp(case, dtype):
    """dQ, dK, dV of the port's autograd Function (the plain K6 struct on
    the CPU) against ``jax.vjp`` of the JAX function on the same output
    gradient."""
    s, ct, clean_len, kv_valid = CASES[case]
    q, k, v, g = _inputs(1, s, dtype)
    jdt = getattr(jnp, dtype)
    _, vjp = jax.vjp(
        lambda a, b, c: jfa.flash_attention(
            a, b, c, chunk_tokens=ct, tf_clean_len=clean_len,
            kv_valid=kv_valid),
        *(jnp.asarray(x).astype(jdt) for x in (q, k, v)))
    want = vjp(jnp.asarray(g).astype(jdt))
    tq, tk, tv = (_torch(x, dtype).requires_grad_() for x in (q, k, v))
    before = dict(_build.PLAIN_CALLS)
    out = tfa.flash_attention(tq, tk, tv, chunk_tokens=ct,
                              tf_clean_len=clean_len, kv_valid=kv_valid)
    out.backward(_torch(g, dtype))
    for name in ("flash_bwd_struct_dq", "flash_bwd_struct_dkv"):
        assert _build.PLAIN_CALLS[name] == before[name] + 1
    for name, got, w in zip("qkv", (tq.grad, tk.grad, tv.grad), want):
        w = _np(w)
        atol, rtol = _tol(dtype, w)
        np.testing.assert_allclose(got.float().numpy(), w, atol=atol,
                                   rtol=rtol, err_msg=f"d{name}")


@pytest.mark.parametrize("case", ["chunk_kv_valid", "tf"])
def test_slabs_equal_one_slab(case, monkeypatch):
    """The plain versions in slabs of 7 query rows against one slab: the
    same rows of the same products, so equal up to the BLAS's blocking of
    the fp32 products (1e-6) for out, LSE, dQ, and dK/dV summed over the
    slabs."""
    s, ct, clean_len, kv_valid = CASES[case]
    q, k, v, g = (torch.from_numpy(x) for x in _inputs(2, s, "float32"))
    kw = dict(scale=D**-0.5, kv_valid=kv_valid, chunk_tokens=ct,
              tf_clean_len=clean_len)

    def run():
        out, lse = tfa.flash_attention_plain(q, k, v, **kw)
        return (out, lse, *tfa.flash_attention_bwd_plain(q, k, v, out, lse,
                                                         g, **kw))

    whole = run()
    monkeypatch.setattr(tfa, "SLAB_BYTES", 4 * H * s * 7)
    assert len(tfa._row_slabs(q, s)) == -(-s // 7)
    slabbed = run()
    for name, a, b in zip(("out", "lse", "dq", "dk", "dv"), slabbed, whole):
        torch.testing.assert_close(a, b, atol=1e-6, rtol=1e-6, msg=name)


def test_teacher_forcing_needs_chunk_tokens():
    """tf_clean_len > 0 without chunk_tokens raises ValueError, as the JAX
    function does, in every entry of the port."""
    q = torch.zeros(1, 8, 1, 16)
    with pytest.raises(ValueError, match="chunk"):
        jfa.flash_attention(*(jnp.zeros((1, 8, 1, 16)),) * 3, tf_clean_len=4)
    with pytest.raises(ValueError, match="chunk"):
        tfa.flash_attention(q, q, q, tf_clean_len=4)
    with pytest.raises(ValueError, match="chunk"):
        tfa.flash_attention_plain(q, q, q, scale=0.25, tf_clean_len=4)
    lse = torch.zeros(1, 1, 8)
    with pytest.raises(ValueError, match="chunk"):
        tfa.flash_attention_bwd(q, q, q, q, lse, q, scale=0.25,
                                tf_clean_len=4)
    with pytest.raises(ValueError, match="chunk"):
        tfa.flash_attention_bwd_plain(q, q, q, q, lse, q, scale=0.25,
                                      tf_clean_len=4)
