"""The KV-cache attention's grad route against the JAX package: under
autograd the port attends the valid keys gathered into one tensor
(``context_attention`` on ``cache_context``: ``flash_attention`` on the
flash branch, K1 and K6 on the card), and its
output and q / k / v gradients equal JAX's dense masked attention (the
bias branch of ``cached_self_attention``, differentiated by ``jax.vjp``)
on the same cache: sink 0 and > 0, fresh, partly filled, rolled and
straddling the sink, buffers of >= 1,024 keys at a head of 128 and the
dense branch's small ones. Also the gathered ranges against JAX's mask,
the routes' kernels (K5 only without grad, and still refusing grad on
CUDA), and ``forward_block``'s grad passes, checkpointed or not and on
fresh caches, against its pass without grad on the caches."""

import importlib
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastvideo_tpu.models.dits import causal_wan as jcw
from fastvideo_tpu_torch.models.dits import causal_wan as tcw
from fastvideo_tpu_torch.models.registry import resolve_model_cls
from fastvideo_tpu_torch.ops import _build
from fastvideo_tpu_torch.ops import flash_attention as tfa

sys.path.insert(0, os.path.dirname(__file__))

from test_torch_no_jax import _cuda_typed  # noqa: E402
from utils import TINY_DIT  # noqa: E402

torch.set_num_threads(2)

# the module (the package's ``flash_attention`` name is the function)
jfa = importlib.import_module("fastvideo_tpu.ops.flash_attention")
ATOL, RTOL = 2e-5, 1e-4


def _jax_dense_kv_mask(q, k, v, ok, scale=None):
    """JAX's dense branch (``causal_wan.py``'s bias attention) in place of
    its kv-mask kernel, which has no VJP."""
    bias = jnp.where(ok, 0.0, jcw.NEG_INF)[None, None, None, :]
    return jax.nn.dot_product_attention(q, k, v, bias=bias, scale=scale)


def _caches(h, d, window, sink, blocks, n, rng):
    """A JAX and a port fp32 cache after ``blocks`` passes of n tokens."""
    jcache = jcw.init_layer_cache(1, window, sink, h, d, jnp.float32)
    tcache = tcw.init_layer_cache(1, window, sink, h, d, torch.float32)
    for _ in range(blocks):
        q, k, v = (rng.standard_normal((1, n, h, d), dtype=np.float32)
                   for _ in range(3))
        _, jcache = jcw.cached_self_attention(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jcache, d**-0.5)
        with torch.no_grad():
            _, tcache = tcw.cached_self_attention(
                torch.from_numpy(q), torch.from_numpy(k),
                torch.from_numpy(v), tcache, d**-0.5)
    return jcache, tcache


# (heads, head dim, tokens a pass, window tokens (the sink inside),
# sink tokens, passes before the one differentiated)
CASES = {
    "flash_fresh": (1, 128, 256, 1280, 0, 0),
    "flash_sink0_partial": (1, 128, 256, 1280, 0, 2),
    "flash_sink0_rolled": (1, 128, 256, 1280, 0, 6),
    "flash_sink_partial": (1, 128, 256, 1280, 256, 2),
    "flash_sink_rolled": (1, 128, 256, 1280, 256, 6),
    # a pass that writes the sink's last 128 slots and the window's first
    "flash_sink_straddle": (1, 128, 256, 1536, 384, 1),
    # the full clip in one pass, longer than the window
    "flash_longer_than_window": (1, 128, 1536, 1280, 256, 0),
    "dense_sink": (2, 32, 16, 64, 16, 5),
    "dense_sink0": (2, 32, 16, 64, 0, 2),
}


@pytest.mark.parametrize("case", list(CASES))
def test_grad_route_matches_jax_dense_masked_attention(case, monkeypatch):
    """Output and q / k / v gradients (for one random cotangent) of a pass
    under grad, within fp32 summation-order tolerance; on the flash
    branch the port runs K1's and K6's plain versions once each and never
    K5's."""
    h, d, n, window, sink, blocks = CASES[case]
    monkeypatch.setattr(jfa, "flash_attention_kv_mask", _jax_dense_kv_mask)
    rng = np.random.default_rng(3)
    jcache, tcache = _caches(h, d, window, sink, blocks, n, rng)
    q, k, v, w = (rng.standard_normal((1, n, h, d), dtype=np.float32)
                  for _ in range(4))

    def f(q_, k_, v_):
        return jcw.cached_self_attention(q_, k_, v_, jcache, d**-0.5)[0]

    want, vjp = jax.vjp(f, *(jnp.asarray(x) for x in (q, k, v)))
    want_grads = vjp(jnp.asarray(w))
    tq, tk, tv = (torch.tensor(x, requires_grad=True) for x in (q, k, v))
    ctx = tcw.cache_context(tcache, n, torch.float32)
    before = dict(_build.PLAIN_CALLS)
    got = tcw.context_attention(tq, tk, tv, ctx, d**-0.5)
    got.backward(torch.from_numpy(w))
    calls = {name: _build.PLAIN_CALLS[name] - before.get(name, 0)
             for name in ("flash_fwd", "flash_bwd_dq", "flash_fwd_kv_mask")}
    flash = case.startswith("flash")
    assert calls == {"flash_fwd": int(flash), "flash_bwd_dq": int(flash),
                     "flash_fwd_kv_mask": 0}, calls
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=ATOL, rtol=RTOL)
    for name, g, gw in zip("qkv", (tq, tk, tv), want_grads):
        np.testing.assert_allclose(g.grad.numpy(), np.asarray(gw),
                                   atol=ATOL, rtol=RTOL, err_msg=name)
    # the pass's commit, without grad, gives JAX's new cache
    _, jnew = jcw.cached_self_attention(*(jnp.asarray(x) for x in (q, k, v)),
                                        jcache, d**-0.5)
    with torch.no_grad():
        _, new = tcw.cached_self_attention(tq, tk, tv, tcache, d**-0.5)
    for key in ("k", "v", "sink_k", "sink_v"):
        np.testing.assert_array_equal(new[key].detach().numpy(),
                                      np.asarray(jnew[key]), err_msg=key)
    assert (new["valid"], new["global_end"]) == (int(jnew["valid"]),
                                                 int(jnew["global_end"]))


def test_valid_ranges_match_jax_mask(monkeypatch):
    """The gathered keys are exactly the keys JAX's mask keeps, over
    fills, evictions, sinks written across passes and passes longer than
    the window; a fresh context is a fresh cache's."""
    seen = {}

    def capture(q, k, v, ok, scale=None):
        seen["k"], seen["ok"] = np.asarray(k), np.asarray(ok)
        return q

    monkeypatch.setattr(jfa, "flash_attention_kv_mask", capture)
    h, d = 1, 128
    for window, sink, n in ((1280, 0, 256), (1280, 256, 256),
                            (1536, 384, 256), (1280, 512, 160),
                            (1280, 256, 1536), (1024, 0, 1024)):
        jcache = jcw.init_layer_cache(1, window, sink, h, d, jnp.float32)
        tcache = tcw.init_layer_cache(1, window, sink, h, d, torch.float32)
        for p in range(8):
            # each token's key holds its absolute position
            pos = np.arange(p * n, (p + 1) * n, dtype=np.float32) + 1
            k = np.broadcast_to(pos[None, :, None, None],
                                (1, n, h, d)).copy()
            _, jcache_new = jcw.cached_self_attention(
                jnp.asarray(k), jnp.asarray(k), jnp.asarray(k), jcache, 1.0)
            kept = np.sort(seen["k"][0, seen["ok"], 0, 0])
            ctx = tcw.cache_context(tcache, n, torch.float32)
            a, lo = ctx["new"]
            old = ([] if ctx["k"] is None else
                   list(ctx["k"][0, :, 0, 0].numpy()))
            mine = old + list(pos[:a]) + list(pos[lo:])
            assert np.array_equal(np.sort(mine), kept), (window, sink, n, p)
            assert ctx["keys"] == window
            with torch.no_grad():
                tk = torch.from_numpy(k)
                _, tcache = tcw.cached_self_attention(tk, tk, tk, tcache, 1.0)
            jcache = jcache_new
            fresh = tcw.fresh_context(window, sink, n)
            if p == 0:
                assert fresh["new"] == ctx["new"] and ctx["k"] is None


def test_no_grad_pass_keeps_k5_and_grad_pass_takes_k1(monkeypatch):
    """Without grad the flash branch is K5 on the whole buffers; under grad
    it is flash_attention (K1 / K6) on the gathered keys, and K5 is never
    called."""
    monkeypatch.setattr(jfa, "flash_attention_kv_mask", _jax_dense_kv_mask)
    calls = []
    real_flash, real_k5 = tcw.flash_attention, tcw.flash_attention_kv_mask
    monkeypatch.setattr(tcw, "flash_attention", lambda q, k, v, **kw: (
        calls.append(("k1", k.shape[1])), real_flash(q, k, v, **kw))[1])
    monkeypatch.setattr(tcw, "flash_attention_kv_mask",
                        lambda q, k, v, m, **kw: (
                            calls.append(("k5", k.shape[1])),
                            real_k5(q, k, v, m, **kw))[1])
    rng = np.random.default_rng(0)
    _, cache = _caches(1, 128, 1280, 256, 2, 256, rng)
    calls.clear()
    q = torch.randn(1, 256, 1, 128)
    with torch.no_grad():
        tcw.cached_self_attention(q, q, q, cache, 0.1)
    assert calls == [("k5", 1280)]
    calls.clear()
    tcw.context_attention(q.requires_grad_(), q, q,
                          tcw.cache_context(cache, 256, q.dtype), 0.1)
    # 256 sink keys, 256 old window keys, 256 new
    assert calls == [("k1", 768)]


def test_cuda_routes(monkeypatch):
    """On CUDA tensors the grad route reaches K1's launch (here its build,
    with no nvcc), never K5 and never a plain version; the pass without
    grad called under grad reaches K5, which still refuses and names the
    differentiable form."""
    monkeypatch.setattr(_build, "check_device", lambda t, name: None)
    monkeypatch.setattr(_build, "stream_ptr", lambda t: 0)
    monkeypatch.setattr(_build, "_libs", {})
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", "/nonexistent")
    bf = torch.bfloat16
    c = _cuda_typed
    cache = tcw.init_layer_cache(1, 1280, 0, 1, 128, bf)
    cache = {k: c(v) if torch.is_tensor(v) else v for k, v in cache.items()}
    q = c(torch.zeros(1, 256, 1, 128, dtype=bf, requires_grad=True))
    kv = c(torch.zeros(1, 256, 1, 128, dtype=bf))
    before = dict(_build.PLAIN_CALLS)
    with pytest.raises(_build.KernelError, match="nvcc not found"):
        tcw.context_attention(q, kv, kv, tcw.cache_context(cache, 256, bf),
                              0.1)
    for call in (lambda: tcw.cached_self_attention(q, kv, kv, cache, 0.1),
                 lambda: tfa.flash_attention_kv_mask(
                     q, kv, kv, c(torch.ones(256, dtype=torch.bool)))):
        with pytest.raises(_build.KernelError,
                           match="flash_attention over the valid keys"):
            call()
    assert _build.PLAIN_CALLS == before


def _tiny_causal(seed=0):
    """One head of 128 and a 5-frame window of 256-token frames (1,280
    keys, a 1-frame sink): the flash branch."""
    cls, arch_cls = resolve_model_cls("CausalWanTransformer3DModel")
    cfg = dict(TINY_DIT, num_attention_heads=1, attention_head_dim=128,
               num_layers=2, num_frames_per_block=2, local_attn_size=5,
               sink_size=1)
    torch.manual_seed(seed)
    return cls(arch_cls(**{k: tuple(v) if isinstance(v, list) else v
                           for k, v in cfg.items()}), dtype=torch.float32)


def test_forward_block_routes_agree(monkeypatch):
    """forward_block under grad on a cache two blocks in: the checkpointed
    pass equals the pass without checkpoint in output and parameter
    gradients, and both equal in output the pass without grad (K5 on the
    whole buffers); a pass on fresh caches (``kv_caches=None``, none
    allocated) equals one on allocated fresh caches, with and without
    grad; a pass that would write the caches under grad, or without
    caches, raises."""
    model = _tiny_causal()
    emb = torch.randn(1, 6, TINY_DIT["text_dim"])
    x = [torch.randn(1, 4, 2, 32, 32) for _ in range(3)]
    t = torch.full((1,), 500.0)
    frame = 16 * 16
    caches = model.init_caches(1, frame, torch.float32)
    with torch.no_grad():
        for i in range(2):
            model.forward_block(x[i], emb, torch.zeros(1), caches,
                                start_frame=2 * i)
    params = [p for p in model.parameters() if p.requires_grad]

    def run(remat, kv):
        model.gradient_checkpointing = remat
        out, _ = model.forward_block(x[2], emb, t, kv, start_frame=4,
                                     update_caches=False)
        return out, torch.autograd.grad(out.square().sum(), params)

    plain, remat = run(False, caches), run(True, caches)
    torch.testing.assert_close(plain[0], remat[0], atol=0, rtol=0)
    for a, b in zip(plain[1], remat[1]):
        torch.testing.assert_close(a, b, atol=1e-6, rtol=1e-5)
    with torch.no_grad():
        k5 = model.forward_block(x[2], emb, t, caches, start_frame=4,
                                 update_caches=False)[0]
    torch.testing.assert_close(plain[0].detach(), k5, atol=2e-5, rtol=1e-4)
    fresh = model.init_caches(1, frame, torch.float32)
    for remat_on in (False, True):
        a, b = run(remat_on, fresh), run(remat_on, None)
        torch.testing.assert_close(a[0], b[0], atol=2e-5, rtol=1e-4)
        for ga, gb in zip(a[1], b[1]):
            torch.testing.assert_close(ga, gb, atol=2e-5, rtol=1e-4)
    with torch.no_grad():
        a = model.forward_block(x[2], emb, t, fresh, update_caches=False)[0]
        b = model.forward_block(x[2], emb, t, None, update_caches=False)[0]
    torch.testing.assert_close(a, b, atol=2e-5, rtol=1e-4)
    for remat_on in (False, True):
        model.gradient_checkpointing = remat_on
        with pytest.raises(ValueError, match="writes the caches"):
            model.forward_block(x[2], emb, t, caches)
    with pytest.raises(ValueError, match="writes the caches"), \
            torch.no_grad():
        model.forward_block(x[2], emb, t, None)
