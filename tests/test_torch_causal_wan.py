"""Port causal Wan against the JAX CausalWanTransformer3DModel: the cached
self-attention over a rolling window with a sink (dense and kv-mask flash
paths, through eviction; every cache field after every block), the text
K/V caches, forward_block over three blocks with their commit passes, the
read-only denoise passes, and the start_frame RoPE tables. fp32, weights
carried by state_dict_from_jax."""

import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

from fastvideo_tpu.configs.models.dits.wan import WanArchConfig
from fastvideo_tpu.layers.rotary import get_rotary_pos_embed_wan as jax_rope
from fastvideo_tpu.models.dits import causal_wan as jcw
from fastvideo_tpu_torch.configs.models.dits.wan import (
    WanArchConfig as TorchWanArchConfig)
from fastvideo_tpu_torch.layers.rotary import get_rotary_pos_embed_wan
from fastvideo_tpu_torch.models.dits import causal_wan as tcw
from fastvideo_tpu_torch.models.loader.jax_params import state_dict_from_jax
from fastvideo_tpu_torch.models.registry import resolve_model_cls
from fastvideo_tpu_torch.ops import _build

sys.path.insert(0, os.path.dirname(__file__))

from test_torch_wan_dit import jax_params, numpy_model  # noqa: E402
from utils import TINY_DIT  # noqa: E402

torch.set_num_threads(2)

# fp32 on both sides: summation order only
ATOL, RTOL = 2e-5, 1e-4
CAUSAL = dict(num_frames_per_block=2, local_attn_size=3, sink_size=1)


def _np(x):
    return np.asarray(x)


def _assert_cache_equal(tcache: dict, jcache: dict, atol: float = 0.0,
                        rtol: float = 0.0) -> None:
    """Every field equal; with a tolerance for keys and values that the
    two frameworks computed (not copied) from the same inputs."""
    for key in ("k", "v", "sink_k", "sink_v"):
        np.testing.assert_allclose(tcache[key].numpy(), _np(jcache[key]),
                                   atol=atol, rtol=rtol, err_msg=key)
    assert tcache["valid"] == int(jcache["valid"])
    assert tcache["global_end"] == int(jcache["global_end"])


@pytest.mark.parametrize("path,h,d,n,window,sink,blocks", [
    # 64 keys: the dense bias path; 6 blocks of 16 fill and evict
    ("dense", 2, 32, 16, 48, 16, 6),
    # 1,024 keys at head dim 128: the kv-mask flash path (K5); a 128-token
    # sink written from the first block, then 4 blocks fill the 896-slot
    # window and the fifth evicts
    ("flash", 1, 128, 256, 896, 128, 5),
])
def test_cached_self_attention_matches_jax(path, h, d, n, window, sink,
                                           blocks):
    rng = np.random.default_rng(0)
    jcache = jcw.init_layer_cache(1, window + sink, sink, h, d, jnp.float32)
    tcache = tcw.init_layer_cache(1, window + sink, sink, h, d,
                                  torch.float32)
    _assert_cache_equal(tcache, jcache)
    for _ in range(blocks):
        q, k, v = (rng.standard_normal((1, n, h, d), dtype=np.float32)
                   for _ in range(3))
        before = dict(_build.PLAIN_CALLS)
        want, jcache = jcw.cached_self_attention(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jcache, d**-0.5)
        got, tcache = tcw.cached_self_attention(
            torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
            tcache, d**-0.5)
        flash_calls = (_build.PLAIN_CALLS["flash_fwd_kv_mask"] -
                       before["flash_fwd_kv_mask"])
        assert flash_calls == (1 if path == "flash" else 0)
        np.testing.assert_allclose(got.numpy(), _np(want), atol=ATOL,
                                   rtol=RTOL)
        _assert_cache_equal(tcache, jcache)
    assert tcache["global_end"] > window + sink  # the window evicted


def _models(seed: int = 0):
    cfg = dict(TINY_DIT, **CAUSAL)
    arch = {k: tuple(v) if isinstance(v, list) else v for k, v in cfg.items()}
    jmodel = numpy_model(lambda: jcw.CausalWanTransformer3DModel(
        WanArchConfig(**arch), param_dtype=jnp.float32, rngs=nnx.Rngs(0)),
        seed=seed)
    cls, arch_cls = resolve_model_cls("CausalWanTransformer3DModel")
    tmodel = cls(arch_cls(**arch), dtype=torch.float32)
    tmodel.load_state_dict(state_dict_from_jax(jax_params(jmodel)),
                           strict=True)
    return jmodel, tmodel.eval()


@pytest.fixture(scope="module")
def models():
    # the blocks build their (unused) self-attention backend from the
    # environment, which other tests may leave set
    mp = pytest.MonkeyPatch()
    mp.setenv("FASTVIDEO_ATTENTION_BACKEND", "FLASH_ATTN")
    try:
        return _models()
    finally:
        mp.undo()


def test_precompute_crossattn_caches_matches_jax(models):
    jmodel, tmodel = models
    ctx = np.random.default_rng(1).standard_normal(
        (1, 12, TINY_DIT["text_dim"]), dtype=np.float32)
    want = jmodel.precompute_crossattn_caches(jnp.asarray(ctx))
    with torch.no_grad():
        got = tmodel.precompute_crossattn_caches(torch.from_numpy(ctx))
    assert len(got) == len(want) == TINY_DIT["num_layers"]
    for g, w in zip(got, want, strict=True):
        for key in ("k", "v"):
            np.testing.assert_allclose(g[key].numpy(), _np(w[key]),
                                       atol=ATOL, rtol=RTOL)


def _clone(caches):
    return [{k: v.clone() if torch.is_tensor(v) else v for k, v in c.items()}
            for c in caches]


def test_forward_block_matches_jax_over_blocks(models):
    """Three blocks of (denoise pass, commit pass) at t = 0, on a window of
    3 frames with a 1-frame sink: the third block evicts. The denoise
    passes leave every cache bit-identical."""
    jmodel, tmodel = models
    rng = np.random.default_rng(2)
    ctx = rng.standard_normal((1, 12, TINY_DIT["text_dim"]),
                              dtype=np.float32)
    b, c, nf, hh, ww = 1, 4, 2, 8, 8
    frame_seqlen = (hh // 2) * (ww // 2)
    jcaches = jmodel.init_caches(b, frame_seqlen, jnp.float32)
    tcaches = tmodel.init_caches(b, frame_seqlen, torch.float32)
    jca = jmodel.precompute_crossattn_caches(jnp.asarray(ctx))
    with torch.no_grad():
        tca = tmodel.precompute_crossattn_caches(torch.from_numpy(ctx))
    tctx = torch.from_numpy(ctx)
    for blk in range(3):
        x = rng.standard_normal((b, c, nf, hh, ww), dtype=np.float32)
        for t, commit in ((757.0, False), (0.0, True)):
            tt = np.array([t], np.float32)
            want, jnew = jmodel.forward_block(
                jnp.asarray(x), jnp.asarray(ctx), jnp.asarray(tt), jcaches,
                crossattn_caches=jca, start_frame=blk * nf)
            snapshot = _clone(tcaches)
            with torch.no_grad():
                got, tnew = tmodel.forward_block(
                    torch.from_numpy(x), tctx, torch.from_numpy(tt), tcaches,
                    crossattn_caches=tca, start_frame=blk * nf,
                    update_caches=commit)
            np.testing.assert_allclose(got.numpy(), _np(want), atol=ATOL,
                                       rtol=RTOL)
            if commit:
                jcaches = jnew
            else:
                for s, c_ in zip(snapshot, tnew, strict=True):
                    for key in ("k", "v", "sink_k", "sink_v"):
                        assert torch.equal(s[key], c_[key])
                    assert (s["valid"], s["global_end"]) == (
                        c_["valid"], c_["global_end"])
            for tc, jc in zip(tcaches, jcaches, strict=True):
                _assert_cache_equal(tc, jc, ATOL, RTOL)
    assert tcaches[0]["global_end"] == 3 * nf * frame_seqlen


def test_forward_block_without_text_caches_matches_jax(models):
    """No crossattn caches: each block projects the context itself."""
    jmodel, tmodel = models
    rng = np.random.default_rng(3)
    ctx = rng.standard_normal((1, 12, TINY_DIT["text_dim"]),
                              dtype=np.float32)
    x = rng.standard_normal((1, 4, 2, 8, 8), dtype=np.float32)
    t = np.array([500.0], np.float32)
    want, _ = jmodel.forward_block(jnp.asarray(x), jnp.asarray(ctx),
                                   jnp.asarray(t),
                                   jmodel.init_caches(1, 16, jnp.float32))
    with torch.no_grad():
        got, _ = tmodel.forward_block(
            torch.from_numpy(x), torch.from_numpy(ctx), torch.from_numpy(t),
            tmodel.init_caches(1, 16, torch.float32))
    np.testing.assert_allclose(got.numpy(), _np(want), atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("start_frame", [0, 3, 20])
def test_start_frame_rope_matches_jax(start_frame):
    want = jax_rope((3, 4, 5), 128, 10000.0, start_frame=start_frame)
    got = get_rotary_pos_embed_wan((3, 4, 5), 128, 10000.0,
                                   start_frame=start_frame)
    for g, w in zip(got, want, strict=True):
        np.testing.assert_array_equal(g.numpy(), _np(w))


def test_training_forward_raises(models):
    """The training forward is ported (tests/test_torch_causal_train_forward.py
    holds it against JAX); what it still refuses, as the JAX one does, is a
    timestep that is not one per latent frame."""
    _, tmodel = models
    x = torch.zeros(1, TINY_DIT["in_channels"], 2, 8, 8)
    ctx = torch.zeros(1, 5, TINY_DIT["text_dim"])
    with pytest.raises(ValueError, match="per latent frame"):
        tmodel.train_forward(x, ctx, torch.zeros(1))
