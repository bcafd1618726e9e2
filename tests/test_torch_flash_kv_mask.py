"""Port kv-mask flash attention (K5; its plain version on the CPU) against
the JAX ``flash_attention_kv_mask`` (its Pallas kernel in interpret mode),
in fp32, at the causal Wan's head dim and the smallest key count that
takes the kernel."""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastvideo_tpu_torch.ops import _build
from fastvideo_tpu_torch.ops import flash_attention as tfa

jfa = importlib.import_module("fastvideo_tpu.ops.flash_attention")

torch.set_num_threads(2)

# fp32 on both sides: only the summation order differs (the JAX package's
# own kv-mask test holds its kernel to the dense formula at 2e-5)
ATOL, RTOL = 2e-5, 2e-5
B, SQ, SKV, H, D = 1, 128, 1152, 2, 128


def _mask(kind: str) -> np.ndarray:
    pos = np.arange(SKV)
    if kind == "empty_front":  # a young stream: only the window's tail
        return pos >= SKV - 200
    if kind == "sink_window":  # a frozen sink, then the filled window
        return (pos < 128) | (pos >= 700)
    return np.random.default_rng(4).random(SKV) < 0.3


@pytest.mark.parametrize("kind", ["empty_front", "sink_window", "random"])
def test_kv_mask_matches_jax(kind):
    rng = np.random.default_rng(3)
    q, k, v = (rng.standard_normal((B, s, H, D), dtype=np.float32)
               for s in (SQ, SKV, SKV))
    ok = _mask(kind)
    want = jfa.flash_attention_kv_mask(jnp.asarray(q), jnp.asarray(k),
                                       jnp.asarray(v), jnp.asarray(ok),
                                       scale=D**-0.5)
    before = dict(_build.PLAIN_CALLS)
    got = tfa.flash_attention_kv_mask(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        torch.from_numpy(ok), scale=D**-0.5)
    assert _build.PLAIN_CALLS["flash_fwd_kv_mask"] == \
        before["flash_fwd_kv_mask"] + 1
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=RTOL)


def test_kv_mask_plain_equals_flash_plain_on_a_suffix():
    """A mask that keeps keys [0, n) is K1's kv_valid = n."""
    rng = np.random.default_rng(5)
    q, k, v = (torch.from_numpy(rng.standard_normal((1, s, 2, 64),
                                                    dtype=np.float32))
               for s in (40, 300, 300))
    mask = torch.arange(300) < 123
    out = tfa.flash_attention_kv_mask_plain(q, k, v, mask, scale=0.125)
    ref, _ = tfa.flash_attention_plain(q, k, v, scale=0.125, kv_valid=123)
    assert torch.equal(out, ref)
