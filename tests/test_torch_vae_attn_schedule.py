"""The host side of K1's wide schedule (bf16, a head of 384: the VAE's
mid-block attention), on the CPU: which flash route a head of 384 takes
(forward, fp32, backward), how many key splits a launch gets, the plain
emulation of the split partials and of their merge against the plain
attention and against the JAX ``flash_attention`` (its Pallas kernel in
interpret mode), the wrapper's launches on a CUDA-typed tensor, and that
the Python rules and constants are the CUDA sources'."""

import importlib
import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastvideo_tpu_torch.ops import _build
from fastvideo_tpu_torch.ops import flash_attention as fa
from fastvideo_tpu_torch.ops import sparse_schedule as ss

# the JAX package's ops/__init__ re-exports functions under these names
jfa = importlib.import_module("fastvideo_tpu.ops.flash_attention")

torch.set_num_threads(2)

CSRC = os.path.join(os.path.dirname(os.path.dirname(__file__)),
                    "fastvideo_tpu_torch", "csrc")
# fp32 on both sides: the split and merge change only the summation order
ATOL, RTOL = 2e-5, 1e-4


def _source(name: str) -> str:
    with open(os.path.join(CSRC, name)) as fh:
        return fh.read()


def _qkv(seed, b, sq, skv, h, d=384):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, sq, h, d), dtype=np.float32),
            rng.standard_normal((b, skv, h, d), dtype=np.float32),
            rng.standard_normal((b, skv, h, d), dtype=np.float32))


def test_route_rule_at_a_head_of_384(monkeypatch):
    """bf16 K1 takes the wide schedule; fp32 takes its 3xTF32 form; the
    backward and the sparse kernels keep their own rule, which has no
    wide schedule, and the backward is refused at a head above 128."""
    assert fa.flash_schedule(torch.bfloat16, 384) == "sm90_wide"
    assert fa.flash_schedule(torch.float32, 384) == "sm90_wide_tf32"
    assert fa.flash_schedule(torch.bfloat16, 128) == "sm90"
    assert fa.flash_bwd_schedule(384) == "tile"
    assert fa.flash_bwd_schedule(128) == "sm90"
    assert ss.sparse_schedule(torch.bfloat16, 384) == "tile"
    monkeypatch.setattr(_build, "check_device", lambda t, name: None)
    q = torch.zeros(1, 8, 1, 384, dtype=torch.bfloat16)
    with pytest.raises(_build.KernelError, match="up to 128"):
        fa.check_bwd_operands(fa.NAME_BWD_DQ, q, q, q)


@pytest.mark.parametrize("b,sq,sms,want", [
    # the first decode chunk: 49 query tiles of 128 rows for 132 SMs
    (1, 6240, 132, 5),
    # a 2-frame chunk: 98 tiles -> 4 splits, 392 blocks (0.99 of 3 waves)
    (2, 6240, 132, 4),
    # 480x848: 50 tiles a frame
    (1, 6360, 132, 5),
    (2, 6360, 132, 5),
    # another card's SM count
    (1, 6240, 114, 2),
    (2, 6240, 114, 8),
    (1, 6360, 114, 2),
    # 100 tiles on 114 SMs fill 0.877 at every split count: the fewest
    (2, 6360, 114, 1),
])
def test_wide_splits(b, sq, sms, want):
    assert fa.wide_splits(b, 1, sq, sq, sms) == want


def test_wide_splits_fill_the_card_or_take_the_fullest():
    """The rule's split count fills the card's waves to 90 % where any
    count up to the cap does, else fills them most; it never exceeds the
    cap or the tile's key chunks."""
    bq, bk = fa.WIDE_BLOCK_ROWS, fa.WIDE_CHUNK_KEYS
    for b in (1, 2, 3):
        for sq in (64, 1000, 6240, 6360):
            for sms in (114, 132):
                for keys in (30, 500, sq):
                    s = fa.wide_splits(b, 1, sq, keys, sms)
                    blocks = b * -(-sq // bq)
                    top = max(1, min(fa.WIDE_MAX_SPLITS, -(-keys // bk)))
                    assert 1 <= s <= top

                    def fill(n):
                        return n * blocks / (-(-n * blocks // sms) * sms)
                    ok = [n for n in range(1, top + 1) if fill(n) >= 0.9]
                    if ok:
                        assert s == ok[0]
                    else:
                        assert fill(s) == max(fill(n)
                                              for n in range(1, top + 1))


@pytest.mark.parametrize("b,sq,skv,h,splits,kv_valid", [
    (2, 300, 300, 1, 4, None),   # the VAE's form: a frame a batch row
    (1, 260, 333, 2, 5, 250),    # ragged chunks, keys masked past 250
    (1, 140, 60, 1, 3, None),    # fewer chunks than splits: empty splits
])
def test_split_partials_and_merge_match_plain_and_jax(b, sq, skv, h, splits,
                                                      kv_valid):
    """The plain emulation of a split launch (each split's softmax over its
    own keys, O / l and the LSE in fp32) merged by the plain combine equals
    the plain attention and the JAX flash attention, out and LSE, at a head
    of 384 in fp32."""
    q, k, v = _qkv(3, b, sq, skv, h)
    kw = {} if kv_valid is None else dict(kv_valid=kv_valid)
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    scale = 384**-0.5
    part, lse_part = fa.wide_partials_plain(tq, tk, tv, scale=scale,
                                            splits=splits, **kw)
    assert part.shape == (splits, b, h, sq, 384)
    assert lse_part.shape == (splits, b, h, sq)
    before = _build.PLAIN_CALLS[fa.NAME_COMBINE]
    out, lse = fa.wide_combine_plain(part, lse_part, torch.float32)
    assert _build.PLAIN_CALLS[fa.NAME_COMBINE] == before + 1
    ref, ref_lse = fa.flash_attention_plain(
        tq, tk, tv, scale=scale, kv_valid=skv if kv_valid is None else
        kv_valid)
    np.testing.assert_allclose(out.numpy(), ref.numpy(), atol=ATOL,
                               rtol=RTOL)
    np.testing.assert_allclose(lse.numpy(), ref_lse.numpy(), atol=1e-5,
                               rtol=1e-6)
    want = jfa.flash_attention(jnp.asarray(q), jnp.asarray(k),
                               jnp.asarray(v), **kw)
    np.testing.assert_allclose(out.numpy(), np.asarray(want), atol=ATOL,
                               rtol=RTOL)


def test_chunk_ranges_cover_the_keys_once():
    for keys in (1, 31, 32, 333, 6240, 6360):
        for splits in range(1, fa.WIDE_MAX_SPLITS + 1):
            ranges = fa.wide_chunk_ranges(keys, splits)
            assert len(ranges) == splits
            assert [j for r in ranges for j in r] == list(range(keys))
            assert all(r.start % fa.WIDE_CHUNK_KEYS == 0
                       for r in ranges if len(r))


def test_merge_of_empty_rows_is_zero():
    """A row with no key in any split gives 0 and an LSE of -inf; a row
    empty in some splits takes the others alone."""
    rng = np.random.default_rng(5)
    part = torch.from_numpy(rng.standard_normal((3, 1, 1, 4, 384),
                                                dtype=np.float32))
    lse_part = torch.from_numpy(rng.standard_normal((3, 1, 1, 4),
                                                    dtype=np.float32))
    lse_part[:, 0, 0, 1] = float("-inf")
    part[:, 0, 0, 1] = 0
    lse_part[0, 0, 0, 2] = float("-inf")
    part[0, 0, 0, 2] = 0
    out, lse = fa.wide_combine_plain(part, lse_part, torch.float32)
    assert torch.all(out[0, 1, 0] == 0) and lse[0, 0, 1] == float("-inf")
    w = torch.softmax(lse_part[1:, 0, 0, 2], dim=0)
    torch.testing.assert_close(out[0, 2, 0], (w[:, None] *
                                              part[1:, 0, 0, 2]).sum(0))


class _CudaTyped(torch.Tensor):
    """A CPU tensor that reports itself as a CUDA tensor, to drive the
    wrapper's CUDA dispatch without a card."""

    @property
    def is_cuda(self):
        return True


@pytest.mark.parametrize("b,sq,want_splits", [(1, 6240, 5), (2, 6240, 4),
                                              (1, 32000, 1)])
def test_cuda_call_launches_the_wide_entry_and_its_combine(b, sq,
                                                           want_splits,
                                                           monkeypatch):
    """On a CUDA tensor a bf16 head-of-384 call launches the wide entry
    with the host rule's splits and layout, straight from the qkv column
    views (no copy), then the combine where it splits; counted as K1 and
    flash_fwd_combine; the plain version never runs."""
    seen = []

    def fake_launch(name, fn, *args):
        seen.append((name, fn, args))
        _build.count_launch(name)

    monkeypatch.setattr(_build, "check_device", lambda t, name: None)
    monkeypatch.setattr(_build, "stream_ptr", lambda t: 0)
    monkeypatch.setattr(_build, "num_sms", lambda device: 132)
    monkeypatch.setattr(_build, "launch", fake_launch)
    qkv = torch.zeros(b, sq, 1, 3 * 384, dtype=torch.bfloat16)
    q, k, v = (qkv[..., i * 384:(i + 1) * 384].as_subclass(_CudaTyped)
               for i in range(3))
    before = dict(_build.PLAIN_CALLS)
    fa.flash_attention(q, k, v)
    assert _build.PLAIN_CALLS == before
    name, fn, args = seen[0]
    assert (name, fn) == (fa.NAME, "fvt_flash_fwd_wide")
    assert args[0] == q.data_ptr() and args[1] == k.data_ptr()
    # q, k, v, o, lse, part, lse_part, B, H, Sq, Skv, 12 strides, scale,
    # causal, kv_valid, splits
    assert args[7:11] == (b, 1, sq, sq)
    assert args[11:14] == (sq * 1152, 1152, 1152)  # q's view, uncopied
    assert args[-4:-1] == (0, sq, want_splits)
    assert (args[5] is None) == (want_splits == 1)
    if want_splits == 1:
        assert len(seen) == 1
    else:
        (name, fn, cargs), = seen[1:]
        assert (name, fn) == (fa.NAME_COMBINE, "fvt_flash_fwd_combine")
        assert cargs[:2] == (args[5], args[6])
        assert cargs[4:8] == (want_splits, b, 1, sq)


def test_host_rules_match_the_sources():
    """The head, block rows, chunk keys, split cap and split rule are the
    CUDA sources' own, and the entries take the arguments the wrapper
    passes."""
    cuh, cu = _source("flash_fwd_wide_sm90.cuh"), _source("flash_fwd.cu")
    for name, want in (("kWideD", fa.WIDE_HEAD),
                       ("kWideBQ", fa.WIDE_BLOCK_ROWS),
                       ("kWideBK", fa.WIDE_CHUNK_KEYS),
                       ("kWideMaxSplits", fa.WIDE_MAX_SPLITS)):
        assert int(re.search(name + r" = (\d+);", cuh).group(1)) == want
    assert "if (10 * n >= 9 * cap) return s;" in cuh
    assert re.search(r"bool use_wide\(int dtype, int D\) \{ return dtype == 1 "
                     r"&& D == s9w::kWideD; \}", cu)
    assert "flash_fwd_combine" in _build.KERNELS
    assert _build.SOURCE_OF["flash_fwd_combine"] == "flash_fwd"
    for entry in ("fvt_flash_fwd_wide", "fvt_flash_fwd_combine",
                  "fvt_flash_fwd_wide_splits"):
        n_args = len(_build._SIGNATURES[entry])
        decl = re.search(r'extern "C" int ' + entry + r"\((.*?)\)\s*\{", cu,
                         re.S).group(1)
        assert decl.count(",") + 1 == n_args, entry
