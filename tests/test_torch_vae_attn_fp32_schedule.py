"""The host side of K1's fp32 form at a head of 384 (the 3xTF32 wide
schedule: the VAE attention of an fp32 decode), on the CPU: its route, its
key splits at 64 query rows a block, the emulation of its arithmetic
against the JAX ``flash_attention`` in fp32 (its Pallas kernel in
interpret mode) within the card's gate, one TF32 pass missing that gate,
the pre-pass's layout (TF32 heads and tails of K and of V^T, whose keys
are stored in the order that makes P's accumulator fragment the A operand
of P V), the fp32 merge's plain version, the wrapper's launches on a
CUDA-typed tensor, and the Python rules and constants against the CUDA
sources."""

import importlib
import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastvideo_tpu_torch.ops import _build
from fastvideo_tpu_torch.ops import conv3d as tconv
from fastvideo_tpu_torch.ops import flash_attention as fa

# the JAX package's ops/__init__ re-exports functions under these names
jfa = importlib.import_module("fastvideo_tpu.ops.flash_attention")

torch.set_num_threads(2)

CSRC = os.path.join(os.path.dirname(os.path.dirname(__file__)),
                    "fastvideo_tpu_torch", "csrc")
# chip_smoke.py's gate for the 3xTF32 K1 against its plain fp32 version
GATE_ATOL, GATE_RTOL = 1e-5, 1e-4
D = 384


def _source(name: str) -> str:
    with open(os.path.join(CSRC, name)) as fh:
        return fh.read()


def _qkv(seed, b, sq, skv, h=1):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, sq, h, D), dtype=np.float32),
            rng.standard_normal((b, skv, h, D), dtype=np.float32),
            rng.standard_normal((b, skv, h, D), dtype=np.float32))


def _gate_x(got, want) -> float:
    """The largest error as a multiple of the gate."""
    err = (got.double() - want.double()).abs()
    return (err / (GATE_ATOL + GATE_RTOL * want.double().abs())).max().item()


@pytest.mark.parametrize("dtype,d,want", [
    (torch.float32, 384, "sm90_wide_tf32"),  # an fp32 decode's attention
    (torch.bfloat16, 384, "sm90_wide"),
    (torch.float32, 128, "tile"),  # fp32 at every other head
    (torch.float32, 256, "tile"),
])
def test_route_rule(dtype, d, want):
    assert fa.flash_schedule(dtype, d) == want


@pytest.mark.parametrize("b,sq,sms,want", [
    # the first decode chunk: 98 query tiles of 64 rows for 132 SMs ->
    # 4 splits, 392 blocks (0.99 of 3 waves)
    (1, 6240, 132, 4),
    # a 2-frame chunk: 196 tiles -> 2 splits, 392 blocks
    (2, 6240, 132, 2),
    # 480x848: 100 tiles a frame
    (1, 6360, 132, 5),
    (2, 6360, 132, 3),
    # 98 tiles on 114 SMs fill 0.86 until 8 splits (0.98)
    (1, 6240, 114, 8),
])
def test_tf32_splits_at_64_rows_a_block(b, sq, sms, want):
    assert fa.wide_splits(b, 1, sq, sq, sms, fa.TF32_BLOCK_ROWS) == want


@pytest.mark.parametrize("b,sq,skv,causal,kv_valid,splits", [
    (1, 160, 160, False, None, 1),   # the VAE's form: one frame, no mask
    (2, 96, 130, False, 100, 3),     # keys masked inside a chunk, 3 splits
    (1, 120, 120, True, None, 1),    # causal, a ragged last chunk
])
def test_emulation_matches_jax_within_the_gate(b, sq, skv, causal, kv_valid,
                                               splits):
    """Three TF32 products a pair (hi hi + hi lo + lo hi) for S and for P V,
    with the kernel's key splits merged in fp32, agree with the JAX flash
    attention in fp32 within 1e-5 + 1e-4 |out|; one TF32 pass (hi hi
    alone) does not."""
    q, k, v = _qkv(7, b, sq, skv)
    kw = dict(causal=causal, kv_valid=kv_valid)
    want = torch.from_numpy(np.array(jfa.flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), **kw)))
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    got, lse = fa.flash_attention_tf32x3_plain(tq, tk, tv, scale=D**-0.5,
                                               splits=splits, **kw)
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert _gate_x(got, want) <= 1.0
    _, ref_lse = fa.flash_attention_plain(
        tq, tk, tv, scale=D**-0.5, causal=causal,
        kv_valid=skv if kv_valid is None else kv_valid)
    torch.testing.assert_close(lse, ref_lse, atol=1e-5, rtol=0)
    one, _ = fa.flash_attention_tf32x3_plain(tq, tk, tv, scale=D**-0.5,
                                             splits=splits, products=1, **kw)
    assert _gate_x(one, want) > 1.0


def test_emulation_of_empty_rows():
    """kv_valid 0: every row outputs 0 with an LSE of -inf, split or not."""
    q, k, v = (torch.from_numpy(x) for x in _qkv(8, 1, 40, 70, 2))
    for splits in (1, 3):
        out, lse = fa.flash_attention_tf32x3_plain(q, k, v, scale=D**-0.5,
                                                   kv_valid=0,
                                                   splits=splits)
        assert torch.all(out == 0) and torch.all(lse == float("-inf"))


def test_key_order_makes_the_fragment_an_a_operand():
    """Thread t of a quad holds accumulator columns 2t and 2t + 1 of each
    group of 8 keys; the TF32 A fragment takes columns t and t + 4. V^T's
    position t must hold key 2t and position t + 4 key 2t + 1, in every
    group of 8."""
    order = fa.tf32_key_order(64)
    assert sorted(order.tolist()) == list(range(64))
    for grp in range(8):
        for t in range(4):
            assert order[8 * grp + t] == 8 * grp + 2 * t
            assert order[8 * grp + t + 4] == 8 * grp + 2 * t + 1


@pytest.mark.parametrize("b,skv,h", [(2, 77, 3), (1, 64, 1)])
def test_pre_pass_layout_gives_back_k_and_v(b, skv, h):
    """The pre-pass's plain version: K's and V^T's heads are TF32 (low 13
    bits zero), head + tail holds the value to 2^-21, V^T's keys read back
    in tf32_key_order give V, and every slot past Skv is zero."""
    rng = np.random.default_rng(9)
    k = torch.from_numpy(rng.standard_normal((b, skv, h, D),
                                             dtype=np.float32))
    v = torch.from_numpy(rng.standard_normal((b, skv, h, D),
                                             dtype=np.float32))
    before = _build.PLAIN_CALLS[fa.NAME_TF32_SPLIT]
    k_hi, k_lo, vt_hi, vt_lo = fa.tf32_split_kv(k, v)  # CPU: the plain one
    assert _build.PLAIN_CALLS[fa.NAME_TF32_SPLIT] == before + 1
    pad = fa.tf32_keys_padded(skv)
    assert pad % fa.TF32_CHUNK_KEYS == 0 and pad >= skv
    assert k_hi.shape == (b, h, pad, D) and vt_hi.shape == (b, h, D, pad)
    low = (1 << tconv.TF32_DROPPED_BITS) - 1
    for t in (k_hi, k_lo, vt_hi, vt_lo):
        assert t.dtype == torch.float32
        assert torch.all(t.view(torch.int32) & low == 0)
    kk = (k_hi.double() + k_lo.double())[:, :, :skv]
    want_k = k.double().transpose(1, 2)
    assert torch.all((kk - want_k).abs() <= 2.0**-21 * want_k.abs())
    inv = torch.argsort(fa.tf32_key_order(pad))
    vv = (vt_hi.double() + vt_lo.double())[..., inv].transpose(2, 3)
    want_v = v.double().transpose(1, 2)
    assert torch.all((vv[:, :, :skv] - want_v).abs() <=
                     2.0**-21 * want_v.abs())
    assert torch.all(k_hi[:, :, skv:] == 0) and torch.all(vv[:, :, skv:] == 0)


def test_fp32_merge_of_splits_equals_one_pass():
    """The fp32 merge's plain version: the emulation's key splits merged
    in fp32 equal the unsplit emulation to fp32 rounding, out and LSE."""
    q, k, v = (torch.from_numpy(x) for x in _qkv(10, 2, 50, 200))
    whole, whole_lse = fa.flash_attention_tf32x3_plain(q, k, v,
                                                       scale=D**-0.5)
    before = _build.PLAIN_CALLS[fa.NAME_COMBINE]
    split, split_lse = fa.flash_attention_tf32x3_plain(q, k, v,
                                                       scale=D**-0.5,
                                                       splits=4)
    assert _build.PLAIN_CALLS[fa.NAME_COMBINE] == before + 1
    assert split.dtype == torch.float32
    torch.testing.assert_close(split, whole, atol=1e-6, rtol=1e-5)
    torch.testing.assert_close(split_lse, whole_lse, atol=1e-6, rtol=0)


class _CudaTyped(torch.Tensor):
    """A CPU tensor that reports itself as a CUDA tensor, to drive the
    wrapper's CUDA dispatch without a card."""

    @property
    def is_cuda(self):
        return True


@pytest.mark.parametrize("b,sq,want_splits", [(1, 6240, 4), (2, 6240, 2),
                                              (1, 32000, 1)])
def test_cuda_call_launches_the_pre_pass_kernel_and_merge(b, sq,
                                                          want_splits,
                                                          monkeypatch):
    """On a CUDA tensor an fp32 head-of-384 call launches the pre-pass on
    the k/v column views, the 3xTF32 entry on the q view (no copy) with
    the host rule's splits at 64 rows a block and the padded key count,
    then the fp32 merge where it splits; each counted by its own name; the
    plain versions never run."""
    seen = []

    def fake_launch(name, fn, *args):
        seen.append((name, fn, args))
        _build.count_launch(name)

    monkeypatch.setattr(_build, "check_device", lambda t, name: None)
    monkeypatch.setattr(_build, "stream_ptr", lambda t: 0)
    monkeypatch.setattr(_build, "num_sms", lambda device: 132)
    monkeypatch.setattr(_build, "launch", fake_launch)
    qkv = torch.zeros(b, sq, 1, 3 * D)
    q, k, v = (qkv[..., i * D:(i + 1) * D].as_subclass(_CudaTyped)
               for i in range(3))
    before = dict(_build.PLAIN_CALLS)
    out = fa.flash_attention(q, k, v)
    assert _build.PLAIN_CALLS == before
    assert out.dtype == torch.float32 and out.shape == (b, sq, 1, D)
    (n0, f0, a0), (n1, f1, a1) = seen[:2]
    assert (n0, f0) == (fa.NAME_TF32_SPLIT, "fvt_flash_tf32_split")
    assert a0[:2] == (k.data_ptr(), v.data_ptr())
    pad = fa.tf32_keys_padded(sq)
    # k, v, k_hi, k_lo, vt_hi, vt_lo, B, H, Skv, Skv_pad, 6 strides
    assert a0[6:10] == (b, 1, sq, pad)
    assert a0[10:13] == (sq * 1152, 1152, 1152)  # k's view, uncopied
    assert (n1, f1) == (fa.NAME_TF32, "fvt_flash_fwd_wide_tf32")
    assert a1[0] == q.data_ptr() and a1[1:5] == a0[2:6]
    # q, 4 split operands, o, lse, part, lse_part, B, H, Sq, Skv, Skv_pad,
    # q strides, o strides, scale, causal, kv_valid, splits
    assert a1[9:14] == (b, 1, sq, sq, pad)
    assert a1[14:17] == (sq * 1152, 1152, 1152)
    assert a1[-4:-1] == (0, sq, want_splits)
    assert (a1[7] is None) == (want_splits == 1)
    if want_splits == 1:
        assert len(seen) == 2
    else:
        (n2, f2, a2), = seen[2:]
        assert (n2, f2) == (fa.NAME_COMBINE, "fvt_flash_fwd_combine_f32")
        assert a2[:2] == (a1[7], a1[8]) and a2[4:8] == (want_splits, b, 1,
                                                        sq)


def test_cuda_call_refuses_grad_before_any_launch(monkeypatch):
    """No backward runs at a head of 384: an fp32 call under grad raises
    before the pre-pass launches."""
    monkeypatch.setattr(_build, "check_device", lambda t, name: None)
    q = torch.zeros(1, 64, 1, D, requires_grad=True).as_subclass(_CudaTyped)
    before = dict(_build.LAUNCHES)
    with pytest.raises(_build.KernelError, match="backward"):
        fa.flash_attention(q, q, q)
    assert _build.LAUNCHES == before


def test_host_rules_match_the_sources():
    """The block rows, chunk keys and pre-pass tile are the CUDA sources'
    own, the route rule and the key order are the same on both sides, and
    the entries take the arguments the wrappers pass."""
    cuh, cu = _source("flash_fwd_wide_tf32_sm90.cuh"), _source("flash_fwd.cu")
    for name, want in (("kTf32BQ", fa.TF32_BLOCK_ROWS),
                       ("kTf32BK", fa.TF32_CHUNK_KEYS),
                       ("kSplitTile", fa.TF32_CHUNK_KEYS)):
        assert int(re.search(name + r" = (\d+);", cuh).group(1)) == want
    assert "kTf32Half = kWideD / 2;" in cuh
    # wide_splits counts the keys in chunks of WIDE_CHUNK_KEYS for both forms
    assert fa.TF32_CHUNK_KEYS == fa.WIDE_CHUNK_KEYS
    # the kernel reads the chunk at the same 8-key order the pre-pass writes
    assert ("(x & 7) < 4 ? 2 * (x & 7) : 2 * (x & 7) - 7" in cuh)
    assert re.search(r"bool use_wide_tf32\(int dtype, int D\) \{ return "
                     r"dtype == 0 && D == s9w::kWideD; \}", cu)
    assert "(use_wide_tf32(dtype, D) ? 3 : 0)" in cu
    for name in (fa.NAME_TF32, fa.NAME_TF32_SPLIT):
        assert name in _build.KERNELS
        assert _build.SOURCE_OF[name] == "flash_fwd"
    for entry in ("fvt_flash_fwd_wide_tf32", "fvt_flash_tf32_split",
                  "fvt_flash_fwd_combine_f32",
                  "fvt_flash_fwd_wide_tf32_splits"):
        n_args = len(_build._SIGNATURES[entry])
        decl = re.search(r'extern "C" int ' + entry + r"\((.*?)\)\s*\{", cu,
                         re.S).group(1)
        assert decl.count(",") + 1 == n_args, entry
