"""The host side of K1's column-sliced schedule (heads of 640 and 1024: the
Wan2.2 VAE's attention, bf16 and fp32), on the CPU: its sizes against the
CUDA source (cluster, head split, rows a tile, keys a chunk, shared
memory), the plain emulation of its decomposition (a partial score a
warpgroup over its slice of the head, the partials summed as the kernel's
balanced tree, the online softmax over its 32-key chunks, P rounded to
bf16 or split into TF32 heads and tails) against the plain attention and
against the JAX ``flash_attention`` (its Pallas kernel in interpret mode),
and the wrapper's launch on a CUDA-typed tensor.

Tolerances: the emulation against the plain version and JAX in fp32 within
chip_smoke's fp32 gate for this kernel, 1e-4 + 1e-4 |ref| (3xTF32 leaves
about 1e-6; the sums run in another order); in bf16 within chip_smoke's
bf16 gate, 2^-5 of the reference's std + 2^-6 |ref| (both sides round P
and the output to bf16, P against another running maximum)."""

import importlib
import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastvideo_tpu_torch.ops import _build
from fastvideo_tpu_torch.ops import flash_attention as fa

# the JAX package's ops/__init__ re-exports functions under these names
jfa = importlib.import_module("fastvideo_tpu.ops.flash_attention")

torch.set_num_threads(2)

CSRC = os.path.join(os.path.dirname(os.path.dirname(__file__)),
                    "fastvideo_tpu_torch", "csrc")
DTYPES = {"bf16": (torch.bfloat16, jnp.bfloat16),
          "fp32": (torch.float32, jnp.float32)}


def _source(name: str) -> str:
    with open(os.path.join(CSRC, name)) as fh:
        return fh.read()


def _gate(ref: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """chip_smoke.py's attention gate for this kernel, element by element."""
    ref = ref.double()
    if dtype == torch.float32:
        return 1e-4 + 1e-4 * ref.abs()
    return 2.0**-5 * ref.std() + 2.0**-6 * ref.abs()


def _qkv(seed, b, sq, skv, h, d):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, sq, h, d), dtype=np.float32),
            rng.standard_normal((b, skv, h, d), dtype=np.float32),
            rng.standard_normal((b, skv, h, d), dtype=np.float32))


@pytest.mark.parametrize("d", fa.COLS_HEADS)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_layout_partitions_the_head_once(d, dtype):
    """The cluster's CTAs and their two warpgroups cut the head into
    disjoint slices that cover it: S is built once per query tile and key
    chunk (the needed 4 B Sq Skv D products, not once per slice), each
    warpgroup's slice a whole number of k-steps (16 bf16 or 8 TF32
    columns), and the CTA's shared memory fits with at least two stages."""
    lay = fa.cols_layout(dtype, d)
    assert lay["cluster"] == fa.COLS_CLUSTER[dtype]
    assert lay["cluster"] * lay["cta_cols"] == d
    assert 2 * lay["wg_cols"] == lay["cta_cols"]
    assert lay["wg_cols"] % (16 if dtype == torch.bfloat16 else 8) == 0
    assert 2 <= lay["stages"] <= fa.COLS_MAX_STAGES
    assert lay["smem"] <= fa.COLS_SMEM_MAX
    # O's columns a warpgroup stay in registers: 128 fp32 a thread at most
    assert fa.COLS_BLOCK_ROWS * lay["wg_cols"] // 128 <= 128


@pytest.mark.parametrize("dtype,d,want", [
    (torch.bfloat16, 1024, dict(cluster=2, cta_cols=512, wg_cols=256,
                                stages=3, smem=216064)),
    (torch.bfloat16, 640, dict(cluster=2, cta_cols=320, wg_cols=160,
                               stages=4, smem=191488)),
    (torch.float32, 1024, dict(cluster=4, cta_cols=256, wg_cols=128,
                               stages=2, smem=216064)),
    (torch.float32, 640, dict(cluster=4, cta_cols=160, wg_cols=80,
                              stages=4, smem=207872)),
])
def test_layout_at_the_vae_heads(dtype, d, want):
    lay = fa.cols_layout(dtype, d)
    assert {k: lay[k] for k in want} == want


def test_host_rules_match_the_source():
    """The constants and the shared-memory count in Python are
    flash_fwd_cols_sm90.cuh's, and the entries take the arguments the
    wrapper passes."""
    cuh, cu = _source("flash_fwd_cols_sm90.cuh"), _source("flash_fwd_cols.cu")
    for name, want in (("kColsBQ", fa.COLS_BLOCK_ROWS),
                       ("kColsBK", fa.COLS_CHUNK_KEYS),
                       ("kColsMaxStages", fa.COLS_MAX_STAGES),
                       ("kColsSmemMax", fa.COLS_SMEM_MAX)):
        assert int(re.search(name + r" = (\d+);", cuh).group(1)) == want
    assert "int C = Bf16 ? {} : {};".format(
        fa.COLS_CLUSTER[torch.bfloat16], fa.COLS_CLUSTER[torch.float32]) in cuh
    assert "kColsSlotF4 = 4 * kWarpgroup;" in cuh and fa.COLS_SLOT_BYTES == \
        4 * 128 * 16
    # the shared memory ColsShape counts, term by term as cols_layout
    assert ("FIXED = 1024 + round_1k(Q_BYTES) + 4 * kColsSlot +\n"
            "                                  2 * (C - 1) * kColsSlot + 2048;"
            ) in cuh
    assert "NS = NS_FIT < kColsMaxStages ? NS_FIT : kColsMaxStages;" in cuh
    assert "(NQB > 2 * NVB ? NQB : 2 * NVB) * kColsBK * 128" in cuh
    assert "static_cast<size_t>(kColsBK) * DC * 4;" in cuh
    # the pre-pass pads the keys as the wrapper's scratch does
    assert "(chunks < 1 ? 1 : chunks) * s9::kColsBK" in cu
    for skv, want in ((1, 32), (32, 32), (33, 64), (3520, 3520), (0, 32)):
        assert fa.cols_keys_padded(skv) == want
    for entry in ("fvt_flash_fwd_cols", "fvt_flash_fwd_cols_smem",
                  "fvt_flash_fwd_cols_route"):
        n_args = len(_build._SIGNATURES[entry])
        decl = re.search(r'extern "C" int ' + entry + r"\((.*?)\)\s*\{", cu,
                         re.S).group(1)
        assert decl.count(",") + 1 == n_args, entry


@pytest.mark.parametrize("d", fa.COLS_HEADS)
@pytest.mark.parametrize("dt", ["bf16", "fp32"])
@pytest.mark.parametrize("b,sq,skv,h,causal,kv_valid", [
    (1, 40, 40, 1, False, None),   # the VAE's form: one head, no mask
    (2, 45, 70, 2, False, 50),     # kv_valid inside a chunk, two heads
    (1, 70, 70, 2, True, None),    # causal, a partial last chunk
])
def test_emulation_matches_plain_and_jax(d, dt, b, sq, skv, h, causal,
                                         kv_valid):
    """The decomposition the kernel runs (partial scores over the 2C head
    slices, summed as the kernel's tree, the online softmax over 32-key
    chunks) agrees with the plain attention and with JAX's flash attention
    within the card's gates, and its LSE with the plain one's."""
    tdt, jdt = DTYPES[dt]
    q, k, v = _qkv(d + sq, b, sq, skv, h, d)
    kw = dict(causal=causal, kv_valid=kv_valid)
    want = torch.from_numpy(np.asarray(jfa.flash_attention(
        *(jnp.asarray(t, jdt) for t in (q, k, v)), **kw)).astype(np.float32))
    tq, tk, tv = (torch.from_numpy(t).to(tdt) for t in (q, k, v))
    got, lse = fa.cols_partials_plain(tq, tk, tv, scale=d**-0.5, **kw)
    ref, ref_lse = fa.flash_attention_plain(
        tq, tk, tv, scale=d**-0.5, causal=causal,
        kv_valid=skv if kv_valid is None else kv_valid)
    assert got.dtype == tdt and got.shape == (b, sq, h, d)
    for other in (ref.float(), want):
        assert torch.all((got.double() - other.double()).abs() <=
                         _gate(other, tdt))
    torch.testing.assert_close(lse, ref_lse, atol=1e-5, rtol=0)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_emulation_of_empty_rows(dtype):
    """kv_valid 0: every row outputs 0 with an LSE of -inf."""
    q, k, v = (torch.from_numpy(x).to(dtype)
               for x in _qkv(3, 1, 20, 40, 2, 640))
    out, lse = fa.cols_partials_plain(q, k, v, scale=0.04, kv_valid=0)
    assert torch.all(out == 0) and torch.all(lse == float("-inf"))


def test_tree_sum_order_is_the_kernels():
    """The partials are added as a balanced tree in slice order, the
    kernel's order: with one key and partial scores (2^24, 1, 1, -2^24)
    over the four slices of a bf16 head, the tree gives (2^24 + 1) + (1 -
    2^24) = 2^24 - (2^24 - 1) = 1 in fp32 (2^24 + 1 rounds to 2^24), where
    a left-to-right sum would give 0; the one key's LSE is its score."""
    d = 640
    w = d // (2 * fa.COLS_CLUSTER[torch.bfloat16])
    q = torch.zeros(1, 1, 1, d, dtype=torch.bfloat16)
    k = torch.zeros(1, 1, 1, d, dtype=torch.bfloat16)
    for i, (qi, ki) in enumerate(((4096, 4096), (1, 1), (1, 1),
                                  (-4096, 4096))):
        q[..., i * w], k[..., i * w] = qi, ki
    v = torch.ones(1, 1, 1, d, dtype=torch.bfloat16)
    _, lse = fa.cols_partials_plain(q, k, v, scale=1.0)
    assert lse.item() == 1.0


class _CudaTyped(torch.Tensor):
    """A CPU tensor that reports itself as a CUDA tensor, to drive the
    wrapper's CUDA dispatch without a card."""

    @property
    def is_cuda(self):
        return True


@pytest.mark.parametrize("dtype,d", [(torch.bfloat16, 1024),
                                     (torch.float32, 640),
                                     (torch.float32, 1024)])
def test_cuda_call_launches_the_kernel_on_the_views(dtype, d, monkeypatch):
    """On a CUDA tensor a call at a head of 640 or 1024 launches
    fvt_flash_fwd_cols once on the q, k and v column views of one qkv
    tensor (no copy), with the fp32 pre-pass's scratch of 4 x B x H x
    Skv_pad x D values (none for bf16), counted as flash_fwd_cols; the
    plain version never runs."""
    seen = []

    def fake_launch(name, fn, *args):
        seen.append((name, fn, args))
        _build.count_launch(name)

    monkeypatch.setattr(_build, "check_device", lambda t, name: None)
    monkeypatch.setattr(_build, "stream_ptr", lambda t: 0)
    monkeypatch.setattr(_build, "launch", fake_launch)
    b, s = 2, 100
    qkv = torch.zeros(b, s, 1, 3 * d, dtype=dtype)
    q, k, v = (qkv[..., i * d:(i + 1) * d].as_subclass(_CudaTyped)
               for i in range(3))
    before = dict(_build.PLAIN_CALLS)
    launches = _build.LAUNCHES[fa.NAME_COLS]
    out = fa.flash_attention(q, k, v)
    assert _build.PLAIN_CALLS == before
    assert _build.LAUNCHES[fa.NAME_COLS] == launches + 1
    assert out.dtype == dtype and out.shape == (b, s, 1, d)
    (name, fn, args), = seen
    assert (name, fn) == (fa.NAME_COLS, "fvt_flash_fwd_cols")
    assert args[:3] == (q.data_ptr(), k.data_ptr(), v.data_ptr())
    # q, k, v, o, lse, split, dtype, B, H, Sq, Skv, D, 12 strides, scale,
    # causal, kv_valid, stream
    assert args[6:12] == (int(dtype == torch.bfloat16), b, 1, s, s, d)
    assert args[12:15] == (s * 3 * d, 3 * d, 3 * d)  # q's view, uncopied
    assert args[-4:-1] == (d**-0.5, 0, s)
    assert (args[5] is None) == (dtype == torch.bfloat16)
