"""The host side of the padded sparse forward's Hopper schedule (K8, and
K7 fwd, its LSE mode), on the CPU: the lists the wrapper builds from the
top-k indices (-1 slots dropped, one tile's walk, or a group's union for
tiles under 64 rows), walked as the kernel walks them (64-row units,
per-row bits, keys past a tile's valid count masked, LSE m + ln l), give
``block_sparse_attention_plain``'s out and LSE and the JAX package's
``block_sparse_attention`` / ``block_sparse_attention_trainable`` (Pallas
in interpret mode): sentinel rows, ragged tiles that are no multiple of
64 rows, the 64-row choice; rows with no key give exactly 0 and
MASK_VALUE. Also: the routes the CUDA source states and the entry a
CUDA-typed call takes."""

import importlib
import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastvideo_tpu_torch.ops import _build
from fastvideo_tpu_torch.ops import sparse_schedule as ss
from fastvideo_tpu_torch.ops import vsa as tvsa

jvsa = importlib.import_module("fastvideo_tpu.ops.vsa")

torch.set_num_threads(2)

ATOL, RTOL = 2e-5, 1e-4  # fp32 both sides: summation order only

CSRC = os.path.join(os.path.dirname(os.path.dirname(__file__)),
                    "fastvideo_tpu_torch", "csrc")


def _source(name: str) -> str:
    with open(os.path.join(CSRC, name)) as fh:
        return fh.read()


def _inputs(seed, h, nb, e, d, topk, sentinels):
    """fp32 q/k/v [1, h, nb*e, d] with garbage-free zero padded slots (as
    the tiling leaves them), ragged valid counts (tile 0 full), index rows
    of distinct tiles, with -1 sentinels that keep 1..topk of them."""
    rng = np.random.default_rng(seed)
    sizes = rng.integers(1, e + 1, nb).astype(np.int32)
    sizes[0] = e
    valid = (np.arange(nb * e) % e) < np.repeat(sizes, e)
    q, k, v = (rng.standard_normal((1, h, nb * e, d)).astype(np.float32)
               for _ in range(3))
    k[:, :, ~valid] = 0
    v[:, :, ~valid] = 0
    idx = np.stack([rng.permutation(nb)[:topk]
                    for _ in range(h * nb)]).reshape(1, h, nb, topk)
    if sentinels:
        keep = rng.integers(1, topk + 1, (1, h, nb, 1))
        idx = np.where(np.arange(topk) < keep, idx, -1)
    return q, k, v, idx.astype(np.int32), sizes


def _walk(q, k, v, idx, sizes, e, scale):
    """The Hopper schedule's walk in plain fp32: the wrapper's lists
    (padded_lists: a one-tile group's top-k row as it is, -1 slots
    skipped; smaller tiles' groups over their union with per-entry bits),
    each group's rows walking its list in 64-row units of each key tile, a
    row masking the entries its tile does not keep and the keys at or past
    the tile's valid count; online softmax over the units; O / l and LSE
    m + ln l, 0 and MASK_VALUE where l is 0."""
    b, h, s, d = q.shape
    nb = s // e
    _, group = ss.padded_walk(e)
    lists, counts, bits, _ = ss.padded_lists(idx, nb, e)
    if counts is None:  # every slot walked, each kept by the one tile
        counts = torch.full(lists.shape[:3], lists.shape[3])
        bits = torch.ones_like(lists)
    out = torch.zeros_like(q)
    lse = torch.full((b, h, s), tvsa.MASK_VALUE)
    unit = ss.UNIT_ROWS
    for bi in range(b):
        for hi in range(h):
            for g in range(lists.shape[2]):
                r0, r1 = g * group * e, min(s, (g + 1) * group * e)
                if r0 >= s:
                    continue
                rows = torch.arange(r0, r1)
                tile_bit = 1 << ((rows - r0) // e)
                m = torch.full((r1 - r0,), float("-inf"))
                l = torch.zeros(r1 - r0)
                o = torch.zeros(r1 - r0, d)
                for j in range(counts[bi, hi, g].item()):
                    kt = lists[bi, hi, g, j].item()
                    if kt < 0:
                        continue
                    keep = (bits[bi, hi, g, j].item() & tile_bit) != 0
                    for c0 in range(0, min(sizes[kt].item(), e), unit):
                        cols = kt * e + c0 + torch.arange(unit)
                        ok = (c0 + torch.arange(unit) <
                              min(sizes[kt].item(), e))
                        cols = cols.clamp_max(s - 1)
                        sc = q[bi, hi, r0:r1] @ k[bi, hi, cols].T * scale
                        sc = sc.masked_fill(~(keep[:, None] & ok[None]),
                                            float("-inf"))
                        m_new = torch.maximum(m, sc.amax(-1))
                        m_use = torch.where(torch.isinf(m_new), 0.0, m_new)
                        alpha = torch.exp(m - m_use)
                        p = torch.exp(sc - m_use[:, None])
                        vt = torch.where(ok[:, None], v[bi, hi, cols], 0.0)
                        l = l * alpha + p.sum(-1)
                        o = o * alpha[:, None] + p @ vt
                        m = m_new
                seen = l > 0
                out[bi, hi, r0:r1] = torch.where(
                    seen[:, None], o / torch.where(seen, l, 1.0)[:, None], 0)
                lse[bi, hi, r0:r1] = torch.where(
                    seen, m + torch.log(torch.where(seen, l, 1.0)),
                    tvsa.MASK_VALUE)
    return out, lse


@pytest.mark.parametrize("e,nb,topk,sentinels", [
    (64, 7, 3, True),    # SLA's tile (one warpgroup a block) with STA's -1s
    (72, 5, 3, True),    # an E 280-like tile: a ragged unit of 8 rows
    (32, 9, 4, False),   # tiles under 64 rows: two walk one block's union
], ids=["e64_sentinels", "e72_ragged", "e32_union"])
def test_walk_gives_plain_and_jax_out_and_lse(e, nb, topk, sentinels):
    h, d = 2, 32
    scale = d**-0.5
    q, k, v, idx, sizes = _inputs(10 + e, h, nb, e, d, topk, sentinels)
    idx[0, 1, 2] = -1  # a query tile with no key
    tq, tk, tv, tidx, tsizes = (torch.from_numpy(a) for a in
                                (q, k, v, idx, sizes))
    got, got_lse = _walk(tq, tk, tv, tidx, tsizes, e, scale)
    want, want_lse = tvsa.block_sparse_attention_plain(
        tq, tk, tv, tidx, tsizes, scale=scale, tile_elems=e, return_lse=True)
    torch.testing.assert_close(got, want, atol=ATOL, rtol=RTOL)
    torch.testing.assert_close(got_lse, want_lse, atol=ATOL, rtol=RTOL)
    assert (got[0, 1, 2 * e:3 * e] == 0).all()
    assert (got_lse[0, 1, 2 * e:3 * e] == tvsa.MASK_VALUE).all()
    # the JAX package on the rows that see a key (its finite mask gives a
    # keyless row an average of tile 0: no caller has one)
    j = [jnp.asarray(a) for a in (q, k, v, idx, sizes)]
    live = np.ones(nb * e, bool)
    live[2 * e:3 * e] = False
    for fn in (jvsa.block_sparse_attention,
               jvsa.block_sparse_attention_trainable):
        jout = np.asarray(fn(*j, tile_elems=e))
        np.testing.assert_allclose(got[0, 0].numpy(), jout[0, 0], atol=ATOL,
                                   rtol=RTOL)
        np.testing.assert_allclose(got[0, 1, live].numpy(), jout[0, 1, live],
                                   atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("e,want", [(256, (2, 1)), (280, (2, 1)),
                                    (100, (2, 1)), (64, (1, 1)),
                                    (32, (1, 2)), (16, (1, 4)), (40, (1, 1))])
def test_padded_walk(e, want):
    """Tiles over 64 rows: two warpgroups a block, one tile; 64 rows or
    fewer: one warpgroup a 64-row block holding as many whole tiles as
    fit."""
    wgs, group = ss.padded_walk(e)
    assert (wgs, group) == want
    assert group == 1 or group * e <= 64 * wgs


def test_padded_lists():
    """A one-tile group's list is its top-k row as it is (duplicates and
    -1 slots kept; the kernel skips the -1s), its length the real slots;
    tiles under 64 rows group into unions with bits."""
    idx = torch.tensor([[3, -1, 1], [-1, -1, -1], [2, 0, 2]],
                       dtype=torch.int32).reshape(1, 1, 3, 3)
    lists, counts, bits, lens = ss.padded_lists(idx, 4, 64)
    assert lists is idx and counts is None and bits is None
    assert lens.tolist() == [[[2, 0, 3]]]
    lists, counts, bits, lens = ss.padded_lists(idx, 4, 32)
    # groups of two tiles: {1, 3} (tile 0; tile 1 keeps nothing), {0, 2}
    # (tile 2, the duplicate once; the padding tile keeps nothing)
    assert lists.tolist() == [[[[1, 3, -1, -1], [0, 2, -1, -1]]]]
    assert bits.tolist() == [[[[1, 1, 0, 0], [1, 1, 0, 0]]]]
    assert counts.tolist() == [[[2, 2]]] and torch.equal(lens, counts)


def test_sla_union_would_double_the_walk():
    """Why SLA's 64-row tiles walk one tile a block: two random 10 % lists
    (SLA's top 10 % of 390 blocks on random maps) share few tiles, so a
    block of two would walk close to twice the kept pairs."""
    rng = np.random.default_rng(3)
    nb, topk = 390, 39
    idx = torch.from_numpy(np.stack([rng.permutation(nb)[:topk]
                                     for _ in range(nb)]).reshape(
                                         1, 1, nb, topk).astype(np.int32))
    slots = torch.full((1, 1, nb), topk, dtype=torch.int32)
    own = ss.grouped_lists(idx, slots, nb, 64, group=ss.padded_walk(64)[1])
    pair = ss.grouped_lists(idx, slots, nb, 64, group=2)
    assert own[1].sum().item() == nb * topk
    assert pair[1].sum().item() * 2 > 1.8 * nb * topk


def test_host_rules_match_the_sources():
    """The padded route and walk are the CUDA sources' own."""
    src = _source("vsa_sparse_padded_fwd.cu")
    rule = re.search(r"bool use_sm90\(int D\) \{[^}]*\}", src).group(0)
    heads = tuple(sorted(int(x) for x in re.findall(r"D == (\d+)", rule)))
    assert tuple(d for d in (16, 32, 48, 64, 96, 128) if
                 ss.sparse_schedule(torch.bfloat16, d) == "sm90") == heads
    # the first schedule refuses the Hopper heads, the Hopper entry the rest
    assert "D > 128 || use_sm90(D)" in src
    assert "if (!use_sm90(D)" in src
    # wgs warpgroups of 64 rows: the entry's check of padded_walk's groups
    assert "(wgs == 1 && group * E > 64)" in src
    assert "(wgs == 2 && group != 1)" in src
    assert "(group > 1 && (counts == nullptr || bits == nullptr))" in src
    fwd = _source("dyn_sparse_fwd_sm90.cuh")
    assert "return kWGs == 2 ? kDynBK : kUnit;" in fwd
    assert re.search(r"kEmptyLse = -0\.7f \* 3\.40282346\d*e38f", fwd)
    assert np.float32(-0.7 * np.finfo(np.float32).max) == np.float32(
        tvsa.MASK_VALUE)
    assert "vsa_sparse_padded_fwd" in _build.PTXAS_VERBOSE
    for entry in ("fvt_vsa_sparse_padded_fwd_sm90",
                  "fvt_vsa_sparse_padded_fwd"):
        n_args = len(_build._SIGNATURES[entry])
        decl = re.search(r'extern "C" int ' + entry + r"\((.*?)\)\s*\{", src,
                         re.S).group(1)
        assert decl.count(",") + 1 == n_args, entry


class _CudaTyped(torch.Tensor):
    """A CPU tensor that reports itself as a CUDA tensor, to drive the
    wrappers' CUDA dispatch without a card."""

    @property
    def is_cuda(self):
        return True


@pytest.mark.parametrize("d,e,lse", [(64, 64, True), (128, 256, False),
                                     (48, 64, True)])
def test_cuda_call_takes_its_schedules_entry(d, e, lse, monkeypatch):
    """On a CUDA tensor the padded wrapper builds its lists and calls the
    Hopper entry for a head of 64 or 128 (with padded_walk's group and
    warpgroups), the first entry for other heads, counted under the
    kernel's name; the plain version never runs."""
    seen = []

    def fake_launch(name, fn, *args):
        seen.append((name, fn, args))
        _build.count_launch(name)

    monkeypatch.setattr(_build, "check_device", lambda t, name: None)
    monkeypatch.setattr(_build, "stream_ptr", lambda t: 0)
    monkeypatch.setattr(_build, "launch", fake_launch)
    nb = 4
    qt = torch.zeros(1, 2, nb * e, d, dtype=torch.bfloat16).as_subclass(
        _CudaTyped)
    idx = torch.tensor([0, -1, 3, 2], dtype=torch.int32).reshape(
        1, 1, 4, 1).expand(1, 2, 4, 1)
    sizes = torch.full((nb,), e, dtype=torch.int32)
    before = dict(_build.PLAIN_CALLS)
    tvsa.block_sparse_attention(qt, qt, qt, idx, sizes, tile_elems=e,
                                return_lse=lse)
    assert _build.PLAIN_CALLS == before
    assert len(seen) == 1
    name, fn, args = seen[0]
    assert name == "vsa_sparse_padded_fwd"
    if d in (64, 128):
        assert fn == "fvt_vsa_sparse_padded_fwd_sm90"
        # ... B, H, S, D, E, group, wgs, list stride after the 10 pointers:
        # a one-tile group walks the top-k row as it is, no counts or bits
        assert args[10:18] == (1, 2, nb * e, d, e, 1, ss.padded_walk(e)[0],
                               1)
        assert args[6] is None and args[7] is None
        assert (args[4] is not None) == lse
    else:
        assert fn == "fvt_vsa_sparse_padded_fwd"
