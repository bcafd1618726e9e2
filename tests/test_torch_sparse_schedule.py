"""The host side of the sparse kernels' Hopper schedule (K7 bwd, K9a, K9b),
on the CPU: which schedule a (dtype, head) takes, K7 bwd's compacted
transposed sparsity against the membership the JAX package builds from the
same indices (``fastvideo_tpu/ops/vsa.py:933-942``), the heaviest-first
launch order, K9's grouped union lists and per-tile bits (the grouped walk
gives each tile's own result), that the Python constants and rules agree
with the CUDA sources, and that a CUDA-typed call on either schedule goes
to its kernel entry and never to the plain version."""

import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastvideo_tpu_torch.ops import _build, bsa, nabla, vsa
from fastvideo_tpu_torch.ops import sparse_schedule as ss

torch.set_num_threads(2)

CSRC = os.path.join(os.path.dirname(os.path.dirname(__file__)),
                    "fastvideo_tpu_torch", "csrc")


def _source(name: str) -> str:
    with open(os.path.join(CSRC, name)) as fh:
        return fh.read()


@pytest.mark.parametrize("dtype,d,want", [
    (torch.bfloat16, 128, "sm90"),   # every full-width DiT attention
    (torch.bfloat16, 64, "sm90"),    # the tiny dfsft student
    (torch.bfloat16, 16, "tile"),    # the tiny models
    (torch.bfloat16, 32, "tile"),
    (torch.bfloat16, 48, "tile"),
    (torch.float32, 64, "tile"),     # the kernels refuse fp32
    (torch.float32, 128, "tile"),
])
def test_sparse_schedule(dtype, d, want):
    assert ss.sparse_schedule(dtype, d) == want


def _jax_membership(idx: np.ndarray, nb: int) -> np.ndarray:
    """member[b, h, kv_tile, q_tile] as fastvideo_tpu/ops/vsa.py:933-942
    builds it inside _block_sparse_bwd."""
    b, h, nq, topk = idx.shape
    nb_idx = jnp.where(idx[:, :, :nq, :topk] >= 0, idx[:, :, :nq, :topk], nb)
    member = jnp.zeros((b, h, nb + 1, nq), jnp.int32)
    member = member.at[
        jnp.arange(b)[:, None, None, None],
        jnp.arange(h)[None, :, None, None],
        nb_idx,
        jnp.arange(nq)[None, None, :, None]].set(1)
    return np.asarray(member[:, :, :nb])


@pytest.mark.parametrize("q_group", [1, 3])
def test_transposed_lists_are_the_jax_membership(q_group):
    """Per key tile, the ascending query tiles whose top-k holds it (-1
    slots select nothing; a grouped selection expanded per tile, as the
    trainable op does), then -1; the count is the membership row's sum."""
    rng = np.random.default_rng(40 + q_group)
    b, h, nb, topk = 2, 3, 12, 4
    ng = nb // q_group
    idx = np.stack([rng.choice(nb, topk, replace=False)
                    for _ in range(b * h * ng)]).reshape(b, h, ng, topk)
    idx = idx.astype(np.int32)
    idx[0, 1, 2, 1] = -1
    idx[1, 0, 0, :] = -1  # a group that selected nothing
    idx = np.repeat(idx, q_group, axis=2)
    member = _jax_membership(idx, nb)
    t_idx, t_counts = ss.transposed_lists(torch.from_numpy(idx), nb)
    assert t_idx.shape == (b, h, nb, nb) and t_idx.dtype == torch.int32
    assert t_counts.dtype == torch.int32
    np.testing.assert_array_equal(t_counts.numpy(), member.sum(-1))
    for bi in range(b):
        for hi in range(h):
            for kt in range(nb):
                n = t_counts[bi, hi, kt].item()
                got = t_idx[bi, hi, kt].numpy()
                np.testing.assert_array_equal(
                    got[:n], np.flatnonzero(member[bi, hi, kt]))
                assert (got[n:] == -1).all()
    assert (t_idx >= -1).all() and t_counts.sum() == (idx >= 0).sum()


def test_heaviest_first_is_a_permutation_longest_first():
    rng = np.random.default_rng(5)
    counts = torch.from_numpy(rng.integers(0, 9, (2, 3, 17)).astype(
        np.int32))
    order = ss.heaviest_first(counts)
    assert order.dtype == torch.int32 and order.shape == (2 * 3 * 17,)
    assert torch.equal(order.sort().values,
                       torch.arange(order.numel(), dtype=torch.int32))
    walked = counts.reshape(-1)[order.long()]
    assert (walked[:-1] >= walked[1:]).all()
    # among equal lengths the lower flat index first
    for n in walked.unique():
        at = order[walked == n]
        assert (at[:-1] < at[1:]).all()


@pytest.mark.parametrize("rows,nq", [(64, 7), (32, 9), (8, 21), (48, 5),
                                     (24, 6), (256, 3)],
                         ids=["k9a", "k9b_32", "k9b_8", "48", "24", "e256"])
def test_query_group_fills_a_block(rows, nq):
    group = ss.query_group(rows)
    assert 1 <= group <= ss.MAX_GROUP
    if rows <= ss.BLOCK_ROWS:
        assert group * rows <= ss.BLOCK_ROWS < (group + 1) * rows or \
            group == ss.MAX_GROUP
    else:
        assert group == 1


def _mask(rng, b, h, nq, nk):
    """A mask with a row of count 0, a row of every tile and random rows."""
    m = rng.random((b, h, nq, nk)) < 0.6
    m[0, 0, 0] = False
    m[0, -1, -1] = True
    m[-1, 0, 1, 0] = True
    return torch.from_numpy(m)


@pytest.mark.parametrize("rows,nq", [(64, 7), (32, 9), (8, 21), (48, 5)],
                         ids=["k9a", "k9b_32", "k9b_8", "48"])
def test_grouped_lists_keep_each_tiles_own_list(rows, nq):
    """The union lists and bits hold every tile's list exactly: the tiles
    that keep an entry are its bits, the union is ascending with -1 past
    its count, and a group's padding tiles (an odd number of tiles) keep
    nothing. -1 slots inside a count and slots past it select nothing."""
    rng = np.random.default_rng(rows)
    b, h, nk = 2, 2, 11
    mask = _mask(rng, b, h, nq, nk)
    idx, counts = nabla.mask_indices(mask)
    # a -1 inside a count, and a stale id past one, select nothing
    idx[1, 0, 1, 0] = -1
    idx[1, 1, 2, counts[1, 1, 2]:] = 3
    want = ss.kept_mask(idx, counts, nk)
    assert mask[1, 0, 1, 0] and not want[1, 0, 1, 0]
    u_idx, u_counts, bits, group = ss.grouped_lists(idx, counts, nk, rows)
    ng = -(-nq // group)
    assert group == ss.query_group(rows)
    assert u_idx.shape == bits.shape == (b, h, ng, nk)
    assert u_counts.shape == (b, h, ng)
    assert u_idx.dtype == u_counts.dtype == bits.dtype == torch.int32
    for bi in range(b):
        for hi in range(h):
            for g in range(ng):
                n = u_counts[bi, hi, g].item()
                ids = u_idx[bi, hi, g, :n]
                assert (ids[1:] > ids[:-1]).all()
                assert (u_idx[bi, hi, g, n:] == -1).all()
                assert (bits[bi, hi, g, n:] == 0).all()
                for t in range(group):
                    qi = g * group + t
                    kept = ids[(bits[bi, hi, g, :n] >> t) & 1 == 1]
                    if qi >= nq:
                        assert kept.numel() == 0
                    else:
                        assert torch.equal(
                            kept, torch.nonzero(want[bi, hi, qi]).flatten())


def _grouped_attention(q, k, v, u_idx, u_counts, bits, group, rows, sizes,
                       e, scale):
    """The Hopper schedule's walk in plain fp32: each group's rows attend
    the union of its tiles' lists, every row masking the entries its own
    tile does not keep (bits) and the keys past a tile's valid count."""
    b, h, sq, d = q.shape
    out = torch.zeros_like(q)
    offs = torch.arange(e)
    for bi in range(b):
        for hi in range(h):
            for g in range(u_idx.shape[2]):
                n = u_counts[bi, hi, g].item()
                ids = u_idx[bi, hi, g, :n].long()
                r0, r1 = g * group * rows, min(sq, (g + 1) * group * rows)
                if n == 0 or r0 >= sq:
                    continue
                cols = (ids[:, None] * e + offs).reshape(-1)
                sc = q[bi, hi, r0:r1] @ k[bi, hi, cols].T * scale
                tile = (torch.arange(r0, r1) - r0) // rows
                keep = (bits[bi, hi, g, :n][None, :] >> tile[:, None]) & 1
                ok = keep.bool().repeat_interleave(e, dim=1) & (
                    offs[None, :] < sizes[ids][:, None]).reshape(1, -1)
                sc = sc.masked_fill(~ok, float("-inf"))
                m = sc.amax(-1, keepdim=True)
                m = torch.where(torch.isinf(m), torch.zeros_like(m), m)
                p = torch.exp(sc - m)
                l = p.sum(-1, keepdim=True)
                o = p @ v[bi, hi, cols]
                out[bi, hi, r0:r1] = torch.where(l == 0, 0.0, o / l)
    return out


@pytest.mark.parametrize("rows,nq", [(64, 7), (32, 9), (8, 5)],
                         ids=["k9a", "k9b_32", "k9b_8"])
def test_grouped_walk_gives_the_unpaired_result(rows, nq):
    """K9's grouped lists applied as the Hopper kernel applies them (union
    walk, per-row bits) give dyn_sparse_attention_plain's per-tile result
    within 1e-6 (fp32), including a tile with count 0 (exactly 0), an odd
    number of tiles and key tiles with fewer valid keys than E."""
    rng = np.random.default_rng(100 + rows)
    b, h, nk, e, d = 1, 2, 6, 16, 32
    mask = _mask(rng, b, h, nq, nk)
    idx, counts = nabla.mask_indices(mask)
    q = torch.from_numpy(rng.standard_normal((b, h, nq * rows, d)).astype(
        np.float32))
    k, v = (torch.from_numpy(rng.standard_normal((b, h, nk * e, d)).astype(
        np.float32)) for _ in range(2))
    sizes = torch.full((nk,), e, dtype=torch.int32)
    sizes[2] = 5
    sizes[4] = 0
    scale = d**-0.5
    want = nabla.dyn_sparse_attention_plain(q, k, v, idx, counts, sizes,
                                            scale=scale, tile_elems=e,
                                            q_rows=rows)
    lists = ss.grouped_lists(idx, counts, nk, rows)
    got = _grouped_attention(q, k, v, *lists, rows, sizes, e, scale)
    torch.testing.assert_close(got, want, atol=1e-6, rtol=1e-6)
    assert (got[0, 0, :rows] == 0).all()


def test_host_rules_match_the_sources():
    """The Python constants and routes are the CUDA sources' own."""
    sm90 = _source("sm90.cuh")
    assert int(re.search(r"constexpr int kUnit = (\d+);", sm90).group(1)) \
        == ss.UNIT_ROWS
    bwd = _source("flash_bwd_sm90.cuh")
    assert int(re.search(r"kBwdOwn = (\d+)", bwd).group(1)) == ss.BLOCK_ROWS
    assert int(re.search(r"kBwdStep = (\d+)", bwd).group(1)) == ss.UNIT_ROWS
    fwd = _source("flash_fwd_sm90.cuh")
    assert int(re.search(r"kFwdBQ = (\d+)", fwd).group(1)) == ss.BLOCK_ROWS
    # the sparse kernels take the dense kernels' block, unit and stages
    sp_bwd = _source("vsa_sparse_bwd_sm90.cuh")
    assert "BR = kBwdOwn, BC = kBwdStep, NS = kBwdStages" in sp_bwd
    assert "static_assert(BC == kUnit" in sp_bwd
    sp_fwd = _source("dyn_sparse_fwd_sm90.cuh")
    assert "kDynBQ = kFwdBQ" in sp_fwd and "kDynBK = 2 * kUnit" in sp_fwd
    assert "kDynStages = kFwdStages" in sp_fwd
    for src in ("vsa_sparse_bwd.cu", "dyn_sparse_fwd.cu"):
        rule = re.search(r"bool use_sm90\(int D\) \{[^}]*\}",
                         _source(src)).group(0)
        heads = tuple(sorted(int(x) for x in re.findall(r"D == (\d+)", rule)))
        assert tuple(h for h in (16, 32, 48, 64, 96, 128) if
                     ss.sparse_schedule(torch.bfloat16, h) == "sm90") == heads
    assert f"group > {ss.MAX_GROUP}" in _source("dyn_sparse_fwd.cu")
    assert {"vsa_sparse_bwd", "dyn_sparse_fwd"} <= set(_build.PTXAS_VERBOSE)
    for name, src in (("vsa_sparse_bwd_dq", "vsa_sparse_bwd"),
                      ("vsa_sparse_bwd_dkv", "vsa_sparse_bwd"),
                      ("dyn_sparse_fwd", "dyn_sparse_fwd"),
                      ("dyn_sparse_qtile_fwd", "dyn_sparse_fwd")):
        assert _build.SOURCE_OF[name] == src
    for entry in ("fvt_vsa_sparse_bwd_dkv", "fvt_dyn_sparse_fwd_sm90",
                  "fvt_dyn_sparse_qtile_fwd_sm90"):
        n_args = len(_build._SIGNATURES[entry])
        src = _source("vsa_sparse_bwd.cu" if "vsa" in entry else
                      "dyn_sparse_fwd.cu")
        decl = re.search(r'extern "C" int ' + entry + r"\((.*?)\)\s*\{", src,
                         re.S).group(1)
        assert decl.count(",") + 1 == n_args, entry


def test_parse_ptxas_attributes_wgmma_warnings():
    """A ptxas note on serialized wgmma (C7518) lands on the kernel it
    names, whether it comes before or after that kernel's resource lines."""
    a = "_ZN3fvt4sm9022vsa_sparse_bwd_dq_sm90ILi128EEEvNS0_15SparseBwdParamsE"
    b = "_ZN3fvt4sm9022vsa_sparse_bwd_dq_sm90ILi64EEEvNS0_15SparseBwdParamsE"
    log = (
        f"ptxas info    : Compiling entry function '{a}' for 'sm_90a'\n"
        f"ptxas info    : Function properties for {a}\n"
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads\n"
        "ptxas info    : Used 168 registers, used 1 barriers\n"
        "ptxas info    : (C7518) Potential Performance Loss: wgmma.mma_async "
        "instructions are serialized due to the presence of wgmma "
        f"instructions in a divergent path in the function '{b}'.\n"
        f"ptxas info    : Compiling entry function '{b}' for 'sm_90a'\n"
        "    8 bytes stack frame, 4 bytes spill stores, 4 bytes spill loads\n"
        "ptxas info    : Used 128 registers, 2048 bytes smem\n")
    got = _build.parse_ptxas(log)
    assert [r["kernel"] for r in got] == [a, b]
    assert got[0]["warnings"] == [] and got[0]["registers"] == 168
    assert len(got[1]["warnings"]) == 1
    assert got[1]["warnings"][0].startswith("C7518: Potential Performance")
    assert got[1]["spill_stores"] == 4 and got[1]["smem"] == 2048


class _CudaTyped(torch.Tensor):
    """A CPU tensor that reports itself as a CUDA tensor, to drive the
    wrappers' CUDA dispatch without a card."""

    @property
    def is_cuda(self):
        return True


@pytest.mark.parametrize("d", [64, 48])
@pytest.mark.parametrize("kernel", ["k7_bwd", "k9a", "k9b"])
def test_cuda_call_takes_its_schedules_entry(kernel, d, monkeypatch):
    """On a CUDA tensor each wrapper builds its schedule's lists and calls
    its C entry (K9's Hopper entries at a head of 64, the first ones at 48;
    K7 bwd's entries route inside the library), counted under the kernel's
    own name; the plain version never runs."""
    seen = []

    def fake_launch(name, fn, *args):
        seen.append((name, fn))
        _build.count_launch(name)

    monkeypatch.setattr(_build, "check_device", lambda t, name: None)
    monkeypatch.setattr(_build, "stream_ptr", lambda t: 0)
    monkeypatch.setattr(_build, "launch", fake_launch)
    c = lambda t: t.as_subclass(_CudaTyped)  # noqa: E731
    bf = torch.bfloat16
    qt = torch.zeros(1, 2, 256, d, dtype=bf)
    sizes = torch.full((4,), 64, dtype=torch.int32)
    mask = torch.ones(1, 2, 4, 4, dtype=torch.bool)
    before = dict(_build.PLAIN_CALLS)
    if kernel == "k7_bwd":
        idx = torch.tensor([0, 1, 3, 2], dtype=torch.int32).reshape(
            1, 1, 4, 1).expand(1, 2, 4, 1)
        lse = torch.zeros(1, 2, 256)
        vsa.block_sparse_attention_bwd(c(qt), c(qt), c(qt), idx, sizes,
                                       c(qt), lse, c(qt), scale=0.125,
                                       tile_elems=64)
        assert seen == [("vsa_sparse_bwd_dq", "fvt_vsa_sparse_bwd_dq"),
                        ("vsa_sparse_bwd_dkv", "fvt_vsa_sparse_bwd_dkv")]
    elif kernel == "k9a":
        nabla.masked_block_sparse_attention(c(qt), c(qt), c(qt), mask, sizes)
        entry = "fvt_dyn_sparse_fwd" + ("_sm90" if d == 64 else "")
        assert seen == [("dyn_sparse_fwd", entry)]
    else:
        bsa._masked_sparse_qtile(c(qt[:, :, :128]), c(qt), c(qt), mask,
                                 sizes, 32, scale=0.125)
        entry = "fvt_dyn_sparse_qtile_fwd" + ("_sm90" if d == 64 else "")
        assert seen == [("dyn_sparse_qtile_fwd", entry)]
    assert _build.PLAIN_CALLS == before
