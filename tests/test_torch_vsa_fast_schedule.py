"""The host side of the VSA forward's Hopper schedule (K2), on the CPU:
the kernel's walk emulated in fp32 (per query group, 128-row blocks laid
back to back over the group's G E rows, the rows past the group loaded but
not stored; the keys in 64-key units, as one stream of the group's K tiles
built from the boxes the kernel issues (one 64-row box inside a tile,
eight 8-row boxes across a tile's end, clamped to real rows past the
stream's end) or, by the rule, per tile in 64-row units that read zeros
past E; two units a chunk, an odd walk's last unit again and masked; the
online softmax in log2 units per chunk) gives
``block_sparse_attention_plain`` and the JAX package's
``block_sparse_attention_fast`` (Pallas in interpret mode): 280-like and
64-like tile widths with tiny heads, q_group 1 and 3, ragged last blocks
and chunks. Also: the host rules are the CUDA source's own, and the entry
a CUDA-typed call takes."""

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
UNIT = ss.UNIT_ROWS
BOX = ss.STREAM_BOX_ROWS

CSRC = os.path.join(os.path.dirname(os.path.dirname(__file__)),
                    "fastvideo_tpu_torch", "csrc")


def _source(name: str) -> str:
    with open(os.path.join(CSRC, name)) as fh:
        return fh.read()


def _stream_unit(kv, ids, e, f, keys):
    """Unit f of the key stream of a group's tiles ``ids``, as the kernel
    issues its boxes: rows of ``kv`` [S, D] and the unit's valid keys."""
    k0 = f * UNIT
    j, r0 = divmod(k0, e)
    if r0 + UNIT <= e:  # one 64-row box inside tile j
        rows = ids[j] * e + r0 + np.arange(UNIT)
    else:  # eight 8-row boxes, each inside one tile, clamped to real rows
        rows = []
        for bx in range(UNIT // BOX):
            jj, rr = divmod(min(k0 + BOX * bx, keys - BOX), e)
            rows.append(ids[jj] * e + rr + np.arange(BOX))
        rows = np.concatenate(rows)
    return kv[rows], min(UNIT, keys - k0)


def _tile_unit(kv, ids, e, f):
    """Unit f of a per-tile walk: 64 rows of a tile, zeros past its e."""
    per = -(-e // UNIT)
    j, c = divmod(f, per)
    rows = c * UNIT + np.arange(UNIT)
    out = np.zeros((UNIT, kv.shape[1]), np.float32)
    live = rows < e
    out[live] = kv[ids[j] * e + rows[live]]
    return out, min(UNIT, e - c * UNIT)


def _emulate(q, k, v, idx, e, scale):
    """K2's Hopper walk in fp32 (see the module docstring)."""
    b, h, s, d = q.shape
    ng, topk = idx.shape[2:]
    span = s // ng  # a group's rows
    walk = ss.fast_key_walk(e)
    keys = topk * e
    units = -(-keys // UNIT) if walk == "stream" else topk * -(-e // UNIT)
    chunks = -(-units // 2)
    log2e = 1.4426950408889634
    out = np.zeros_like(q)
    for bi in range(b):
        for hi in range(h):
            for g in range(ng):
                ids = idx[bi, hi, g]
                for sub in range(ss.fast_blocks(e, span // e)):
                    r0 = g * span + sub * ss.BLOCK_ROWS
                    rows = r0 + np.arange(ss.BLOCK_ROWS)
                    qb = np.zeros((ss.BLOCK_ROWS, d), np.float32)
                    qb[rows < s] = q[bi, hi, rows[rows < s]]  # past S: zeros
                    m = np.full(ss.BLOCK_ROWS, -np.inf, np.float32)
                    l = np.zeros(ss.BLOCK_ROWS, np.float32)
                    o = np.zeros((ss.BLOCK_ROWS, d), np.float32)
                    for c in range(chunks):
                        ks, vs, lim = [], [], []
                        for f in (2 * c, 2 * c + 1):
                            ff = min(f, units - 1)  # the last unit again
                            if walk == "stream":
                                ku, nk = _stream_unit(k[bi, hi], ids, e, ff,
                                                      keys)
                                vu, _ = _stream_unit(v[bi, hi], ids, e, ff,
                                                     keys)
                            else:
                                ku, nk = _tile_unit(k[bi, hi], ids, e, ff)
                                vu, _ = _tile_unit(v[bi, hi], ids, e, ff)
                            ks.append(ku)
                            vs.append(vu)
                            lim.append(nk if f < units else 0)
                        sc = qb @ np.concatenate(ks).T
                        col = np.arange(2 * UNIT)
                        ok = np.where(col < UNIT, col < lim[0],
                                      col - UNIT < lim[1])
                        sc = np.where(ok[None], sc, -np.inf)
                        m_next = np.maximum(m, sc.max(axis=1) * scale * log2e)
                        m_use = np.where(np.isneginf(m_next), 0.0, m_next)
                        alpha = np.exp2(m - m_use)
                        p = np.exp2(sc * scale * log2e - m_use[:, None])
                        l = l * alpha + p.sum(axis=1)
                        o = o * alpha[:, None] + p @ np.concatenate(vs)
                        m = m_next
                    keep = (rows < (g + 1) * span) & (rows < s)  # the store
                    inv = np.where(l == 0, 0.0, 1.0 / np.where(l == 0, 1, l))
                    out[bi, hi, rows[keep]] = (o * inv[:, None])[keep]
    return out


def _inputs(seed, h, nb, e, d, ng, topk):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((1, h, nb * e, d)).astype(np.float32)
               for _ in range(3))
    idx = np.stack([rng.permutation(nb)[:topk]
                    for _ in range(h * ng)]).reshape(1, h, ng, topk)
    return q, k, v, idx.astype(np.int32)


@pytest.mark.parametrize("nb,e,d,qg,topk", [
    (6, 280, 16, 3, 4),  # the main path's tile: 840-row groups (7 blocks,
                         # the last 72 rows deep), 17.5 units a stream
    (4, 40, 16, 1, 3),   # 280-like (8 | E, 64 ∤ E): units across tile ends;
                         # one 40-row group in a block, rows of the next
    (6, 40, 32, 3, 5),   # groups of 120 rows: 8 rows past each group
    (4, 64, 16, 1, 2),   # 64-like: whole units only
    (6, 64, 16, 3, 3),   # q_group 3 over 64-row tiles: 192-row groups
    (4, 36, 16, 2, 3),   # E % 8 != 0: the rule walks per tile
], ids=["e280_qg3", "e40_qg1", "e40_qg3", "e64_qg1", "e64_qg3",
        "e36_tiles"])
def test_walk_gives_plain_and_jax(nb, e, d, qg, topk):
    ng = nb // qg
    q, k, v, idx = _inputs(nb * e + topk, 2, nb, e, d, ng, topk)
    scale = d**-0.5
    got = _emulate(q, k, v, idx, e, scale)
    want = tvsa.block_sparse_attention_plain(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        torch.from_numpy(idx), scale=scale, tile_elems=e)
    np.testing.assert_allclose(got, want.numpy(), atol=ATOL, rtol=RTOL)
    jwant = jvsa.block_sparse_attention_fast(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(idx),
        scale=scale, tile_elems=e)
    np.testing.assert_allclose(got, np.asarray(jwant), atol=ATOL, rtol=RTOL)


def test_stream_units_never_cross_a_tile():
    """Every box a stream unit issues lies inside one tile (8 | E), so a
    unit is 64 consecutive keys of the group's stream, and only the
    stream's last unit is ragged: 6,720 keys are 105 units at the main
    path (a per-tile walk takes 120 units of which 24 are ragged)."""
    for e in (8, 40, 96, 280, 256):
        topk = 5
        keys = topk * e
        ids = np.arange(topk) * 3 + 1
        stream = np.arange(20 * e).reshape(-1, 1).astype(np.float32)
        want = (ids[:, None] * e + np.arange(e)).reshape(-1)
        for f in range(-(-keys // UNIT)):
            unit, nk = _stream_unit(stream, ids, e, f, keys)
            assert nk == min(UNIT, keys - f * UNIT)
            np.testing.assert_array_equal(unit[:nk, 0],
                                          want[f * UNIT:f * UNIT + nk])
    assert -(-24 * 280 // UNIT) == 105 and 24 * -(-280 // UNIT) == 120


@pytest.mark.parametrize("e,walk", [(280, "stream"), (256, "stream"),
                                    (64, "stream"), (8, "stream"),
                                    (36, "tiles"), (100, "tiles"),
                                    (7, "tiles")])
def test_key_walk_rule(e, walk):
    assert ss.fast_key_walk(e) == walk


@pytest.mark.parametrize("e,g,blocks", [(280, 3, 7), (280, 1, 3),
                                        (256, 1, 2), (64, 3, 2), (40, 1, 1)])
def test_block_rule(e, g, blocks):
    """A group's rows tiled back to back: 840 rows take 7 blocks (896
    slots), where K8's per-tile blocks take 9 (1,152)."""
    assert ss.fast_blocks(e, g) == blocks


def test_host_rules_match_the_sources():
    """The route, key-walk rule, blocks and box rows are the CUDA sources'
    own, and the entries take the arguments the wrapper passes."""
    src = _source("vsa_sparse_fwd.cu")
    rule = re.search(r"bool use_sm90\(int D\) \{[^}]*\}", src).group(0)
    heads = tuple(sorted(int(x) for x in re.findall(r"D == (\d+)", rule)))
    assert tuple(d for d in (16, 32, 48, 64, 96, 128) if
                 ss.sparse_schedule(torch.bfloat16, d) == "sm90") == heads
    walk = re.search(r"bool stream_walk\(int E\) \{ return E % (\d+) == 0; "
                     r"\}", src)
    for e in range(1, 600):
        want = "stream" if e % int(walk.group(1)) == 0 else "tiles"
        assert ss.fast_key_walk(e) == want, e
    assert "D > 128 || use_sm90(D)" in src  # the first schedule
    assert "(walk == 1 && !stream_walk(E))" in src
    assert "p.rows = (nB / ng) * E;" in src
    assert "p.n_sub = (p.rows + s9::kDynBQ - 1) / s9::kDynBQ;" in src
    assert re.search(r"map_bshd\(&p\.k8, k, B, S, H, D, k_sb, k_sh, k_ss, "
                     rf"{BOX}\)", src)
    fwd = _source("dyn_sparse_fwd_sm90.cuh")
    assert "constexpr int kDynBQ = kFwdBQ;" in fwd
    assert "min(k0 + 8 * bx, keys - 8)" in fwd
    assert ss.FAST_WALKS == ("tiles", "stream")  # the entry's walk codes
    assert "vsa_sparse_fwd" in _build.PTXAS_VERBOSE
    for entry in ("fvt_vsa_sparse_fwd_sm90", "fvt_vsa_sparse_fwd"):
        n_args = len(_build._SIGNATURES[entry])
        decl = re.search(r'extern "C" int ' + entry + r"\((.*?)\)\s*\{", src,
                         re.S).group(1)
        assert decl.count(",") + 1 == n_args, entry


class _CudaTyped(torch.Tensor):
    """A CPU tensor that reports itself as a CUDA tensor, to drive the
    wrapper's CUDA dispatch without a card."""

    @property
    def is_cuda(self):
        return True


@pytest.mark.parametrize("d,e,fn,walk", [
    (128, 280, "fvt_vsa_sparse_fwd_sm90", 1),
    (64, 36, "fvt_vsa_sparse_fwd_sm90", 0),
    (32, 40, "fvt_vsa_sparse_fwd", None)])
def test_cuda_call_takes_its_schedules_entry(d, e, fn, walk, monkeypatch):
    """On a CUDA tensor a Hopper head launches the Hopper entry with the
    rule's key walk, another head the first schedule's; counted as K2; the
    plain version never runs."""
    seen = []

    def fake_launch(name, entry, *args):
        seen.append((name, entry, args))
        _build.count_launch(name)

    monkeypatch.setattr(_build, "check_device", lambda t, name: None)
    monkeypatch.setattr(_build, "stream_ptr", lambda t: 0)
    monkeypatch.setattr(_build, "launch", fake_launch)
    q = torch.zeros(1, 2, 6 * e, d, dtype=torch.bfloat16).as_subclass(
        _CudaTyped)
    idx = torch.zeros(1, 2, 2, 3, dtype=torch.int32)
    before = dict(_build.PLAIN_CALLS)
    tvsa.block_sparse_attention_fast(q, q, q, idx, tile_elems=e)
    assert _build.PLAIN_CALLS == before
    (name, entry, args), = seen
    assert (name, entry) == ("vsa_sparse_fwd", fn)
    assert len(args) == len(_build._SIGNATURES[fn])
    # q, k, v, o, indices, B, H, S, D, E, ng, topk (, walk)
    assert args[5:12] == (1, 2, 6 * e, d, e, 2, 3)
    if walk is not None:
        assert args[12] == walk
