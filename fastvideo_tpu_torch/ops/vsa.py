"""Video Sparse Attention (port of fastvideo_tpu/ops/vsa.py).

The composition follows the JAX function: tokens in tile-major order,
a compression branch (per-tile means, dense coarse attention over tiles),
top-k key tiles per query group from the coarse scores, a block-sparse
branch over the selected tiles, and ``out_c * gate + out_s``.

The block-sparse branch over full tiles is K2: on a CUDA tensor
:func:`block_sparse_attention_fast` launches ``csrc/vsa_sparse_fwd.cu``
(replacing the Pallas ``_sparse_fast_kernel``); a head of 64 or 128 runs
its Hopper schedule, K8's list-walk body on each group's top-k row with
the group's rows tiled back to back and the keys walked as one stream
(``sparse_schedule.fast_key_walk``, ``fast_blocks``), other heads the
first one. Grids with no exact tile,
STA and SLA go through :func:`block_sparse_attention` over padded tiles with
per-tile valid counts and ``-1`` index sentinels: on a CUDA tensor it
launches ``csrc/vsa_sparse_padded_fwd.cu`` (K8, and K7 fwd in its LSE mode,
replacing the Pallas ``_sparse_kernel`` and ``_sparse_fwd_lse_kernel``). A
head of 64 or 128 runs its Hopper schedule, K9's forward on each query
tile's own top-k row (``sparse_schedule.padded_lists``, ``padded_walk``
for the block; tiles under 64 rows walk unions), longest rows first; other
heads run the first one. On a CPU tensor both run
:func:`block_sparse_attention_plain`; there is no fallback between kernel
and plain version.

Under autograd the branch is :func:`block_sparse_attention_trainable`, one
``torch.autograd.Function``: K7's forward in its LSE mode (the padded
kernel), then K7 bwd (``csrc/vsa_sparse_bwd.cu``, replacing the Pallas
``_sparse_bwd_dq_kernel`` and ``_sparse_bwd_dkv_kernel``) for dQ and dK/dV,
as the JAX custom VJPs do. K7 bwd has two schedules, chosen by
``sparse_schedule.sparse_schedule`` (dtype and head) in the CUDA source: a
head of 64 or 128 runs the Hopper one, other heads the first one. Both
dK/dV walk the compacted transpose of the top-k
(``sparse_schedule.transposed_lists``), the longest lists first.
:func:`video_sparse_attn` takes that path under grad on every grid, on
exact tiles with per-tile indices as JAX's ``_bsa_fast`` does;
:func:`block_sparse_attention_fast` (K2) and
:func:`block_sparse_attention` (K8: STA, SLA) have no backward and raise on
CUDA for operands that require grad.
:func:`block_sparse_attention_bwd_plain` is K7 bwd's plain version, used in
the backward of CPU tensors only.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from fastvideo_tpu_torch.ops import _build
from fastvideo_tpu_torch.ops.flash_attention import (attn_operand,
                                                     check_bwd_operands)
from fastvideo_tpu_torch.ops.sparse_schedule import (FAST_WALKS,
                                                     fast_key_walk,
                                                     heaviest_first,
                                                     padded_lists,
                                                     padded_walk,
                                                     sparse_schedule,
                                                     transposed_lists)

NAME = "vsa_sparse_fwd"
PADDED_NAME = "vsa_sparse_padded_fwd"
BWD_DQ_NAME = "vsa_sparse_bwd_dq"
BWD_DKV_NAME = "vsa_sparse_bwd_dkv"
VSA_TILE_SIZE = (4, 4, 4)
TILE_ELEMS = 64
# the log-sum-exp of a row with no valid key (the JAX package's finite mask)
MASK_VALUE = -0.7 * float(np.finfo(np.float32).max)


# -- static tile index tables (host numpy, cached per shape) ----------------


@functools.lru_cache(maxsize=32)
def tile_layout(dit_seq_shape: tuple[int, int, int],
                tile_size: tuple[int, int, int] = VSA_TILE_SIZE):
    """Returns (scatter_index, gather_back_index, block_sizes, num_tiles,
    padded_len); ``scatter_index[i]`` is the slot of token i in the padded
    tile-major buffer and ``block_sizes[j]`` the real tokens of tile j."""
    T, H, W = dit_seq_shape
    ts, hs, ws = tile_size
    nt, nh, nw = (math.ceil(T / ts), math.ceil(H / hs), math.ceil(W / ws))
    elems = ts * hs * ws
    token_ids = np.arange(T * H * W).reshape(T, H, W)
    scatter = np.zeros(T * H * W, dtype=np.int64)
    block_sizes = np.zeros(nt * nh * nw, dtype=np.int32)
    tile_idx = 0
    for t in range(nt):
        for h in range(nh):
            for w in range(nw):
                blk = token_ids[t * ts:(t + 1) * ts, h * hs:(h + 1) * hs,
                                w * ws:(w + 1) * ws].reshape(-1)
                scatter[blk] = tile_idx * elems + np.arange(blk.size)
                block_sizes[tile_idx] = blk.size
                tile_idx += 1
    return scatter, scatter, block_sizes, (nt, nh, nw), nt * nh * nw * elems


@functools.lru_cache(maxsize=64)
def select_vsa_tile(dit_seq_shape: tuple[int, int, int],
                    min_elems: int = 128,
                    max_elems: int = 640) -> tuple[int, int, int] | None:
    """A tile geometry that divides the token grid exactly: the tile-token
    count closest to 256, then the squarer spatial footprint, then the
    longer time extent. None when no divisor fits."""
    T, H, W = dit_seq_shape

    def divisors(n, cap=32):
        return [d for d in range(1, min(n, cap) + 1) if n % d == 0]

    best = None
    for ts in divisors(T, 21):
        for hs in divisors(H):
            for ws in divisors(W):
                elems = ts * hs * ws
                if elems % 8 != 0 or not min_elems <= elems <= max_elems:
                    continue
                if (T // ts) * (H // hs) * (W // ws) < 4:
                    continue
                score = (abs(elems - 256), abs(hs - ws), -ts)
                if best is None or score < best[0]:
                    best = (score, (ts, hs, ws))
    return best[1] if best else None


def tile_tokens_exact(x: torch.Tensor, dit_seq_shape: tuple[int, int, int],
                      tile_size: tuple[int, int, int]) -> torch.Tensor:
    """[B, S, ...] raster order -> tile-major order (exact tiles)."""
    T, H, W = dit_seq_shape
    ts, hs, ws = tile_size
    if T % ts or H % hs or W % ws:
        raise ValueError(f"tile {tile_size} does not divide grid {dit_seq_shape}")
    b, feat = x.shape[0], x.shape[2:]
    x = x.reshape(b, T // ts, ts, H // hs, hs, W // ws, ws, *feat)
    x = x.permute(0, 1, 3, 5, 2, 4, 6, *range(7, 7 + len(feat)))
    return x.reshape(b, T * H * W, *feat)


def untile_tokens_exact(x: torch.Tensor, dit_seq_shape: tuple[int, int, int],
                        tile_size: tuple[int, int, int]) -> torch.Tensor:
    """Inverse of :func:`tile_tokens_exact`."""
    T, H, W = dit_seq_shape
    ts, hs, ws = tile_size
    b, feat = x.shape[0], x.shape[2:]
    x = x.reshape(b, T // ts, H // hs, W // ws, ts, hs, ws, *feat)
    x = x.permute(0, 1, 4, 2, 5, 3, 6, *range(7, 7 + len(feat)))
    return x.reshape(b, T * H * W, *feat)


@functools.lru_cache(maxsize=32)
def tile_valid_mask(dit_seq_shape: tuple[int, int, int],
                    tile_size: tuple[int, int, int] = VSA_TILE_SIZE):
    """[S_pad] bool numpy mask: True where a tiled slot holds a real token."""
    _, _, block_sizes, _, padded = tile_layout(tuple(dit_seq_shape),
                                               tuple(tile_size))
    elems = tile_size[0] * tile_size[1] * tile_size[2]
    pos = np.arange(padded)
    return (pos % elems) < block_sizes[pos // elems]


@functools.lru_cache(maxsize=32)
def tile_tables(dit_seq_shape: tuple[int, int, int],
                tile_size: tuple[int, int, int], device: torch.device):
    """(scatter_index, block_sizes, valid mask) of a tiling as tensors on
    ``device``, copied once per (grid, tile, device): the attention layers
    call this at every step. They are built outside inference mode even
    when the first call is a generation's: a later training step saves
    the valid counts for its backward, which autograd refuses for an
    inference tensor."""
    scatter, _, block_sizes, _, _ = tile_layout(dit_seq_shape, tile_size)
    with torch.inference_mode(False):
        return (torch.as_tensor(scatter, device=device),
                torch.as_tensor(block_sizes, device=device),
                torch.as_tensor(tile_valid_mask(dit_seq_shape, tile_size),
                                device=device))


def tile_tokens(x: torch.Tensor, dit_seq_shape: tuple[int, int, int],
                tile_size: tuple[int, int, int] = VSA_TILE_SIZE
                ) -> torch.Tensor:
    """[B, S, ...] token order -> [B, S_pad, ...] tile-major padded order."""
    scatter, sizes, _ = tile_tables(tuple(dit_seq_shape), tuple(tile_size),
                                    x.device)
    padded_len = sizes.numel() * math.prod(tile_size)
    out = x.new_zeros((x.shape[0], padded_len, *x.shape[2:]))
    out[:, scatter] = x
    return out


def untile_tokens(x: torch.Tensor, dit_seq_shape: tuple[int, int, int],
                  tile_size: tuple[int, int, int] = VSA_TILE_SIZE
                  ) -> torch.Tensor:
    """[B, S_pad, ...] tiled order -> [B, S, ...] original token order."""
    gather_back, _, _ = tile_tables(tuple(dit_seq_shape), tuple(tile_size),
                                    x.device)
    return x[:, gather_back]


def block_mean(x: torch.Tensor, block_sizes: torch.Tensor,
               tile_elems: int = TILE_ELEMS) -> torch.Tensor:
    """[B, H, nB*E, D] -> [B, H, nB, D] mean over the valid tokens of each
    tile, summed in fp32 and cast back to the input dtype."""
    b, h, s, d = x.shape
    sums = x.reshape(b, h, s // tile_elems, tile_elems, d).float().sum(dim=3)
    return (sums / block_sizes.float()[None, None, :, None]).to(x.dtype)


# -- block-sparse branch ------------------------------------------------------


def block_sparse_attention_plain(q: torch.Tensor, k: torch.Tensor,
                                 v: torch.Tensor, indices: torch.Tensor,
                                 block_sizes: torch.Tensor | None = None, *,
                                 scale: float,
                                 tile_elems: int = TILE_ELEMS,
                                 return_lse: bool = False,
                                 kernel: str = NAME):
    """Plain PyTorch version of both sparse kernels: each query group gathers
    its selected key tiles (memory ~ S*K*E per head, never S^2).

    q/k/v [B, H, nB*E, D]; indices [B, H, nG, K] key tiles per group of
    nB/nG query tiles (nG == nB: per query tile), -1 marking an unused slot.
    ``block_sizes`` [nB] masks padded slots of partial tiles (None: every
    tile is full). A row with no valid key outputs 0 and an LSE of
    ``MASK_VALUE``. With ``return_lse`` also returns the fp32 [B, H, S]
    log-sum-exp. ``kernel`` names the kernel the call is counted under.
    """
    _build.count_plain(kernel)
    b, h, s, d = q.shape
    e = tile_elems
    ng, topk = indices.shape[2], indices.shape[3]
    rows = s // ng
    out = torch.empty_like(q)
    lse = torch.empty((b, h, s), dtype=torch.float32, device=q.device)
    offs = torch.arange(e, device=q.device)
    sizes = (torch.full((s // e,), e, device=q.device)
             if block_sizes is None else block_sizes.to(q.device))
    for bi in range(b):
        for hi in range(h):
            slot = indices[bi, hi].long()  # [nG, K]
            idx = slot.clamp_min(0)
            kv_rows = (idx[..., None] * e + offs).reshape(ng, topk * e)
            kt = k[bi, hi].float()[kv_rows]  # [nG, K*E, D]
            vt = v[bi, hi][kv_rows]
            qg = q[bi, hi].float().reshape(ng, rows, d)
            sc = torch.matmul(qg, kt.transpose(-1, -2)) * scale
            valid = (offs < sizes[idx][..., None]) & (slot >= 0)[..., None]
            sc = sc.masked_fill(~valid.reshape(ng, 1, topk * e),
                                float("-inf"))
            m = sc.amax(dim=-1, keepdim=True)
            m = torch.where(torch.isinf(m), torch.zeros_like(m), m)
            p = torch.exp(sc - m)
            l = p.sum(dim=-1, keepdim=True)
            empty = l == 0
            o = torch.matmul(p.to(v.dtype).float(), vt.float())
            o = o / torch.where(empty, torch.ones_like(l), l)
            out[bi, hi] = o.reshape(s, d).to(q.dtype)
            lse[bi, hi] = torch.where(
                empty, torch.full_like(l, MASK_VALUE),
                m + torch.log(l)).reshape(s)
    return (out, lse) if return_lse else out


def sparse_cuda_operands(name: str, q, k, v, indices):
    """Checked operands of a sparse kernel launch (K2, K7 fwd / K8, K9): (q,
    k, v, int32 indices, out, the 12 strides). The output is laid out
    [B, S, H, D] so that the caller's transpose back to token-major order
    is free."""
    _build.check_device(q, name)
    d = q.shape[-1]
    if any(t.dtype != torch.bfloat16 for t in (q, k, v)) or d % 16 or d > 128:
        raise _build.KernelError(
            f"{name}: takes bfloat16 operands with a head dim that is a "
            f"multiple of 16 up to 128, got {[t.dtype for t in (q, k, v)]} "
            f"and head dim {d}")
    q, k, v = attn_operand(q), attn_operand(k), attn_operand(v)
    b, h, s, d = q.shape
    idx = indices.to(device=q.device, dtype=torch.int32).contiguous()
    out = torch.empty((b, s, h, d), dtype=q.dtype,
                      device=q.device).transpose(1, 2)
    st = []
    for t in (q, k, v, out):
        st += [t.stride(0), t.stride(1), t.stride(2)]
    return q, k, v, idx, out, st


def _block_sparse_attention_cuda(q, k, v, indices, scale, tile_elems,
                                 walk=None):
    """K2's launch; ``walk`` ("tiles" or "stream") overrides the Hopper
    schedule's key walk, which ``fast_key_walk`` chooses otherwise (the
    card tests and the timing script run both)."""
    _build.refuse_grad(NAME, q, k, v, use="block_sparse_attention_trainable")
    q, k, v, idx, out, st = sparse_cuda_operands(NAME, q, k, v, indices)
    b, h, s, d = q.shape
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            idx.data_ptr(), b, h, s, d, tile_elems, idx.shape[2],
            idx.shape[3])
    if sparse_schedule(q.dtype, d) == "sm90":
        walk = FAST_WALKS.index(walk or fast_key_walk(tile_elems))
        _build.launch(NAME, "fvt_vsa_sparse_fwd_sm90", *args, walk, *st,
                      float(scale), _build.stream_ptr(q))
    else:
        _build.launch(NAME, "fvt_vsa_sparse_fwd", *args, *st, float(scale),
                      _build.stream_ptr(q))
    return out


def block_sparse_attention_fast(q: torch.Tensor, k: torch.Tensor,
                                v: torch.Tensor, indices: torch.Tensor, *,
                                scale: float | None = None,
                                tile_elems: int = TILE_ELEMS) -> torch.Tensor:
    """Block-sparse attention over FULL tiles (K2).

    q/k/v: [B, H, nB*E, D] tile-major; indices: [B, H, nG, K] key-tile ids
    per query group of nB/nG consecutive tiles. Returns [B, H, nB*E, D].
    It has no backward: on CUDA it raises for tensors that require grad
    (:func:`block_sparse_attention_trainable` with valid counts of E is the
    differentiable form, as JAX's ``_bsa_fast_fwd`` routes it).
    """
    b, h, s, d = q.shape
    nb = s // tile_elems
    ng = indices.shape[2]
    if s % tile_elems or nb % ng:
        raise ValueError(f"{s} rows do not split into {ng} groups of "
                         f"{tile_elems}-token tiles")
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    if q.is_cuda:
        return _block_sparse_attention_cuda(q, k, v, indices, scale,
                                            tile_elems)
    if q.device.type == "cpu":
        return block_sparse_attention_plain(q, k, v, indices, scale=scale,
                                            tile_elems=tile_elems)
    raise _build.KernelError(f"{NAME}: unsupported device {q.device}")


def _block_sparse_padded_cuda(q, k, v, indices, block_sizes, scale,
                              tile_elems, return_lse):
    _build.refuse_grad(PADDED_NAME, q, k, v,
                       use="block_sparse_attention_trainable")
    q, k, v, idx, out, st = sparse_cuda_operands(PADDED_NAME, q, k, v,
                                                  indices)
    b, h, s, d = q.shape
    sizes = block_sizes.to(device=q.device, dtype=torch.int32).contiguous()
    lse = (torch.empty((b, h, s), dtype=torch.float32, device=q.device)
           if return_lse else None)
    lse_ptr = lse.data_ptr() if return_lse else None
    if sparse_schedule(q.dtype, d) == "sm90":
        wgs, group = padded_walk(tile_elems)
        lists, counts, bits, lens = padded_lists(idx, s // tile_elems,
                                                 tile_elems)
        _build.launch(PADDED_NAME, "fvt_vsa_sparse_padded_fwd_sm90",
                      q.data_ptr(), k.data_ptr(), v.data_ptr(),
                      out.data_ptr(), lse_ptr, lists.data_ptr(),
                      None if counts is None else counts.data_ptr(),
                      None if bits is None else bits.data_ptr(),
                      heaviest_first(lens).data_ptr(), sizes.data_ptr(), b,
                      h, s, d, tile_elems, group, wgs, lists.shape[-1], *st,
                      float(scale), _build.stream_ptr(q))
    else:
        _build.launch(PADDED_NAME, "fvt_vsa_sparse_padded_fwd", q.data_ptr(),
                      k.data_ptr(), v.data_ptr(), out.data_ptr(), lse_ptr,
                      idx.data_ptr(), sizes.data_ptr(), b, h, s, d,
                      tile_elems, idx.shape[3], *st, float(scale),
                      _build.stream_ptr(q))
    return (out, lse) if return_lse else out


def block_sparse_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           indices: torch.Tensor, block_sizes: torch.Tensor,
                           *, scale: float | None = None,
                           tile_elems: int = TILE_ELEMS,
                           return_lse: bool = False):
    """Block-sparse attention over PADDED tiles: the JAX
    ``block_sparse_attention`` (K8) and, with ``return_lse``, the forward of
    ``block_sparse_attention_trainable`` (K7). It has no backward: on CUDA
    it raises for tensors that require grad
    (:func:`block_sparse_attention_trainable` is the differentiable form).

    q/k/v: [B, H, nB*E, D] in tile-major padded order. indices:
    [B, H, nB, K] int32 key-tile ids per query tile, -1 marking an unused
    slot. block_sizes: [nB] int32 valid token counts. Returns [B, H, nB*E, D]
    and, on request, the fp32 log-sum-exp [B, H, nB*E].
    """
    b, h, s, d = q.shape
    if s % tile_elems or indices.shape[2] != s // tile_elems or \
            block_sizes.shape[0] != s // tile_elems:
        raise ValueError(
            f"{s} rows, indices {tuple(indices.shape)} and block_sizes "
            f"{tuple(block_sizes.shape)} do not describe {tile_elems}-token "
            "tiles with one index row per query tile")
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    if q.is_cuda:
        return _block_sparse_padded_cuda(q, k, v, indices, block_sizes, scale,
                                         tile_elems, return_lse)
    if q.device.type == "cpu":
        return block_sparse_attention_plain(
            q, k, v, indices, block_sizes, scale=scale, tile_elems=tile_elems,
            return_lse=return_lse, kernel=PADDED_NAME)
    raise _build.KernelError(f"{PADDED_NAME}: unsupported device {q.device}")


# -- backward (K7 bwd) and the trainable op -----------------------------------


def block_sparse_attention_bwd_plain(q: torch.Tensor, k: torch.Tensor,
                                     v: torch.Tensor, indices: torch.Tensor,
                                     block_sizes: torch.Tensor | None,
                                     out: torch.Tensor, lse: torch.Tensor,
                                     do: torch.Tensor, *, scale: float,
                                     tile_elems: int = TILE_ELEMS):
    """Plain PyTorch version of K7 bwd (JAX ``_block_sparse_bwd``): (dq, dk,
    dv) of :func:`block_sparse_attention_plain`'s function from its out and
    fp32 lse [B, H, S], step by step in fp32 with the Pallas kernels'
    rounding points. A probability is live where its key is below the
    tile's valid count, its slot is not -1 and the row's LSE is above
    ``MASK_VALUE / 2``. Indices as in the forward ([B, H, nG, K])."""
    _build.count_plain(BWD_DQ_NAME)
    _build.count_plain(BWD_DKV_NAME)
    b, h, s, d = q.shape
    e = tile_elems
    ng, topk = indices.shape[2], indices.shape[3]
    rows = s // ng
    offs = torch.arange(e, device=q.device)
    sizes = (torch.full((s // e,), e, device=q.device)
             if block_sizes is None else block_sizes.to(q.device))
    dq = torch.empty_like(q)
    dk = torch.zeros((b, h, s, d), dtype=torch.float32, device=q.device)
    dv = torch.zeros_like(dk)
    for bi in range(b):
        for hi in range(h):
            slot = indices[bi, hi].long()  # [nG, K]
            idx = slot.clamp_min(0)
            kv_rows = (idx[..., None] * e + offs).reshape(ng, topk * e)
            kt = k[bi, hi].float()[kv_rows]  # [nG, K*E, D]
            vt = v[bi, hi].float()[kv_rows]
            qg = q[bi, hi].float().reshape(ng, rows, d)
            dog = do[bi, hi].float().reshape(ng, rows, d)
            og = out[bi, hi].float().reshape(ng, rows, d)
            lg = lse[bi, hi].float().reshape(ng, rows, 1)
            delta = (dog * og).sum(dim=-1, keepdim=True)
            sc = torch.matmul(qg, kt.transpose(-1, -2)) * scale
            valid = (offs < sizes[idx][..., None]) & (slot >= 0)[..., None]
            live = valid.reshape(ng, 1, topk * e) & (lg > MASK_VALUE / 2)
            p = torch.exp((sc - lg).masked_fill(~live, float("-inf")))
            dp = torch.matmul(dog, vt.transpose(-1, -2))
            ds = p * (dp - delta) * scale
            dq[bi, hi] = torch.matmul(ds.to(k.dtype).float(),
                                      kt).reshape(s, d).to(q.dtype)
            dv_g = torch.matmul(p.to(do.dtype).float().transpose(-1, -2),
                                dog)
            dk_g = torch.matmul(ds.to(q.dtype).float().transpose(-1, -2),
                                qg)
            flat = kv_rows.reshape(-1)
            dk[bi, hi].index_add_(0, flat, dk_g.reshape(-1, d))
            dv[bi, hi].index_add_(0, flat, dv_g.reshape(-1, d))
    return dq, dk.to(k.dtype), dv.to(v.dtype)


def _block_sparse_bwd_cuda(q, k, v, indices, block_sizes, out, lse, do,
                           scale, tile_elems):
    check_bwd_operands(BWD_DQ_NAME, q, k, v, out, do)
    q, k, v, do = (attn_operand(t) for t in (q, k, v, do))
    b, h, s, d = q.shape
    nb = s // tile_elems
    if indices.shape[2] != nb:
        raise _build.KernelError(
            f"{BWD_DQ_NAME}: takes one index row per query tile "
            f"({nb}), got {tuple(indices.shape)}")
    idx = indices.to(device=q.device, dtype=torch.int32).contiguous()
    sizes = block_sizes.to(device=q.device, dtype=torch.int32).contiguous()
    # delta = rowsum(dO * O): a plain reduction, as it is XLA in JAX
    delta = (do.float() * out.float()).sum(dim=-1).contiguous()
    lse = lse.float().contiguous()

    def grad_like(t):  # [B, H, S, D] view of a [B, S, H, D] buffer
        return torch.empty((b, s, h, d), dtype=t.dtype,
                           device=q.device).transpose(1, 2)

    dq, dk, dv = grad_like(q), grad_like(k), grad_like(v)

    def st(t):
        return t.stride(0), t.stride(1), t.stride(2)

    common = (q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
              lse.data_ptr(), delta.data_ptr())
    strides = (*st(q), *st(k), *st(v), *st(do))
    _build.launch(BWD_DQ_NAME, "fvt_vsa_sparse_bwd_dq", *common,
                  dq.data_ptr(), idx.data_ptr(), sizes.data_ptr(), b, h, s, d,
                  tile_elems, idx.shape[3], *strides, *st(dq), float(scale),
                  _build.stream_ptr(q))
    # per key tile the query tiles that chose it, longest lists first
    t_idx, t_counts = transposed_lists(idx, nb)
    order = heaviest_first(t_counts)
    _build.launch(BWD_DKV_NAME, "fvt_vsa_sparse_bwd_dkv", *common,
                  dk.data_ptr(), dv.data_ptr(), t_idx.data_ptr(),
                  t_counts.data_ptr(), order.data_ptr(), sizes.data_ptr(), b,
                  h, s, d, tile_elems, *strides, *st(dk), *st(dv),
                  float(scale), _build.stream_ptr(q))
    return dq, dk, dv


def block_sparse_attention_bwd(q: torch.Tensor, k: torch.Tensor,
                               v: torch.Tensor, indices: torch.Tensor,
                               block_sizes: torch.Tensor, out: torch.Tensor,
                               lse: torch.Tensor, do: torch.Tensor, *,
                               scale: float, tile_elems: int = TILE_ELEMS):
    """K7 bwd: (dq, dk, dv) of block-sparse attention over padded tiles with
    per-tile indices [B, H, nB, K]. CUDA tensors launch the kernels, CPU
    tensors run :func:`block_sparse_attention_bwd_plain`."""
    if q.is_cuda:
        return _block_sparse_bwd_cuda(q, k, v, indices, block_sizes, out,
                                      lse, do, scale, tile_elems)
    if q.device.type == "cpu":
        return block_sparse_attention_bwd_plain(
            q, k, v, indices, block_sizes, out, lse, do, scale=scale,
            tile_elems=tile_elems)
    raise _build.KernelError(f"{BWD_DQ_NAME}: unsupported device {q.device}")


class _BlockSparseAttention(torch.autograd.Function):
    """K7 forward in its LSE mode, K7 bwd backward (JAX
    ``_block_sparse_attention_vjp``); indices and valid counts carry no
    gradient."""

    @staticmethod
    def forward(ctx, q, k, v, indices, block_sizes, scale, tile_elems):
        if q.is_cuda:
            # refuse what K7 bwd cannot take before the forward runs
            check_bwd_operands(BWD_DQ_NAME, q, k, v)
        out, lse = block_sparse_attention(q, k, v, indices, block_sizes,
                                          scale=scale, tile_elems=tile_elems,
                                          return_lse=True)
        ctx.save_for_backward(q, k, v, indices, block_sizes, out, lse)
        ctx.kw = dict(scale=scale, tile_elems=tile_elems)
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, indices, block_sizes, out, lse = ctx.saved_tensors
        dq, dk, dv = block_sparse_attention_bwd(q, k, v, indices, block_sizes,
                                                out, lse, do, **ctx.kw)
        return dq, dk, dv, None, None, None, None


def block_sparse_attention_trainable(q: torch.Tensor, k: torch.Tensor,
                                     v: torch.Tensor, indices: torch.Tensor,
                                     block_sizes: torch.Tensor, *,
                                     scale: float | None = None,
                                     tile_elems: int = TILE_ELEMS
                                     ) -> torch.Tensor:
    """Differentiable block-sparse attention (K7 forward with LSE, K7 bwd).

    The contract of :func:`block_sparse_attention`; ``indices`` may also be
    grouped ([B, H, nG, K], nG dividing nB), and are then expanded to one
    row per query tile, as JAX's ``_bsa_fast_fwd`` does. Gradients flow to
    q, k and v; indices come from top-k and carry none."""
    b, h, s, d = q.shape
    nb = s // tile_elems
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    ng = indices.shape[2]
    if nb % ng:
        raise ValueError(f"{nb} query tiles do not split into {ng} groups")
    if ng != nb:
        indices = indices.repeat_interleave(nb // ng, dim=2)
    indices = indices.to(device=q.device, dtype=torch.int32)
    block_sizes = block_sizes.to(device=q.device, dtype=torch.int32)
    return _BlockSparseAttention.apply(q, k, v, indices, block_sizes,
                                       float(scale), tile_elems)


# -- full VSA composition -----------------------------------------------------


def video_sparse_attn(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      block_sizes: torch.Tensor, topk: int, *,
                      gate_compress: torch.Tensor | None = None,
                      scale: float | None = None,
                      tile_elems: int = TILE_ELEMS, full_tiles: bool = False,
                      q_group: int = 1) -> torch.Tensor:
    """VSA over tiled [B, H, S_pad, D] tensors.

    ``full_tiles`` asserts there is no intra-tile padding, which K2 needs.
    ``q_group`` consecutive query tiles share one top-k set, chosen from
    their averaged coarse scores. Under autograd the sparse branch is
    :func:`block_sparse_attention_trainable` on every grid (K7 forward with
    LSE and K7 bwd; on full tiles the valid counts are all E, as JAX's
    ``_bsa_fast_fwd`` does), so K2 runs only without grad; the compression
    branch is plain PyTorch.
    """
    b, h, s, d = q.shape
    nb = s // tile_elems
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    topk = max(1, min(topk, nb))
    block_sizes = block_sizes.to(q.device)

    q_c = block_mean(q, block_sizes, tile_elems)
    k_c = block_mean(k, block_sizes, tile_elems)
    v_c = block_mean(v, block_sizes, tile_elems)
    scores = torch.matmul(q_c.float(), k_c.float().transpose(-1, -2)) * scale
    attn = torch.softmax(scores, dim=-1)
    out_c = torch.matmul(attn, v_c.float()).to(q.dtype)
    out_c = out_c.repeat_interleave(tile_elems, dim=2)

    if q_group > 1 and full_tiles and nb % q_group == 0:
        scores_sel = scores.reshape(b, h, nb // q_group, q_group,
                                    nb).mean(dim=3)
    else:
        scores_sel = scores
    top_idx = torch.topk(scores_sel, topk, dim=-1).indices

    if _build.needs_grad(q, k, v):
        out_s = block_sparse_attention_trainable(
            q, k, v, top_idx, block_sizes, scale=scale, tile_elems=tile_elems)
    elif full_tiles:
        out_s = block_sparse_attention_fast(q, k, v, top_idx, scale=scale,
                                            tile_elems=tile_elems)
    else:
        out_s = block_sparse_attention(q, k, v, top_idx, block_sizes,
                                       scale=scale, tile_elems=tile_elems)
    if gate_compress is not None:
        return out_c * gate_compress + out_s
    return out_c + out_s
