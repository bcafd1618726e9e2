"""Flash attention forward (port of fastvideo_tpu/ops/flash_attention.py).

``flash_attention`` takes ``[B, S, H, D]`` tensors like the JAX function.
On a CUDA tensor it launches the hand-written sm_90a kernel
``csrc/flash_fwd.cu`` (K1, replacing the Pallas ``_fwd_kernel``); on a CPU
tensor it runs :func:`flash_attention_plain`, the same arithmetic in plain
PyTorch. There is no fallback between the two.

``flash_attention_kv_mask`` is K5, the same kernel with a per-key mask
``[S_kv]`` (replacing ``_fwd_kernel`` with ``has_kv_mask``, reached through
the JAX ``flash_attention_kv_mask``): the causal Wan's attention over its
rolling KV cache, whose key validity changes from one stream block to the
next. Its plain version is :func:`flash_attention_kv_mask_plain`. It has no
backward (nor has the JAX one): on CUDA it raises for operands that
require grad.

With ``chunk_tokens > 0`` (and ``tf_clean_len``) the mask is the causal
Wan training forward's chunk-causal or teacher-forcing one (JAX
``_mask_tile``): K1 struct, an instance of its own in the same source
(``fvt_flash_fwd_struct``, counter ``flash_fwd_struct``), and under
autograd K6 struct (``flash_bwd_struct_dq`` / ``flash_bwd_struct_dkv``).
With ct = ``chunk_tokens`` and s = ``tf_clean_len``, key c is visible to
query r when c < ``kv_valid`` and: chunk-causal (s = 0), c // ct <= r // ct;
teacher forcing (the sequence ``[clean | noisy]``, 2s rows), for a clean
query (r < s) c < s and c // ct <= r // ct, for a noisy one its own noisy
chunk (c >= s, (c - s) // ct == (r - s) // ct) or the clean keys of
strictly earlier chunks (c < s, c // ct < (r - s) // ct). ``causal`` is
ignored there, as in JAX.

The plain versions work in slabs of query rows whose fp32 scores take at
most ``SLAB_BYTES`` (1 GiB), so that they hold the kernels at the causal
Wan's full-width training shapes (a dense [B, H, S, S] score tensor of
65,520 rows would be 206 GB); the backward sums dK and dV over the slabs.

Under autograd ``flash_attention`` runs as one ``torch.autograd.Function``:
K1's forward with its LSE, then K6 (``csrc/flash_bwd.cu``, replacing the
Pallas ``_bwd_dq_kernel`` and ``_bwd_dkv_kernel``) for dQ and dK/dV, as the
JAX function's custom VJP does. :func:`flash_attention_bwd_plain` is K6's
plain version, used in the backward of CPU tensors only.

Each kernel has two schedules, chosen by shape alone (:func:`flash_schedule`;
the CUDA sources apply the same rule): bf16 with a head of 64 or 128, every
DiT launch, runs the Hopper schedule (``csrc/flash_fwd_sm90.cuh``,
``csrc/flash_bwd_sm90.cuh``: wgmma, registers, TMA); fp32 and other heads
run the first one (``csrc/attn_tile.cuh``, ``csrc/attn_bwd_tile.cuh``),
apart from K1's third and fourth, below.
Where the dK/dV grid of the Hopper schedule would leave the card's SMs
idle (the cross-attention's 512 keys), :func:`dkv_splits` cuts the query
rows over more blocks: each writes fp32 partial sums to a scratch
[splits, B, H, Skv, D], and ``flash_bwd_dkv_reduce`` (its own counter) adds
them in split order (:func:`dkv_reduce_plain` is its plain version).

K1 at bf16 with a head of 384, the VAE's mid-block attention, runs a third
schedule (``csrc/flash_fwd_wide_sm90.cuh``, :func:`flash_schedule`'s
"sm90_wide"): a warpgroup's 64 query rows keep all 384 columns of O in
registers, and the keys of each query tile are cut into
:func:`wide_splits` ranges so that a batch of one or two frames fills the
card. A split launch writes fp32 partials (O / l
and the LSE of each range) that ``flash_fwd_combine`` (its own counter)
merges into the output; :func:`wide_partials_plain` and
:func:`wide_combine_plain` are their plain versions. No backward runs at a
head above 128 (:func:`flash_bwd_schedule`).

K1 at fp32 with a head of 384, the VAE attention of an fp32 decode, runs a
fourth schedule (``csrc/flash_fwd_wide_tf32_sm90.cuh``, "sm90_wide_tf32",
its own counter ``flash_fwd_tf32``): each product split into three TF32
wgmma products (hi hi + hi lo + lo hi) with fp32 sums, 64 query rows a
block. TF32 wgmma takes K-major operands only, so a pre-pass
(``flash_fwd_tf32_split``, :func:`tf32_split_kv`; plain version
:func:`tf32_split_plain`) writes K's TF32 heads and tails and V^T's, the
keys of each group of 8 in :func:`tf32_key_order`. The key splits follow
:func:`wide_splits` at 64 rows a block and ``flash_fwd_combine`` merges
them into the fp32 output. :func:`flash_attention_tf32x3_plain` emulates
the kernel's arithmetic on the CPU (the tests hold it to the JAX kernel);
the main path never calls it.

K1 at a head of 640 or 1024 (bf16 or fp32), the Wan2.2 VAE's mid-block
attention, runs a fifth schedule (``csrc/flash_fwd_cols_sm90.cuh``,
launched by ``csrc/flash_fwd_cols.cu``; :func:`flash_schedule`'s "cols",
its own counter ``flash_fwd_cols``): a head that wide fits no SM whole, so a
cluster of ``COLS_CLUSTER[dtype]`` CTAs owns a 64-row query tile, each CTA a
slice of the head for both the scores and O, each of its two warpgroups
half of that (:func:`cols_layout`). Every warpgroup computes a partial
score over its columns; the partials are summed once, in one fixed order,
through shared and distributed shared memory, so every warpgroup holds the
same scores and softmax and adds P V for its own columns. bf16 runs wgmma,
fp32 3xTF32 wgmma after a pre-pass (inside the same entry) that splits K
and V^T into TF32 heads and tails into a scratch the wrapper allocates.
:func:`cols_partials_plain` emulates the decomposition on the CPU (tests
only); the plain version is :func:`flash_attention_plain`, counted under
the same name. No other schedule takes these heads: ``fvt_flash_fwd``
refuses them.

Numerics follow the JAX kernel: fp32 scores and softmax statistics, the
probabilities rounded to the value dtype before the P@V product, and a row
with no valid key outputs 0. Masked keys are excluded exactly (-inf), so
that row's log-sum-exp is -inf. The JAX kernel masks with a finite
``DEFAULT_MASK_VALUE`` instead; the two agree on every row that has a
valid key.
"""

from __future__ import annotations

import math

import torch

from fastvideo_tpu_torch.ops import _build
from fastvideo_tpu_torch.ops.conv3d import tf32_split

NAME = "flash_fwd"
NAME_KV_MASK = "flash_fwd_kv_mask"
NAME_BWD_DQ = "flash_bwd_dq"
NAME_BWD_DKV = "flash_bwd_dkv"
NAME_STRUCT = "flash_fwd_struct"
NAME_BWD_STRUCT_DQ = "flash_bwd_struct_dq"
NAME_BWD_STRUCT_DKV = "flash_bwd_struct_dkv"
NAME_BWD_REDUCE = "flash_bwd_dkv_reduce"
NAME_COMBINE = "flash_fwd_combine"
NAME_TF32 = "flash_fwd_tf32"
NAME_TF32_SPLIT = "flash_fwd_tf32_split"
NAME_COLS = "flash_fwd_cols"
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# the Hopper schedule's heads, and the keys a dK/dV block owns and the query
# rows it streams a step (csrc/flash_bwd_sm90.cuh: kBwdOwn, kBwdStep)
SM90_HEADS = (64, 128)
DKV_BLOCK_KEYS = 128
DKV_STEP_ROWS = 64
# aim for this many waves of dK/dV blocks (one block an SM) when splitting
DKV_SPLIT_WAVES = 4
# the most fp32 scores a plain version holds at once
SLAB_BYTES = 1 << 30
# the wide schedule (csrc/flash_fwd_wide_sm90.cuh: kWideD, kWideBQ,
# kWideBK, kWideMaxSplits): its head, query rows a block, keys a chunk,
# and the most key splits
WIDE_HEAD = 384
WIDE_BLOCK_ROWS = 128
WIDE_CHUNK_KEYS = 32
WIDE_MAX_SPLITS = 8
# the 3xTF32 wide schedule (csrc/flash_fwd_wide_tf32_sm90.cuh: kTf32BQ,
# kTf32BK): query rows a block, keys a chunk (the pre-pass pads the keys to
# whole chunks; wide_splits counts chunks of WIDE_CHUNK_KEYS, the same)
TF32_BLOCK_ROWS = 64
TF32_CHUNK_KEYS = 32
# the column-sliced schedule (csrc/flash_fwd_cols_sm90.cuh: kColsBQ,
# kColsBK, ColsShape<D, Bf16>::C, kColsMaxStages, kColsSmemMax, kColsSlot):
# its heads (bf16 and fp32), query rows a cluster, keys a chunk (one
# exchange of the scores and one softmax step), CTAs a cluster by dtype
# (the head's slices), the most ring stages, a CTA's shared memory at
# most, and the bytes of one warpgroup's fp32 scores of a chunk
COLS_HEADS = (640, 1024)
COLS_BLOCK_ROWS = 64
COLS_CHUNK_KEYS = 32
COLS_CLUSTER = {torch.bfloat16: 2, torch.float32: 4}
COLS_MAX_STAGES = 4
COLS_SMEM_MAX = 232448
COLS_SLOT_BYTES = 4 * 128 * 16


def flash_schedule(dtype: torch.dtype, d: int) -> str:
    """The schedule K1 runs for operands of ``dtype`` with a head of ``d``:
    "sm90" (wgmma and TMA) for bf16 with a head of 64 or 128 (K5 and K1
    struct too), "sm90_wide" for bf16 with a head of 384 (the VAE's
    attention; K1 only), "sm90_wide_tf32" for fp32 with a head of 384 (the
    VAE attention of an fp32 decode; K1 only), "cols" for bf16 or fp32 with
    a head of 640 or 1024 (the Wan2.2 VAE's attention; K1 only), else
    "tile" (the first, WMMA or scalar, schedule)."""
    if dtype in (torch.bfloat16, torch.float32) and d in COLS_HEADS:
        return "cols"
    if dtype == torch.bfloat16 and d in SM90_HEADS:
        return "sm90"
    if dtype == torch.bfloat16 and d == WIDE_HEAD:
        return "sm90_wide"
    if dtype == torch.float32 and d == WIDE_HEAD:
        return "sm90_wide_tf32"
    return "tile"


def flash_bwd_schedule(d: int) -> str:
    """The schedule K6 (bf16 only) runs with a head of ``d``: "sm90" at 64
    and 128, else "tile". There is no backward at a head above 128
    (:func:`check_bwd_operands` refuses it), so none reaches the wide
    forward's schedule."""
    return "sm90" if d in SM90_HEADS else "tile"


def wide_splits(b: int, h: int, sq: int, keys: int, num_sms: int,
                block_rows: int = WIDE_BLOCK_ROWS) -> int:
    """Key ranges the wide schedule cuts each query tile's ``keys`` into
    (csrc/flash_fwd_wide_sm90.cuh:wide_splits): the fewest, up to
    ``WIDE_MAX_SPLITS`` and the tile's chunks, whose waves of blocks fill
    the card's ``num_sms`` SMs to 90 %, else the fullest. At the VAE's
    6,240 rows (49 query tiles a frame) on 132 SMs: 5 splits for one frame,
    4 for two. The 3xTF32 form's tiles are ``TF32_BLOCK_ROWS`` rows (98 a
    frame): 4 splits for one frame, 2 for two."""
    blocks = b * h * -(-sq // block_rows)
    chunks = -(-keys // WIDE_CHUNK_KEYS) if keys > 0 else 0
    best, best_n, best_cap = 1, 0, 1
    for s in range(1, max(1, min(WIDE_MAX_SPLITS, chunks)) + 1):
        n = blocks * s
        cap = -(-n // num_sms) * num_sms
        if 10 * n >= 9 * cap:
            return s
        if n * best_cap > best_n * cap:
            best, best_n, best_cap = s, n, cap
    return best


def wide_chunk_ranges(keys: int, splits: int) -> list[range]:
    """The key range of each split: whole chunks of ``WIDE_CHUNK_KEYS``,
    split z taking chunks [z n / splits, (z + 1) n / splits) of the n that
    cover ``keys`` (some may be empty)."""
    bk = WIDE_CHUNK_KEYS
    n = -(-keys // bk) if keys > 0 else 0
    return [range(min(z * n // splits * bk, keys),
                  min((z + 1) * n // splits * bk, keys))
            for z in range(splits)]


def wide_partials_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, scale: float, splits: int,
                        kv_valid: int | None = None
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of a split wide launch (no causal mask, as the VAE
    calls it): (part fp32 [splits, B, H, Sq, D], lse_part fp32 [splits, B,
    H, Sq]), each split's softmax attention over its keys alone, with K1's
    rounding (P relative to the split's own maximum, rounded to the value
    dtype before P V); a split with no key gives 0 and -inf."""
    skv = k.shape[1]
    keys = min(skv if kv_valid is None else kv_valid, skv)
    b, sq, h, d = q.shape
    parts, lses = [], []
    for keys_z in wide_chunk_ranges(keys, splits):
        if len(keys_z) == 0:
            parts.append(torch.zeros((b, h, sq, d), device=q.device))
            lses.append(torch.full((b, h, sq), float("-inf"),
                                   device=q.device))
            continue
        sl = slice(keys_z.start, keys_z.stop)
        out, lse = [], []
        for rows in _row_slabs(q, len(keys_z)):
            mask = torch.ones((1, len(keys_z)), dtype=torch.bool,
                              device=q.device)
            o_r, lse_r = _masked_attention(q[:, rows.start:rows.stop],
                                           k[:, sl], v[:, sl], mask, scale,
                                           out_dtype=torch.float32)
            out.append(o_r.transpose(1, 2))
            lse.append(lse_r)
        parts.append(torch.cat(out, dim=2))
        lses.append(torch.cat(lse, dim=2))
    return torch.stack(parts), torch.stack(lses)


def wide_combine_plain(part: torch.Tensor, lse_part: torch.Tensor,
                       dtype: torch.dtype = torch.bfloat16
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of ``flash_fwd_combine``: (out [B, Sq, H, D] in
    ``dtype``, lse fp32 [B, H, Sq]) from the partials of a split launch,
    each weighted by exp(lse_z - max_z lse_z); a row with no key in any
    split gives 0 and -inf."""
    _build.count_plain(NAME_COMBINE)
    m = lse_part.amax(dim=0)
    m_safe = torch.where(torch.isinf(m), torch.zeros_like(m), m)
    w = torch.exp(lse_part - m_safe)
    tot = w.sum(dim=0)
    out = (w[..., None] * part).sum(dim=0) / torch.where(
        tot == 0, torch.ones_like(tot), tot)[..., None]
    lse = torch.where(tot == 0, torch.full_like(tot, float("-inf")),
                      m_safe + torch.log(tot))
    return out.to(dtype).transpose(1, 2), lse


def wide_combine(part: torch.Tensor, lse_part: torch.Tensor,
                 out: torch.Tensor, lse: torch.Tensor | None) -> None:
    """``flash_fwd_combine``: out (bf16 or fp32 [B, Sq, H, 384], written in
    place) and lse (fp32 [B, H, Sq] or None) from a split launch's partials
    ([splits, B, H, Sq, 384], [splits, B, H, Sq], fp32, contiguous)."""
    _build.check_device(part, NAME_COMBINE)
    splits, b, h, sq, d = part.shape
    align = 16 if out.dtype == torch.float32 else 8  # 4 columns a store
    if (d != WIDE_HEAD or lse_part.shape != part.shape[:-1] or any(
            t.dtype != torch.float32 or not t.is_contiguous()
            for t in (part, lse_part))
            or out.dtype not in (torch.bfloat16, torch.float32)
            or out.shape != (b, sq, h, d) or out.stride(-1) != 1
            or out.data_ptr() % align
            or any(st % 4 for st in out.stride()[:-1])
            or (lse is not None and (lse.shape != (b, h, sq)
                                     or not lse.is_contiguous()))):
        raise _build.KernelError(
            f"{NAME_COMBINE}: takes contiguous fp32 partials [splits, B, H, "
            f"Sq, {WIDE_HEAD}] and [splits, B, H, Sq], a bf16 or fp32 out "
            f"[B, Sq, H, {WIDE_HEAD}] and an fp32 lse [B, H, Sq] or None")
    entry = ("fvt_flash_fwd_combine_f32" if out.dtype == torch.float32 else
             "fvt_flash_fwd_combine")
    _build.launch(NAME_COMBINE, entry, part.data_ptr(),
                  lse_part.data_ptr(), out.data_ptr(),
                  None if lse is None else lse.data_ptr(), splits, b, h, sq,
                  *bhs(out), _build.stream_ptr(part))


def cols_layout(dtype: torch.dtype, d: int) -> dict:
    """The column-sliced schedule's sizes at operands of ``dtype`` and a
    head of ``d``, as csrc/flash_fwd_cols_sm90.cuh:ColsShape computes them:
    "cluster" CTAs a query tile, "cta_cols" and "wg_cols" head columns a CTA
    and a consumer warpgroup (for the scores and for O), "stages" of the
    TMA ring, "unit" bytes a stage and "smem" bytes a CTA. bf16: 2 CTAs
    (1024: 512 and 256 columns; 640: 320 and 160), two units (K, V) a
    32-key chunk; fp32: 4 (256 and 128; 160 and 80), four units (K's and
    V^T's TF32 heads and tails). The exchange's local slots are
    double-buffered."""
    bf16 = dtype == torch.bfloat16
    c = COLS_CLUSTER[dtype]
    dc = d // c
    dw = dc // 2
    esz = 2 if bf16 else 4
    nqb = dc // (128 // esz)  # Q's and K's 128-byte boxes a CTA
    nvb = -(-dw // 64)        # bf16: V's 64-column boxes a warpgroup
    unit = (max(nqb, 2 * nvb) * COLS_CHUNK_KEYS * 128 if bf16 else
            COLS_CHUNK_KEYS * dc * 4)
    q_bytes = -(-COLS_BLOCK_ROWS * dc * esz // 1024) * 1024
    fixed = (1024 + q_bytes + 4 * COLS_SLOT_BYTES +
             2 * (c - 1) * COLS_SLOT_BYTES + 2048)
    stages = min(COLS_MAX_STAGES, (COLS_SMEM_MAX - fixed) // unit)
    return dict(cluster=c, cta_cols=dc, wg_cols=dw, stages=stages, unit=unit,
                smem=fixed + stages * unit)


def cols_keys_padded(skv: int) -> int:
    """Keys of the fp32 column-sliced form's pre-pass output: ``skv``
    rounded up to whole chunks of ``COLS_CHUNK_KEYS`` (at least one)."""
    return max(1, -(-skv // COLS_CHUNK_KEYS)) * COLS_CHUNK_KEYS


def cols_partials_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, scale: float, causal: bool = False,
                        kv_valid: int | None = None
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """CPU emulation of the column-sliced schedule's decomposition (tests
    only): the head cut into 2 ``COLS_CLUSTER[dtype]`` equal column slices,
    one a warpgroup of the cluster; for each chunk of ``COLS_CHUNK_KEYS``
    keys a partial score over each slice (fp32 sums; fp32 operands: hi hi +
    hi lo + lo hi of their TF32 heads and tails, exact in fp64, rounded to
    fp32), the partials added as a balanced tree in slice order (the
    kernel's fixed order); the online softmax in log2 units of the scaled
    scores; P rounded to bf16 (bf16 operands) or split into TF32 heads and
    tails (fp32) before P V; O rescaled and summed chunk by chunk in fp32.
    Returns (out [B, Sq, H, D] in q's dtype, lse fp32 [B, H, Sq])."""
    b, sq, h, d = q.shape
    skv = k.shape[1]
    kv_valid = skv if kv_valid is None else kv_valid
    keys = max(0, min(kv_valid, skv))
    tf32 = q.dtype == torch.float32
    parts = 2 * COLS_CLUSTER[q.dtype]
    w = d // parts
    qf, kf, vf = (t.float().transpose(1, 2) for t in (q, k, v))
    if tf32:
        qs, ks, vs = (tuple(x.double() for x in tf32_split(t))
                      for t in (qf, kf, vf))
    scale_log2 = (torch.tensor(scale, dtype=torch.float32) *
                  torch.tensor(1.4426950408889634, dtype=torch.float32))
    mask = _structural_mask(range(sq), skv, kv_valid, causal, q.device)
    m = q.new_full((b, h, sq), float("-inf"), dtype=torch.float32)
    l = q.new_zeros((b, h, sq), dtype=torch.float32)
    o = q.new_zeros((b, h, sq, d), dtype=torch.float32)
    for j0 in range(0, keys, COLS_CHUNK_KEYS):
        sl = slice(j0, min(j0 + COLS_CHUNK_KEYS, keys))
        partials = []
        for i in range(parts):
            cs = slice(i * w, (i + 1) * w)
            if tf32:
                a = [t[..., cs] for t in qs]
                kt = [t[:, :, sl, cs].transpose(-1, -2) for t in ks]
                partials.append((a[0] @ kt[0] + a[0] @ kt[1] +
                                 a[1] @ kt[0]).float())
            else:
                partials.append(qf[..., cs] @
                                kf[:, :, sl, cs].transpose(-1, -2))
        while len(partials) > 1:
            partials = [partials[i] + partials[i + 1]
                        for i in range(0, len(partials), 2)]
        s = partials[0].masked_fill(~mask[:, sl], float("-inf"))
        m_next = torch.maximum(m, s.amax(dim=-1) * scale_log2)
        m_use = torch.where(torch.isinf(m_next), torch.zeros_like(m_next),
                            m_next)
        alpha = torch.exp2(m - m_use)
        p = torch.exp2(s * scale_log2 - m_use[..., None])
        l = l * alpha + p.sum(dim=-1)
        o = o * alpha[..., None]
        if tf32:
            ph, pl = (x.double() for x in tf32_split(p))
            vh, vl = (t[:, :, sl] for t in vs)
            o = o + (ph @ vh + ph @ vl + pl @ vh).float()
        else:
            o = o + p.to(v.dtype).float() @ vf[:, :, sl]
        m = m_next
    inv = torch.where(l == 0, torch.zeros_like(l), 1.0 / l)
    out = (o * inv[..., None]).to(q.dtype).transpose(1, 2)
    lse = torch.where(l == 0, torch.full_like(l, float("-inf")),
                      m * math.log(2.0) + torch.log(l))
    return out, lse

def tf32_keys_padded(skv: int) -> int:
    """Keys of the 3xTF32 pre-pass's output: ``skv`` rounded up to whole
    chunks of ``TF32_CHUNK_KEYS`` (at least one)."""
    return max(1, -(-skv // TF32_CHUNK_KEYS)) * TF32_CHUNK_KEYS


def tf32_key_order(n: int) -> torch.Tensor:
    """The key each of V^T's ``n`` positions holds (n a multiple of 8):
    within each group of 8 the keys 0 2 4 6 1 3 5 7, the order in which
    the S accumulator's fragment (columns 2t, 2t + 1 of thread t) is the
    TF32 A fragment of P V (columns t, t + 4)."""
    c = torch.arange(n)
    low = c % 8
    return c - low + torch.where(low < 4, 2 * low, 2 * low - 7)


def tf32_split_plain(k: torch.Tensor, v: torch.Tensor
                     ) -> tuple[torch.Tensor, ...]:
    """Plain version of ``flash_fwd_tf32_split``: from fp32 k, v [B, Skv,
    H, 384], K's TF32 heads and tails [B, H, Skv_pad, 384] and V^T's [B, H,
    384, Skv_pad] (keys in :func:`tf32_key_order`), zero past Skv, with
    Skv_pad = :func:`tf32_keys_padded` (Skv)."""
    _build.count_plain(NAME_TF32_SPLIT)
    b, skv, h, d = k.shape
    pad = tf32_keys_padded(skv)
    kp = k.new_zeros((b, h, pad, d))
    kp[:, :, :skv] = k.float().transpose(1, 2)
    vp = v.new_zeros((b, h, pad, d))
    vp[:, :, :skv] = v.float().transpose(1, 2)
    vt = vp[:, :, tf32_key_order(pad).to(v.device)].transpose(2, 3)
    return (*tf32_split(kp), *tf32_split(vt.contiguous()))


def tf32_split_kv(k: torch.Tensor, v: torch.Tensor
                  ) -> tuple[torch.Tensor, ...]:
    """``flash_fwd_tf32_split``, the 3xTF32 schedule's pre-pass: (k_hi,
    k_lo, vt_hi, vt_lo) as :func:`tf32_split_plain` gives them, from fp32
    [B, Skv, H, 384] views (any strides, unit stride along the head). CUDA
    tensors launch the kernel, CPU tensors run the plain version."""
    if not k.is_cuda:
        if k.device.type == "cpu":
            return tf32_split_plain(k, v)
        raise _build.KernelError(
            f"{NAME_TF32_SPLIT}: unsupported device {k.device}")
    _build.check_device(k, NAME_TF32_SPLIT)
    b, skv, h, d = k.shape
    if (d != WIDE_HEAD or v.shape != k.shape or any(
            t.dtype != torch.float32 or t.stride(-1) != 1 or
            t.device != k.device for t in (k, v))):
        raise _build.KernelError(
            f"{NAME_TF32_SPLIT}: takes fp32 k and v [B, Skv, H, "
            f"{WIDE_HEAD}] with a unit stride along the head, got "
            f"{k.dtype} {tuple(k.shape)} and {v.dtype} {tuple(v.shape)}")
    pad = tf32_keys_padded(skv)
    k_hi, k_lo = (torch.empty((b, h, pad, d), dtype=torch.float32,
                              device=k.device) for _ in range(2))
    vt_hi, vt_lo = (torch.empty((b, h, d, pad), dtype=torch.float32,
                                device=k.device) for _ in range(2))
    _build.launch(NAME_TF32_SPLIT, "fvt_flash_tf32_split", k.data_ptr(),
                  v.data_ptr(), k_hi.data_ptr(), k_lo.data_ptr(),
                  vt_hi.data_ptr(), vt_lo.data_ptr(), b, h, skv, pad,
                  *bhs(k), *bhs(v), _build.stream_ptr(k))
    return k_hi, k_lo, vt_hi, vt_lo


def flash_attention_tf32x3_plain(q: torch.Tensor, k: torch.Tensor,
                                 v: torch.Tensor, *, scale: float,
                                 causal: bool = False,
                                 kv_valid: int | None = None,
                                 products: int = 3, splits: int = 1
                                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """CPU emulation of the 3xTF32 schedule's arithmetic (tests only): q,
    k, v, and P split into TF32 heads and tails, S = Q K^T and O = P V as
    hi hi + hi lo + lo hi (``products`` 1: hi hi alone, one TF32 pass),
    each product exact and summed in fp64, S and the softmax in fp32, the
    keys cut into ``splits`` ranges of whole chunks as the kernel cuts them
    (no causal mask then) and merged as ``flash_fwd_combine`` merges them.
    Returns (out fp32 [B, Sq, H, D], lse [B, H, Sq])."""
    if causal and splits > 1:
        raise ValueError("the emulation splits the keys of unmasked "
                         "attention only")
    _build.count_plain(NAME_TF32)
    b, sq, h, d = q.shape
    skv = k.shape[1]
    kv_valid = skv if kv_valid is None else kv_valid
    keys = max(0, min(kv_valid, skv))
    mask = _structural_mask(range(sq), skv, kv_valid, causal, q.device)
    qs, ks, vs = (tf32_split(t.float().transpose(1, 2)) for t in (q, k, v))

    def product(a, b_):
        """sum over ``products`` of the split pairs of a @ b_, in fp64."""
        pairs = [(0, 0), (0, 1), (1, 0)][:products]
        return sum(a[i].double() @ b_[j].double() for i, j in pairs)

    parts, lses = [], []
    for keys_z in wide_chunk_ranges(keys, splits):
        sl = slice(keys_z.start, keys_z.stop)
        if len(keys_z) == 0:
            parts.append(q.new_zeros((b, h, sq, d), dtype=torch.float32))
            lses.append(q.new_full((b, h, sq), float("-inf"),
                                   dtype=torch.float32))
            continue
        s = product(qs, [t[:, :, sl].transpose(-1, -2) for t in ks])
        s = (s.float() * scale).masked_fill(~mask[:, sl], float("-inf"))
        m = s.amax(dim=-1, keepdim=True)
        m_safe = torch.where(torch.isinf(m), torch.zeros_like(m), m)
        p = torch.exp(s - m_safe)
        l = p.double().sum(dim=-1, keepdim=True)
        pv = product(tf32_split(p), [t[:, :, sl] for t in vs])
        parts.append((pv / torch.where(l == 0, torch.ones_like(l), l)
                      ).float())
        lses.append(torch.where(l == 0, torch.full_like(m, float("-inf")),
                                m_safe + torch.log(l).float())[..., 0])
    if splits == 1:
        return parts[0].transpose(1, 2), lses[0]
    return wide_combine_plain(torch.stack(parts), torch.stack(lses),
                              torch.float32)


def dkv_splits(b: int, h: int, sq: int, skv: int, d: int,
               num_sms: int) -> int:
    """Query-row ranges the dK/dV kernel's grid is cut into: 1 when its
    key tiles alone fill the card's ``num_sms`` SMs (or the first schedule
    runs), else enough to give about ``DKV_SPLIT_WAVES`` waves, at most one
    a streamed step of rows. At the cross-attention's 512 keys and 12
    heads on 132 SMs: 48 blocks, 11 splits, 528 blocks."""
    if flash_bwd_schedule(d) != "sm90":
        return 1
    blocks = b * h * -(-skv // DKV_BLOCK_KEYS)
    if blocks >= num_sms:
        return 1
    steps = -(-sq // DKV_STEP_ROWS)
    return max(1, min(steps, -(-DKV_SPLIT_WAVES * num_sms // blocks)))


def dkv_scratch_shape(splits: int, b: int, h: int, skv: int,
                      d: int) -> tuple[int, ...]:
    """Shape of each fp32 partial-sum scratch (dK's and dV's) of a split
    dK/dV launch."""
    return (splits, b, h, skv, d)


def dkv_reduce_plain(part_k: torch.Tensor, part_v: torch.Tensor
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of ``flash_bwd_dkv_reduce``: (dk, dv) bf16 [B, Skv, H,
    D], the fp32 partial sums [splits, B, H, Skv, D] added in split order
    and rounded once."""
    _build.count_plain(NAME_BWD_REDUCE)
    outs = []
    for part in (part_k, part_v):
        acc = part[0].clone()
        for z in range(1, part.shape[0]):
            acc += part[z]
        outs.append(acc.to(torch.bfloat16).transpose(1, 2))
    return outs[0], outs[1]


def dkv_reduce(part_k: torch.Tensor, part_v: torch.Tensor, dk: torch.Tensor,
               dv: torch.Tensor) -> None:
    """``flash_bwd_dkv_reduce``: dk, dv (bf16 [B, Skv, H, D], written in
    place) = the partial sums [splits, B, H, Skv, D] added in split
    order."""
    _build.check_device(part_k, NAME_BWD_REDUCE)
    splits, b, h, skv, d = part_k.shape
    if (part_v.shape != part_k.shape or any(
            t.dtype != torch.float32 or not t.is_contiguous()
            for t in (part_k, part_v)) or dk.shape != (b, skv, h, d)
            or dv.shape != dk.shape):
        raise _build.KernelError(
            f"{NAME_BWD_REDUCE}: takes contiguous fp32 partial sums "
            f"[splits, B, H, Skv, D] and bf16 dk/dv [B, Skv, H, D]")
    _build.launch(NAME_BWD_REDUCE, "fvt_flash_bwd_dkv_reduce",
                  part_k.data_ptr(), part_v.data_ptr(), dk.data_ptr(),
                  dv.data_ptr(), splits, b, h, skv, d, *bhs(dk), *bhs(dv),
                  _build.stream_ptr(dk))


def check_struct(chunk_tokens: int, tf_clean_len: int) -> None:
    """The teacher-forcing mask is chunk-granular (JAX ``flash_attention``
    raises the same)."""
    if tf_clean_len > 0 and chunk_tokens <= 0:
        raise ValueError(
            "tf_clean_len > 0 requires chunk_tokens > 0 (teacher-forcing "
            "masks are chunk-granular)")


def _structural_mask(rows: range, skv: int, kv_valid: int, causal: bool,
                     device, chunk_tokens: int = 0,
                     tf_clean_len: int = 0) -> torch.Tensor:
    """[len(rows), Skv] bool: key c is visible to query row r of ``rows``
    (``_mask_tile``)."""
    row = torch.arange(rows.start, rows.stop, device=device)[:, None]
    col = torch.arange(skv, device=device)[None, :]
    mask = col < kv_valid
    ct, s = chunk_tokens, tf_clean_len

    def div(x):
        return torch.div(x, ct, rounding_mode="floor")

    if s > 0:
        clean = row < s
        cq = div(row - s)
        clean_ok = clean & (col < s) & (div(col) <= div(row))
        noisy_own = (col >= s) & (div(col - s) == cq)
        noisy_ctx = (col < s) & (div(col) < cq)
        return mask & (clean_ok | (~clean & (noisy_own | noisy_ctx)))
    if ct > 0:
        return mask & (div(col) <= div(row))
    if causal:
        return mask & (col <= row)
    return mask


def _row_slabs(q: torch.Tensor, skv: int):
    """Ranges of query rows whose fp32 scores [B, H, rows, Skv] take at
    most ``SLAB_BYTES``."""
    b, sq, h, _ = q.shape
    step = max(1, SLAB_BYTES // (4 * b * h * max(skv, 1)))
    return [range(r0, min(r0 + step, sq)) for r0 in range(0, sq, step)]


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, scale: float, causal: bool = False,
                          kv_valid: int | None = None, chunk_tokens: int = 0,
                          tf_clean_len: int = 0
                          ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of K1 (and K1 struct, with ``chunk_tokens``):
    returns (out [B,Sq,H,D], lse [B,H,Sq])."""
    check_struct(chunk_tokens, tf_clean_len)
    _build.count_plain(NAME_STRUCT if chunk_tokens > 0 else
                       NAME_COLS if q.shape[-1] in COLS_HEADS else NAME)
    skv = k.shape[1]
    kv_valid = skv if kv_valid is None else kv_valid
    outs, lses = [], []
    for rows in _row_slabs(q, skv):
        mask = _structural_mask(rows, skv, kv_valid, causal, q.device,
                                chunk_tokens, tf_clean_len)
        out, lse = _masked_attention(q[:, rows.start:rows.stop], k, v, mask,
                                     scale)
        outs.append(out)
        lses.append(lse)
    return torch.cat(outs, dim=1), torch.cat(lses, dim=2)


def flash_attention_kv_mask_plain(q: torch.Tensor, k: torch.Tensor,
                                  v: torch.Tensor, kv_mask: torch.Tensor, *,
                                  scale: float) -> torch.Tensor:
    """Plain PyTorch version of K5: K1's with key j visible where
    ``kv_mask[j] != 0``, in slabs of query rows (``SLAB_BYTES``). Returns
    out [B, Sq, H, D]."""
    _build.count_plain(NAME_KV_MASK)
    mask = (kv_mask.reshape(1, -1) != 0).to(q.device)
    return torch.cat([_masked_attention(q[:, rows.start:rows.stop], k, v,
                                        mask, scale)[0]
                      for rows in _row_slabs(q, k.shape[1])], dim=1)


def _masked_attention(q, k, v, mask, scale, out_dtype=None):
    """Softmax attention over [B, S, H, D] where ``mask`` [Sq or 1, Skv]
    says which keys a query row sees: (out [B, Sq, H, D] in ``out_dtype``,
    default q's, lse [B, H, Sq])."""
    qf = q.float().transpose(1, 2)
    kf = k.float().transpose(1, 2)
    s = torch.matmul(qf, kf.transpose(-1, -2)) * scale
    s = s.masked_fill(~mask, float("-inf"))
    m = s.amax(dim=-1, keepdim=True)
    m_safe = torch.where(torch.isinf(m), torch.zeros_like(m), m)
    p = torch.exp(s - m_safe)
    l = p.sum(dim=-1, keepdim=True)
    pv = torch.matmul(p.to(v.dtype).float(), v.float().transpose(1, 2))
    out = pv / torch.where(l == 0, torch.ones_like(l), l)
    lse = torch.where(l == 0, torch.full_like(l, float("-inf")),
                      m_safe + torch.log(l))
    return out.to(out_dtype or q.dtype).transpose(1, 2), lse[..., 0]


def flash_attention_bwd_plain(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, out: torch.Tensor,
                              lse: torch.Tensor, do: torch.Tensor, *,
                              scale: float, causal: bool = False,
                              kv_valid: int | None = None,
                              chunk_tokens: int = 0, tf_clean_len: int = 0):
    """Plain PyTorch version of K6 (JAX ``_flash_attention_bwd_bhsd``):
    (dq, dk, dv) of ``[B, S, H, D]`` operands from the forward's out and
    fp32 lse [B, H, Sq], step by step in fp32 with the Pallas kernels'
    rounding points: p to dO's dtype before p^T dO, dS to the operands'
    dtype before dS K and dS^T Q, the results in the input dtypes. In
    slabs of query rows (``SLAB_BYTES``), dK and dV summed over them."""
    check_struct(chunk_tokens, tf_clean_len)
    struct = chunk_tokens > 0
    _build.count_plain(NAME_BWD_STRUCT_DQ if struct else NAME_BWD_DQ)
    _build.count_plain(NAME_BWD_STRUCT_DKV if struct else NAME_BWD_DKV)
    skv = k.shape[1]
    kv_valid = skv if kv_valid is None else kv_valid
    kf, vf = (t.float().transpose(1, 2) for t in (k, v))
    dqs = []
    dk = dv = 0.0
    for rows in _row_slabs(q, skv):
        sl = slice(rows.start, rows.stop)
        mask = _structural_mask(rows, skv, kv_valid, causal, q.device,
                                chunk_tokens, tf_clean_len)
        qf, of, dof = (t[:, sl].float().transpose(1, 2) for t in (q, out, do))
        delta = (dof * of).sum(dim=-1, keepdim=True)  # [B, H, rows, 1]
        s = torch.matmul(qf, kf.transpose(-1, -2)) * scale
        # masked before the exponent: an empty row's -inf LSE meets no key
        p = torch.exp((s - lse[:, :, sl].float()[..., None]).masked_fill(
            ~mask, float("-inf")))
        del s
        dv = dv + torch.matmul(p.to(do.dtype).float().transpose(-1, -2),
                               dof)
        dp = torch.matmul(dof, vf.transpose(-1, -2))
        ds = p * (dp - delta) * scale
        del p, dp
        dqs.append(torch.matmul(ds.to(k.dtype).float(), kf).to(q.dtype))
        dk = dk + torch.matmul(ds.to(q.dtype).float().transpose(-1, -2), qf)
        del ds
    return (torch.cat(dqs, dim=2).transpose(1, 2),
            dk.to(k.dtype).transpose(1, 2),
            dv.to(v.dtype).transpose(1, 2))


def attn_operand(t: torch.Tensor) -> torch.Tensor:
    """A view the attention kernels can read: unit stride on the last dim,
    16-byte aligned base and row strides (else a contiguous copy)."""
    vec = 16 // t.element_size()
    ok = (t.stride(-1) == 1 and t.data_ptr() % 16 == 0
          and all(s % vec == 0 for s in t.stride()[:-1]))
    return t if ok else t.contiguous()


def _check_cuda_operands(name: str, *ts: torch.Tensor) -> int:
    _build.check_device(ts[0], name)
    dtype = ts[0].dtype
    if dtype not in _DTYPE_CODES or any(t.dtype != dtype for t in ts):
        raise _build.KernelError(
            f"{name}: takes bfloat16 or float32 operands of one dtype, got "
            f"{[t.dtype for t in ts]}")
    if ts[0].shape[-1] % 16:
        raise _build.KernelError(
            f"{name}: head dim must be a multiple of 16, got {ts[0].shape[-1]}")
    return _DTYPE_CODES[dtype]


def bhs(t):
    """(batch, head, row) strides of a [B, S, H, D] tensor."""
    return t.stride(0), t.stride(2), t.stride(1)


def _flash_attention_wide_cuda(q, k, v, *, scale, causal, kv_valid):
    """K1 on the wide schedule: one launch over ``wide_splits`` key ranges,
    then ``flash_fwd_combine`` where there is more than one."""
    b, sq, h, d = q.shape
    skv = k.shape[1]
    out = torch.empty((b, sq, h, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    splits = wide_splits(b, h, sq, min(kv_valid, skv),
                         _build.num_sms(q.device))
    part = lse_part = None
    if splits > 1:
        part = torch.empty((splits, b, h, sq, d), dtype=torch.float32,
                           device=q.device)
        lse_part = torch.empty((splits, b, h, sq), dtype=torch.float32,
                               device=q.device)
    _build.launch(NAME, "fvt_flash_fwd_wide", q.data_ptr(), k.data_ptr(),
                  v.data_ptr(), out.data_ptr(), lse.data_ptr(),
                  None if part is None else part.data_ptr(),
                  None if lse_part is None else lse_part.data_ptr(), b, h,
                  sq, skv, *bhs(q), *bhs(k), *bhs(v), *bhs(out), float(scale),
                  int(causal), int(kv_valid), splits, _build.stream_ptr(q))
    if splits > 1:
        wide_combine(part, lse_part, out, lse)
    return out, lse


def _flash_attention_tf32_cuda(q, k, v, *, scale, causal, kv_valid):
    """K1 on the 3xTF32 wide schedule: the pre-pass, one launch over
    ``wide_splits`` key ranges (``TF32_BLOCK_ROWS`` rows a block), then
    ``flash_fwd_combine`` where there is more than one."""
    b, sq, h, d = q.shape
    skv = k.shape[1]
    k_hi, k_lo, vt_hi, vt_lo = tf32_split_kv(k, v)
    out = torch.empty((b, sq, h, d), dtype=torch.float32, device=q.device)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    splits = wide_splits(b, h, sq, min(kv_valid, skv),
                         _build.num_sms(q.device), TF32_BLOCK_ROWS)
    part = lse_part = None
    if splits > 1:
        part = torch.empty((splits, b, h, sq, d), dtype=torch.float32,
                           device=q.device)
        lse_part = torch.empty((splits, b, h, sq), dtype=torch.float32,
                               device=q.device)
    _build.launch(NAME_TF32, "fvt_flash_fwd_wide_tf32", q.data_ptr(),
                  k_hi.data_ptr(), k_lo.data_ptr(), vt_hi.data_ptr(),
                  vt_lo.data_ptr(), out.data_ptr(), lse.data_ptr(),
                  None if part is None else part.data_ptr(),
                  None if lse_part is None else lse_part.data_ptr(), b, h,
                  sq, skv, k_hi.shape[2], *bhs(q), *bhs(out), float(scale),
                  int(causal), int(kv_valid), splits, _build.stream_ptr(q))
    if splits > 1:
        wide_combine(part, lse_part, out, lse)
    return out, lse


def _flash_attention_cols_cuda(q, k, v, dtype, *, scale, causal, kv_valid):
    """K1 on the column-sliced schedule (heads of 640 and 1024); the fp32
    form's pre-pass writes its TF32 split of K and V^T into ``split``."""
    b, sq, h, d = q.shape
    skv = k.shape[1]
    out = torch.empty((b, sq, h, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    split = None
    if q.dtype == torch.float32:
        split = torch.empty((4, b, h, cols_keys_padded(skv), d),
                            dtype=torch.float32, device=q.device)
    _build.launch(NAME_COLS, "fvt_flash_fwd_cols", q.data_ptr(), k.data_ptr(),
                  v.data_ptr(), out.data_ptr(), lse.data_ptr(),
                  None if split is None else split.data_ptr(), dtype, b, h,
                  sq, skv, d, *bhs(q), *bhs(k), *bhs(v), *bhs(out),
                  float(scale), int(causal), int(kv_valid),
                  _build.stream_ptr(q))
    return out, lse


def _flash_attention_cuda(q, k, v, *, scale, causal, kv_valid, chunk_tokens,
                          tf_clean_len):
    struct = chunk_tokens > 0
    b, sq, h, d = q.shape
    schedule = flash_schedule(q.dtype, d)
    if schedule == "cols" and struct:
        raise _build.KernelError(
            f"{NAME_STRUCT}: no schedule takes a head of {d} (the "
            f"column-sliced one, heads {COLS_HEADS}, is K1's alone)")
    name = (NAME_STRUCT if struct else
            NAME_COLS if schedule == "cols" else NAME)
    dtype = _check_cuda_operands(name, q, k, v)
    q, k, v = attn_operand(q), attn_operand(k), attn_operand(v)
    if schedule == "cols":
        return _flash_attention_cols_cuda(q, k, v, dtype, scale=scale,
                                          causal=causal, kv_valid=kv_valid)
    if not struct and schedule == "sm90_wide":
        return _flash_attention_wide_cuda(q, k, v, scale=scale,
                                          causal=causal, kv_valid=kv_valid)
    if not struct and schedule == "sm90_wide_tf32":
        return _flash_attention_tf32_cuda(q, k, v, scale=scale,
                                          causal=causal, kv_valid=kv_valid)
    skv = k.shape[1]
    out = torch.empty((b, sq, h, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr(), dtype, b, h, sq, skv, d, *bhs(q), *bhs(k),
            *bhs(v), *bhs(out), float(scale))
    if struct:
        _build.launch(name, "fvt_flash_fwd_struct", *ptrs, int(kv_valid),
                      int(chunk_tokens), int(tf_clean_len),
                      _build.stream_ptr(q))
    else:
        _build.launch(name, "fvt_flash_fwd", *ptrs, int(causal),
                      int(kv_valid), _build.stream_ptr(q))
    return out, lse


def check_bwd_operands(name: str, *ts: torch.Tensor) -> None:
    """The backward kernels (K6, K7 bwd) take bf16 with a head dim that is a
    multiple of 16 up to 128."""
    _build.check_device(ts[0], name)
    d = ts[0].shape[-1]
    if any(t.dtype != torch.bfloat16 for t in ts) or d % 16 or d > 128:
        raise _build.KernelError(
            f"{name}: the backward takes bfloat16 operands with a head dim "
            f"that is a multiple of 16 up to 128, got "
            f"{[t.dtype for t in ts]} and head dim {d}")


def _flash_attention_bwd_cuda(q, k, v, out, lse, do, *, scale, causal,
                              kv_valid, chunk_tokens, tf_clean_len):
    struct = chunk_tokens > 0
    names = ((NAME_BWD_STRUCT_DQ, NAME_BWD_STRUCT_DKV) if struct else
             (NAME_BWD_DQ, NAME_BWD_DKV))
    check_bwd_operands(names[0], q, k, v, out, do)
    q, k, v, do = (attn_operand(t) for t in (q, k, v, do))
    b, sq, h, d = q.shape
    skv = k.shape[1]
    # delta = rowsum(dO * O): a plain reduction, as it is XLA in JAX
    delta = (do.float() * out.float()).sum(dim=-1).transpose(1,
                                                             2).contiguous()
    lse = lse.float().contiguous()
    dq = torch.empty((b, sq, h, d), dtype=q.dtype, device=q.device)
    dk = torch.empty((b, skv, h, d), dtype=k.dtype, device=q.device)
    dv = torch.empty((b, skv, h, d), dtype=v.dtype, device=q.device)

    common = (q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
              lse.data_ptr(), delta.data_ptr())
    if struct:
        entries = ("fvt_flash_bwd_struct_dq", "fvt_flash_bwd_struct_dkv")
        tail = (float(scale), int(kv_valid), int(chunk_tokens),
                int(tf_clean_len), _build.stream_ptr(q))
    else:
        entries = ("fvt_flash_bwd_dq", "fvt_flash_bwd_dkv")
        tail = (float(scale), int(causal), int(kv_valid),
                _build.stream_ptr(q))
    _build.launch(names[0], entries[0], *common, dq.data_ptr(), b, h, sq,
                  skv, d, *bhs(q), *bhs(k), *bhs(v), *bhs(do), *bhs(dq),
                  *tail)
    splits = dkv_splits(b, h, sq, skv, d, _build.num_sms(q.device))
    if splits == 1:
        _build.launch(names[1], entries[1], *common, dk.data_ptr(),
                      dv.data_ptr(), b, h, sq, skv, d, *bhs(q), *bhs(k),
                      *bhs(v), *bhs(do), *bhs(dk), *bhs(dv), *tail)
        return dq, dk, dv
    shape = dkv_scratch_shape(splits, b, h, skv, d)
    part_k = torch.empty(shape, dtype=torch.float32, device=q.device)
    part_v = torch.empty(shape, dtype=torch.float32, device=q.device)
    _build.launch(names[1], "fvt_flash_bwd_dkv_split", *common,
                  part_k.data_ptr(), part_v.data_ptr(), b, h, sq, skv, d,
                  *bhs(q), *bhs(k), *bhs(v), *bhs(do), float(scale),
                  int(causal), int(kv_valid), int(chunk_tokens),
                  int(tf_clean_len), splits, _build.stream_ptr(q))
    dkv_reduce(part_k, part_v, dk, dv)
    return dq, dk, dv


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        out: torch.Tensor, lse: torch.Tensor,
                        do: torch.Tensor, *, scale: float,
                        causal: bool = False, kv_valid: int | None = None,
                        chunk_tokens: int = 0, tf_clean_len: int = 0):
    """K6: (dq, dk, dv) of flash attention over ``[B, S, H, D]`` operands,
    from the forward's out and lse [B, H, Sq] and the output gradient
    ``do``; K6 struct with ``chunk_tokens > 0``. CUDA tensors launch the
    kernels, CPU tensors run :func:`flash_attention_bwd_plain`."""
    check_struct(chunk_tokens, tf_clean_len)
    kw = dict(scale=scale, causal=causal,
              kv_valid=k.shape[1] if kv_valid is None else int(kv_valid),
              chunk_tokens=int(chunk_tokens), tf_clean_len=int(tf_clean_len))
    if q.is_cuda:
        return _flash_attention_bwd_cuda(q, k, v, out, lse, do, **kw)
    if q.device.type == "cpu":
        return flash_attention_bwd_plain(q, k, v, out, lse, do, **kw)
    raise _build.KernelError(f"{NAME_BWD_DQ}: unsupported device {q.device}")


def _flash_attention_fwd(q, k, v, **kw):
    """(out, lse): K1 (or K1 struct) on a CUDA tensor, its plain version
    on a CPU one."""
    if q.is_cuda:
        return _flash_attention_cuda(q, k, v, **kw)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, **kw)
    raise _build.KernelError(f"{NAME}: unsupported device {q.device}")


class _FlashAttention(torch.autograd.Function):
    """K1 forward with its LSE, K6 backward (JAX ``_flash_attention_bhsd``'s
    custom VJP); their struct instances with ``chunk_tokens > 0``."""

    @staticmethod
    def forward(ctx, q, k, v, scale, causal, kv_valid, chunk_tokens,
                tf_clean_len):
        kw = dict(scale=scale, causal=causal, kv_valid=kv_valid,
                  chunk_tokens=chunk_tokens, tf_clean_len=tf_clean_len)
        if q.is_cuda:
            # refuse what K6 cannot take before the forward runs
            check_bwd_operands(NAME_BWD_STRUCT_DQ if chunk_tokens > 0 else
                               NAME_BWD_DQ, q, k, v)
        out, lse = _flash_attention_fwd(q, k, v, **kw)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.kw = kw
        ctx.mark_non_differentiable(lse)
        return out, lse

    @staticmethod
    def backward(ctx, do, _dlse):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, out, lse, do, **ctx.kw)
        return dq, dk, dv, None, None, None, None, None


def _flash_attention_kv_mask_cuda(q, k, v, kv_mask, *, scale):
    _build.refuse_grad(
        NAME_KV_MASK, q, k, v,
        use="flash_attention over the valid keys gathered into one tensor "
        "(models/dits/causal_wan.py:context_attention)")
    dtype = _check_cuda_operands(NAME_KV_MASK, q, k, v)
    if kv_mask.shape != (k.shape[1],) or kv_mask.device != q.device:
        raise _build.KernelError(
            f"{NAME_KV_MASK}: kv_mask must be [{k.shape[1]}] on {q.device}, "
            f"got {tuple(kv_mask.shape)} on {kv_mask.device}")
    mask = (kv_mask if kv_mask.dtype == torch.bool else kv_mask != 0)
    mask = mask.contiguous()  # one byte a key, 0 or 1
    q, k, v = attn_operand(q), attn_operand(k), attn_operand(v)
    b, sq, h, d = q.shape
    out = torch.empty((b, sq, h, d), dtype=q.dtype, device=q.device)
    # no LSE: the JAX function returns none (a null pointer skips it)
    _build.launch(NAME_KV_MASK, "fvt_flash_fwd_kv_mask", q.data_ptr(),
                  k.data_ptr(), v.data_ptr(), out.data_ptr(), None,
                  mask.data_ptr(), dtype, b, h, sq, k.shape[1], d, *bhs(q),
                  *bhs(k), *bhs(v), *bhs(out), float(scale),
                  _build.stream_ptr(q))
    return out


def flash_attention_kv_mask(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, kv_mask: torch.Tensor, *,
                            scale: float | None = None) -> torch.Tensor:
    """K5: flash attention over ``[B, S, H, D]`` tensors where key j is
    visible to every query where ``kv_mask[j] != 0`` (``kv_mask`` [S_kv],
    bool or 0/1, its values free to change between calls). Forward only,
    as in the JAX package."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    if q.is_cuda:
        return _flash_attention_kv_mask_cuda(q, k, v, kv_mask, scale=scale)
    if q.device.type == "cpu":
        return flash_attention_kv_mask_plain(q, k, v, kv_mask, scale=scale)
    raise _build.KernelError(f"{NAME_KV_MASK}: unsupported device {q.device}")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    scale: float | None = None, causal: bool = False,
                    kv_valid: int | None = None, return_lse: bool = False,
                    chunk_tokens: int = 0, tf_clean_len: int = 0):
    """Flash attention over ``[B, S, H, D]`` tensors (same layout out).

    ``kv_valid``: keys at index >= this are masked (default: all).
    ``chunk_tokens`` > 0: the chunk-causal mask at this chunk size in place
    of ``causal``; with ``tf_clean_len`` > 0 the teacher-forcing
    ``[clean | noisy]`` mask (sequence length 2 * ``tf_clean_len``).
    With ``return_lse`` also returns the fp32 log-sum-exp ``[B, H, Sq]``.
    Differentiable in q, k and v (K6 backward on CUDA, bf16 only).
    """
    check_struct(chunk_tokens, tf_clean_len)
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    if kv_valid is None:
        kv_valid = k.shape[1]
    kw = dict(scale=scale, causal=causal, kv_valid=int(kv_valid),
              chunk_tokens=int(chunk_tokens), tf_clean_len=int(tf_clean_len))
    if _build.needs_grad(q, k, v):
        out, lse = _FlashAttention.apply(q, k, v, *kw.values())
    else:
        out, lse = _flash_attention_fwd(q, k, v, **kw)
    return (out, lse) if return_lse else out
