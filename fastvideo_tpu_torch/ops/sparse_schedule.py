"""Host side of the sparse kernels' schedules (K7 bwd, K9a, K9b, the
padded forward K8 with its LSE mode K7 fwd, and the VSA forward on full
tiles K2).

Each sparse kernel has two schedules, chosen by dtype and head alone
(``sparse_schedule``; the CUDA sources apply the same rule): bf16 with a
head of 64 or 128, every DiT launch, runs the Hopper schedule
(``csrc/vsa_sparse_bwd_sm90.cuh``,
``csrc/dyn_sparse_fwd_sm90.cuh``, which the padded forward shares: wgmma,
registers, a TMA ring, walking a list of tiles in 64-row units); other
heads run the first one (``csrc/attn_bwd_tile.cuh``,
``csrc/attn_tile.cuh``). The kernels take bf16 only, so fp32 never reaches
either.

The lists the Hopper schedule walks are built here, in plain PyTorch on
the device, as the JAX package builds its index tables in XLA:

- :func:`transposed_lists`: K7 bwd's dK/dV (both schedules) walks, per key
  tile, the ascending query tiles that selected it (the transpose of the
  top-k indices, JAX's membership matrix ``vsa.py:933-942`` as lists);
- :func:`grouped_lists`: K9 runs ``group`` query tiles in one block of 128
  rows (two 64-row tiles of K9a, four 32-row tiles of K9b), which walk the
  ascending union of their lists; a per-entry bit set says which of the
  group's tiles keep it, and each row masks the tiles its own does not;
  K8 / K7 fwd walk each query tile's top-k row as it is, or, for tiles
  under 64 rows, such unions, in the blocks :func:`padded_walk` gives;
- :func:`heaviest_first`: the launch order, longest walks first.

K2 walks each query group's top-k row as it is (every slot valid, all
rows of one length, so no list is built and the blocks run in order):
its blocks tile the group's rows back to back (:func:`fast_blocks`), and
its keys are one stream of 8-row boxes or per-tile units
(:func:`fast_key_walk`).
"""

from __future__ import annotations

import torch

from fastvideo_tpu_torch.ops.flash_attention import flash_bwd_schedule

# rows of a tile a list walk takes at a time (csrc/sm90.cuh: kUnit)
UNIT_ROWS = 64
# rows a block owns: two warpgroups of 64 (kBwdOwn, kDynBQ)
BLOCK_ROWS = 128
# the most query tiles one K9 block groups (32-bit masks of 8-row tiles)
MAX_GROUP = 16
# rows of the small boxes K2's key stream assembles a unit from where it
# crosses a tile's end (csrc/dyn_sparse_fwd_sm90.cuh: the {64, 8} maps)
STREAM_BOX_ROWS = 8
# K2's key walks, by the code its C entry takes
FAST_WALKS = ("tiles", "stream")



def sparse_schedule(dtype: torch.dtype, d: int) -> str:
    """The schedule a sparse kernel (K2, K7 bwd, K8 / K7 fwd, K9a, K9b)
    runs for operands of (dtype, head d): the flash backward's rule, "sm90"
    for bf16 with a head of 64 or 128, else "tile" (the first schedule;
    the kernels refuse fp32)."""
    return flash_bwd_schedule(d) if dtype == torch.bfloat16 else "tile"


def mask_indices(mask: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """bool [B, H, nQ, nK] -> (int32 [B, H, nQ, nK] kept key-tile ids in
    ascending order, then -1; int32 [B, H, nQ] counts), as the JAX wrapper
    builds them (a stable argsort of ``~mask``)."""
    counts = mask.sum(dim=-1, dtype=torch.int32)
    order = torch.argsort((~mask).to(torch.uint8), dim=-1, stable=True)
    col = torch.arange(mask.shape[-1], device=mask.device)
    idx = torch.where(col < counts[..., None], order, -1)
    return idx.to(torch.int32), counts


def sparse_membership(indices: torch.Tensor, n_tiles: int) -> torch.Tensor:
    """member[b, h, kv_tile, q_tile] = 1 where query tile q_tile selected key
    tile kv_tile (uint8 [B, H, nB, nQ]); ``-1`` slots select nothing. The
    transposed sparsity of dK/dV, built outside the kernel as in JAX
    (vsa.py:934-946)."""
    b, h, nq, _ = indices.shape
    member = torch.zeros((b, h, n_tiles + 1, nq), dtype=torch.uint8,
                         device=indices.device)
    slots = torch.where(indices >= 0, indices, n_tiles).long()
    member.scatter_(2, slots.transpose(2, 3), 1)
    return member[:, :, :n_tiles].contiguous()


def transposed_lists(indices: torch.Tensor, n_tiles: int
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """K7 bwd's dK/dV walk: per key tile the ascending query tiles whose
    top-k ``indices`` [B, H, nQ, K] (-1 slots select nothing) hold it, then
    -1 (int32 [B, H, nB, nQ]), and their number (int32 [B, H, nB])."""
    return mask_indices(sparse_membership(indices, n_tiles).bool())


def heaviest_first(counts: torch.Tensor) -> torch.Tensor:
    """int32 permutation of the flat entries of ``counts`` (the walk length
    of each (batch, head, tile) block), longest first, ties in order."""
    return torch.argsort(counts.reshape(-1), descending=True,
                         stable=True).to(torch.int32)


def query_group(rows: int) -> int:
    """Query tiles of ``rows`` rows that one K9 block of 128 rows runs."""
    return max(1, min(MAX_GROUP, BLOCK_ROWS // rows))


def fast_key_walk(e: int) -> str:
    """K2's key walk for full tiles of ``e`` rows (csrc/vsa_sparse_fwd.cu:
    stream_walk): "stream" where ``e`` is a multiple of 8 (the group's K
    tiles back to back, K e keys in 64-key units: one 64-row box inside a
    tile, eight 8-row boxes across a tile's end, so only the stream's last
    unit is ragged), else "tiles" (each tile in 64-row units, reading zeros
    past e, as K8 walks). A schedule choice, not a fallback: both compute
    the same function."""
    return "stream" if e % STREAM_BOX_ROWS == 0 else "tiles"


def fast_blocks(e: int, group_tiles: int) -> int:
    """Blocks of K2's Hopper schedule a query group of ``group_tiles``
    tiles of ``e`` rows takes: its rows tiled back to back by 128-row
    blocks (840 rows: 7 blocks, the last 72 rows deep)."""
    return -(-group_tiles * e // BLOCK_ROWS)


def padded_walk(e: int) -> tuple[int, int]:
    """(warpgroups a block, query tiles a group) of the padded forward's
    Hopper schedule for tiles of ``e`` rows: tiles of more than 64 rows (E
    256, 280) run two warpgroups a 128-row block, one tile each (a tile of
    280 rows is three blocks); tiles of at most 64 rows (SLA's 64) run one
    warpgroup a 64-row block, so that a tile of 64 rows walks its own row
    and not the union with a neighbour's (two 10 % lists of random maps
    walk close to their sum); smaller tiles group as many as fill it."""
    if e > UNIT_ROWS:
        return 2, 1
    return 1, max(1, UNIT_ROWS // e)


def padded_lists(indices: torch.Tensor, n_tiles: int, e: int):
    """The padded forward's Hopper walk over top-k ``indices`` [B, H, nB,
    K] (int32, -1 slots) for tiles of ``e`` rows, in the groups of
    :func:`padded_walk`: (lists, counts, bits, lens). A group of one tile
    walks its row as it is (the kernel skips the -1 slots): lists =
    ``indices``, counts and bits None. Larger groups walk
    :func:`grouped_lists`' unions. ``lens`` [B, H, nG] are the walks' entry
    counts, for :func:`heaviest_first`."""
    group = padded_walk(e)[1]
    if group == 1:
        return indices, None, None, (indices >= 0).sum(dim=-1,
                                                       dtype=torch.int32)
    slots = torch.full(indices.shape[:3], indices.shape[3],
                       dtype=torch.int32, device=indices.device)
    lists, lens, bits, _ = grouped_lists(indices, slots, n_tiles, e,
                                         group=group)
    return lists, lens, bits, lens


def kept_mask(indices: torch.Tensor, counts: torch.Tensor,
              n_k: int) -> torch.Tensor:
    """bool [B, H, nQ, nK]: the key tiles in the first ``counts`` slots of
    each row of ``indices`` [B, H, nQ, slots], -1 slots skipped."""
    slots = indices.shape[-1]
    live = (torch.arange(slots, device=indices.device) <
            counts[..., None].to(indices.device)) & (indices >= 0)
    ids = torch.where(live, indices.long(), n_k)
    sel = torch.zeros((*indices.shape[:-1], n_k + 1), dtype=torch.bool,
                      device=indices.device)
    sel.scatter_(-1, ids, True)
    return sel[..., :n_k]


def grouped_lists(indices: torch.Tensor, counts: torch.Tensor, n_k: int,
                  rows: int, group: int | None = None):
    """K9's (and K8's) Hopper walk: the query tiles in groups of ``group``
    (default ``query_group(rows)``; the last group padded with tiles that
    keep nothing), each group's ascending union of its tiles' kept key
    tiles, then -1 (int32 [B, H, nG, nK]), its length (int32 [B, H, nG]),
    and per entry the bits of the group's tiles that keep it (int32 [B, H,
    nG, nK]; bit t: tile g * group + t; 0 past the length). Returns (list,
    counts, bits, group)."""
    group = query_group(rows) if group is None else group
    mask = kept_mask(indices, counts, n_k)
    b, h, nq, _ = mask.shape
    ng = -(-nq // group)
    if ng * group != nq:
        mask = torch.cat([mask, mask.new_zeros(b, h, ng * group - nq, n_k)],
                         dim=2)
    mask = mask.reshape(b, h, ng, group, n_k)
    weight = torch.tensor([1 << t for t in range(group)], dtype=torch.int32,
                          device=mask.device)
    bits = (mask.to(torch.int32) * weight[:, None]).sum(dim=3,
                                                        dtype=torch.int32)
    u_idx, u_counts = mask_indices(mask.any(dim=3))
    u_bits = torch.where(u_idx >= 0,
                         torch.gather(bits, -1, u_idx.clamp_min(0).long()), 0)
    return u_idx, u_counts, u_bits.to(torch.int32), group
