"""Time the port's sparse attention kernels K2, K7 fwd, K8, K7 bwd, K9a
and K9b at their main-path shapes, on one card, for the checkout at --root:

    python3 scripts/torch_sparse_instance_times.py --root DIR [--reps N]

Each row is one call of the public wrapper on bf16 tensors made from a
seed, timed with CUDA events over N calls after a warm-up:

- K2 (``k2_fastwan``): the VSA forward on full tiles at the FastWan main
  path's q/k/v [1,12,32760,128], 117 tiles of 280 rows, a random top-24
  per group of 3 tiles (4b, 4e); where the checkout has K2's Hopper key
  walks, also the same call walking each tile in 64-row units
  (``k2_fastwan_tiles``, the rows cut alone) beside the key stream (the
  rule's choice at E 280: both cuts); and, in every checkout, the same
  function through K8 on the indices expanded per tile with full valid
  counts (``k2_fastwan_as_k8``: K8's walk, neither cut);
- K7 fwd (the padded forward with its LSE, and the lists the wrapper
  builds) and K7 bwd (dQ and dK/dV with delta = rowsum(dO * O) and the
  lists the wrapper builds): the SFT self-attention q/k/v/dO
  [1,12,32760,128], 117 exact tiles of 280 rows, a top-24 chosen per group
  of 3 query tiles and expanded per tile (4i); and the 480x848 padded grid
  [1,12,43008,128], 168 tiles of 256 with their valid counts, top-34 (the
  VSA step of 4c);
- K8 (the padded forward without LSE): STA's (3, 3, 3)-tile windows on
  that grid (4d), and SLA at q/k/v [1,12,24960,128], 390 tiles of 64, top
  10 % of sla_block_map's blocks (4f); with the lists alone where the
  checkout builds them (``k8_sla_lists``);
- K9a: q/k/v [1,12,24960,128] (390 tiles of 64) under the NABLA mask
  nabla_block_mask builds from the seeded q/k at thr 0.9 (4k), and under a
  mask whose per-row counts run 1..390;
- K9b: the 480x848 grid as BSA_ATTN builds it: 32 pruned queries of each
  of 672 tiles, q [1,12,21504,128] over k/v [1,12,43008,128] under
  select_kv_blocks at 0.9 (4j);
- where the checkout has them (ops/sparse_schedule.py), the host-side
  pieces the Hopper wrappers add, alone: K7 bwd's transposed lists and
  launch order, and K9's grouped lists, at the shapes above; and K7 bwd's
  delta = rowsum(dO * O), which both schedules compute;
- controls this comparison does not change: K6 at the SFT cross-attention
  (q/dO [1,32760,12,128] over 512 keys, with delta) and K1 struct at
  dfsft's chunk-causal mask ([1,32760,12,128], 4,680-token chunks).

Prints one JSON line: the card and power limit, and each row's ms. Run it
for two checkouts in turns (A, B, B, A) inside one call to compare them on
one card, e.g. with the parent under build/parent:

    for r in build/parent . . build/parent; do
        python3 scripts/torch_sparse_instance_times.py --root $r; done
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys


def events_ms(fn, reps: int) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--root", required=True,
                        help="checkout whose fastvideo_tpu_torch to time")
    parser.add_argument("--reps", type=int, default=5,
                        help="calls a row")
    args = parser.parse_args()
    sys.path.insert(0, os.path.abspath(args.root))
    import torch

    from fastvideo_tpu_torch.ops import bsa, nabla, sla, sta, vsa
    from fastvideo_tpu_torch.ops import flash_attention as fa
    try:
        from fastvideo_tpu_torch.ops import sparse_schedule as ss
    except ImportError:  # a checkout before the Hopper sparse schedule
        ss = None

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(14)
    h, d, bf = 12, 128, torch.bfloat16
    scale = d**-0.5
    ms = {}

    def rnd(*shape):
        return torch.randn(*shape, generator=g, device=dev, dtype=bf)

    # K2
    e, nb, q_group, topk = 280, 117, 3, 24
    q, k, v = (rnd(1, h, nb * e, d) for _ in range(3))
    idx = torch.rand(1, h, nb // q_group, nb, generator=g,
                     device=dev).topk(topk, dim=-1).indices.int()
    kw = dict(scale=scale, tile_elems=e)
    ms["k2_fastwan"] = events_ms(lambda: vsa.block_sparse_attention_fast(
        q, k, v, idx, **kw), args.reps)
    if ss is not None and hasattr(ss, "fast_key_walk"):
        ms["k2_fastwan_tiles"] = events_ms(
            lambda: vsa._block_sparse_attention_cuda(q, k, v, idx, scale, e,
                                                     walk="tiles"),
            args.reps)
    per_tile = idx.repeat_interleave(q_group, dim=2)
    full = torch.full((nb,), e, dtype=torch.int32, device=dev)
    ms["k2_fastwan_as_k8"] = events_ms(lambda: vsa.block_sparse_attention(
        q, k, v, per_tile, full, **kw), args.reps)
    del q, k, v
    torch.cuda.empty_cache()

    # K7 bwd
    for label, e, nb, topk, q_group, grid in (
            ("k7_bwd_sft", 280, 117, 24, 3, None),
            ("k7_bwd_padded_848", 256, 168, 34, 1, (21, 30, 53))):
        if grid is None:
            sizes = torch.full((nb,), e, dtype=torch.int32, device=dev)
        else:
            sizes = torch.as_tensor(vsa.tile_layout(grid, (4, 8, 8))[2],
                                    device=dev)
        valid = (torch.arange(nb * e, device=dev) % e) < \
            sizes.repeat_interleave(e)
        q, k, v, do = (rnd(1, h, nb * e, d) * valid[:, None]
                       for _ in range(4))
        idx = torch.rand(1, h, nb // q_group, nb, generator=g,
                         device=dev).topk(topk, dim=-1).indices
        idx = idx.repeat_interleave(q_group, dim=2).int()
        kw = dict(scale=scale, tile_elems=e)
        out, lse = vsa.block_sparse_attention(q, k, v, idx, sizes,
                                              return_lse=True, **kw)
        ms[label.replace("bwd", "fwd")] = events_ms(
            lambda: vsa.block_sparse_attention(q, k, v, idx, sizes,
                                               return_lse=True, **kw),
            args.reps)
        ms[label] = events_ms(lambda: vsa.block_sparse_attention_bwd(
            q, k, v, idx, sizes, out, lse, do, **kw), args.reps)
        if grid is None:
            ms["k7_bwd_sft_delta"] = events_ms(lambda: (
                do.float() * out.float()).sum(dim=-1).contiguous(), args.reps)
            if ss is not None:
                ms["k7_bwd_sft_lists"] = events_ms(lambda: ss.heaviest_first(
                    ss.transposed_lists(idx, nb)[1]), args.reps)
        if grid is not None:  # K8: STA's windows on the same grid
            widx = torch.as_tensor(sta.sta_window_indices(
                grid, (4, 8, 8), ((3, 3, 3),) * h), device=dev)[None]
            ms["k8_sta_848"] = events_ms(lambda: vsa.block_sparse_attention(
                q, k, v, widx, sizes, **kw), args.reps)
        del q, k, v, do, out, lse
        torch.cuda.empty_cache()

    # K8 at SLA's shape
    s, nb = 24960, 390
    q, k, v = (rnd(1, h, s, d) for _ in range(3))
    lut, _ = sla.sla_block_map(q, k, 0.1)
    full = torch.full((nb,), 64, dtype=torch.int32, device=dev)
    ms["k8_sla"] = events_ms(lambda: vsa.block_sparse_attention(
        q, k, v, lut, full, scale=scale), args.reps)
    if ss is not None and hasattr(ss, "padded_lists"):
        ms["k8_sla_lists"] = events_ms(lambda: ss.heaviest_first(
            ss.padded_lists(lut.int(), nb, 64)[3]), args.reps)
    del q, k, v
    torch.cuda.empty_cache()

    # K9a
    s, nb = 24960, 390
    q, k, v = (rnd(1, s, h, d) for _ in range(3))
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    sizes = torch.full((nb,), 64, dtype=torch.int32, device=dev)
    row = torch.arange(nb, device=dev)
    counts = (row[None, :] + 37 * torch.arange(h, device=dev)[:, None]) % nb
    ranks = torch.rand(1, h, nb, nb, generator=g, device=dev).argsort(
        -1).argsort(-1)
    for label, mask in (("k9a_nabla", nabla.nabla_block_mask(q, k, None,
                                                              0.9)),
                        ("k9a_ramp", ranks < (counts + 1)[None, :, :, None])):
        idx, cnt = nabla.mask_indices(mask)
        ms[label] = events_ms(lambda: nabla.dyn_sparse_attention(
            qt, kt, vt, idx, cnt, sizes, scale=scale), args.reps)
        if ss is not None:
            ms[label + "_lists"] = events_ms(lambda: ss.heaviest_first(
                ss.grouped_lists(idx, cnt, nb, 64)[1]), args.reps)
    del q, k, v, qt, kt, vt
    torch.cuda.empty_cache()

    # K9b
    grid = (21, 30, 53)
    q, k, v = (vsa.tile_tokens(rnd(1, grid[0] * grid[1] * grid[2], h, d),
                               grid) for _ in range(3))
    n = q.shape[1] // 64
    qb = q.transpose(1, 2).reshape(1, h, n, 64, d)
    kb = k.transpose(1, 2).reshape(1, h, n, 64, d)
    sparse_q, _, keep = bsa.prune_queries(qb, 0.5)
    mask = bsa.select_kv_blocks(sparse_q, kb, 0.9, 1)
    qs = sparse_q.reshape(1, h, n * keep, d)
    kbt, vt = kb.reshape(1, h, n * 64, d), v.transpose(1, 2)
    sizes = torch.full((n,), 64, dtype=torch.int32, device=dev)
    idx, cnt = nabla.mask_indices(mask)
    ms["k9b_bsa"] = events_ms(lambda: nabla.dyn_sparse_attention(
        qs, kbt, vt, idx, cnt, sizes, scale=scale, q_rows=keep), args.reps)
    if ss is not None:
        ms["k9b_bsa_lists"] = events_ms(lambda: ss.heaviest_first(
            ss.grouped_lists(idx, cnt, n, keep)[1]), args.reps)
    del q, k, v, qb, kb, sparse_q, qs, kbt, vt
    torch.cuda.empty_cache()

    # controls
    q, do = rnd(1, 32760, h, d), rnd(1, 32760, h, d)
    kv = rnd(1, 512, h, d), rnd(1, 512, h, d)
    kw = dict(scale=scale, causal=False, kv_valid=512)
    out, lse = fa.flash_attention(q, *kv, return_lse=True, **kw)
    ms["k6_cross_attn_bwd_control"] = events_ms(
        lambda: fa.flash_attention_bwd(q, *kv, out, lse, do, **kw), args.reps)
    k, v = rnd(1, 32760, h, d), rnd(1, 32760, h, d)
    ms["k1_struct_dfsft_control"] = events_ms(lambda: fa.flash_attention(
        q, k, v, scale=scale, kv_valid=32760, chunk_tokens=3 * 30 * 52,
        tf_clean_len=0), args.reps)

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(json.dumps({"root": args.root, "card": card, "ms": ms}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
