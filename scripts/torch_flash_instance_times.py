"""Time the port's dense flash attention kernels at their main-path shapes,
on one card, for the checkout at --root:

    python3 scripts/torch_flash_instance_times.py --root DIR [--reps N]

Each row is one call of the public wrapper on bf16 [B, S, H, D] tensors
made from a seed, timed with CUDA events over N launches after a warm-up
(the backward rows include delta = rowsum(dO * O) and, where the dK/dV
grid is split, the reduction of its partial sums):

- K1: q [1,32760,12,128] over 512 keys (the DiT cross-attention), 4f's
  q [1,24960,12,128] and one causal block's q [1,4680,12,128];
- K5: q [1,4680,12,128] over the causal stream's 32,760-key window, as
  block 0 (its last 4,680 keys valid), block 3 (18,720) and a full window
  see it;
- K1 struct and the K6 struct backward: dfsft's chunk-causal mask over
  [1,32760,12,128] (4,680-token chunks) and tfsft's teacher-forcing mask
  over [1,65520,12,128] (clean length 32,760);
- the K6 backward at the SFT cross-attention (q/dO as K1's, k/v 512 keys);
- K7 bwd, a kernel this comparison does not change, as a control:
  [1,12,32760,128], 117 tiles of 280, 24 key tiles a query tile;
- K1 at the VAE's mid-block attention, one head of 384 with q, k and v
  column views of one qkv tensor as the VAE passes them: the first decode
  chunk q [1,6240,1,384] (``k1_vae_first``), a 2-frame chunk
  [2,6240,1,384] (``k1_vae_chunk``), a 2-frame chunk at 480x848
  [2,6360,1,384] (``k1_vae_848``), and in fp32 (an fp32 decode's, with the
  3xTF32 schedule's pre-pass and merge where the checkout has them) at the
  first chunk (``k1_vae_first_fp32``) and at a 2-frame chunk
  (``k1_vae_chunk_fp32``).

Prints one JSON line: the card and power limit, and each row's ms. Run it
for two checkouts in turns (A, B, B, A) inside one call to compare them
on one card, e.g. with the parent under build/parent:

    for r in build/parent . . build/parent; do
        python3 scripts/torch_flash_instance_times.py --root $r; done
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

# the causal Wan at 480x832: 30 x 52 tokens a latent frame, 3 a chunk
FRAME = 30 * 52
CHUNK = 3 * FRAME
WINDOW = 21 * FRAME


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
                        help="launches a row (the 65,520-row rows: 2)")
    args = parser.parse_args()
    sys.path.insert(0, os.path.abspath(args.root))
    import torch

    from fastvideo_tpu_torch.ops import flash_attention as fa
    from fastvideo_tpu_torch.ops import vsa

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(12)
    h, d = 12, 128
    scale = d**-0.5
    ms = {}

    def rnd(*shape):
        return torch.randn(*shape, generator=g, device=dev,
                           dtype=torch.bfloat16)

    kv = rnd(1, 512, h, d), rnd(1, 512, h, d)
    for label, sq in (("k1_cross_attn", 32760), ("k1_cross_attn_4f", 24960),
                      ("k1_cross_attn_causal_block", CHUNK)):
        q = rnd(1, sq, h, d)
        ms[label] = events_ms(lambda: fa.flash_attention(q, *kv), args.reps)
    q, do = rnd(1, 32760, h, d), rnd(1, 32760, h, d)
    kw = dict(scale=scale, causal=False, kv_valid=512)
    out, lse = fa.flash_attention(q, *kv, return_lse=True, **kw)
    ms["k6_cross_attn_bwd"] = events_ms(
        lambda: fa.flash_attention_bwd(q, *kv, out, lse, do, **kw), args.reps)
    del kv, q, do, out, lse

    q = rnd(1, CHUNK, h, d)
    k, v = rnd(1, WINDOW, h, d), rnd(1, WINDOW, h, d)
    pos = torch.arange(WINDOW, device=dev)
    for label, valid in (("k5_block0", CHUNK), ("k5_block3", 4 * CHUNK),
                         ("k5_full", WINDOW)):
        mask = pos >= WINDOW - valid
        ms[label] = events_ms(lambda: fa.flash_attention_kv_mask(
            q, k, v, mask, scale=scale), args.reps)
    del q, k, v

    for label, s_len, clean in (("dfsft", WINDOW, 0),
                                ("tfsft", 2 * WINDOW, WINDOW)):
        reps = args.reps if clean == 0 else max(1, min(args.reps, 2))
        q, k, v, do = (rnd(1, s_len, h, d) for _ in range(4))
        kw = dict(scale=scale, kv_valid=s_len, chunk_tokens=CHUNK,
                  tf_clean_len=clean)
        ms[f"k1_struct_{label}"] = events_ms(
            lambda: fa.flash_attention(q, k, v, **kw), reps)
        out, lse = fa.flash_attention(q, k, v, return_lse=True, **kw)
        ms[f"k6_struct_{label}_bwd"] = events_ms(
            lambda: fa.flash_attention_bwd(q, k, v, out, lse, do, **kw), reps)
        del q, k, v, do, out, lse
        torch.cuda.empty_cache()

    e, nb, topk = 280, 117, 24
    q, k, v, do = (torch.randn(1, h, nb * e, d, generator=g, device=dev,
                               dtype=torch.bfloat16) for _ in range(4))
    sizes = torch.full((nb,), e, dtype=torch.int32, device=dev)
    idx = torch.rand(1, h, nb, nb, generator=g, device=dev).topk(
        topk, dim=-1).indices.int()
    kw = dict(scale=scale, tile_elems=e)
    out, lse = vsa.block_sparse_attention(q, k, v, idx, sizes,
                                          return_lse=True, **kw)
    ms["k7_bwd_control"] = events_ms(lambda: vsa.block_sparse_attention_bwd(
        q, k, v, idx, sizes, out, lse, do, **kw), args.reps)

    del q, k, v, do, out, lse
    torch.cuda.empty_cache()
    for label, b, s_len, dtype in (
            ("k1_vae_first", 1, 6240, torch.bfloat16),
            ("k1_vae_chunk", 2, 6240, torch.bfloat16),
            ("k1_vae_848", 2, 6360, torch.bfloat16),
            ("k1_vae_first_fp32", 1, 6240, torch.float32),
            ("k1_vae_chunk_fp32", 2, 6240, torch.float32)):
        qkv = torch.randn(b, s_len, 1, 3 * 384, generator=g, device=dev,
                          dtype=dtype)
        q, k, v = qkv[..., :384], qkv[..., 384:768], qkv[..., 768:]
        ms[label] = events_ms(lambda: fa.flash_attention(q, k, v),
                              args.reps)
        del qkv, q, k, v

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(json.dumps({"root": args.root, "card": card, "ms": ms}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
