"""Time what the column-sliced K1's steps cost, on one card (an ablation of
the schedule's exchange and products):

    python3 scripts/torch_cols_exchange_cost.py --root DIR [--work DIR]

K1 at the Wan2.2 VAE's heads of 640 and 1024
(``fastvideo_tpu_torch/csrc/flash_fwd_cols_sm90.cuh``) sums each step's
partial scores over its cluster in ``cols_sum_s``: the two warpgroups of a
CTA through shared memory, then the CTAs through distributed shared
memory. This script copies DIR's ``fastvideo_tpu_torch`` into --work
(default DIR/build/cols_exchange) once per variant: as it is ("full"),
with the cluster step cut out of ``cols_sum_s`` ("local": each CTA keeps
its own sum), with the whole exchange cut out ("none": each warpgroup keeps
its own partial), with the score products cut out ("no_s": the wgmma of S
left out, its registers kept live) and with the P V products cut out
("no_pv"). It builds each and times K1, q, k and v column views of one qkv
tensor, at the decoder's 4-frame chunk [4,3520,1,1024] (bf16) and first
chunk [1,3520,1,1024], and at the encoder's first frame [1,3520,1,640]
(fp32), with CUDA events over --reps launches after a warm-up. The cut
variants compute wrong outputs and only their times are read: full -
local is the cluster exchange's cost, local - none the local one's, full -
no_s and full - no_pv what the products add on the critical path.

Prints one JSON line: the card and power limit, and each variant's ms.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys

# each cut variant's substitutions in flash_fwd_cols_sm90.cuh: (text, its
# replacement, how many times the text occurs)
_S_BF16 = ("cols_ss_n32(s, desc_k(sq, kColsBQ, 0, kx), desc_k(ks, BK, 0, kx), "
           "kk > 0);")
_PV_BF16 = "cols_rs<DW>(o, pf[kk], desc(vs + kk * 2048, BK * 128, 1024), 1);"
_LOCAL = "  // this CTA's sum into its slot C - 1 - d of the CTA d ranks on"
_MINE = "  float4* mine = lslot + (2 * buf + wg) * kColsSlotF4;"
CUTS = {
    "full": [],
    "local": [(_LOCAL, "  return;\n" + _LOCAL, 1)],
    "none": [(_MINE, "  return;\n" + _MINE, 1)],
    "no_s": [(_S_BF16, "fence_regs(s);", 1),
             ("cols_tf32_n32(s, lo[g], db, (first && g == 0) ? 0 : 1);",
              "fence_regs(s);", 1),
             ("cols_tf32_n32(s, hi[g], db, 1);", "fence_regs(s);", 2)],
    "no_pv": [(_PV_BF16, "fence_regs(o);", 1),
              ("cols_tf32<DW>(o, ph[kk], desc(v_lo + kk * 32, 16, 1024), 1);",
               "fence_regs(o);", 1),
              ("cols_tf32<DW>(o, pl[kk], db, 1);", "fence_regs(o);", 1),
              ("cols_tf32<DW>(o, ph[kk], db, 1);", "fence_regs(o);", 1)],
}
CASES = (("dec_chunk_bf16", 4, 3520, 1024, "bfloat16"),
         ("dec_first_bf16", 1, 3520, 1024, "bfloat16"),
         ("enc_ti2v_fp32", 1, 3520, 640, "float32"))


def child(root: str, reps: int) -> int:
    sys.path.insert(0, root)
    import torch

    from fastvideo_tpu_torch.ops import flash_attention as fa

    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(21)
    ms = {}
    for label, b, s, d, dtype in CASES:
        qkv = torch.randn(b, s, 1, 3 * d, generator=g, device=dev,
                          dtype=getattr(torch, dtype))
        q, k, v = qkv[..., :d], qkv[..., d:2 * d], qkv[..., 2 * d:]
        fa.flash_attention(q, k, v)
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fa.flash_attention(q, k, v)
        end.record()
        torch.cuda.synchronize()
        ms[label] = start.elapsed_time(end) / reps
    print(json.dumps(ms))
    return 0


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--root", required=True,
                        help="checkout whose fastvideo_tpu_torch to time")
    parser.add_argument("--work", default=None,
                        help="where the variants are copied and built")
    parser.add_argument("--reps", type=int, default=10)
    parser.add_argument("--child", default=None, help=argparse.SUPPRESS)
    args = parser.parse_args()
    if args.child:
        return child(args.child, args.reps)
    root = os.path.abspath(args.root)
    work = os.path.abspath(args.work or os.path.join(root, "build",
                                                     "cols_exchange"))
    out = {}
    for name, cut in CUTS.items():
        dst = os.path.join(work, name)
        shutil.rmtree(dst, ignore_errors=True)
        shutil.copytree(os.path.join(root, "fastvideo_tpu_torch"),
                        os.path.join(dst, "fastvideo_tpu_torch"),
                        ignore=shutil.ignore_patterns("__pycache__"))
        path = os.path.join(dst, "fastvideo_tpu_torch", "csrc",
                            "flash_fwd_cols_sm90.cuh")
        with open(path) as fh:
            src = fh.read()
        for old, new, count in cut:
            if src.count(old) != count:
                raise SystemExit(f"{name}: the source no longer has {old!r} "
                                 f"{count} time(s)")
            src = src.replace(old, new)
        with open(path, "w") as fh:
            fh.write(src)
        run = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--root", root,
             "--reps", str(args.reps), "--child", dst],
            capture_output=True, text=True)
        if run.returncode != 0:
            raise SystemExit(f"{name}: {run.stderr[-4000:]}")
        out[name] = json.loads(run.stdout.strip().splitlines()[-1])
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(json.dumps({"root": args.root, "card": card, "ms": out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
