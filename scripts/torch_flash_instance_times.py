"""Time the port's K1 and K6 kernels (their plain-mask instances) at the
SFT cross-attention shape, q/dO [1, 32760, 12, 128] over k/v [1, 512, 12,
128] bf16, on one card, for the checkout at --root:

    python3 scripts/torch_flash_instance_times.py --root DIR [--reps N]

Prints one JSON line: the card, K1's forward ms (CUDA events over --reps
launches) and K6's dQ and dK/dV ms (torch.profiler device time). Run it
for two checkouts in turns (A, B, B, A) inside one call to compare them
on one card.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--root", required=True,
                        help="checkout whose fastvideo_tpu_torch to time")
    parser.add_argument("--reps", type=int, default=20)
    args = parser.parse_args()
    sys.path.insert(0, os.path.abspath(args.root))
    import torch
    from torch.profiler import ProfilerActivity, profile

    from fastvideo_tpu_torch.ops import flash_attention as fa

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(12)
    b, sq, skv, h, d = 1, 32760, 512, 12, 128
    q, do = (torch.randn(b, sq, h, d, generator=g, device=dev,
                         dtype=torch.bfloat16) for _ in range(2))
    k, v = (torch.randn(b, skv, h, d, generator=g, device=dev,
                        dtype=torch.bfloat16) for _ in range(2))
    kw = dict(scale=d**-0.5, causal=False, kv_valid=skv)
    out, lse = fa.flash_attention(q, k, v, return_lse=True, **kw)
    for _ in range(3):
        fa.flash_attention(q, k, v, **kw)
        fa.flash_attention_bwd(q, k, v, out, lse, do, **kw)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(args.reps):
        fa.flash_attention(q, k, v, **kw)
    end.record()
    torch.cuda.synchronize()
    k1 = start.elapsed_time(end) / args.reps
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(args.reps):
            fa.flash_attention_bwd(q, k, v, out, lse, do, **kw)
        torch.cuda.synchronize()
    bwd = {}
    for label, sub in (("dq", "flash_bwd_dq_kernel"),
                       ("dkv", "flash_bwd_dkv_kernel")):
        bwd[label] = sum(e.self_device_time_total for e in prof.key_averages()
                         if e.device_type == torch.autograd.DeviceType.CUDA
                         and sub in e.key) / args.reps / 1e3
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(json.dumps({"root": args.root, "card": card, "k1_ms": k1,
                      "k6_dq_ms": bwd["dq"], "k6_dkv_ms": bwd["dkv"]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
