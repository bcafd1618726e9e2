"""Time 4z's DecodingStage (the Wan2.2 VAE's bf16 decode of a TI2V-5B
clip, 121x704x1280) on one card, for the checkout at --root, without
writing a checkpoint:

    python3 scripts/torch_wan22_decode_times.py --root DIR [--reps N]

It builds the checkout's Wan2.2 VAE at its chip_smoke.py's TI2V_VAE_CFG
(the TI2V-5B VAE's widths, as 4z writes it) with random weights from a
seed, in bf16 on the card (4z's VAE file and its decode precision), and
runs the checkout's own DecodingStage on a latent of 4z's shape [1, 48, 31,
44, 80] from a seed: one warm-up decode, then --reps timed ones (host clock
around a synchronized forward, as the pipeline's stage times). It decodes
in 4z's chunks (the first latent frame, then 4 at a time: 9 chunks, each
with one K1 at a head of 1024). Prints one JSON line: the card and power
limit, each decode's seconds, and one decode's launches of K1's
column-sliced form and of K3. Run it for two checkouts in turns (A, B, B,
A) inside one call to compare them on one card, e.g. with the parent under
build/parent:

    for r in build/parent . . build/parent; do
        python3 scripts/torch_wan22_decode_times.py --root $r; done
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
import types


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--root", required=True,
                        help="checkout whose fastvideo_tpu_torch to time")
    parser.add_argument("--reps", type=int, default=2,
                        help="timed decodes after the warm-up")
    args = parser.parse_args()
    sys.path.insert(0, os.path.abspath(args.root))
    import torch

    import chip_smoke as cs
    from fastvideo_tpu_torch.configs.models.vaes.wan import WanVAEArchConfig
    from fastvideo_tpu_torch.models.loader.component_loader import (
        _build_arch_config as arch)
    from fastvideo_tpu_torch.models.vaes.wan import AutoencoderKLWan
    from fastvideo_tpu_torch.ops import _build
    from fastvideo_tpu_torch.pipelines.stages.decoding import DecodingStage

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    cfg = arch(WanVAEArchConfig, cs.TI2V_VAE_CFG)
    gen = torch.Generator(device=dev).manual_seed(45)
    state = cs.random_state(AutoencoderKLWan(cfg, device="meta"),
                            torch.bfloat16, dev, gen)
    vae = AutoencoderKLWan(cfg, device=dev, dtype=torch.bfloat16)
    vae.load_state_dict(state)
    del state
    vae.eval()
    stage = DecodingStage(vae, None, device=dev)
    z = torch.randn(1, cs.TI2V_VAE_CFG["z_dim"],
                    *cs.vae22_latent(cs.TI2V_SIZE), generator=gen, device=dev)
    seconds, launches = [], None
    with torch.no_grad():
        for rep in range(args.reps + 1):
            _build.reset_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = stage.forward(types.SimpleNamespace(latents=z), None).output
            torch.cuda.synchronize()
            if rep > 0:
                seconds.append(time.perf_counter() - t0)
            launches = {k: v for k, v in _build.LAUNCHES.items()
                        if k in ("flash_fwd_cols", "conv3d") and v}
            if not torch.isfinite(out.float()).all():
                print("non-finite decode", file=sys.stderr)
                return 1
            del out
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(json.dumps({"root": args.root, "card": card,
                      "decode_s": seconds, "launches": launches}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
