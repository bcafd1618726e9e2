"""The Wan I2V / V2V slice alone on one card, from chip_smoke.py's own
functions:

    python3 scripts/torch_i2v_card.py             # every phase
    python3 scripts/torch_i2v_card.py 3 4a        # some of them
    python3 scripts/torch_i2v_card.py 4x --profile DIR

It builds the kernels, then runs phase 3's checks of this slice (K3's fp32
form at every conv of the VAE encoder in both kinds of encode chunk, K1 at
the I2V DiT's 40 heads over 32,760, 512 and 257 keys, each against its
plain version with its times and bound), 4a's tiny I2V and V2V generations
card against CPU, and 4x: a base checkpoint (UMT5 at full width, the Wan
VAE with both halves; a tiny DiT, which 4x does not read) under
build/i2v_card, then the I2V generation at the 14B-480P widths as
chip_smoke.py runs it, with its checks. A failed phase prints its
traceback and the next one runs; the exit code is 1 if any failed. With
``--profile DIR`` 4x adds one generation under torch.profiler (device
time by kernel, busy share; a Chrome trace in DIR, which is large).
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import time
import traceback

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

PHASES = ("3", "4a", "4x")


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("phases", nargs="*", choices=PHASES,
                        help="the phases to run (default: all)")
    parser.add_argument("--profile", metavar="DIR",
                        help="profile one more 4x generation")
    args = parser.parse_args()

    import torch

    import chip_smoke as cs
    from fastvideo_tpu_torch.ops import _build

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    t0 = time.perf_counter()
    print(cs.card_line(), flush=True)
    _build.build_all()
    print(f"built in {time.perf_counter() - t0:.1f} s", flush=True)
    dev = torch.device("cuda", 0)
    work = os.path.join(ROOT, "build", "i2v_card")
    shutil.rmtree(work, ignore_errors=True)
    want = set(args.phases or PHASES)
    failed = []
    results = {"conv3d": {}, "flash_fwd": {}}

    def run(name, fn, *a):
        if name not in want:
            return None
        print(f"## {name} [{time.perf_counter() - t0:.0f} s in]", flush=True)
        try:
            return fn(*a)
        except BaseException:  # noqa: BLE001 (SystemExit included)
            traceback.print_exc()
            sys.stdout.flush()
            failed.append(name)
            return None

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    run("3", cs.check_encoder_convs, dev, results)
    run("3", cs.check_i2v_flash, dev, results)
    run("4a", cs.check_small_i2v, work)
    if "4x" in want:
        os.environ["FASTVIDEO_ATTENTION_BACKEND"] = "FLASH_ATTN"
        cs.write_checkpoint(
            os.path.join(work, "FastWan2.1-T2V-1.3B-Diffusers"),
            cs.TINY_DIT_CFG, cs.VAE_CFG, cs.T5_CFG, seed=42)
    i2v = run("4x", cs.run_i2v, work, args.profile)
    shutil.rmtree(work, ignore_errors=True)
    print(json.dumps({"phase3": results,
                      "i2v": i2v and {k: i2v[k] for k in (
                          "launches", "encode", "step_s", "peak_gib",
                          "stage_times")}}), flush=True)
    print(f"done [{time.perf_counter() - t0:.0f} s]; failed: {failed}",
          flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
