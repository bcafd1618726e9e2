"""The Wan2.2 slice alone on one card, from chip_smoke.py's own functions:

    python3 scripts/torch_wan22_card.py             # every phase
    python3 scripts/torch_wan22_card.py 3 4a        # some of them
    python3 scripts/torch_wan22_card.py 4z --profile DIR

It builds the kernels, then runs phase 3's checks of this slice (K1's
column-sliced form at the Wan2.2 VAE's attention shapes, heads of 640 and
1024 in bf16 and fp32, and K3 at every distinct conv shape of the Wan2.2
VAE at 704x1280, each against its plain version with its times and bound),
4a's tiny TI2V, Lucy Edit and T2V-A14B generations card against CPU, and
4z / 4za: a base checkpoint (UMT5 at full width, the Wan2.1 VAE; a tiny
DiT, which they do not read) under build/wan22_card, then the TI2V-5B and
T2V-A14B generations as chip_smoke.py runs them, with their checks. A
failed phase prints its traceback and the next one runs; the exit code is
1 if any failed. With ``--profile DIR`` 4z and 4za each add one generation
under torch.profiler (device time by kernel, busy share; a Chrome trace in
DIR, which is large).
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

PHASES = ("3", "4a", "4z", "4za")


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("phases", nargs="*", choices=PHASES,
                        help="the phases to run (default: all)")
    parser.add_argument("--profile", metavar="DIR",
                        help="profile one more generation of 4z and 4za")
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
    work = os.path.join(ROOT, "build", "wan22_card")
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
    run("3", cs.check_vae22_attn, dev, results)
    run("3", cs.check_vae22_convs, dev, results)
    run("4a", cs.check_small_wan22, work)
    if want & {"4z", "4za"}:
        os.environ["FASTVIDEO_ATTENTION_BACKEND"] = "FLASH_ATTN"
        cs.write_checkpoint(
            os.path.join(work, "FastWan2.1-T2V-1.3B-Diffusers"),
            cs.TINY_DIT_CFG, cs.VAE_CFG, cs.T5_CFG, seed=42)
    ti2v = run("4z", cs.run_ti2v, work, args.profile)
    a14b = run("4za", cs.run_a14b, work, args.profile)
    shutil.rmtree(work, ignore_errors=True)
    print(json.dumps({
        "phase3": results,
        "ti2v": ti2v and {k: ti2v[k] for k in (
            "launches", "step_s", "encode_s", "decode_s", "peak_gib")},
        "a14b": a14b and {k: a14b[k] for k in (
            "launches", "step_s", "peak_gib", "expert_passes")}}),
        flush=True)
    print(f"done [{time.perf_counter() - t0:.0f} s]; failed: {failed}",
          flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
