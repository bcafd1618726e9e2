"""The LoRA / kd / AnyFlow slice alone on one card, from chip_smoke.py's
own functions:

    python3 scripts/torch_lora_distill_card.py            # every phase
    python3 scripts/torch_lora_distill_card.py 4a 4r      # some of them
    python3 scripts/torch_lora_distill_card.py 4r --profile DIR

It builds the kernels, runs 4a's slice checks (a tiny FastWan with a LoRA
adapter active, merged and unmerged, and one step each of lora_finetune,
kd, anyflow_pretrain and anyflow, card against CPU), writes the 4b
checkpoint and 4n's shard under build/lora_distill_card, then runs 4r (LoRA
serving), 4s (lora_finetune), 4t (kd), 4u (anyflow_pretrain) and 4v
(anyflow) as chip_smoke.py does, with their checks. A failed phase prints
its traceback and the next one runs; the exit code is 1 if any failed.
With ``--profile DIR`` each phase adds a generation or a step under
torch.profiler (device time by kernel, busy share; Chrome traces in DIR,
which are large).
"""

from __future__ import annotations

import argparse
import os
import shutil
import sys
import time
import traceback

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

PHASES = ("4a", "4r", "4s", "4t", "4u", "4v")


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("phases", nargs="*", choices=PHASES,
                        help="the phases to run (default: all)")
    parser.add_argument("--profile", metavar="DIR",
                        help="profile one more generation or step of each "
                        "phase")
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
    work = os.path.join(ROOT, "build", "lora_distill_card")
    shutil.rmtree(work, ignore_errors=True)
    want = set(args.phases or PHASES)
    failed = []

    def run(name, fn, *a):
        if name not in want:
            return
        print(f"## {name} [{time.perf_counter() - t0:.0f} s in]", flush=True)
        try:
            fn(*a)
        except BaseException:  # noqa: BLE001 (SystemExit included)
            traceback.print_exc()
            sys.stdout.flush()
            failed.append(name)

    run("4a", cs.check_small_slice, work)
    data = None
    if want - {"4a"}:
        os.environ["FASTVIDEO_ATTENTION_BACKEND"] = "VIDEO_SPARSE_ATTN"
        cs.write_checkpoint(
            os.path.join(work, "FastWan2.1-T2V-1.3B-Diffusers"), cs.DIT_CFG,
            cs.VAE_CFG, cs.T5_CFG, seed=42)
        data, _ = cs.write_dmd2_data(work)
    run("4r", cs.run_lora_serving, work, args.profile)
    run("4s", cs.run_lora_finetune, work, data, args.profile)
    run("4t", cs.run_kd, work, data, args.profile)
    run("4u", cs.run_anyflow_pretrain, work, data, args.profile)
    run("4v", cs.run_anyflow, work, data, args.profile)
    shutil.rmtree(work, ignore_errors=True)
    print(f"done [{time.perf_counter() - t0:.0f} s]; failed: {failed}",
          flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
