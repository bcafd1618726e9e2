"""The preprocess slice alone on one card, from chip_smoke.py's own
functions:

    python3 scripts/torch_preprocess_card.py          # 4a and 4y
    python3 scripts/torch_preprocess_card.py 4y       # one of them

It builds the kernels, then runs 4a's tiny preprocess checks (the port's
``main.py preprocess`` on tiny checkpoints, T2V, I2V and ODE, card against
CPU) and 4y: the checkpoints that 4y reads in a whole chip_smoke.py run,
written under build/preprocess_card (4b's VAE and UMT5 at full width
beside a tiny DiT, 4j's Wan2.1-T2V-1.3B DiT as the ODE teacher, 4x's CLIP
ViT-H/14 beside a tiny I2V DiT, which preprocessing does not read), then
chip_smoke.run_preprocess with its checks. A failed phase prints its
traceback and the next one runs; the exit code is 1 if any failed.
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

PHASES = ("4a", "4y")


def write_checkpoints(cs, work: str) -> None:
    """What 4y reads from 4b, 4j and 4x, with their seeds."""
    os.environ["FASTVIDEO_ATTENTION_BACKEND"] = "FLASH_ATTN"
    base = cs.write_checkpoint(
        os.path.join(work, "FastWan2.1-T2V-1.3B-Diffusers"),
        cs.TINY_DIT_CFG, cs.VAE_CFG, cs.T5_CFG, seed=42)
    cs.write_checkpoint(
        os.path.join(work, "BSA_ATTN", "Wan2.1-T2V-1.3B-Diffusers"),
        cs.DIT_CFG, cs.VAE_CFG, cs.T5_CFG, seed=43, share=base)
    cs.write_checkpoint(
        os.path.join(work, "Wan2.1-I2V-14B-480P-Diffusers"),
        cs.TINY_I2V_DIT_CFG, cs.VAE_CFG, cs.T5_CFG, seed=44, share=base,
        class_name="WanImageToVideoPipeline",
        image_encoder_cfg=cs.CLIP_H_CFG)


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("phases", nargs="*", choices=PHASES,
                        help="the phases to run (default: all)")
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
    work = os.path.join(ROOT, "build", "preprocess_card")
    shutil.rmtree(work, ignore_errors=True)
    want = set(args.phases or PHASES)
    failed = []

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

    run("4a", cs.check_small_preprocess, work)
    if "4y" in want:
        t1 = time.perf_counter()
        write_checkpoints(cs, work)
        print(f"checkpoints written in {time.perf_counter() - t1:.1f} s",
              flush=True)
    report = run("4y", cs.run_preprocess, work)
    shutil.rmtree(work, ignore_errors=True)
    print(json.dumps({"preprocess": report}), flush=True)
    print(f"done [{time.perf_counter() - t0:.0f} s]; failed: {failed}",
          flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
