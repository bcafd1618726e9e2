"""The causal distillation slice alone on one card, from chip_smoke.py's
own functions:

    python3 scripts/torch_causal_distill_card.py              # checks
    python3 scripts/torch_causal_distill_card.py --profile DIR

It builds the kernels, holds K5 over a full clip and the KV-cache grad
route's K1 / K6 against their plain versions (``check_causal_distill``),
runs 4a's tiny self_forcing step card against CPU, writes a CausalWan-1.3B
transformer (``CAUSAL_DIT_CFG``; a tiny VAE and text encoder beside it,
which the trainers do not read) and 4n's shard under build/chip_smoke,
then trains 4o (self_forcing), 4p (streaming_long_tuning) and 4q
(causal_cd) as chip_smoke.py does, with their launch checks. With
``--profile DIR`` it skips the kernel checks and the tiny step, and each
phase adds one step under torch.profiler (device time by kernel, busy
share; Chrome traces in DIR, which are large).
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--profile", metavar="DIR",
                        help="profile one more step of each phase")
    args = parser.parse_args()

    import torch

    import chip_smoke as cs
    from fastvideo_tpu_torch.ops import _build

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    t0 = time.perf_counter()

    def done(what: str) -> None:
        print(f"[{time.perf_counter() - t0:.0f} s] {what}", flush=True)

    print(cs.card_line(), flush=True)
    _build.build_all()
    done(f"kernels built in {_build.BUILD_SECONDS:.1f} s")
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    work = os.path.join(ROOT, "build", "chip_smoke")
    shutil.rmtree(work, ignore_errors=True)
    results = {k: {"max_abs_err": 0.0} for k in (
        "flash_fwd_kv_mask", "flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")}
    if not args.profile:
        cs.check_causal_distill(dev, results)
        done("phase 3's causal distillation shapes")
        cs.check_small_self_forcing(work)
        done("4a's tiny self_forcing step")
    os.environ["FASTVIDEO_ATTENTION_BACKEND"] = "FLASH_ATTN"
    cs.write_checkpoint(cs.causal_ckpt(work), cs.CAUSAL_DIT_CFG,
                        cs.TINY_VAE_CFG, cs.TINY_T5_CFG, seed=45,
                        dit_class="CausalWanTransformer3DModel")
    data, _ = cs.write_dmd2_data(work)
    done("checkpoint and shard written")
    ends = {}
    ends["self_forcing"] = cs.run_self_forcing(work, data, args.profile)
    done("4o")
    ends["streaming"] = cs.run_streaming_long(work, data, args.profile)
    done("4p")
    ends["causal_cd"] = cs.run_causal_cd(work, data, args.profile)
    done("4q")
    shutil.rmtree(work, ignore_errors=True)
    print(json.dumps({"card": cs.card_line(), "kernels": results, "ends": {
        k: {"step_s": r["step_s"], "step_times": r["step_times"],
            "step_states": r["step_states"], "peak_gib": r["peak_gib"],
            "launches": {
                n: c for n, c in r["launches"].items() if c}}
        for k, r in ends.items()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
