"""End-to-end seconds of chip_smoke.py's full-width serving paths, on one
card, for the checkout at --root:

    python3 scripts/torch_path_ends.py --root DIR

It runs that checkout's own ``chip_smoke.py`` path functions in one
process, in this order: 4b (FastWan 81x480x832, a warm-up then a timed
generation), 4f (TurboDiffusion 61x480x832), 4k (Wan2.1 with NABLA_ATTN
at 61x480x832), 4g (the causal Wan through ``VideoGenerator``) and 4h
(the 8-block stream on 4g's modules), each writing its random-weight
checkpoint under DIR/build/path_ends; 4f, 4k and 4g time their first
generation in the process, as chip_smoke.py does. It reads each path's
generation seconds, stage seconds, 4b's fp32 decode seconds (where the
checkout runs one) and 4h's steady block seconds from the lines the path
prints, and prints one JSON line with the card and power
limit. Run it for two checkouts in turns (A, B, B, A) inside one call to
compare their ends on one card, e.g. with the parent's whole tree under
build/parent:

    for r in build/parent . . build/parent; do
        python3 scripts/torch_path_ends.py --root $r; done
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import re
import shutil
import subprocess
import sys


class _Tee(io.TextIOBase):
    """Writes to the real stdout and keeps a copy."""

    def __init__(self, out):
        self.out, self.kept = out, io.StringIO()

    def write(self, s):
        self.kept.write(s)
        return self.out.write(s)

    def flush(self):
        self.out.flush()


def _ends(text: str) -> dict:
    """The generation seconds, stage seconds, fp32 decode seconds (4b, where
    the checkout decodes its clip in fp32 too) and steady block seconds a
    path printed."""
    out = {}
    m = re.search(r"(?<!warm-up )generation ([0-9.]+) s", text)
    if m:
        out["generation_s"] = float(m.group(1))
    m = re.search(r"decoded in fp32: DecodingStage ([0-9.]+) s", text)
    if m:
        out["fp32_decode_s"] = float(m.group(1))
    m = re.search(r"stage seconds (\{.*?\})", text)
    if m:
        out["stage_s"] = json.loads(m.group(1))
    m = re.search(r"steady_block_s ([0-9.]+)", text)
    if m:
        out["steady_block_s"] = float(m.group(1))
    return out


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--root", required=True,
                        help="checkout whose chip_smoke.py and "
                        "fastvideo_tpu_torch to run")
    args = parser.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import torch

    import chip_smoke as cs

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    work = os.path.join(root, "build", "path_ends")
    shutil.rmtree(work, ignore_errors=True)
    with open(os.path.join(root, "benchmarks",
                           "causal_streaming.json")) as fh:
        spec = json.load(fh)

    def run(fn, *a):
        tee = _Tee(sys.stdout)
        with contextlib.redirect_stdout(tee):
            ret = fn(*a)
        return ret, _ends(tee.kept.getvalue())

    ends = {}
    _, ends["4b"] = run(cs.run_main_path, work)
    _, ends["4f"] = run(cs.run_turbo_path, work)
    os.environ.pop("FASTVIDEO_VAE_CONV3D", None)
    _, ends["4k"] = run(lambda: cs.run_wan_path(
        work, "NABLA_ATTN", cs.K9_STEPS, {}, size=cs.TURBO_SIZE,
        kernel="dyn_sparse_fwd"))
    (_, gen), ends["4g"] = run(cs.run_causal_path, work)
    _, ends["4h"] = run(cs.run_streaming, gen, spec)
    shutil.rmtree(work, ignore_errors=True)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(json.dumps({"root": args.root, "card": card, "ends": ends}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
