"""The DiffusionNFT / callbacks / "ops" slice alone on one card, from
chip_smoke.py's own functions:

    python3 scripts/torch_rl_card.py             # every phase
    python3 scripts/torch_rl_card.py 4a 4w       # some of them
    python3 scripts/torch_rl_card.py 4w --profile DIR

It builds the kernels, runs 4a's slice checks (a tiny DiffusionNFT outer
step with a tiny CLIP dual tower, a tiny SFT step under "ops" and "full",
a tiny SFT step with the grad_clip and ema callbacks, each card against
CPU where it says so), writes the 4b checkpoint under build/rl_card and its
prompt's UMT5 embedding (as 4b's pipeline encodes it, bf16), then runs 4i's
"ops" step and 4w (diffusion_nft at full width) as chip_smoke.py does, with
their checks. A failed phase prints its traceback and the next one runs;
the exit code is 1 if any failed. With ``--profile DIR`` 4w adds one step
under torch.profiler (device time by kernel, busy share; a Chrome trace in
DIR, which is large).
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

PHASES = ("4a", "4i", "4w")


def write_prompt_embedding(work: str, ckpt: str) -> None:
    """The 4b prompt's UMT5 embedding, as FastWan's TextEncodingStage makes
    it, saved where 4w reads it; the encoder is freed after."""
    import numpy as np
    import torch

    import chip_smoke as cs
    from fastvideo_tpu_torch.configs.pipelines.wan import (
        FastWanT2V480PConfig)
    from fastvideo_tpu_torch.models.loader.component_loader import (
        load_model_component)
    from fastvideo_tpu_torch.models.loader.tokenizer import load_tokenizer
    from fastvideo_tpu_torch.pipelines.stages.text_encoding import (
        TextEncodingStage)

    cfg = FastWanT2V480PConfig()
    dev = torch.device("cuda")
    encoder = load_model_component(
        os.path.join(ckpt, "text_encoder"), device=dev,
        precision=cfg.text_encoder_precisions[0],
        model_config=cfg.text_encoder_configs[0])
    stage = TextEncodingStage([encoder], [load_tokenizer(
        os.path.join(ckpt, "tokenizer"))], cfg.postprocess_text_funcs,
        device=dev)
    with torch.inference_mode():
        emb = stage._encode_one([cs.PROMPT], 0)
    np.save(os.path.join(work, "nft_prompt_embeds.npy"),
            emb.float().cpu().numpy())
    del stage, encoder, emb
    torch.cuda.empty_cache()


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("phases", nargs="*", choices=PHASES,
                        help="the phases to run (default: all)")
    parser.add_argument("--profile", metavar="DIR",
                        help="profile one more 4w step")
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
    work = os.path.join(ROOT, "build", "rl_card")
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

    run("4a", cs.check_small_rl_slice, work)
    if want - {"4a"}:
        os.environ["FASTVIDEO_ATTENTION_BACKEND"] = "VIDEO_SPARSE_ATTN"
        ckpt = cs.write_checkpoint(
            os.path.join(work, "FastWan2.1-T2V-1.3B-Diffusers"), cs.DIT_CFG,
            cs.VAE_CFG, cs.T5_CFG, seed=42)
        if "4w" in want:
            write_prompt_embedding(work, ckpt)
    run("4i", cs.run_ops_step, work)
    run("4w", cs.run_diffusion_nft, work, args.profile)
    shutil.rmtree(work, ignore_errors=True)
    print(f"done [{time.perf_counter() - t0:.0f} s]; failed: {failed}",
          flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
