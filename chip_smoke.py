"""Smoke test of the PyTorch/CUDA port on one NVIDIA H100.

    python3 chip_smoke.py                     # all phases, one card
    python3 chip_smoke.py --profile DIR       # plus a profiled generation
                                              # of each path and train step
    python3 chip_smoke.py --flex-struct       # plus compiled flex_attention
                                              # beside K1 / K6 struct

Phases, each printing its own lines:
  1. environment: torch/CUDA versions and the card's name and power limit;
  2. kernel build: nvcc for sm_90a from fastvideo_tpu_torch/csrc, and
     the registers, spills, shared memory and ptxas warnings of each
     Hopper instance of the flash, sparse and conv kernels (from -Xptxas
     -v; a spill at a head of 128, in a wide K1 instance (head 384), in a
     K3 instance of 96 or 128 output channels (bf16 or 3xTF32) or in a K4
     instance fails, and so does a serialized wgmma, C7518 or C7513, in a
     head-of-128 instance of K2, K7 bwd, K9 or K8 / K7 fwd, in a wide K1
     instance or in those conv instances);
  3. kernel checks: each kernel against its plain PyTorch version on the
     card at the main paths' shapes, with kernel, plain, library and bound
     times; each flash, K7 bwd, K9, K8 / K7 fwd and conv case prints the
     schedule it takes (a bf16 case with a head of 128 and every bf16 conv
     must take the Hopper one, and the profiler must name K1's and K6's
     Hopper kernels; K2 also prints its key walk, and K4 must equal its
     plain version bit for bit), and K6's split dK/dV reduction is held
     to its plain version at the cross-attention's scratch shape (the
     padded sparse kernel at its VSA, STA and SLA shapes, with the walked
     fraction of SLA's block map, and in its LSE mode at 4i's E 280 /
     top-24; the decode convs in the dispatched decode's chunks: the first
     latent frame alone, then 2 at a time, and the stream's one frame; K5 at the causal stream's first
     block, fourth block and full window; the fp32 decode's K3, K4 and K1
     forms (K1 at both decode chunks on its 3xTF32 schedule, held to 1e-5
     + 1e-4 |plain|, which one TF32 pass must miss, with its pre-pass and
     its fp32 merge); the backward kernels K6 at the training
     cross-attention and K7 bwd at the training self-attention, 117 exact
     tiles of 280 with a real coarse top-24, and at the 480x848 padded
     shape; K1 at the VAE
     attention's head of 384 (the wide schedule, q/k/v column views of one
     qkv tensor) at the first decode chunk, a 2-frame chunk and 480x848's,
     timed beside its plain version, SDPA (naming its backend) and its
     bound, and its key-split merge flash_fwd_combine against its plain
     version; K3's fp32 form (3xTF32) beside the error one TF32 product
     would leave; the count-driven
     sparse kernels K9a at 4k's NABLA shape, under nabla_block_mask's mask
     and under a ramp of per-row counts 1..390, and K9b at 4j's BSA shape,
     32 pruned queries a tile, under select_kv_blocks' mask; K2, K7 fwd
     and K7 bwd at DMD2's top-117 of 117 tiles, beside SDPA; the causal
     distillation methods' shapes: K5 over a full clip on fresh caches,
     q = k = [1, 32760, 12, 128], and the KV-cache attention's grad route,
     K1 and K6 at the generator's last block, q [1, 4680, 12, 128] over
     32,760 gathered keys, and at a full clip);
  4. a: tiny models, the card's whole path against the CPU's plain path
     (FastWan DMD, also with an fp32 decode; Wan UniPC + CFG with VSA and
     with STA on a padded grid, and on every other self-attention backend:
     BSA, NABLA, TORCH_SDPA, SAGE_ATTN, VMOBA_ATTN, ATTN_QAT_TRAIN;
     TurboDiffusion; the causal Wan with a head of 128, a sink and a window
     of 1,280 keys that evicts; one SFT, dfsft, tfsft and DMD2 step, and
     one self_forcing step of that causal Wan, so that K5 and the grad
     route's K1 and K6 run; the tiny FastWan with a LoRA adapter active,
     merged and unmerged, and one step each of lora_finetune, kd (its
     teacher rollout too), anyflow_pretrain and anyflow; one DiffusionNFT
     outer step with a tiny CLIP dual tower, one SFT step with the
     grad_clip and ema callbacks, and on the card one SFT step under
     selective_checkpointing "ops" against one under "full");
     b: the FastWan main path at full width: a random-weight
     FastWan2.1-T2V-1.3B-shaped diffusers checkpoint written with the
     port's own safetensors writer, loaded by
     VideoGenerator.from_pretrained(VSA_sparsity=0.8) and run by
     generate_video at 81x480x832, seed 42 (warm-up, then timed), then
     the same clip once more with vae_decode_precision="fp32" (every
     decode conv on K3's 3xTF32 form, every VAE attention on K1's: its
     DecodingStage seconds and launches);
     c, d: the Wan2.1-T2V-1.3B multistep path at full width and depth,
     81x480x848 (token grid (21, 30, 53), no exact VSA tile), FlowUniPC
     steps with classifier-free guidance: with VIDEO_SPARSE_ATTN at
     sparsity 0.8 (--vsa-steps, default 4) and with SLIDING_TILE_ATTN
     (--sta-steps, default 2); each with stage times, the kernels' launch
     counts and peak memory;
     e: FastWan int8 serving, the 4b checkpoint loaded with
     text_encoder_quant="int8-weight-only" (UMT5 quantized at load) and
     transformer_quant="int8" (W8A8 DiT linears), decoded with
     FASTVIDEO_VAE_CONV3D=auto_int8 (the int8 conv K4 where its rule
     allows): UMT5 bytes and peak memory during its load, stage times,
     the K3 / K4 split;
     f: TurboDiffusion T2V 1.3B at 61x480x832 (SLA takes token counts
     that are multiples of 64, and 81 frames give 32,760): 4 rCM steps
     with SLA_ATTN (top 10 %), W8A8 DiT linears and auto_int8 decode;
     g: the causal (self-forcing) Wan, CausalWan-1.3B at full width and
     depth through VideoGenerator (WanCausalDMDPipeline) at 81x480x832:
     7 blocks of 3 latent frames, 3 flow-match Euler steps a block, every
     cached self-attention through the kv-mask flash kernel K5;
     h: StreamingVideoGenerator on 4g's modules: reset, 8 blocks (the
     21-frame window fills and evicts), finalize; per-block latency,
     steady block seconds and steady fps;
     i: flow-matching SFT of Wan2.1-T2V-1.3B at the JAX repo's sft_33k
     cell (81x480x832 latents, 512 text tokens, VSA 0.8, full remat,
     AdamW, fp32 master weights) on the 4b checkpoint's DiT, through
     build_from_config, SFTMethod and method.train over the port's
     PrefetchingLoader: a warm-up step, then --train-steps (default 1)
     timed ones; seconds a step, loss, grad_norm, peak memory and the
     launch counts of every kernel of the step; then one timed step under
     selective_checkpointing="ops" (the linears' outputs saved), its peak
     memory (at 41 frames if 81 do not fit);
     j, k: the Wan2.1-T2V-1.3B multistep path at full width and depth with
     BSA_ATTN at 81x480x848 (K9b) and with NABLA_ATTN at 61x480x832 (K9a,
     which takes token counts that are multiples of 64), 2 FlowUniPC steps
     with CFG each, on checkpoints without VSA gate weights: stage times,
     seconds a step, peak memory, the mean kept fraction of the block
     masks and the launch counts;
     l, m: dfsft and tfsft of CausalWan-1.3B on 4g's checkpoint (4i's
     latents, 3-frame chunks): a warm-up step, then --df-steps timed ones;
     n: DMD2 distillation of Wan2.1-T2V-1.3B through build_from_config
     (method dmd2, a Parquet data.path): the 4b checkpoint's DiT as
     generator, teacher and critic in fp32 masters, on a Snappy shard of 2
     records (81x480x832 latents, 512 text tokens) that the port writes
     and reads, a generator and a critic update a step, VSA at sparsity 0
     (top-117 of 117 tiles): a warm-up step, then --dmd-steps timed ones;
     seconds a step, losses and grad norms, peak memory, the teacher's
     checksum, the launch counts and the reader's MB/s on a random and on
     a zero-padded record;
     o, p, q: the causal distillation methods on 4g's checkpoint and 4n's
     shard through build_from_config, every role in fp32 masters, full
     remat: self_forcing (7 blocks, a generator and a critic update a
     step: SF_STEPS timed step after a warm-up), streaming_long_tuning
     (a stream from step 0 in chunks of at most 6 latent frames up to 27,
     until it starts over) and causal_cd under FLASH_ATTN (CD_STEPS);
     each step timed, with its CPU seconds, its allocator retries and
     the card's SM clock, temperature and power draw after it; losses
     and grad norms, peak memory, the trained roles moved and the frozen
     ones' checksums unchanged, no K5 call in a pass under grad, and the
     launches of K5, K1 and K6 against their formulas;
     r: LoRA serving on 4b's checkpoint and prompt: a rank-32 adapter
     (official names under "diffusion_model.") on the 300 block linears
     through VideoGenerator.set_lora_adapter, the base, active, merged and
     unmerged generations (each after a warm-up), merge and unmerge
     seconds, the adapter's calls and extra launches, merged and unmerged
     within 8 uint8 levels of active, the weights restored by unmerge;
     s, t, u, v: the slice's methods through build_from_config on the 4b
     checkpoint and 4n's shard, a warm-up step, then METHOD_STEPS timed
     ones: lora_finetune (rank 32, 304 linears, VSA 0.8; the frozen
     base's checksum), kd (t_list KD_T_LIST, a self-distillation teacher,
     generate_cache over the shard, a warm teacher rollout, steps from the
     cache), anyflow_pretrain (VSA 0.8, the copy rule) and anyflow (a
     4-step flow-map rollout, 4n's roles); seconds a step, peak memory,
     losses and grad norms, and the launches against their formulas;
     w: diffusion_nft through build_from_config on the 4b checkpoint's DiT
     (the student in fp32 masters, old and ref as frozen copies), rewards
     clipscore + pickscore on a random CLIP dual tower at ViT-L/14 and
     CLIP-L widths (its text projection 1024 wide), 4b's VAE as decode_fn,
     4b's UMT5 embedding of its prompt, 1 prompt x 2 videos at 81x480x832
     latents, 2 sampling steps: a warm-up step, then one timed: seconds
     by stage (sample, decode, score, update), peak memory, losses,
     rewards, the student moved, ref unchanged, old moved, the launches
     against their formula;
  5. the kernels line, the card line and the result line.

Each phase header ends with the seconds since the start.

Any failure exits non-zero before the result line. It imports nothing of
the JAX package.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
import shutil
import subprocess
import sys
import time

# the card's published dense peaks (NVIDIA H100 SXM data sheet)
PEAK_FLOPS = {"bf16": 989e12, "fp32": 67e12, "int8": 1979e12,
              "tf32": 495e12}
PEAK_BYTES = 3.35e12

# kernel -> the Pallas function it replaces (file:line)
REPLACES = {
    "flash_fwd": "fastvideo_tpu/ops/flash_attention.py:93",
    "vsa_sparse_fwd": "fastvideo_tpu/ops/vsa.py:209",
    "vsa_sparse_padded_fwd":
    "fastvideo_tpu/ops/vsa.py:629 and fastvideo_tpu/ops/vsa.py:378",
    "conv3d": "fastvideo_tpu/ops/conv3d.py:180 and fastvideo_tpu/ops/conv3d.py:55",
    "conv3d_int8": "fastvideo_tpu/ops/conv3d.py:214",
    "flash_fwd_kv_mask":
    "fastvideo_tpu/ops/flash_attention.py:93 (has_kv_mask, from "
    "flash_attention_kv_mask :539)",
    "flash_bwd_dq": "fastvideo_tpu/ops/flash_attention.py:310",
    "flash_bwd_dkv": "fastvideo_tpu/ops/flash_attention.py:355",
    "vsa_sparse_bwd_dq": "fastvideo_tpu/ops/vsa.py:698",
    "vsa_sparse_bwd_dkv": "fastvideo_tpu/ops/vsa.py:762",
    "dyn_sparse_fwd": "fastvideo_tpu/ops/nabla.py:60 (call :188, from "
    "masked_block_sparse_attention :134)",
    "dyn_sparse_qtile_fwd": "fastvideo_tpu/ops/nabla.py:60 with q_rows (call "
    "fastvideo_tpu/ops/bsa.py:137, from _masked_sparse_qtile :91)",
    "flash_fwd_struct": "fastvideo_tpu/ops/flash_attention.py:93 with "
    "chunk_tokens / tf_clean_len (_mask_tile :39, _tile_reachable :70; call "
    ":222)",
    "flash_bwd_struct_dq": "fastvideo_tpu/ops/flash_attention.py:310 with "
    "chunk_tokens / tf_clean_len (call :432)",
    "flash_bwd_struct_dkv": "fastvideo_tpu/ops/flash_attention.py:355 with "
    "chunk_tokens / tf_clean_len (call :459)",
    "flash_bwd_dkv_reduce": "fastvideo_tpu/ops/flash_attention.py:355 (the "
    "sum over the query grid axis that _bwd_dkv_kernel carries in scratch; "
    "call :459)",
    "flash_fwd_combine": "fastvideo_tpu/ops/flash_attention.py:93 (the "
    "online softmax's merge over the key grid axis that _fwd_kernel carries "
    "in scratch; call :222)",
    "flash_fwd_tf32": "fastvideo_tpu/ops/flash_attention.py:93 (fp32 "
    "operands at a head of 384, the VAE attention of an fp32 decode; call "
    ":222)",
    "flash_fwd_tf32_split": "fastvideo_tpu/ops/flash_attention.py:93 (the "
    "K and V operands of its fp32 form at a head of 384, split into TF32 "
    "heads and tails; call :222)",
}
SOURCES = {
    "flash_fwd": "fastvideo_tpu_torch/csrc/flash_fwd.cu",
    "vsa_sparse_fwd": "fastvideo_tpu_torch/csrc/vsa_sparse_fwd.cu",
    "vsa_sparse_padded_fwd":
    "fastvideo_tpu_torch/csrc/vsa_sparse_padded_fwd.cu",
    "conv3d": "fastvideo_tpu_torch/csrc/conv3d.cu",
    "conv3d_int8": "fastvideo_tpu_torch/csrc/conv3d_int8.cu",
    "flash_fwd_kv_mask": "fastvideo_tpu_torch/csrc/flash_fwd.cu",
    "flash_bwd_dq": "fastvideo_tpu_torch/csrc/flash_bwd.cu",
    "flash_bwd_dkv": "fastvideo_tpu_torch/csrc/flash_bwd.cu",
    "vsa_sparse_bwd_dq": "fastvideo_tpu_torch/csrc/vsa_sparse_bwd.cu",
    "vsa_sparse_bwd_dkv": "fastvideo_tpu_torch/csrc/vsa_sparse_bwd.cu",
    "dyn_sparse_fwd": "fastvideo_tpu_torch/csrc/dyn_sparse_fwd.cu",
    "dyn_sparse_qtile_fwd": "fastvideo_tpu_torch/csrc/dyn_sparse_fwd.cu",
    "flash_fwd_struct": "fastvideo_tpu_torch/csrc/flash_fwd.cu",
    "flash_bwd_struct_dq": "fastvideo_tpu_torch/csrc/flash_bwd.cu",
    "flash_bwd_struct_dkv": "fastvideo_tpu_torch/csrc/flash_bwd.cu",
    "flash_bwd_dkv_reduce": "fastvideo_tpu_torch/csrc/flash_bwd.cu",
    "flash_fwd_combine": "fastvideo_tpu_torch/csrc/flash_fwd.cu",
    "flash_fwd_tf32": "fastvideo_tpu_torch/csrc/flash_fwd_wide_tf32_sm90.cuh",
    "flash_fwd_tf32_split":
    "fastvideo_tpu_torch/csrc/flash_fwd_wide_tf32_sm90.cuh",
}
# the flash kernels' Hopper instances by their mangled names' stem
SM90_KERNELS = {"flash_fwd_sm90": {"0": "K1", "1": "K5", "2": "K1 struct"},
                "flash_bwd_dq_sm90": {"0": "K6 dQ", "1": "K6 struct dQ"},
                "flash_bwd_dkv_sm90": {"0": "K6 dK/dV",
                                       "1": "K6 struct dK/dV"}}
# the sparse kernels' Hopper instances (the padded forward's mode: its
# warpgroups a block)
SPARSE_SM90 = {"vsa_sparse_bwd_dq_sm90": {"0": "K7 bwd dQ"},
               "vsa_sparse_bwd_dkv_sm90": {"0": "K7 bwd dK/dV"},
               "dyn_sparse_fwd_sm90": {"0": "K9a", "1": "K9b"},
               "vsa_sparse_fwd_sm90": {"0": "K2, per-tile walk",
                                       "1": "K2, key stream"},
               "vsa_sparse_padded_fwd_sm90": {"1": "K8 / K7 fwd, E <= 64",
                                              "2": "K8 / K7 fwd"}}
# the convs' Hopper instances by their N tile, and the convs they take
CONV_SM90 = {"8": "K3 conv_out (Co 3)", "96": "K3 (Co 96: up3, the hot "
             "conv; Co 192)", "128": "K3 (Co 384)"}
CONV8_SM90 = {"96": "K4 (Co 96: up3, the hot conv)",
              "192": "K4 (Co 192; 384)"}
# the 3xTF32 conv instances by their N tile
TF32_SM90 = {"8": "K3 fp32 conv_out (Co 3)", "96": "K3 fp32 (Co 96, 192, 384)"}
# K1's schedule by the library's code (fvt_flash_fwd_sm90)
FLASH_SCHEDULES = ("tile", "sm90", "sm90_wide", "sm90_wide_tf32")
# kernels a profiled generation reports whatever their rank: the VAE
# attention's wide K1 and merge, and the first schedule's bf16 K1 instance
# (attn_tile.cuh) that ran it before
PROFILE_WATCH = ("flash_fwd_wide_sm90", "flash_fwd_combine",
                 "flash_fwd_kernel<__nv_bfloat16, 64, 32, 0>")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def card_state() -> str:
    """The card's SM clock (now / max), temperature and power draw as
    nvidia-smi reads them, or why they were not read."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm,"
         "temperature.gpu,power.draw", "--format=csv,noheader"],
        capture_output=True, text=True, check=False, timeout=60)
    lines = out.stdout.strip().splitlines()
    return (f"SM clock, max, temperature, power {lines[0]}"
            if out.returncode == 0 and lines else
            f"card state not read ({out.stderr.strip()[:80]})")


def bound_ms(flops: float, nbytes: float, dtype: str = "bf16"
             ) -> tuple[float, str]:
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def time_ms(fn, reps: int = 5, warmup: int = 1) -> float:
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def check(name: str, got, want, atol: float, rtol: float = 0.0) -> float:
    """Hold a kernel's output to its plain version: every element within
    atol + rtol * |plain|. Returns the max absolute error."""
    import torch

    torch.cuda.synchronize()
    if not torch.isfinite(got.float()).all():
        raise SystemExit(f"{name}: kernel output has non-finite values")
    diff = (got.float() - want.float()).abs()
    err = diff.max().item()
    ok = bool((diff <= atol + rtol * want.float().abs()).all())
    print(f"  {name}: max_abs_err {err:.3e} (tolerance {atol:.1e} + "
          f"{rtol:.1e} * |plain|; plain std {want.float().std().item():.3e})"
          f" {'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        raise SystemExit(f"{name}: kernel disagrees with its plain version")
    return err


def attn_tol(want, dtype) -> tuple[float, float]:
    """(atol, rtol) for an attention output against its plain version.

    An output row is a softmax average of N random values, so its typical
    size is about N**-0.5 (0.02 to 0.07 at the path's shapes), far below 1.
    bf16: both sides round to bf16, so up to two bf16 ulps (2**-6 relative)
    apart, plus 2**-5 of the plain output's std for values near zero, where
    the order of the fp32 sums shows. fp32: summation order only."""
    import torch

    if dtype != torch.bfloat16:
        return 1e-4, 1e-4
    return 2.0**-5 * want.float().std().item(), 2.0**-6


def sm90_instance(kernel: str):
    """(label, stem, head, mode) of a Hopper instance's mangled name, or
    None: the flash kernels' (SM90_KERNELS) and the sparse kernels'
    (SPARSE_SM90)."""
    import re

    m = re.search(r"(flash_\w+_sm90)ILi(\d+)EL[ib](\d)E", kernel)
    if m and m.group(1) in SM90_KERNELS:
        stem, d, mode = m.group(1), int(m.group(2)), m.group(3)
        return SM90_KERNELS[stem][mode], stem, d, int(mode)
    m = re.search(r"(vsa_sparse_bwd_d(?:q|kv)_sm90|dyn_sparse_fwd_sm90|"
                  r"vsa_sparse_padded_fwd_sm90|vsa_sparse_fwd_sm90)ILi(\d+)E"
                  r"(?:L[bi](\d)E)?", kernel)
    if m:
        stem, d, mode = m.group(1), int(m.group(2)), m.group(3) or "0"
        return SPARSE_SM90[stem][mode], stem, d, int(mode)
    m = re.search(r"conv3d_sm90ILi(\d+)E", kernel)
    if m:
        return CONV_SM90[m.group(1)], "conv3d_sm90", int(m.group(1)), 0
    m = re.search(r"conv3d_int8_sm90ILi(\d+)E", kernel)
    if m:
        return CONV8_SM90[m.group(1)], "conv3d_int8_sm90", int(m.group(1)), 0
    if "flash_fwd_wide_sm90" in kernel:
        return "K1 wide (head 384)", "flash_fwd_wide_sm90", 384, 0
    if "flash_fwd_wide_tf32_sm90" in kernel:
        return ("K1 wide fp32 (3xTF32, head 384)", "flash_fwd_wide_tf32_sm90",
                384, 0)
    m = re.search(r"conv3d_tf32_sm90ILi(\d+)E", kernel)
    if m:
        return TF32_SM90[m.group(1)], "conv3d_tf32_sm90", int(m.group(1)), 0
    return None


def report_sm90_build() -> None:
    """Registers, spills, stack, shared memory and ptxas warnings of each
    Hopper instance of the flash, sparse and conv kernels, from the
    -Xptxas -v log of their build (the dynamic shared memory from the
    library, K5's at the 32,760-key window, K7 bwd's at 4i's top-24 over
    117 tiles, K9's over 4j's 672 key tiles, K8's at VSA's top-34 and
    SLA's top-39 rows, K2's at the top-24, K3's and K4's at W = 832's 64 x
    2 patches). Fails on a spill in an instance with a head of 128, in a
    K3 instance of 96 or 128 output channels or in a K4 instance, and on a
    serialized-wgmma warning (C7518) in a head-of-128 instance of the
    sparse kernels or in those conv instances;
    the flash kernels' warnings (the head-of-64 struct dQ's C7518) are
    reported."""
    from fastvideo_tpu_torch.ops import _build

    for src in _build.PTXAS_VERBOSE:
        for r in _build.ptxas_report(src):
            inst = sm90_instance(r["kernel"])
            if inst is not None:
                name, stem, d, mode = inst
                label = f"{name}, {stem}<{d}, {mode}>"
                if stem == "flash_fwd_sm90":
                    dyn = _build.query(src, "fvt_flash_fwd_sm90_smem", d, mode,
                                       CAUSAL_WINDOW_TOKENS)
                elif stem.startswith("flash_bwd"):
                    dyn = _build.query(src, "fvt_flash_bwd_sm90_smem",
                                       int(stem == "flash_bwd_dkv_sm90"), d,
                                       mode)
                elif stem.startswith("vsa_sparse_bwd"):
                    dkv = stem == "vsa_sparse_bwd_dkv_sm90"
                    dyn = _build.query(src, "fvt_vsa_sparse_bwd_sm90_smem",
                                       int(dkv), d, 117 if dkv else 24)
                elif stem == "vsa_sparse_padded_fwd_sm90":  # a top-k row
                    dyn = _build.query(src,
                                       "fvt_vsa_sparse_padded_fwd_sm90_smem",
                                       d, mode, 39 if mode == 1 else 34)
                elif stem == "vsa_sparse_fwd_sm90":
                    dyn = _build.query(src, "fvt_vsa_sparse_fwd_sm90_smem", d,
                                       24)
                elif stem == "conv3d_sm90":  # d is the N tile
                    dyn = _build.query(src, "fvt_conv3d_sm90_smem",
                                       {8: 3, 96: 96, 128: 384}[d], 64)
                elif stem == "conv3d_int8_sm90":  # d is the N tile
                    dyn = _build.query(src, "fvt_conv3d_int8_sm90_smem", d,
                                       64)
                elif stem == "flash_fwd_wide_sm90":
                    dyn = _build.query(src, "fvt_flash_fwd_wide_smem")
                elif stem == "flash_fwd_wide_tf32_sm90":
                    dyn = _build.query(src, "fvt_flash_fwd_wide_tf32_smem")
                elif stem == "conv3d_tf32_sm90":  # d is the N tile
                    dyn = _build.query(src, "fvt_conv3d_tf32_smem",
                                       {8: 3, 96: 96}[d], 64)
                else:
                    dyn = _build.query(src, "fvt_dyn_sparse_fwd_sm90_smem", d,
                                       672)
            elif "flash_bwd_dkv_reduce" in r["kernel"]:
                label, stem, d, dyn = "flash_bwd_dkv_reduce", "", 0, 0
            elif "flash_fwd_combine" in r["kernel"]:
                out = "fp32" if "combineIf" in r["kernel"] else "bf16"
                label, stem, d, dyn = f"flash_fwd_combine ({out} out)", "", 0, 0
            elif "flash_tf32_split" in r["kernel"]:
                label, stem, d, dyn = "flash_fwd_tf32_split", "", 0, 0
            else:
                continue
            spills = r["spill_stores"] + r["spill_loads"]
            serial = [w for w in r["warnings"] if w.startswith(("C7518",
                                                                "C7513"))
                      or "serialized" in w]
            print(f"  {label}: {r['registers']} registers, {spills} spill "
                  f"bytes ({r['spill_stores']} stored, {r['spill_loads']} "
                  f"loaded), {r['stack']} bytes stack, {dyn + r['smem']} "
                  f"bytes shared memory; ptxas warnings: "
                  f"{r['warnings'] or 'none'}", flush=True)
            conv = stem in ("conv3d_sm90", "conv3d_int8_sm90",
                            "conv3d_tf32_sm90")
            wide = stem in ("flash_fwd_wide_sm90", "flash_fwd_wide_tf32_sm90")
            hot = (conv and d >= 96) or (not conv and d == 128) or wide
            if hot and spills:
                raise SystemExit(f"{label}: ptxas reports {spills} spill "
                                 "bytes in a head-of-128, wide or hot conv "
                                 "instance")
            if hot and serial and (stem in SPARSE_SM90 or conv or wide):
                raise SystemExit(f"{label}: ptxas serialized the wgmma of a "
                                 f"head-of-128 or hot conv instance: "
                                 f"{serial}")


def check_schedule(label: str, dtype, d: int, backward: bool = False) -> str:
    """The schedule the flash library takes for (dtype, head d): it must be
    the host rule's (flash_attention.flash_schedule), and a bf16 case with
    a head of 128 must take the Hopper one."""
    import torch

    from fastvideo_tpu_torch.ops import _build
    from fastvideo_tpu_torch.ops import flash_attention as fa

    if backward:
        lib = _build.query(fa.NAME_BWD_DQ, "fvt_flash_bwd_sm90", d)
        took, want = ("sm90" if lib else "tile"), fa.flash_bwd_schedule(d)
    else:
        lib = _build.query(fa.NAME, "fvt_flash_fwd_sm90",
                           int(dtype == torch.bfloat16), d)
        took, want = FLASH_SCHEDULES[lib], fa.flash_schedule(dtype, d)
    print(f"  {label}: schedule {took}", flush=True)
    if took != want:
        raise SystemExit(f"{label}: the library takes schedule {took}, the "
                         f"host rule {want}")
    if dtype == torch.bfloat16 and d == 128 and took != "sm90":
        raise SystemExit(f"{label}: a bf16 case with a head of 128 reached "
                         "the first schedule")
    if dtype == torch.bfloat16 and d == 384 and took != "sm90_wide":
        raise SystemExit(f"{label}: a bf16 case with a head of 384 reached "
                         "the first schedule")
    if dtype == torch.float32 and d == 384 and took != "sm90_wide_tf32":
        raise SystemExit(f"{label}: an fp32 case with a head of 384 reached "
                         "the first schedule")
    return took


def check_sparse_schedule(label: str, kernel: str, d: int) -> str:
    """The schedule the sparse library of ``kernel`` (K2, K7 bwd, K9 or K8
    / K7 fwd) takes
    for a bf16 head of d: it must be the host rule's
    (sparse_schedule.sparse_schedule), and a head of 128 must take the
    Hopper one."""
    import torch

    from fastvideo_tpu_torch.ops import _build
    from fastvideo_tpu_torch.ops.sparse_schedule import sparse_schedule

    fn = ("fvt_vsa_sparse_bwd_sm90" if kernel.startswith("vsa_sparse_bwd")
          else "fvt_vsa_sparse_padded_fwd_route"
          if kernel == "vsa_sparse_padded_fwd"
          else "fvt_vsa_sparse_fwd_route" if kernel == "vsa_sparse_fwd"
          else "fvt_dyn_sparse_fwd_sm90_route")
    took = "sm90" if _build.query(kernel, fn, d) else "tile"
    want = sparse_schedule(torch.bfloat16, d)
    print(f"  {label}: schedule {took}", flush=True)
    if took != want:
        raise SystemExit(f"{label}: the library takes schedule {took}, the "
                         f"host rule {want}")
    if d == 128 and took != "sm90":
        raise SystemExit(f"{label}: a bf16 case with a head of 128 reached "
                         "the first schedule")
    return took


def check_conv_schedule(label: str, c: int, co: int) -> str:
    """The schedule and N tile the conv library takes for a bf16 conv of C
    in and Co out channels: they must be the host rule's
    (conv3d.conv_schedule, conv3d.conv_tile_n), and every bf16 conv must
    take the Hopper one."""
    import torch

    from fastvideo_tpu_torch.ops import _build, conv3d

    took = "sm90" if _build.query(conv3d.NAME, "fvt_conv3d_route", 1, c,
                                  co) else "simt"
    bn = _build.query(conv3d.NAME, "fvt_conv3d_tile_n", co)
    want = conv3d.conv_schedule(torch.bfloat16, c, co)
    if took != want or bn != conv3d.conv_tile_n(co):
        raise SystemExit(f"{label}: the library takes schedule {took} with "
                         f"N tile {bn}, the host rule {want} with "
                         f"{conv3d.conv_tile_n(co)}")
    if took != "sm90":
        raise SystemExit(f"{label}: a bf16 conv reached the first schedule")
    return f"{took}, N tile {bn}"


# -- phase 3: kernels against their plain versions ---------------------------


def check_flash(dev, results: dict) -> None:
    import torch
    import torch.nn.functional as F

    from fastvideo_tpu_torch.ops import flash_attention as fa
    from fastvideo_tpu_torch.ops import vsa

    g = torch.Generator(device=dev).manual_seed(0)

    def rnd(*shape, dtype=torch.bfloat16):
        return torch.randn(*shape, generator=g, device=dev, dtype=dtype)

    # 480x832: 32,760 tokens (4f's 61 frames: 24,960), VAE mid block 60x104.
    # 480x848: the VSA trunk runs in padded tile-major order (43,008 slots,
    # the padded ones zero), the STA trunk in token order (33,390), VAE mid
    # block 60x106. The VAE attention runs once per decode chunk, on its
    # frames: the first latent frame alone, then 2 at a time
    chunk = decode_chunk_frames(latent_of(CLIP_480P))
    bf16 = torch.bfloat16
    cases = [
        ("cross_attn", (1, 32760, 12, 128), 512, bf16, False),
        ("cross_attn 4f", (1, turbo_tokens(), 12, 128), 512, bf16, False),
        # the causal paths (4g, 4h): one block's queries over the text K/V
        ("cross_attn causal", (1, CAUSAL_BLOCK_TOKENS, 12, 128), 512, bf16,
         False),
        ("cross_attn 480x848 vsa", (1, 43008, 12, 128), 512, bf16, False),
        ("cross_attn 480x848 sta", (1, 33390, 12, 128), 512, bf16, False),
        ("vae_mid_attn first chunk", (1, 6240, 1, 384), 6240, bf16, False),
        (f"vae_mid_attn {chunk}-frame chunk", (chunk, 6240, 1, 384), 6240,
         bf16, False),
        (f"vae_mid_attn 480x848 {chunk}-frame chunk", (chunk, 6360, 1, 384),
         6360, bf16, False),
        ("fp32_causal_tail", (2, 1000, 2, 64), 777, torch.float32, True),
    ]
    padded_valid = torch.as_tensor(
        vsa.tile_valid_mask((21, 30, 53), (4, 8, 8)), device=dev)
    errs = []
    for label, (b, sq, h, d), skv, dtype, causal in cases:
        if label.startswith("vae_mid_attn"):
            # q, k and v as the VAE passes them: column views of one qkv
            qkv = rnd(b, sq, h, 3 * d, dtype=dtype)
            q, k, v = qkv[..., :d], qkv[..., d:2 * d], qkv[..., 2 * d:]
            del qkv
        else:
            q = rnd(b, sq, h, d, dtype=dtype)
            if sq == padded_valid.numel():
                q = q * padded_valid[None, :, None, None]
            k = rnd(b, skv, h, d, dtype=dtype)
            v = rnd(b, skv, h, d, dtype=dtype)
        kv_valid = skv - 13 if causal else skv
        kw = dict(scale=d**-0.5, causal=causal, kv_valid=kv_valid)
        check_schedule(f"flash_fwd[{label}]", dtype, d)
        out, lse = fa.flash_attention(q, k, v, return_lse=True, **kw)
        ref, ref_lse = fa.flash_attention_plain(q, k, v, **kw)
        errs.append(check(f"flash_fwd[{label}]", out, ref,
                          *attn_tol(ref, dtype)))
        check(f"flash_fwd[{label}] lse", lse, ref_lse, 1e-3)
        if label.startswith("vae_mid_attn"):
            time_vae_attn(label, q, k, v, results["flash_fwd"])
        if label not in ("cross_attn", "cross_attn 4f", "cross_attn causal"):
            del q, k, v, out, ref, lse, ref_lse
            continue
        ms = time_ms(lambda: fa.flash_attention(q, k, v, **kw))
        flops = 4.0 * b * h * sq * skv * d
        nbytes = 2.0 * (2 * b * sq * h * d + 2 * b * skv * h * d) + 4 * b * h * sq
        bms, by = bound_ms(flops, nbytes)
        if label != "cross_attn":
            key = "turbo" if label == "cross_attn 4f" else "causal"
            results["flash_fwd"].update({f"{key}_ms": ms,
                                         f"{key}_bound_ms": bms})
            print(f"  flash_fwd[{label}]: {ms:.3f} ms kernel, bound {bms:.3f} "
                  f"ms ({by}, {flops:.3e} FLOP)", flush=True)
            del q, k, v, out, ref, lse, ref_lse
            continue
        plain = time_ms(lambda: fa.flash_attention_plain(q, k, v, **kw), 2)
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        lib = time_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, scale=d**-0.5))
        # the profiler names the Hopper kernel that ran
        kernel_device_ms(lambda: fa.flash_attention(q, k, v, **kw),
                         {"K1": "flash_fwd_sm90"})
        results["flash_fwd"] = dict(max_abs_err=0.0, ms=ms, plain_ms=plain,
                                    bound_ms=bms, bound_by=by,
                                    library_ms=lib,
                                    shape=f"q{[b, sq, h, d]} kv{skv} bf16")
        print(f"  flash_fwd[{label}]: {ms:.3f} ms kernel, {plain:.3f} ms "
              f"plain, {lib:.3f} ms sdpa, bound {bms:.3f} ms ({by}, "
              f"{flops:.3e} FLOP)", flush=True)
    results["flash_fwd"]["max_abs_err"] = max(errs)  # over every case


def sdpa_ms(q, k, v) -> tuple[float, str]:
    """The library yardstick of an attention over [B, S, H, D] views, timed
    here only: one scaled_dot_product_attention call, on the first of
    PyTorch's fused backends that takes the shape (flash and cuDNN stop at
    a head of 256), as (ms, backend)."""
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    for backend in (SDPBackend.FLASH_ATTENTION, SDPBackend.CUDNN_ATTENTION,
                    SDPBackend.EFFICIENT_ATTENTION, SDPBackend.MATH):
        try:
            with sdpa_kernel([backend]):
                return time_ms(lambda: F.scaled_dot_product_attention(
                    qt, kt, vt)), backend.name.lower()
        except RuntimeError:
            continue
    raise SystemExit("scaled_dot_product_attention took no backend")


def time_vae_attn(label: str, q, k, v, results: dict) -> None:
    """K1 at the VAE attention's shape (bf16, a head of 384 on the wide
    schedule): kernel, plain and SDPA times and the bound, the key splits,
    and the profiler's name for the kernel that ran."""
    from fastvideo_tpu_torch.ops import _build
    from fastvideo_tpu_torch.ops import flash_attention as fa

    b, sq, h, d = q.shape
    key = {"vae_mid_attn first chunk": "vae_first"}.get(
        label, "vae_848" if "480x848" in label else "vae_chunk")
    ms = time_ms(lambda: fa.flash_attention(q, k, v))
    plain = time_ms(lambda: fa.flash_attention_plain(q, k, v,
                                                     scale=d**-0.5), 2)
    lib, backend = sdpa_ms(q, k, v)
    flops = 4.0 * b * h * sq * sq * d
    bms, by = bound_ms(flops, 2.0 * 4 * b * sq * h * d + 4 * b * h * sq)
    splits = fa.wide_splits(b, h, sq, sq, _build.num_sms(q.device))
    dev_ms = kernel_device_ms(lambda: fa.flash_attention(q, k, v),
                              {"K1 wide": "flash_fwd_wide_sm90",
                               "combine": "flash_fwd_combine"})
    results.update({f"{key}_ms": ms, f"{key}_plain_ms": plain,
                    f"{key}_bound_ms": bms, f"{key}_library_ms": lib,
                    f"{key}_library": backend, f"{key}_splits": splits,
                    f"{key}_device_ms": dev_ms})
    print(f"  flash_fwd[{label}]: {ms:.3f} ms kernel and combine "
          f"({splits} key splits; profiler: "
          f"flash_fwd_wide_sm90 {dev_ms['K1 wide']:.3f} ms, "
          f"flash_fwd_combine {dev_ms['combine']:.3f} ms), {plain:.3f} ms "
          f"plain, {lib:.3f} ms sdpa ({backend}), bound {bms:.3f} ms ({by}, "
          f"{flops:.3e} FLOP)", flush=True)


def check_flash_combine(dev, results: dict) -> None:
    """flash_fwd_combine against its plain version at the 2-frame decode
    chunk's partials ([4, 2, 1, 6240, 384]), with rows empty in a split
    and in every split; its time, the plain version's and the bound (the
    partials read once, O and the LSE written once)."""
    import torch

    from fastvideo_tpu_torch.ops import flash_attention as fa

    g = torch.Generator(device=dev).manual_seed(14)
    chunk = decode_chunk_frames(latent_of(CLIP_480P))
    sq, d = 6240, fa.WIDE_HEAD
    splits = fa.wide_splits(chunk, 1, sq, sq, 132)
    part = torch.randn(splits, chunk, 1, sq, d, generator=g, device=dev)
    lse_part = torch.randn(splits, chunk, 1, sq, generator=g,
                           device=dev) * 4
    lse_part[0, :, :, :64] = float("-inf")
    lse_part[:, 0, 0, 100:103] = float("-inf")
    part[lse_part.isinf()] = 0
    out = torch.empty(chunk, sq, 1, d, device=dev, dtype=torch.bfloat16)
    lse = torch.empty(chunk, 1, sq, device=dev)
    fa.wide_combine(part, lse_part, out, lse)
    ref, ref_lse = fa.wide_combine_plain(part, lse_part)
    # both round the same fp32 merge to bf16 once: one bf16 ulp apart at
    # most, where the two sums' orders differ in the last fp32 bit
    err = check(f"flash_fwd_combine[{splits} splits, {chunk}-frame chunk]",
                out, ref, 0.0, 2.0**-7)
    fin = torch.isfinite(ref_lse)
    if not torch.equal(fin, torch.isfinite(lse)) or not bool(
            (out[0, 100:103, 0] == 0).all()):
        raise SystemExit("flash_fwd_combine: empty rows differ from plain")
    check("flash_fwd_combine lse", lse[fin], ref_lse[fin], 1e-5)
    ms = time_ms(lambda: fa.wide_combine(part, lse_part, out, lse))
    plain = time_ms(lambda: fa.wide_combine_plain(part, lse_part), 2)
    nbytes = 4.0 * (part.numel() + lse_part.numel() + lse.numel()) + \
        2.0 * out.numel()
    bms, by = bound_ms(0.0, nbytes)
    results["flash_fwd_combine"] = dict(
        max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=bms, bound_by=by,
        library_ms=None,
        shape=f"part{list(part.shape)} -> out{list(out.shape)} bf16")
    print(f"  flash_fwd_combine: {ms:.3f} ms kernel, {plain:.3f} ms plain, "
          f"bound {bms:.3f} ms ({by}); no single PyTorch call merges "
          f"softmax partials", flush=True)


def vsa_block_mask(idx, s: int, e: int, group_rows: int, block: int = 128):
    """The flex_attention BlockMask of K2's sparsity: query rows of group g
    see the key tiles idx[b, h, g]. A block of `block` rows or columns spans
    at most two groups or tiles (block < E <= group_rows), so it is full
    when all four (group, tile) pairs are selected, partial when some are."""
    import torch
    from torch.nn.attention.flex_attention import BlockMask

    b, h, ng, _ = idx.shape
    sel = torch.zeros(b, h, ng, s // e, dtype=torch.bool, device=idx.device)
    sel.scatter_(-1, idx.long(), True)
    lo = torch.arange(0, s, block, device=idx.device)
    hi = torch.clamp(lo + block, max=s) - 1
    pairs = [sel[:, :, gq][:, :, :, tk] for gq in (lo // group_rows,
                                                   hi // group_rows)
             for tk in (lo // e, hi // e)]
    full = pairs[0] & pairs[1] & pairs[2] & pairs[3]
    partial = (pairs[0] | pairs[1] | pairs[2] | pairs[3]) & ~full

    def blocks(m):
        order = torch.argsort(m.to(torch.int8), dim=-1, descending=True,
                              stable=True)
        return m.sum(-1, dtype=torch.int32), order.to(torch.int32)

    def mask_mod(bi, hi_, q_idx, kv_idx):
        return sel[bi, hi_, q_idx // group_rows, kv_idx // e]

    return BlockMask.from_kv_blocks(*blocks(partial), *blocks(full),
                                    BLOCK_SIZE=block, mask_mod=mask_mod,
                                    seq_lengths=(s, s))


def check_vsa(dev, results: dict) -> None:
    import torch
    from torch.nn.attention.flex_attention import flex_attention

    from fastvideo_tpu_torch.ops import _build, vsa
    from fastvideo_tpu_torch.ops.sparse_schedule import (FAST_WALKS,
                                                         fast_key_walk)

    g = torch.Generator(device=dev).manual_seed(1)
    b, h, d, e, nb, qg, topk = 1, 12, 128, 280, 117, 3, 24
    sched = check_sparse_schedule("vsa_sparse_fwd[480p]", vsa.NAME, d)
    walk = FAST_WALKS[_build.query(vsa.NAME, "fvt_vsa_sparse_fwd_walk", e)]
    print(f"  vsa_sparse_fwd[480p]: key walk {walk}", flush=True)
    if walk != fast_key_walk(e):
        raise SystemExit(f"vsa_sparse_fwd: the library walks {walk}, the "
                         f"host rule {fast_key_walk(e)}")
    s, ng = nb * e, nb // qg
    q, k, v = (torch.randn(b, h, s, d, generator=g, device=dev,
                           dtype=torch.bfloat16) for _ in range(3))
    idx = torch.stack([torch.randperm(nb, generator=g, device=dev)[:topk]
                       for _ in range(b * h * ng)]).reshape(b, h, ng, topk)
    idx = idx.to(torch.int32)
    scale = d**-0.5
    out = vsa.block_sparse_attention_fast(q, k, v, idx, scale=scale,
                                          tile_elems=e)
    ref = vsa.block_sparse_attention_plain(q, k, v, idx, scale=scale,
                                           tile_elems=e)
    tol = attn_tol(ref, torch.bfloat16)
    err = check("vsa_sparse_fwd[480p]", out, ref, *tol)
    ms = time_ms(lambda: vsa.block_sparse_attention_fast(
        q, k, v, idx, scale=scale, tile_elems=e))
    plain = time_ms(lambda: vsa.block_sparse_attention_plain(
        q, k, v, idx, scale=scale, tile_elems=e), 1)
    # the library yardstick: flex_attention (compiled) with the same
    # block sparsity as a BlockMask; timed here only, the port never calls it
    mask = vsa_block_mask(idx, s, e, qg * e)
    flex = torch.compile(flex_attention, dynamic=False)
    check("flex_attention[480p] (library)",
          flex(q, k, v, block_mask=mask, scale=scale), ref, *tol)
    lib = time_ms(lambda: flex(q, k, v, block_mask=mask, scale=scale))
    flops = 4.0 * b * h * s * topk * e * d
    nbytes = 2.0 * 4 * b * h * s * d + 4 * idx.numel()
    bms, by = bound_ms(flops, nbytes)
    results["vsa_sparse_fwd"] = dict(
        max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=bms, bound_by=by,
        library_ms=lib, schedule=f"{sched}, key walk {walk}",
        shape=f"q{[b, h, s, d]} E{e} groups{ng} topk{topk}")
    print(f"  vsa_sparse_fwd[480p]: {ms:.3f} ms kernel "
          f"({flops / ms / 1e9:.1f} TFLOP/s of needed work), {plain:.3f} ms "
          f"plain, {lib:.3f} ms flex_attention, bound {bms:.3f} ms ({by}, "
          f"{flops:.3e} FLOP)", flush=True)


def padded_block_mask(idx, sizes, s: int, e: int, block: int = 128):
    """The flex_attention BlockMask of the padded kernel's sparsity: query
    tile qi sees the keys below sizes[t] of every tile t in idx[b, h, qi]
    (-1 slots see nothing). E is a multiple of `block`, so a key block lies
    in one tile: full when the tile is selected and its valid count covers
    the block, partial when the count ends inside it."""
    import torch
    from torch.nn.attention.flex_attention import BlockMask

    b, h, nq, _ = idx.shape
    nb, per = s // e, e // block
    sel = torch.zeros(b, h, nq, nb + 1, dtype=torch.bool, device=idx.device)
    sel.scatter_(-1, torch.where(idx >= 0, idx, nb).long(), True)
    sel = sel[..., :nb]
    blk = torch.arange(nb * per, device=idx.device)
    cover = sizes[blk // per] - (blk % per) * block  # valid keys per block
    sel_blk = sel[..., blk // per].repeat_interleave(per, dim=2)
    full = sel_blk & (cover >= block)
    partial = sel_blk & (cover > 0) & (cover < block)

    def blocks(m):
        order = torch.argsort(m.to(torch.int8), dim=-1, descending=True,
                              stable=True)
        return m.sum(-1, dtype=torch.int32), order.to(torch.int32)

    def mask_mod(bi, hi_, q_idx, kv_idx):
        return sel[bi, hi_, q_idx // e, kv_idx // e] & (
            kv_idx % e < sizes[kv_idx // e])

    return BlockMask.from_kv_blocks(*blocks(partial), *blocks(full),
                                    BLOCK_SIZE=block, mask_mod=mask_mod,
                                    seq_lengths=(s, s))


def padded_bound(idx, sizes, d: int) -> tuple[float, float]:
    """(FLOP, bytes) the padded sparse function needs for these inputs: real
    query rows against the valid keys of their real slots, each real token
    of q/k/v read once and of out (and the fp32 LSE) written once."""
    import torch

    sizes = sizes.double()
    keys = (sizes[idx.clamp_min(0).long()] * (idx >= 0)).sum(-1)  # [B, H, nQ]
    pairs = (keys * sizes[None, None, :]).sum().item()
    b, h = idx.shape[:2]
    tokens = b * h * sizes.sum().item()
    return 4.0 * d * pairs, 2.0 * 4 * tokens * d + 4 * tokens + 4 * idx.numel()


def check_vsa_padded(dev, results: dict) -> None:
    """The padded sparse kernel (K8 / K7 fwd) at the 480x848 shapes: VSA
    (top-34 of 168 padded tiles, output and LSE), STA (window rows with -1
    slots), SLA at 4f's shape (64-token full tiles, with the walked
    fraction of its block map), and rows with no valid key on 256- and
    64-row tiles; each case on the Hopper schedule."""
    import torch
    from torch.nn.attention.flex_attention import flex_attention

    from fastvideo_tpu_torch.attention.backends.vsa import vsa_topk
    from fastvideo_tpu_torch.ops import sla, sta, vsa
    from fastvideo_tpu_torch.ops import sparse_schedule as ss

    name = "vsa_sparse_padded_fwd"
    g = torch.Generator(device=dev).manual_seed(3)
    grid, tile, b, h, d = (21, 30, 53), (4, 8, 8), 1, 12, 128
    _, _, sizes_np, _, s = vsa.tile_layout(grid, tile)
    e, nb = 256, s // 256
    sizes = torch.as_tensor(sizes_np, device=dev)
    valid = torch.as_tensor(vsa.tile_valid_mask(grid, tile), device=dev)
    # the padded slots hold zeros, as the backend leaves them
    q, k, v = (torch.randn(b, h, s, d, generator=g, device=dev,
                           dtype=torch.bfloat16) * valid[:, None]
               for _ in range(3))
    scale = d**-0.5
    topk = vsa_topk(0.8, nb)
    idx = torch.stack([torch.randperm(nb, generator=g, device=dev)[:topk]
                       for _ in range(b * h * nb)]).reshape(b, h, nb, topk)
    idx = idx.to(torch.int32)
    kw = dict(scale=scale, tile_elems=e)

    check_sparse_schedule(f"{name}[vsa 480x848]", name, d)
    out, lse = vsa.block_sparse_attention(q, k, v, idx, sizes,
                                          return_lse=True, **kw)
    ref, ref_lse = vsa.block_sparse_attention_plain(q, k, v, idx, sizes,
                                                    return_lse=True, **kw)
    tol = attn_tol(ref, torch.bfloat16)
    err = check(f"{name}[vsa 480x848]", out, ref, *tol)
    check(f"{name}[vsa 480x848] lse", lse, ref_lse, 1e-3)
    ms = time_ms(lambda: vsa.block_sparse_attention(
        q, k, v, idx, sizes, return_lse=True, **kw))
    plain = time_ms(lambda: vsa.block_sparse_attention_plain(
        q, k, v, idx, sizes, return_lse=True, **kw), 1)
    # the library yardstick, timed here only: compiled flex_attention with
    # the same indices and valid counts as a BlockMask
    mask = padded_block_mask(idx, sizes, s, e)
    flex = torch.compile(flex_attention, dynamic=False)
    check("flex_attention[vsa 480x848] (library)",
          flex(q, k, v, block_mask=mask, scale=scale), ref, *tol)
    lib = time_ms(lambda: flex(q, k, v, block_mask=mask, scale=scale))
    flops, nbytes = padded_bound(idx, sizes, d)
    bms, by = bound_ms(flops, nbytes)
    print(f"  {name}[vsa 480x848]: {ms:.3f} ms kernel, {plain:.3f} ms plain, "
          f"{lib:.3f} ms flex_attention, bound {bms:.3f} ms ({by}, "
          f"{flops:.3e} FLOP on real rows and valid keys; top-{topk} of {nb} "
          f"tiles, {sizes.sum().item()} tokens in {s} slots)", flush=True)

    # a query tile whose every slot is a sentinel, on 256-row tiles (two
    # warpgroups a block): exactly 0 and the empty-row LSE
    empty = idx.clone()
    empty[:, :, 5] = -1
    out, lse = vsa.block_sparse_attention(q, k, v, empty, sizes,
                                          return_lse=True, **kw)
    rows = slice(5 * e, 6 * e)
    torch.cuda.synchronize()
    if not ((out[:, :, rows] == 0).all()
            and (lse[:, :, rows] == vsa.MASK_VALUE).all()):
        raise SystemExit(f"{name}: a 256-row tile with no valid key is not "
                         "0 with the empty-row LSE")

    # STA: the (3, 3, 3)-tile window rows of the same grid, no LSE
    widx = torch.as_tensor(sta.sta_window_indices(grid, tile,
                                                  ((3, 3, 3),) * h),
                           device=dev)[None]
    check_sparse_schedule(f"{name}[sta 480x848]", name, d)
    out = vsa.block_sparse_attention(q, k, v, widx, sizes, **kw)
    ref = vsa.block_sparse_attention_plain(q, k, v, widx, sizes, **kw)
    sta_err = check(f"{name}[sta 480x848]", out, ref,
                    *attn_tol(ref, torch.bfloat16))
    sta_ms = time_ms(lambda: vsa.block_sparse_attention(q, k, v, widx, sizes,
                                                        **kw))
    sta_mask = padded_block_mask(widx, sizes, s, e)
    check("flex_attention[sta 480x848] (library)",
          flex(q, k, v, block_mask=sta_mask, scale=scale), ref,
          *attn_tol(ref, torch.bfloat16))
    sta_lib = time_ms(lambda: flex(q, k, v, block_mask=sta_mask, scale=scale))
    sta_flops, sta_bytes = padded_bound(widx, sizes, d)
    sta_bms, sta_by = bound_ms(sta_flops, sta_bytes)
    print(f"  {name}[sta 480x848]: {sta_ms:.3f} ms kernel, {sta_lib:.3f} ms "
          f"flex_attention, bound {sta_bms:.3f} ms ({sta_by}, "
          f"{sta_flops:.3e} FLOP; "
          f"{(widx >= 0).sum().item() // h} (tile, window-tile) pairs a head,"
          f" {(widx < 0).sum().item() // h} sentinel slots)", flush=True)
    del q, k, v, out, ref, lse, ref_lse, mask, sta_mask

    # SLA at the 4f path's length: 64-token full tiles, top 10% of the key
    # blocks from its block map
    s2, e2 = turbo_tokens(), 64
    q, k, v = (torch.randn(b, h, s2, d, generator=g, device=dev,
                           dtype=torch.bfloat16) for _ in range(3))
    lut, _ = sla.sla_block_map(q, k, 0.1)
    full = torch.full((s2 // e2,), e2, dtype=torch.int32, device=dev)
    # the walked fraction: the key tiles a block walks over those a tile
    # keeps; two 64-row tiles a 128-row block would walk their union, so
    # tiles of 64 rows take a block of one warpgroup each (padded_walk)
    nq = s2 // e2
    slots = torch.full(lut.shape[:3], lut.shape[3], dtype=torch.int32,
                       device=dev)
    kept = (lut >= 0).sum().item() / (b * h * nq * nq)
    walked = {}
    for g_ in (2, ss.padded_walk(e2)[1]):
        lens = ss.grouped_lists(lut.int(), slots, nq, e2, group=g_)[1]
        walked[g_] = lens.sum().item() / (b * h * lens.shape[2] * nq)
    print(f"  {name}[sla {s2}]: kept fraction {kept:.4f}; a block of two "
          f"64-row tiles would walk {walked[2]:.4f} ({walked[2] / kept:.2f}x "
          f"the kept pairs); a block of one warpgroup a tile (the route, "
          f"{ss.padded_walk(e2)}) walks {walked[ss.padded_walk(e2)[1]]:.4f}",
          flush=True)
    check_sparse_schedule(f"{name}[sla {s2}]", name, d)
    out = vsa.block_sparse_attention(q, k, v, lut, full, scale=scale)
    ref = vsa.block_sparse_attention_plain(q, k, v, lut, full, scale=scale)
    sla_err = check(f"{name}[sla {s2}]", out, ref,
                    *attn_tol(ref, torch.bfloat16))
    sla_ms = time_ms(lambda: vsa.block_sparse_attention(q, k, v, lut, full,
                                                        scale=scale))
    # 128-row mask blocks span two 64-token query and key tiles each
    sla_mask = vsa_block_mask(lut, s2, e2, e2)
    check(f"flex_attention[sla {s2}] (library)",
          flex(q, k, v, block_mask=sla_mask, scale=scale), ref,
          *attn_tol(ref, torch.bfloat16))
    sla_lib = time_ms(lambda: flex(q, k, v, block_mask=sla_mask, scale=scale))
    sla_flops, sla_bytes = padded_bound(lut, full, d)
    sla_bms, sla_by = bound_ms(sla_flops, sla_bytes)
    print(f"  {name}[sla {s2}]: {sla_ms:.3f} ms kernel, {sla_lib:.3f} ms "
          f"flex_attention, bound {sla_bms:.3f} ms ({sla_by}, "
          f"{sla_flops:.3e} FLOP; top-{lut.shape[-1]} of {s2 // e2} blocks)",
          flush=True)

    # a query tile whose every slot is a sentinel: exactly 0, never NaN
    small = torch.full((1, h, s2 // e2, 2), -1, dtype=torch.int32, device=dev)
    small[:, :, 1:, 0] = 0
    out, lse = vsa.block_sparse_attention(q, k, v, small, full, scale=scale,
                                          return_lse=True)
    torch.cuda.synchronize()
    if not (torch.isfinite(out.float()).all() and torch.isfinite(lse).all()
            and (out[:, :, :e2] == 0).all()
            and (lse[:, :, :e2] == vsa.MASK_VALUE).all()
            and (out[:, :, e2:] != 0).any()):
        raise SystemExit(f"{name}: a row with no valid key is not 0")
    print(f"  {name}[all-masked rows]: output exactly 0, LSE "
          f"{vsa.MASK_VALUE:.3e}, no NaN: ok", flush=True)
    results[name] = dict(
        max_abs_err=max(err, sta_err, sla_err), ms=ms, plain_ms=plain,
        bound_ms=bms, bound_by=by, library_ms=lib,
        shape=f"q{[b, h, s, d]} E{e} tiles{nb} topk{topk} + lse",
        sta_ms=sta_ms, sta_bound_ms=sta_bms, sta_library_ms=sta_lib,
        sla_ms=sla_ms, sla_bound_ms=sla_bms, sla_library_ms=sla_lib,
        sla_kept_fraction=kept, sla_walked_fraction=walked[
            ss.padded_walk(e2)[1]], sla_union_walked_fraction=walked[2])


def dyn_block_mask(mask, sq: int, skv: int, q_block: int, kv_block: int):
    """The flex_attention BlockMask of K9's sparsity: query block qi sees
    every key of the key blocks that ``mask[b, h, qi]`` keeps (all full
    blocks: the tiles hold 64 real tokens each)."""
    import torch
    from torch.nn.attention.flex_attention import BlockMask

    from fastvideo_tpu_torch.ops import nabla

    idx, counts = nabla.mask_indices(mask)
    none = torch.zeros_like(counts)
    return BlockMask.from_kv_blocks(none, idx.clamp_min(0), counts,
                                    idx.clamp_min(0),
                                    BLOCK_SIZE=(q_block, kv_block),
                                    seq_lengths=(sq, skv))


def dyn_bound(mask, rows: int, e: int, d: int) -> tuple[float, float]:
    """(FLOP, bytes) K9 needs for these inputs: 4*D a (query row, kept key)
    pair; q read and o written once, each key tile that some row keeps read
    once (k and v), the indices and counts."""
    b, h, nq, nk = mask.shape
    pairs = mask.sum().item() * rows * e
    tiles = mask.any(dim=2).sum().item()
    nbytes = 2.0 * 2 * b * h * nq * rows * d + 2.0 * 2 * tiles * e * d + \
        4 * (mask.numel() + b * h * nq)
    return 4.0 * d * pairs, nbytes


def time_dyn_case(label: str, q, k, v, mask, q_rows) -> dict:
    """K9a (q_rows None) or K9b on one mask: held to the plain version on
    the same indices and counts, timed, with the plain time, the library
    time (compiled flex_attention with a BlockMask of the same kept pairs,
    (rows, 64) blocks; timed here only, the port never calls it), the
    bound, the kept fraction and the fraction of key tiles the Hopper
    schedule's groups walk (the union of their tiles' lists)."""
    import torch
    from torch.nn.attention.flex_attention import flex_attention

    from fastvideo_tpu_torch.ops import nabla
    from fastvideo_tpu_torch.ops.sparse_schedule import grouped_lists

    rows, e, d = q_rows or 64, 64, q.shape[-1]
    sizes = torch.full((k.shape[2] // e,), e, dtype=torch.int32,
                       device=q.device)
    scale = d**-0.5
    name = nabla.QTILE_NAME if q_rows else nabla.NAME
    check_sparse_schedule(f"{name}[{label}]", name, d)
    idx, counts = nabla.mask_indices(mask)
    kw = dict(scale=scale, q_rows=q_rows)
    out = nabla.dyn_sparse_attention(q, k, v, idx, counts, sizes, **kw)
    ref = nabla.dyn_sparse_attention_plain(q, k, v, idx, counts, sizes, **kw)
    tol = attn_tol(ref, torch.bfloat16)
    err = check(f"{name}[{label}]", out, ref, *tol)
    ms = time_ms(lambda: nabla.dyn_sparse_attention(q, k, v, idx, counts,
                                                    sizes, **kw))
    plain = time_ms(lambda: nabla.dyn_sparse_attention_plain(
        q, k, v, idx, counts, sizes, **kw), 1)
    block_mask = dyn_block_mask(mask, q.shape[2], k.shape[2], rows, e)
    flex = torch.compile(flex_attention, dynamic=False)
    opts = {"BLOCK_M": rows, "BLOCK_N": e}
    check(f"flex_attention[{label}] (library)",
          flex(q, k, v, block_mask=block_mask, scale=scale,
               kernel_options=opts), ref, *tol)
    lib = time_ms(lambda: flex(q, k, v, block_mask=block_mask, scale=scale,
                               kernel_options=opts))
    flops, nbytes = dyn_bound(mask, rows, e, d)
    bms, by = bound_ms(flops, nbytes)
    kept = mask.float().mean().item()
    # the Hopper schedule walks each group's union: the key tiles it runs
    _, lens, _, group = grouped_lists(idx, counts, mask.shape[-1], rows)
    walked = lens.float().mean().item() / mask.shape[-1]
    print(f"  {name}[{label}]: {ms:.3f} ms kernel, {plain:.3f} ms plain, "
          f"{lib:.3f} ms flex_attention ({rows}, {e}) blocks, bound "
          f"{bms:.3f} ms ({by}, {flops:.3e} FLOP); kept fraction {kept:.4f},"
          f" counts {counts.min().item()}..{counts.max().item()} of "
          f"{mask.shape[-1]}; groups of {group} tiles walk {walked:.4f} of "
          f"the key tiles; q{list(q.shape)} k{list(k.shape)}", flush=True)
    return dict(max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=bms,
                bound_by=by, library_ms=lib, kept_fraction=kept,
                walked_fraction=walked)


def check_dyn_sparse(dev, results: dict) -> None:
    """K9a at 4k's NABLA shape (q/k/v [1, 12, 24960, 128], 390 tiles) under
    the mask nabla_block_mask builds from seeded q/k at thr 0.9, and under
    a mask whose per-row counts run from 1 to 390; K9b at 4j's BSA shape
    (the pruned queries of the 480x848 grid's 672 padded tiles, 32 rows a
    tile, over k/v [1, 12, 43008, 128]) under select_kv_blocks' mask."""
    import torch

    from fastvideo_tpu_torch.ops import bsa, nabla, vsa

    g = torch.Generator(device=dev).manual_seed(9)
    b, h, d, bf = 1, 12, 128, torch.bfloat16
    s = turbo_tokens()
    nb = s // 64
    q, k, v = (torch.randn(b, s, h, d, generator=g, device=dev, dtype=bf)
               for _ in range(3))
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    mask = nabla.nabla_block_mask(q, k, None, 0.9)
    r = time_dyn_case(f"nabla {s} thr 0.9", qt, kt, vt, mask, None)
    # counts 1 .. nb across each head's rows, random tiles
    row = torch.arange(nb, device=dev)
    counts = (row[None, :] + 37 * torch.arange(h, device=dev)[:, None]) % nb
    ranks = torch.rand(b, h, nb, nb, generator=g, device=dev).argsort(
        -1).argsort(-1)
    ramp = ranks < (counts + 1)[None, :, :, None]
    r2 = time_dyn_case(f"counts 1..{nb}", qt, kt, vt, ramp, None)
    results[nabla.NAME] = dict(
        r, shape=f"q/k/v{[b, h, s, d]}, {nb} tiles, NABLA mask thr 0.9",
        ramp_ms=r2["ms"], ramp_bound_ms=r2["bound_ms"],
        ramp_library_ms=r2["library_ms"], ramp_plain_ms=r2["plain_ms"],
        ramp_kept_fraction=r2["kept_fraction"],
        ramp_walked_fraction=r2["walked_fraction"],
        max_abs_err=max(r["max_abs_err"], r2["max_abs_err"]))
    del q, k, v, qt, kt, vt, mask, ramp
    torch.cuda.empty_cache()

    # K9b: the 480x848 grid as BSA_ATTN builds it
    grid = (21, 30, 53)
    s = grid[0] * grid[1] * grid[2]
    q, k, v = (vsa.tile_tokens(torch.randn(b, s, h, d, generator=g,
                                           device=dev, dtype=bf), grid)
               for _ in range(3))
    n = q.shape[1] // 64
    qb = q.transpose(1, 2).reshape(b, h, n, 64, d)
    kb = k.transpose(1, 2).reshape(b, h, n, 64, d)
    sparse_q, _, keep = bsa.prune_queries(qb, 0.5)
    mask = bsa.select_kv_blocks(sparse_q, kb, 0.9, 1)
    qs = sparse_q.reshape(b, h, n * keep, d)
    kbt, vt = kb.reshape(b, h, n * 64, d), v.transpose(1, 2)
    r = time_dyn_case(f"bsa 480x848 q_rows {keep}", qs, kbt, vt, mask, keep)
    results[nabla.QTILE_NAME] = dict(
        r, shape=f"q{[b, h, n * keep, d]} ({keep} rows a tile) over "
        f"k/v{[b, h, n * 64, d]}, {n} tiles, select_kv_blocks thr 0.9")


def decode_chunk_frames(latent: tuple[int, int, int]) -> int:
    """Latent frames per chunk of the dispatched decode of a (T, H, W)
    latent (pipelines/stages/decoding.py), T for a one-pass decode."""
    import types

    import torch

    from fastvideo_tpu_torch.pipelines.stages.decoding import (
        dispatched_chunk_frames)

    z = torch.empty(1, VAE_CFG["z_dim"], *latent, device="meta")
    return (dispatched_chunk_frames(z, types.SimpleNamespace(**VAE_CFG))
            or latent[0])


def chunk_conv_shapes(latent: tuple[int, int, int],
                      stream: bool = False) -> list[tuple]:
    """(label, convs, C, Co, kt, time_pad, T_in, H, W): the decoder's 3x3
    convs in the two kinds of chunk of the dispatched decode of a (T, H, W)
    latent: the first latent frame alone (each kt = 3 conv pads 2 zero
    frames in front) and a chunk of later frames (each kt = 3 conv reads
    the 2 frames cached from the chunk before, no pad). With ``stream``
    also the third kind the streaming decode runs: one later latent frame
    behind its 2 cached frames."""
    chunk = decode_chunk_frames(latent)
    kinds = [("first chunk", 1, 1), (f"{chunk}-frame chunk", chunk, 0)]
    if stream:
        kinds.append(("stream 1-frame chunk", 1, 0))
    out = []
    for kind, t0, first in kinds:
        for label, n, c, co, kt, t, h, w in decoder_conv_shapes(
                (t0, *latent[1:]), first_len=first):
            tp = kt - 1 if first else 0
            out.append((f"{label}@{h}x{w} {kind}", n, c, co, kt, tp,
                        t + kt - 1 - tp, h, w))
    return out


def is_hot(label: str) -> bool:
    """The decode's hot conv: up3's 96x96 resnet convs at full resolution,
    in a chunk of later frames of the dispatched decode."""
    return (label.startswith("up3 resnets") and "first chunk" not in label
            and "stream" not in label)


def real_taps(t_out: int, kt: int, time_pad: int) -> int:
    """(output frame, time tap) pairs of a causal conv that read a real
    input frame (the taps K3 walks): the taps on the zero pad in front add
    nothing and are not work the conv needs."""
    from fastvideo_tpu_torch.ops.conv3d import live_time_taps

    t_in = t_out + kt - 1 - time_pad
    return sum(len(live_time_taps(o, kt, time_pad, t_in))
               for o in range(t_out))


def cudnn_conv(x, wt, bias, tp: int):
    """The library yardstick of K3, timed here only: cuDNN's F.conv3d on
    the same channels-last inputs and weight, with the causal pad."""
    import torch
    import torch.nn.functional as F

    xc = x.permute(0, 4, 1, 2, 3)  # NCDHW view, channels-last strides
    wc = wt.permute(4, 3, 0, 1, 2).contiguous(
        memory_format=torch.channels_last_3d)
    return lambda: F.conv3d(F.pad(xc, (0, 0, 0, 0, tp, 0)), wc, bias,
                            padding=(0, 1, 1))


def check_conv(dev, results: dict) -> None:
    """K3 (bf16) at every 3x3 conv shape of the decoder's chunks, each
    taking the Hopper schedule, with kernel, plain, cuDNN and bound times
    at up3's hot conv (W = 832 and 848) and at the stream's chunk."""
    import torch

    from fastvideo_tpu_torch.ops import conv3d

    g = torch.Generator(device=dev).manual_seed(2)
    errs = []
    # 480x832 (FastWan, TurboDiffusion, the causal stream's one-frame
    # decodes) and 480x848 (Wan UniPC paths: 53 x 16 columns, a different
    # ragged tail on the implicit-GEMM tiles)
    for label, _, c, co, kt, tp, t, h, w in (
            chunk_conv_shapes((21, 60, 104), stream=True)
            + chunk_conv_shapes((21, 60, 106))):
        x = torch.randn(1, t, h, w, c, generator=g, device=dev,
                        dtype=torch.bfloat16)
        wt = (torch.randn(kt, 3, 3, c, co, generator=g, device=dev) *
              (kt * 9 * c)**-0.5).to(torch.bfloat16)
        bias = torch.randn(co, generator=g, device=dev).to(torch.bfloat16)
        sched = check_conv_schedule(f"conv3d[{label}]", c, co)
        out = conv3d.conv3d_ndhwc(x, wt, bias, time_pad=tp)
        ref = conv3d.conv3d_ndhwc_plain(x, wt, bias, time_pad=tp)
        # bf16 outputs: two bf16 ulps (2 * 2^-7) relative, plus 1e-2 for
        # values near zero where fp32 summation order shows
        errs.append(check(f"conv3d[{label}] ({sched}, "
                          f"{conv3d.conv_tile_w(h, w)}-wide patches)", out,
                          ref, 1e-2, 1.6e-2))
        t_out = t + tp - kt + 1
        flops = 2.0 * real_taps(t_out, kt, tp) * h * w * c * co * 9
        nbytes = 2.0 * (t * h * w * c + t_out * h * w * co + wt.numel() + co)
        bms, by = bound_ms(flops, nbytes)
        if label.startswith("up3 resnets") and "stream" in label:
            ms = time_ms(lambda: conv3d.conv3d_ndhwc(x, wt, bias,
                                                     time_pad=tp))
            lib = time_ms(cudnn_conv(x, wt, bias, tp))
            results["conv3d"].update(stream_ms=ms, stream_bound_ms=bms,
                                     stream_library_ms=lib)
            print(f"  conv3d[{label}]: {ms:.3f} ms kernel, {lib:.3f} ms "
                  f"cudnn, bound {bms:.3f} ms ({by}, {flops:.3e} FLOP)",
                  flush=True)
        if not is_hot(label):
            del x, out, ref
            continue
        ms = time_ms(lambda: conv3d.conv3d_ndhwc(x, wt, bias, time_pad=tp))
        plain = time_ms(lambda: conv3d.conv3d_ndhwc_plain(
            x, wt, bias, time_pad=tp), 1)
        lib = time_ms(cudnn_conv(x, wt, bias, tp))
        if w == 832:
            results["conv3d"] = dict(
                max_abs_err=0.0, ms=ms, plain_ms=plain, bound_ms=bms,
                bound_by=by, library_ms=lib,
                shape=f"x{[1, t, h, w, c]} w{[kt, 3, 3, c, co]}")
        else:
            results["conv3d"].update(w848_ms=ms, w848_plain_ms=plain,
                                     w848_bound_ms=bms, w848_library_ms=lib)
        print(f"  conv3d[{label}]: {ms:.3f} ms kernel, {plain:.3f} ms plain,"
              f" {lib:.3f} ms cudnn, bound {bms:.3f} ms ({by}, "
              f"{flops:.3e} FLOP)", flush=True)
        del x, out, ref
    results["conv3d"]["max_abs_err"] = max(errs)  # over every shape


def decoder_conv_shapes(latent: tuple[int, int, int],
                        first_len: int = 1) -> list[tuple]:
    """The decoder's 3x3 convs for a (T, H, W) latent, from its structure
    (models/vaes/wan.py): (label, convs, C, Co, kt, output frames, H, W).
    Every conv runs once per decode chunk, the frames split across the
    chunks. Each temporal upsample doubles the frames from ``first_len``
    on: the clip's first frame is never doubled, and a later chunk holds
    none of it (``first_len`` 0)."""
    t0, h0, w0 = latent
    t1 = first_len + 2 * (t0 - first_len)  # frames after each upsample
    t2 = first_len + 2 * (t1 - first_len)
    return [
        ("conv_in", 1, 16, 384, 3, t0, h0, w0),
        ("mid + up0 resnets 384x384", 10, 384, 384, 3, t0, h0, w0),
        ("up0 resample 384->192 (1,3,3)", 1, 384, 192, 1, t1, 2 * h0,
         2 * w0),
        ("up1 resnet0 conv1 192->384", 1, 192, 384, 3, t1, 2 * h0, 2 * w0),
        ("up1 resnets 384x384", 5, 384, 384, 3, t1, 2 * h0, 2 * w0),
        ("up1 resample 384->192 (1,3,3)", 1, 384, 192, 1, t2, 4 * h0,
         4 * w0),
        ("up2 resnets 192x192", 6, 192, 192, 3, t2, 4 * h0, 4 * w0),
        ("up2 resample 192->96 (1,3,3)", 1, 192, 96, 1, t2, 8 * h0, 8 * w0),
        ("up3 resnets 96x96", 6, 96, 96, 3, t2, 8 * h0, 8 * w0),
        ("conv_out 96->3", 1, 96, 3, 3, t2, 8 * h0, 8 * w0),
    ]


def int8_route_split(latent: tuple[int, int, int]) -> tuple[int, int]:
    """(K4 convs, K3 convs) of one decode chunk under auto_int8: the JAX
    package's int8 rule (C, Co multiples of 32, C >= 64, W >= 256)."""
    from fastvideo_tpu_torch.ops.conv3d import int8_ok

    k4 = sum(n for _, n, c, co, _, _, _, w in decoder_conv_shapes(latent)
             if int8_ok(c, co, w, "auto_int8"))
    k3 = sum(n for _, n, *_ in decoder_conv_shapes(latent))
    return k4, k3 - k4


def decode_conv_bound(latent: tuple[int, int, int]) -> float:
    """Print the bound of the decode's K3 launches per distinct conv shape
    (from the decoder's structure for a (T, H, W) latent) and return the
    total ms."""
    total_flops = total_bytes = 0.0
    t2 = 4 * latent[0] - 3
    h0, w0 = latent[1:]
    for label, n, c, co, kt, t, h, w in decoder_conv_shapes(latent):
        flops = 2.0 * n * real_taps(t, kt, kt - 1) * h * w * c * co * 9
        nbytes = 2.0 * n * t * h * w * (c + co)
        total_flops += flops
        total_bytes += nbytes
        bms, by = bound_ms(flops, nbytes)
        print(f"  K3 bound {label}: {n} conv(s), {flops:.3e} FLOP, "
              f"{bms:.1f} ms ({by})", flush=True)
    bms, by = bound_ms(total_flops, total_bytes)
    print(f"  K3 bound for one {t2}x{8 * h0}x{8 * w0} decode: "
          f"{total_flops:.4e} FLOP, "
          f"{bms:.1f} ms ({by})", flush=True)
    return bms


def int8_conv_shapes() -> list[tuple]:
    """(label, mode, C, Co, kt, time_pad, T_in, H, W): every decoder conv
    shape that takes K4 at 480x832 under auto_int8, in both kinds of decode
    chunk, and the two edges of the route: C = Co = 32 under kf_int8 and
    W = 256 under auto_int8."""
    from fastvideo_tpu_torch.ops.conv3d import int8_ok

    out = [(label, "auto_int8", c, co, kt, tp, t, h, w)
           for label, _, c, co, kt, tp, t, h, w in chunk_conv_shapes(
               (21, 60, 104)) if int8_ok(c, co, w, "auto_int8")]
    out.append(("edge C=Co=32", "kf_int8", 32, 32, 3, 2, 4, 30, 52))
    out.append(("edge W=256", "auto_int8", 64, 64, 3, 2, 3, 16, 256))
    return out


def check_ulp(name: str, got, want) -> float:
    """K4 against its plain version: the int32 sums are exact in both, so
    they may differ by the epilogue's rounding only, at most one bf16 ulp
    of the output. Returns the max absolute error."""
    import torch

    torch.cuda.synchronize()
    if not torch.isfinite(got.float()).all():
        raise SystemExit(f"{name}: kernel output has non-finite values")
    diff = (got.float() - want.float()).abs()
    ulp = torch.exp2(torch.floor(torch.log2(
        want.float().abs().clamp_min(2.0**-126))) - 7)
    ok = bool((diff <= ulp).all())
    err = diff.max().item()
    print(f"  {name}: max_abs_err {err:.3e} (tolerance one bf16 ulp of the "
          f"plain output) {'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        raise SystemExit(f"{name}: kernel disagrees with its plain version")
    return err


def check_conv_int8(dev, results: dict) -> None:
    """K4 at every int8 decoder shape of 480x832 and at the route's edges:
    conv3d_ndhwc in the int8 mode takes K4 (and the quantize passes), and
    K4 agrees with conv3d_int8_plain on the same quantized operands. At the
    hot shape: K4, plain, K3 and cuDNN bf16 times and the quantize pass."""
    import torch
    import torch.nn.functional as F

    from fastvideo_tpu_torch.ops import _build, conv3d

    g = torch.Generator(device=dev).manual_seed(8)
    errs, total_ms, n_shapes = [], 0.0, 0
    for label, mode, c, co, kt, tp, t, h, w in int8_conv_shapes():
        x = torch.randn(1, t, h, w, c, generator=g, device=dev,
                        dtype=torch.bfloat16)
        wt = (torch.randn(kt, 3, 3, c, co, generator=g, device=dev) *
              (kt * 9 * c)**-0.5).to(torch.bfloat16)
        b = torch.randn(co, generator=g, device=dev).to(torch.bfloat16)
        before = _build.LAUNCHES[conv3d.NAME_INT8]
        routed = conv3d.conv3d_ndhwc(x, wt, b, time_pad=tp, mode=mode)
        if _build.LAUNCHES[conv3d.NAME_INT8] != before + 1:
            raise SystemExit(f"conv3d_int8[{label}]: {mode} did not take K4")
        xq, sx = conv3d.quantize_int8(x)
        wq, sw = conv3d.quantize_int8(wt, dims=(0, 1, 2, 3))
        scale, bias = sw.reshape(-1) * sx.reshape(()), b.float()
        args = (xq, wq, scale, bias)
        kw = dict(time_pad=tp, out_dtype=torch.bfloat16)
        out = conv3d.conv3d_int8(*args, **kw)
        ref = conv3d.conv3d_int8_plain(*args, **kw)
        errs.append(check_ulp(f"conv3d_int8[{label}]", out, ref))
        if not torch.equal(out, ref):
            raise SystemExit(f"conv3d_int8[{label}]: K4 is not bit for bit "
                             "its plain version (exact int32 sums, the same "
                             "epilogue roundings)")
        if not torch.equal(routed, out):
            raise SystemExit(f"conv3d_int8[{label}]: conv3d_ndhwc's int8 "
                             "route differs from K4 on its own operands")
        del routed, ref
        t_out = t + tp - kt + 1
        flops = 2.0 * real_taps(t_out, kt, tp) * h * w * c * co * 9
        nbytes = t * h * w * c + wq.numel() + 2.0 * t_out * h * w * co + 8 * co
        bms, by = bound_ms(flops, nbytes, "int8")
        ms = time_ms(lambda: conv3d.conv3d_int8(*args, **kw), 3)
        if not label.startswith("edge"):
            total_ms += ms
            n_shapes += 1
        print(f"  conv3d_int8[{label}]: {ms:.3f} ms kernel, "
              f"{flops / ms / 1e9:.1f} TOPS, bound {bms:.3f} ms ({by}, "
              f"{flops:.3e} operations)", flush=True)
        if not is_hot(label):
            del x, xq, out
            continue
        plain = time_ms(lambda: conv3d.conv3d_int8_plain(*args, **kw), 1)
        quant = time_ms(lambda: conv3d.quantize_int8(x), 3)
        k3 = time_ms(lambda: conv3d.conv3d_ndhwc(x, wt, b, time_pad=tp), 3)
        xc = x.permute(0, 4, 1, 2, 3)  # NCDHW view, channels-last strides
        wc = wt.permute(4, 3, 0, 1, 2).contiguous(
            memory_format=torch.channels_last_3d)
        cudnn = time_ms(lambda: F.conv3d(F.pad(xc, (0, 0, 0, 0, tp, 0)), wc,
                                         b, padding=(0, 1, 1)), 3)
        results["conv3d_int8"] = dict(
            max_abs_err=0.0, ms=ms, plain_ms=plain, bound_ms=bms,
            bound_by=by, library_ms=None, bf16_cudnn_ms=cudnn, bf16_k3_ms=k3,
            quantize_ms=quant,
            shape=f"xq{[1, t, h, w, c]} wq{[kt, 3, 3, c, co]}")
        print(f"  conv3d_int8[{label}]: {plain:.3f} ms plain (torch._int_mm "
              f"per tap); context: {k3:.3f} ms K3 and {cudnn:.3f} ms cuDNN "
              f"F.conv3d in bf16 on the same x (no single PyTorch call "
              f"computes an int8 conv3d); the per-tensor quantize pass "
              f"{quant:.3f} ms", flush=True)
        del x, xq, out
    results["conv3d_int8"]["max_abs_err"] = max(errs)
    results["conv3d_int8"]["chunk_shapes_ms"] = total_ms
    print(f"  K4 at the {n_shapes} 480x832 chunk shapes: {total_ms:.1f} ms for "
          f"one conv of each", flush=True)


def check_w8a8_linear(dev) -> None:
    """The W8A8 linear (per-token quantize, torch._int_mm, dequantize) at
    the DiT's FFN shapes against F.linear in bf16: times, and the int8
    result's distance from the bf16 one."""
    import torch

    from fastvideo_tpu_torch.layers.linear import Linear
    from fastvideo_tpu_torch.layers.quantization import int8

    torch.manual_seed(9)
    for fin, fout in ((1536, 8960), (8960, 1536)):
        lin = Linear(fin, fout, device=dev, dtype=torch.bfloat16)
        q = int8.Int8Linear.from_linear(lin)
        x = torch.randn(1, 32760, fin, device=dev, dtype=torch.bfloat16)
        want, got = lin(x).float(), q(x).float()
        rel = ((got - want).norm() / want.norm()).item()
        if not (torch.isfinite(got).all() and rel < 3e-2):
            raise SystemExit(f"W8A8 linear {fin}->{fout}: relative error "
                             f"{rel:.3e} against bf16")
        xq, _ = int8.quantize_activation(x)
        ms_q = time_ms(lambda: q(x))
        ms_bf16 = time_ms(lambda: lin(x))
        ms_quant = time_ms(lambda: int8.quantize_activation(x))
        ms_mm = time_ms(lambda: int8.int8_mm(xq.reshape(-1, fin), q.weight_q))
        ops = 2.0 * 32760 * fin * fout
        print(f"  W8A8 linear [32760, {fin}] -> {fout}: {ms_q:.3f} ms "
              f"(quantize {ms_quant:.3f}, torch._int_mm {ms_mm:.3f} ms = "
              f"{ops / ms_mm / 1e9:.0f} TOPS, the rest dequantize and bias); "
              f"F.linear bf16 {ms_bf16:.3f} ms ({ops / ms_bf16 / 1e9:.0f} "
              f"TFLOP/s); relative L2 distance {rel:.2e}", flush=True)
        del lin, q, x, xq, want, got


# the causal stream at 480x832: a block of 3 latent frames of 30 x 52
# tokens, and the 21-frame KV window
CAUSAL_BLOCK_TOKENS = 3 * 30 * 52
CAUSAL_WINDOW_TOKENS = 21 * 30 * 52


def check_flash_kv_mask(dev, results: dict) -> None:
    """K5 at the causal stream's shapes: one block's queries
    [1, 4680, 12, 128] over the window's keys [1, 32760, 12, 128] in bf16,
    with the window as block 0 sees it (its last 4,680 slots valid), as
    block 3 sees it (18,720) and full (block 7 on). The bound counts the
    valid keys only, which is all the kernel reads and computes."""
    import torch
    import torch.nn.functional as F

    from fastvideo_tpu_torch.ops import flash_attention as fa

    g = torch.Generator(device=dev).manual_seed(12)
    n, window, h, d = CAUSAL_BLOCK_TOKENS, CAUSAL_WINDOW_TOKENS, 12, 128
    q, k, v = (torch.randn(1, s, h, d, generator=g, device=dev,
                           dtype=torch.bfloat16) for s in (n, window, window))
    pos = torch.arange(window, device=dev)
    errs, rec = [], {}
    for label, valid in (("block0", n), ("block3", 4 * n),
                         ("full", window)):
        mask = pos >= window - valid
        kw = dict(scale=d**-0.5)
        check_schedule(f"flash_fwd_kv_mask[{label}]", torch.bfloat16, d)
        out = fa.flash_attention_kv_mask(q, k, v, mask, **kw)
        ref = fa.flash_attention_kv_mask_plain(q, k, v, mask, **kw)
        errs.append(check(f"flash_fwd_kv_mask[{label}: {valid} of {window} "
                          f"keys]", out, ref, *attn_tol(ref, torch.bfloat16)))
        del out, ref
        ms = time_ms(lambda: fa.flash_attention_kv_mask(q, k, v, mask, **kw))
        flops = 4.0 * h * n * valid * d
        nbytes = 2.0 * (2 * n * h * d + 2 * valid * h * d) + window
        bms, by = bound_ms(flops, nbytes)
        rec[label] = (ms, bms, by)
        line = (f"  flash_fwd_kv_mask[{label}]: {ms:.3f} ms kernel, bound "
                f"{bms:.3f} ms ({by}, {flops:.3e} FLOP)")
        if label == "full":
            plain = time_ms(lambda: fa.flash_attention_kv_mask_plain(
                q, k, v, mask, **kw), 1)
            qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
            lib = time_ms(lambda: F.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=mask[None, None, None, :], **kw))
            line += f", {plain:.3f} ms plain, {lib:.3f} ms sdpa with the mask"
        print(line, flush=True)
    ms, bms, by = rec["full"]
    results["flash_fwd_kv_mask"] = dict(
        max_abs_err=max(errs), ms=ms, plain_ms=plain, bound_ms=bms,
        bound_by=by, library_ms=lib,
        shape=f"q[1, {n}, {h}, {d}] kv[1, {window}, {h}, {d}] bf16",
        block0_ms=rec["block0"][0], block0_bound_ms=rec["block0"][1],
        block3_ms=rec["block3"][0], block3_bound_ms=rec["block3"][1])
    del q, k, v


def check_causal_distill(dev, results: dict) -> None:
    """The causal distillation methods' shapes (4o-4q), bf16, each against
    its plain version and timed beside SDPA and its bound: K5 over a full
    clip on fresh caches (q = k = [1, 32760, 12, 128], every key valid:
    the score models' passes), and the grad route's K1 forward and K6
    backward at the generator's last block (q [1, 4680, 12, 128] over
    32,760 gathered keys) and at a full clip (q = k = [1, 32760, 12, 128]:
    the critic's pass, and causal_cd's student)."""
    import torch
    import torch.nn.functional as F

    from fastvideo_tpu_torch.ops import _build
    from fastvideo_tpu_torch.ops import flash_attention as fa

    g = torch.Generator(device=dev).manual_seed(21)
    h, d, skv = 12, 128, CAUSAL_WINDOW_TOKENS
    scale = d**-0.5
    bf16 = torch.bfloat16

    def rnd(s):
        return torch.randn(1, s, h, d, generator=g, device=dev, dtype=bf16)

    def sdpa(*ts):
        return F.scaled_dot_product_attention(
            *(t.transpose(1, 2) for t in ts), scale=scale)

    k, v, q_clip = rnd(skv), rnd(skv), rnd(skv)
    q = q_clip
    everything = torch.ones(skv, dtype=torch.bool, device=dev)
    check_schedule("flash_fwd_kv_mask[full clip]", bf16, d)
    out = fa.flash_attention_kv_mask(q, k, v, everything, scale=scale)
    ref = fa.flash_attention_kv_mask_plain(q, k, v, everything, scale=scale)
    err = check(f"flash_fwd_kv_mask[full clip: {skv} of {skv} keys]", out,
                ref, *attn_tol(ref, bf16))
    del out, ref
    ms = time_ms(lambda: fa.flash_attention_kv_mask(q, k, v, everything,
                                                    scale=scale))
    plain = time_ms(lambda: fa.flash_attention_kv_mask_plain(
        q, k, v, everything, scale=scale), 1)
    lib = time_ms(lambda: sdpa(q, k, v))
    flops = 4.0 * h * skv * skv * d
    bms, by = bound_ms(flops, 2.0 * 4 * skv * h * d + skv)
    r = results["flash_fwd_kv_mask"]
    r.update(full_clip_ms=ms, full_clip_plain_ms=plain, full_clip_bound_ms=bms,
             full_clip_library_ms=lib, full_clip_max_abs_err=err,
             full_clip_shape=f"q/k/v[1, {skv}, {h}, {d}] bf16, every key "
             "valid")
    r["max_abs_err"] = max(r["max_abs_err"], err)
    print(f"  flash_fwd_kv_mask[full clip]: {ms:.3f} ms kernel, {plain:.3f} "
          f"ms plain, {lib:.3f} ms sdpa, bound {bms:.3f} ms ({by}, "
          f"{flops:.3e} FLOP)", flush=True)
    sms = _build.num_sms(dev)
    for label, sq in (("generator", CAUSAL_BLOCK_TOKENS), ("full_clip", skv)):
        q, do = (q_clip if sq == skv else rnd(sq)), rnd(sq)
        kw = dict(scale=scale, causal=False, kv_valid=skv)
        check_schedule(f"flash_fwd[grad route {label}]", bf16, d)
        check_schedule(f"flash_bwd[grad route {label}]", bf16, d,
                       backward=True)
        out, lse = fa.flash_attention(q, k, v, return_lse=True, **kw)
        ref, ref_lse = fa.flash_attention_plain(q, k, v, **kw)
        f_err = check(f"flash_fwd[grad route {label}: q{[1, sq, h, d]} over "
                      f"{skv} keys]", out, ref, *attn_tol(ref, bf16))
        check(f"flash_fwd[grad route {label}] lse", lse, ref_lse, 1e-3)
        del ref, ref_lse
        f_ms = time_ms(lambda: fa.flash_attention(q, k, v, **kw))
        f_plain = time_ms(lambda: fa.flash_attention_plain(q, k, v, **kw), 1)
        f_lib = time_ms(lambda: sdpa(q, k, v))
        f_flops = 4.0 * h * sq * skv * d
        f_b, f_by = bound_ms(f_flops, 2.0 * (2 * sq * h * d + 2 * skv * h * d)
                             + 4.0 * h * sq)
        got = fa.flash_attention_bwd(q, k, v, out, lse, do, **kw)
        want = fa.flash_attention_bwd_plain(q, k, v, out, lse, do, **kw)
        errs = [check(f"flash_bwd[grad route {label}] d{n}", t, w,
                      *attn_tol(w, bf16)) for n, t, w in zip("qkv", got, want)]
        del got, want
        splits = fa.dkv_splits(1, h, sq, skv, d, sms)
        names = {"dq": "flash_bwd_dq_sm90", "dkv": "flash_bwd_dkv_sm90"}
        if splits > 1:
            names["reduce"] = "flash_bwd_dkv_reduce"
        b_ms = kernel_device_ms(
            lambda: fa.flash_attention_bwd(q, k, v, out, lse, do, **kw),
            names)
        whole = time_ms(lambda: fa.flash_attention_bwd(q, k, v, out, lse, do,
                                                       **kw))
        b_plain = time_ms(lambda: fa.flash_attention_bwd_plain(
            q, k, v, out, lse, do, **kw), 1)
        b_lib = library_backward_ms(
            lambda a, b_, c: F.scaled_dot_product_attention(a, b_, c,
                                                            scale=scale),
            tuple(t.transpose(1, 2) for t in (q, k, v)), do.transpose(1, 2))
        product = 2.0 * h * sq * skv * d
        rows = 2.0 * h * d
        io = 4 * 2 * h * sq + 2 * rows * skv
        (dq_b, _), (dkv_b, _), (all_b, all_by) = bwd_bounds(
            product, io + 3 * rows * sq, io + 2 * rows * sq + 2 * rows * skv)
        shape = f"q/dO[1, {sq}, {h}, {d}] k/v[1, {skv}, {h}, {d}] bf16"
        results["flash_fwd"][f"{label}_grad_route"] = dict(
            ms=f_ms, plain_ms=f_plain, bound_ms=f_b, library_ms=f_lib,
            max_abs_err=f_err, shape=shape)
        for name, t, bnd, e in (("flash_bwd_dq", b_ms["dq"], dq_b, errs[0]),
                                ("flash_bwd_dkv", b_ms["dkv"], dkv_b,
                                 max(errs[1:]))):
            results[name][f"{label}_grad_route"] = dict(
                ms=t, bound_ms=bnd, backward_ms=whole,
                backward_bound_ms=all_b, plain_ms=b_plain, library_ms=b_lib,
                max_abs_err=e, splits=splits, shape=shape)
            results[name]["max_abs_err"] = max(results[name]["max_abs_err"],
                                               e)
        results["flash_fwd"]["max_abs_err"] = max(
            results["flash_fwd"]["max_abs_err"], f_err)
        print(f"  grad route {label}, {shape}: K1 {f_ms:.3f} ms (bound "
              f"{f_b:.3f}, {f_by}; plain {f_plain:.3f}; sdpa {f_lib:.3f}); "
              f"K6 dQ {b_ms['dq']:.3f} ms (bound {dq_b:.3f}), dK/dV "
              f"{b_ms['dkv']:.3f} ms (bound {dkv_b:.3f}, {splits} splits), "
              f"the backward {whole:.3f} ms with delta (bound {all_b:.3f}, "
              f"{all_by}; plain {b_plain:.3f}; sdpa's backward "
              f"{b_lib:.3f})", flush=True)
        del out, lse, do
    del q, q_clip, k, v


def check_fp32_decode(dev, results: dict) -> None:
    """The fp32 decode's kernels (vae_decode_precision="fp32") at 480x832:
    K3's fp32 form (the 3xTF32 schedule) at up3's 96x96 conv in the first
    decode chunk (one output frame, two of its three time taps on the
    causal pad) and in a 2-frame chunk (8 output frames, every tap real),
    each beside the error of one TF32 product (the plain conv with TF32
    matmuls), which the gate would refuse, and at conv_out's 96->3 tail; K4
    storing fp32 (bit for bit with its plain version), and K1 in fp32 at
    the VAE attention's head of 384 (check_fp32_vae_attn). The conv bounds
    count the real taps only: three TF32 products a pair at 495 TFLOP/s,
    and, for reference, fp32 FMAs at 67."""
    import torch
    import torch.nn.functional as F

    from fastvideo_tpu_torch.ops import _build, conv3d
    from fastvideo_tpu_torch.ops import flash_attention as fa

    g = torch.Generator(device=dev).manual_seed(13)
    chunk = decode_chunk_frames(latent_of(CLIP_480P))
    errs = []
    for label, co, t, tp, key in (
            ("up3 resnet 96x96, first chunk", 96, 1, 2, "fp32"),
            ("conv_out 96->3, first chunk", 3, 1, 2, None),
            (f"up3 resnet 96x96, {chunk}-frame chunk", 96, 4 * chunk + 2, 0,
             "fp32_chunk")):
        x = torch.randn(1, t, 480, 832, 96, generator=g, device=dev)
        wt = torch.randn(3, 3, 3, 96, co, generator=g, device=dev) * (
            27 * 96)**-0.5
        b = torch.randn(co, generator=g, device=dev)
        if conv3d.conv_schedule(x.dtype, 96, co) != "tf32x3" or \
                _build.query(conv3d.NAME, "fvt_conv3d_route", 0, 96, co) != 2:
            raise SystemExit(f"conv3d fp32[{label}]: the library or the host "
                             "rule does not take the 3xTF32 schedule")
        out = conv3d.conv3d_ndhwc(x, wt, b, time_pad=tp)
        ref = conv3d.conv3d_ndhwc_plain(x, wt, b, time_pad=tp)
        # fp32: three TF32 products a pair (the lo-lo product, about 2^-22
        # of each, left out) summed a stage at a time, against the plain
        # version's tap-by-tap fp32 sums over K = 2592 products of order-1
        # outputs
        errs.append(check(f"conv3d fp32[{label}] (tf32x3)", out, ref, 5e-5,
                          1e-5))
        del out
        if key is None:  # cuBLAS takes no TF32 path for conv_out's 3 columns
            del ref
            continue
        # one TF32 product a pair, for the record: the plain conv with
        # TF32 matmuls (what the 3xTF32 split avoids)
        torch.backends.cuda.matmul.allow_tf32 = True
        one = conv3d.conv3d_ndhwc_plain(x, wt, b, time_pad=tp)
        torch.backends.cuda.matmul.allow_tf32 = False
        one_err = (one - ref).abs().max().item()
        gate = ((one - ref).abs() / (5e-5 + 1e-5 * ref.abs())).max().item()
        print(f"  conv3d fp32[{label}]: one TF32 product a pair would err "
              f"{one_err:.3e}, {gate:.1f}x the gate", flush=True)
        results["conv3d"][f"{key}_tf32x1_err"] = one_err
        del one, ref
        ms = time_ms(lambda: conv3d.conv3d_ndhwc(x, wt, b, time_pad=tp))
        plain = time_ms(lambda: conv3d.conv3d_ndhwc_plain(x, wt, b,
                                                          time_pad=tp), 2)
        xc = x.permute(0, 4, 1, 2, 3)
        wc = wt.permute(4, 3, 0, 1, 2).contiguous(
            memory_format=torch.channels_last_3d)
        lib = time_ms(lambda: F.conv3d(F.pad(xc, (0, 0, 0, 0, tp, 0)), wc, b,
                                       padding=(0, 1, 1)))
        t_out = t + tp - 2
        flops = 2.0 * real_taps(t_out, 3, tp) * 480 * 832 * 96 * 96 * 9
        nbytes = 4.0 * ((t + t_out) * 480 * 832 * 96 + wt.numel() + 96)
        bms, by = bound_ms(3 * flops, nbytes, "tf32")
        fp32_bms, _ = bound_ms(flops, nbytes, "fp32")
        results["conv3d"].update({f"{key}_ms": ms, f"{key}_plain_ms": plain,
                                  f"{key}_bound_ms": bms,
                                  f"{key}_fp32_fma_bound_ms": fp32_bms,
                                  f"{key}_library_ms": lib})
        print(f"  conv3d fp32[{label}]: {ms:.3f} ms kernel, {plain:.3f} ms "
              f"plain, {lib:.3f} ms cudnn fp32 (TF32 off), bound {bms:.3f} "
              f"ms ({by}: 3 x {flops:.3e} TF32 FLOP on real taps at 495 "
              f"TFLOP/s; fp32 FMAs at 67 TFLOP/s: {fp32_bms:.3f} ms)",
              flush=True)
        del x
    results["conv3d"]["fp32_max_abs_err"] = max(errs)

    xq = torch.randint(-127, 128, (1, 1, 480, 832, 96), generator=g,
                       device=dev, dtype=torch.int8)
    wq = torch.randint(-127, 128, (3, 3, 3, 96, 96), generator=g, device=dev,
                       dtype=torch.int8)
    scale = torch.rand(96, generator=g, device=dev) * 1e-4
    bias = torch.randn(96, generator=g, device=dev)
    kw = dict(time_pad=2, out_dtype=torch.float32)
    out = conv3d.conv3d_int8(xq, wq, scale, bias, **kw)
    ref = conv3d.conv3d_int8_plain(xq, wq, scale, bias, **kw)
    torch.cuda.synchronize()
    if out.dtype != torch.float32 or not torch.equal(out, ref):
        raise SystemExit("conv3d_int8 fp32 store: differs from its plain "
                         "version")
    ms = time_ms(lambda: conv3d.conv3d_int8(xq, wq, scale, bias, **kw))
    results["conv3d_int8"].update(fp32_store_ms=ms)
    print(f"  conv3d_int8 fp32 store[up3 resnet 96x96, first chunk]: equal "
          f"to its plain version bit for bit; {ms:.3f} ms", flush=True)
    del xq, out, ref

    check_fp32_vae_attn(dev, results)


def check_fp32_vae_attn(dev, results: dict) -> None:
    """K1 in fp32 at the VAE attention's head of 384 (the 3xTF32 wide
    schedule) at the first decode chunk [1,6240,1,384] and a 2-frame chunk,
    q/k/v column views of one qkv tensor: held to the plain fp32 version
    within 1e-5 + 1e-4 |plain| (an output is about 0.02, at most about 0.1),
    beside the error one TF32 pass (the plain version with TF32 matmuls)
    would leave, which must miss that gate; its time beside SDPA in fp32,
    the 3xTF32 bound (three TF32 products a pair at 495 TFLOP/s) and fp32
    FMAs' at 67. Its pre-pass (bit for bit with its plain version) and its
    fp32 merge (flash_fwd_combine's fp32 instance) are held and timed at
    the 2-frame chunk."""
    import torch

    from fastvideo_tpu_torch.ops import _build
    from fastvideo_tpu_torch.ops import flash_attention as fa

    g = torch.Generator(device=dev).manual_seed(15)
    chunk = decode_chunk_frames(latent_of(CLIP_480P))
    sq, d = 6240, fa.WIDE_HEAD
    atol, rtol = 1e-5, 1e-4
    rec, errs = {}, []
    for key, b in (("first", 1), ("chunk", chunk)):
        label = ("vae_mid_attn first chunk" if b == 1 else
                 f"vae_mid_attn {b}-frame chunk")
        qkv = torch.randn(b, sq, 1, 3 * d, generator=g, device=dev)
        q, k, v = qkv[..., :d], qkv[..., d:2 * d], qkv[..., 2 * d:]
        check_schedule(f"flash_fwd fp32[{label}, head 384]", torch.float32,
                       d)
        out, lse = fa.flash_attention(q, k, v, return_lse=True)
        ref, ref_lse = fa.flash_attention_plain(q, k, v, scale=d**-0.5)
        errs.append(check(f"flash_fwd_tf32[{label}] (3xTF32)", out, ref,
                          atol, rtol))
        check(f"flash_fwd_tf32[{label}] lse", lse, ref_lse, 1e-4)
        # one TF32 pass for the record: the gate must refuse it
        torch.backends.cuda.matmul.allow_tf32 = True
        one, _ = fa.flash_attention_plain(q, k, v, scale=d**-0.5)
        torch.backends.cuda.matmul.allow_tf32 = False
        one_err = (one - ref).abs().max().item()
        one_x = ((one - ref).abs() / (atol + rtol * ref.abs())).max().item()
        print(f"  flash_fwd_tf32[{label}]: one TF32 pass would err "
              f"{one_err:.3e}, {one_x:.1f}x the gate", flush=True)
        if one_x <= 1.0:
            raise SystemExit(f"flash_fwd_tf32[{label}]: the gate would take "
                             "one TF32 pass for an fp32 result")
        del one, out, lse, ref_lse
        ms = time_ms(lambda: fa.flash_attention(q, k, v))
        plain = time_ms(lambda: fa.flash_attention_plain(q, k, v,
                                                         scale=d**-0.5), 2)
        lib, backend = sdpa_ms(q, k, v)
        flops = 4.0 * b * sq * sq * d
        nbytes = 4.0 * 4 * b * sq * d + 4.0 * b * sq  # q, k, v, out, lse
        bms, by = bound_ms(3 * flops, nbytes, "tf32")
        fma_bms, _ = bound_ms(flops, nbytes, "fp32")
        splits = fa.wide_splits(b, 1, sq, sq, _build.num_sms(dev),
                                fa.TF32_BLOCK_ROWS)
        rec[key] = dict(ms=ms, plain_ms=plain, bound_ms=bms, bound_by=by,
                        fp32_fma_bound_ms=fma_bms, library_ms=lib,
                        library=backend, splits=splits,
                        max_abs_err=errs[-1], tf32x1_err=one_err,
                        tf32x1_gate_x=one_x)
        print(f"  flash_fwd_tf32[{label}]: {ms:.3f} ms pre-pass, kernel and "
              f"merge ({splits} key splits), "
              f"{plain:.3f} ms plain, {lib:.3f} ms sdpa fp32 ({backend}), "
              f"bound {bms:.3f} ms ({by}: 3 x {flops:.3e} TF32 FLOP at 495 "
              f"TFLOP/s; fp32 FMAs at 67 TFLOP/s: {fma_bms:.3f} ms)",
              flush=True)
        del ref
        if key == "first":
            del qkv, q, k, v
    results["flash_fwd_tf32"] = dict(
        max_abs_err=max(errs), ms=rec["chunk"]["ms"],
        plain_ms=rec["chunk"]["plain_ms"],
        bound_ms=rec["chunk"]["bound_ms"],
        bound_by=rec["chunk"]["bound_by"],
        library_ms=rec["chunk"]["library_ms"],
        shape=f"q/k/v[{chunk}, {sq}, 1, {d}] fp32, views of one qkv",
        gate=f"{atol} + {rtol} * |plain|", first_chunk=rec["first"],
        chunk=rec["chunk"])

    # the pre-pass at the 2-frame chunk: bit for bit with its plain version
    got = fa.tf32_split_kv(k, v)
    want = fa.tf32_split_plain(k, v)
    torch.cuda.synchronize()
    if not all(torch.equal(a, w) for a, w in zip(got, want)):
        raise SystemExit("flash_fwd_tf32_split: differs from its plain "
                         "version")
    del got, want
    ms = time_ms(lambda: fa.tf32_split_kv(k, v))
    plain = time_ms(lambda: fa.tf32_split_plain(k, v), 2)
    pad = fa.tf32_keys_padded(sq)
    nbytes = 4.0 * (2 * chunk * sq * d + 4 * chunk * pad * d)
    bms, by = bound_ms(0.0, nbytes)
    results["flash_fwd_tf32_split"] = dict(
        max_abs_err=0.0, ms=ms, plain_ms=plain, bound_ms=bms, bound_by=by,
        library_ms=None,
        shape=f"k/v[{chunk}, {sq}, 1, {d}] fp32 -> 4 x [{chunk}, 1, {pad}, "
        f"{d}]")
    print(f"  flash_fwd_tf32_split[{chunk}-frame chunk]: equal to its plain "
          f"version bit for bit; {ms:.3f} ms kernel, {plain:.3f} ms plain, "
          f"bound {bms:.3f} ms ({by}); no single PyTorch call splits fp32 "
          f"into TF32 heads and tails", flush=True)
    del qkv, q, k, v

    # the fp32 merge at the 2-frame chunk's partials
    splits = fa.wide_splits(chunk, 1, sq, sq, 132, fa.TF32_BLOCK_ROWS)
    part = torch.randn(splits, chunk, 1, sq, d, generator=g, device=dev)
    lse_part = torch.randn(splits, chunk, 1, sq, generator=g,
                           device=dev) * 4
    lse_part[0, :, :, :64] = float("-inf")
    lse_part[:, 0, 0, 100:103] = float("-inf")
    part[lse_part.isinf()] = 0
    out = torch.empty(chunk, sq, 1, d, device=dev)
    lse = torch.empty(chunk, 1, sq, device=dev)
    fa.wide_combine(part, lse_part, out, lse)
    ref, ref_lse = fa.wide_combine_plain(part, lse_part, torch.float32)
    # the same fp32 merge, its sums in another order: a few fp32 ulps
    check(f"flash_fwd_combine fp32[{splits} splits, {chunk}-frame chunk]",
          out, ref, 1e-6, 1e-5)
    fin = torch.isfinite(ref_lse)
    if not torch.equal(fin, torch.isfinite(lse)) or not bool(
            (out[0, 100:103, 0] == 0).all()):
        raise SystemExit("flash_fwd_combine fp32: empty rows differ from "
                         "plain")
    ms = time_ms(lambda: fa.wide_combine(part, lse_part, out, lse))
    results["flash_fwd_combine"]["fp32_ms"] = ms
    print(f"  flash_fwd_combine fp32[{splits} splits]: {ms:.3f} ms kernel",
          flush=True)


# -- phase 3, the backward kernels (K6, K7 bwd) at the training shapes -------


def kernel_device_ms(fn, names: dict, reps: int = 3) -> dict:
    """Device time a call of each kernel in ``names`` ({label: substring of
    its CUDA kernel name}) takes inside ``fn``, from torch.profiler over
    ``reps`` calls after a warm-up: the mean over the launches it recorded
    (``fn`` launches each kernel once; the profiler may drop a launch's
    record, which a sum over ``reps`` calls would count as 0 ms)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = {}
    for label, sub in names.items():
        hits = [e for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA
                and sub in e.key]
        if not hits:
            raise SystemExit(f"profiler shows no device time for {sub}")
        out[label] = sum(e.self_device_time_total for e in hits) / sum(
            e.count for e in hits) / 1e3
    return out


def library_backward_ms(fwd, ins, do) -> float:
    """Time of the backward of one PyTorch call (``fwd(*ins)``) given the
    output gradient ``do``: the library yardstick of a backward kernel."""
    import torch

    leaves = [t.detach().requires_grad_() for t in ins]
    out = fwd(*leaves)
    return time_ms(lambda: torch.autograd.grad(out, leaves, do,
                                               retain_graph=True))


def bwd_bounds(pair_products: float, nbytes_dq: float, nbytes_dkv: float):
    """Bounds of the two backward kernels from the FLOP of one product over
    the sparsity's (query row, valid key) pairs (2 * D a pair): dQ needs
    three products (S, dP, dS K), dK/dV four (S, dP, p^T dO, dS^T Q); the
    whole backward five."""
    return (bound_ms(3 * pair_products, nbytes_dq),
            bound_ms(4 * pair_products, nbytes_dkv),
            bound_ms(5 * pair_products, nbytes_dq + nbytes_dkv))


def check_flash_bwd(dev, results: dict) -> None:
    """K6 at the training cross-attention: q/dO [1,32760,12,128] over k/v
    [1,512,12,128], bf16, against the plain backward."""
    import torch
    import torch.nn.functional as F

    from fastvideo_tpu_torch.ops import _build
    from fastvideo_tpu_torch.ops import flash_attention as fa

    g = torch.Generator(device=dev).manual_seed(12)
    b, sq, skv, h, d = 1, 32760, 512, 12, 128
    q, do = (torch.randn(b, sq, h, d, generator=g, device=dev,
                         dtype=torch.bfloat16) for _ in range(2))
    k, v = (torch.randn(b, skv, h, d, generator=g, device=dev,
                        dtype=torch.bfloat16) for _ in range(2))
    kw = dict(scale=d**-0.5, causal=False, kv_valid=skv)
    check_schedule("flash_bwd[cross_attn]", torch.bfloat16, d, backward=True)
    splits = fa.dkv_splits(b, h, sq, skv, d, _build.num_sms(dev))
    print(f"  flash_bwd[cross_attn]: dK/dV over {splits} query-row splits "
          f"({b * h * -(-skv // fa.DKV_BLOCK_KEYS)} key tiles, "
          f"{_build.num_sms(dev)} SMs)", flush=True)
    out, lse = fa.flash_attention(q, k, v, return_lse=True, **kw)
    got = fa.flash_attention_bwd(q, k, v, out, lse, do, **kw)
    want = fa.flash_attention_bwd_plain(q, k, v, out, lse, do, **kw)
    errs = [check(f"flash_bwd[cross_attn] d{n}", t, w, *attn_tol(w,
                                                                  torch.bfloat16))
            for n, t, w in zip("qkv", got, want)]
    del got, want
    names = {"dq": "flash_bwd_dq_sm90", "dkv": "flash_bwd_dkv_sm90"}
    if splits > 1:
        names["reduce"] = "flash_bwd_dkv_reduce"
    ms = kernel_device_ms(
        lambda: fa.flash_attention_bwd(q, k, v, out, lse, do, **kw), names)
    whole = time_ms(lambda: fa.flash_attention_bwd(q, k, v, out, lse, do,
                                                   **kw))
    plain = time_ms(lambda: fa.flash_attention_bwd_plain(q, k, v, out, lse,
                                                         do, **kw), 2)
    qt, kt, vt, dot = (t.transpose(1, 2) for t in (q, k, v, do))
    lib = library_backward_ms(lambda a, b_, c: F.scaled_dot_product_attention(
        a, b_, c, scale=d**-0.5), (qt, kt, vt), dot)
    product = 2.0 * b * h * sq * skv * d
    rows = 2.0 * b * h * d  # bytes of one bf16 row of every head
    io = 4 * 2 * b * h * sq + 2 * rows * skv  # lse, delta; k, v
    (dq_b, dq_by), (dkv_b, dkv_by), (all_b, all_by) = bwd_bounds(
        product, io + 3 * rows * sq, io + 2 * rows * sq + 2 * rows * skv)
    shape = f"q/dO{[b, sq, h, d]} k/v{[b, skv, h, d]} bf16"
    common = dict(plain_ms=plain, library_ms=lib, shape=shape,
                  backward_ms=whole, backward_bound_ms=all_b)
    results["flash_bwd_dq"] = dict(max_abs_err=errs[0], ms=ms["dq"],
                                   bound_ms=dq_b, bound_by=dq_by, **common)
    results["flash_bwd_dkv"] = dict(max_abs_err=max(errs[1:]),
                                    ms=ms["dkv"], bound_ms=dkv_b,
                                    bound_by=dkv_by, splits=splits, **common)
    check_dkv_reduce(dev, results, (splits, b, h, skv, d))
    print(f"  flash_bwd[cross_attn]: dQ {ms['dq']:.3f} ms (bound "
          f"{dq_b:.3f}, {dq_by}), dK/dV {ms['dkv']:.3f} ms (bound "
          f"{dkv_b:.3f}, {dkv_by}); the backward {whole:.3f} ms with delta "
          f"(bound {all_b:.3f} ms: 5 products, {5 * product:.3e} FLOP), "
          f"{plain:.3f} ms plain, {lib:.3f} ms scaled_dot_product_attention's "
          f"backward", flush=True)


def check_dkv_reduce(dev, results: dict, shape: tuple) -> None:
    """flash_bwd_dkv_reduce at the cross-attention's scratch shape [splits,
    B, H, Skv, D] against its plain version (both add the splits in order
    and round once), on random partial sums: it is a pure function of
    them. Bound: the partial sums read once, dK and dV written once."""
    import torch

    from fastvideo_tpu_torch.ops import flash_attention as fa

    g = torch.Generator(device=dev).manual_seed(14)
    part_k, part_v = (torch.randn(shape, generator=g, device=dev)
                      for _ in range(2))
    splits, b, h, skv, d = shape
    dk, dv = (torch.empty(b, skv, h, d, dtype=torch.bfloat16, device=dev)
              for _ in range(2))
    fa.dkv_reduce(part_k, part_v, dk, dv)
    want = fa.dkv_reduce_plain(part_k, part_v)
    # one bf16 rounding of sums taken in the same order: equal, or one ulp
    # apart where the fp32 sums differ in their last bit
    err = max(check(f"flash_bwd_dkv_reduce[{n}]", t, w, 0.0, 2.0**-7)
              for n, t, w in zip(("dk", "dv"), (dk, dv), want))
    ms = time_ms(lambda: fa.dkv_reduce(part_k, part_v, dk, dv))
    plain = time_ms(lambda: fa.dkv_reduce_plain(part_k, part_v), 2)
    lib = time_ms(lambda: (part_k.sum(dim=0), part_v.sum(dim=0)))
    nbytes = 2 * 4.0 * part_k.numel() + 2 * 2.0 * dk.numel()
    bms, by = bound_ms(splits * 2.0 * dk.numel(), nbytes, "fp32")
    results["flash_bwd_dkv_reduce"] = dict(
        max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=bms, bound_by=by,
        library_ms=lib, shape=f"2 x {list(shape)} fp32 -> 2 x "
        f"{[b, skv, h, d]} bf16")
    print(f"  flash_bwd_dkv_reduce[{list(shape)}]: {ms:.3f} ms kernel, "
          f"{plain:.3f} ms plain, {lib:.3f} ms torch.sum over the splits "
          f"(fp32 out), bound {bms:.3f} ms ({by})", flush=True)


# the causal Wan's training forward at 81x480x832: 21 latent frames of 30 x
# 52 tokens, 3 frames a chunk; dfsft runs the chunk-causal mask over 32,760
# tokens, tfsft the teacher-forcing one over [clean | noisy], 65,520
STRUCT_FRAME = 30 * 52
STRUCT_CHUNK = 3 * STRUCT_FRAME
STRUCT_CASES = {"dfsft": (21 * STRUCT_FRAME, 0),
                "tfsft": (2 * 21 * STRUCT_FRAME, 21 * STRUCT_FRAME)}


def struct_pairs(s_len: int, ct: int, clean_len: int) -> int:
    """(query, key) pairs of one head that the chunk-causal (clean_len 0)
    or teacher-forcing mask keeps: a row sees [0, a) and its own noisy
    chunk."""
    import numpy as np

    r = np.arange(s_len, dtype=np.int64)
    if clean_len == 0:
        return int(np.minimum((r // ct + 1) * ct, s_len).sum())
    cq = (r - clean_len) // ct
    own = np.minimum(clean_len + (cq + 1) * ct, s_len) - (clean_len + cq * ct)
    seen = np.where(r < clean_len,
                    np.minimum((r // ct + 1) * ct, clean_len),
                    np.minimum(cq * ct, clean_len) + own)
    return int(seen.sum())


def struct_mask_mod(ct: int, clean_len: int):
    """The same mask as a flex_attention mask_mod, for the library
    yardstick."""
    def mask_mod(b, h, q_idx, kv_idx):
        if clean_len == 0:
            return kv_idx // ct <= q_idx // ct
        clean = q_idx < clean_len
        cq = (q_idx - clean_len) // ct
        clean_ok = clean & (kv_idx < clean_len) & (kv_idx // ct <= q_idx // ct)
        own = (kv_idx >= clean_len) & ((kv_idx - clean_len) // ct == cq)
        ctx = (kv_idx < clean_len) & (kv_idx // ct < cq)
        return clean_ok | (~clean & (own | ctx))

    return mask_mod


def check_flash_struct(dev, results: dict, flex: bool = False) -> None:
    """K1 struct and K6 struct at the causal Wan's full-width training
    shapes: q/k/v/dO [1, S, 12, 128] bf16 under the dfsft chunk-causal mask
    (S 32,760) and the tfsft teacher-forcing one (S 65,520), against the
    plain versions (out, LSE, dq, dk, dv); with ``flex`` (``--flex-struct``,
    about 90 s of compiles), compiled flex_attention's forward and backward
    on a BlockMask of the same mask_mod as the library yardstick (timed
    here only, the port never calls it; without it library_ms is null)."""
    import torch
    from torch.nn.attention.flex_attention import (create_block_mask,
                                                   flex_attention)

    from fastvideo_tpu_torch.ops import flash_attention as fa

    b, h, d, ct = 1, 12, 128, STRUCT_CHUNK
    scale = d**-0.5
    fwd, dq_r, dkv_r = {}, {}, {}
    for label, (s_len, clean_len) in STRUCT_CASES.items():
        g = torch.Generator(device=dev).manual_seed(13)
        q, k, v, do = (torch.randn(b, s_len, h, d, generator=g, device=dev,
                                   dtype=torch.bfloat16) for _ in range(4))
        kw = dict(scale=scale, kv_valid=s_len, chunk_tokens=ct,
                  tf_clean_len=clean_len)
        check_schedule(f"flash_fwd_struct[{label}]", torch.bfloat16, d)
        check_schedule(f"flash_bwd_struct[{label}]", torch.bfloat16, d,
                       backward=True)
        out, lse = fa.flash_attention(q, k, v, return_lse=True, **kw)
        ref, ref_lse = fa.flash_attention_plain(q, k, v, **kw)
        tol = attn_tol(ref, torch.bfloat16)
        err = check(f"flash_fwd_struct[{label}]", out, ref, *tol)
        check(f"flash_fwd_struct[{label}] lse", lse, ref_lse, 1e-3)
        ms = time_ms(lambda: fa.flash_attention(q, k, v, **kw), 3)
        plain = time_ms(lambda: fa.flash_attention_plain(q, k, v, **kw), 1)
        got = fa.flash_attention_bwd(q, k, v, out, lse, do, **kw)
        want = fa.flash_attention_bwd_plain(q, k, v, out, lse, do, **kw)
        errs = [check(f"flash_bwd_struct[{label}] d{n}", t, w,
                      *attn_tol(w, torch.bfloat16))
                for n, t, w in zip("qkv", got, want)]
        del got, want
        bwd = kernel_device_ms(
            lambda: fa.flash_attention_bwd(q, k, v, out, lse, do, **kw),
            {"dq": "flash_bwd_dq_sm90", "dkv": "flash_bwd_dkv_sm90"})
        whole = time_ms(lambda: fa.flash_attention_bwd(q, k, v, out, lse, do,
                                                       **kw), 3)
        plain_bwd = time_ms(lambda: fa.flash_attention_bwd_plain(
            q, k, v, out, lse, do, **kw), 1)
        lib = lib_bwd = mask = None
        if flex:
            # the library yardstick on [B, H, S, D] views of the same tensors
            mask = create_block_mask(struct_mask_mod(ct, clean_len), None,
                                     None, s_len, s_len, device=dev,
                                     BLOCK_SIZE=128, _compile=True)
            qt, kt, vt, dot = (t.transpose(1, 2) for t in (q, k, v, do))
            # the timing calls its backward twice on one graph, which a
            # compiled backward with donated buffers refuses
            with torch._functorch.config.patch(donated_buffer=False):
                flex = torch.compile(flex_attention, dynamic=False)
                check(f"flex_attention[{label}] (library)",
                      flex(qt, kt, vt, block_mask=mask,
                           scale=scale).transpose(1, 2), ref, *tol)
                lib = time_ms(lambda: flex(qt, kt, vt, block_mask=mask,
                                           scale=scale))
                lib_bwd = library_backward_ms(lambda a, b_, c: flex(
                    a, b_, c, block_mask=mask, scale=scale), (qt, kt, vt),
                    dot)
        del ref, ref_lse
        pairs = h * struct_pairs(s_len, ct, clean_len)
        product = 2.0 * d * pairs * b
        rows = 2.0 * b * h * d * s_len  # bytes of one bf16 [B, S, H, D]
        stats = 4.0 * b * h * s_len  # one fp32 [B, H, S]
        f_bms, f_by = bound_ms(2 * product, 4 * rows + stats)
        io = 2 * stats + 2 * rows  # lse, delta; k, v
        (dq_b, dq_by), (dkv_b, dkv_by), (all_b, _) = bwd_bounds(
            product, io + 3 * rows, io + 4 * rows)
        shape = (f"q/k/v{[b, s_len, h, d]} bf16, chunk_tokens {ct}, "
                 f"tf_clean_len {clean_len}")
        density = pairs / (h * s_len * s_len)
        fwd[label] = dict(max_abs_err=err, ms=ms, plain_ms=plain,
                          bound_ms=f_bms, bound_by=f_by, library_ms=lib,
                          shape=shape, kept_fraction=density)
        common = dict(plain_ms=plain_bwd, library_ms=lib_bwd, shape=shape,
                      backward_ms=whole, backward_bound_ms=all_b)
        dq_r[label] = dict(max_abs_err=errs[0], ms=bwd["dq"], bound_ms=dq_b,
                           bound_by=dq_by, **common)
        dkv_r[label] = dict(max_abs_err=max(errs[1:]), ms=bwd["dkv"],
                            bound_ms=dkv_b, bound_by=dkv_by, **common)
        flex_fwd, flex_bwd = (
            (f"{lib:.3f} ms flex_attention", f"{lib_bwd:.3f} ms "
             "flex_attention's backward") if flex else
            ("flex_attention not timed (--flex-struct)",) * 2)
        print(f"  flash_struct[{label}]: kept fraction {density:.4f} "
              f"({pairs:.3e} pairs); forward {ms:.3f} ms kernel, {plain:.3f} "
              f"ms plain, {flex_fwd}, bound {f_bms:.3f} ms "
              f"({f_by}, {2 * product:.3e} FLOP); backward dQ {bwd['dq']:.3f}"
              f" ms (bound {dq_b:.3f}), dK/dV {bwd['dkv']:.3f} ms (bound "
              f"{dkv_b:.3f}), {whole:.3f} ms with delta (bound {all_b:.3f}: 5 "
              f"products, {5 * product:.3e} FLOP), {plain_bwd:.3f} ms plain, "
              f"{flex_bwd}", flush=True)
        del q, k, v, do, out, lse, mask
        torch.cuda.empty_cache()

    def merged(per: dict) -> dict:
        # dfsft's numbers first, tfsft's under a "tfsft_" prefix; the error
        # is the larger of the two
        out = dict(per["dfsft"])
        out.update({f"tfsft_{k}": v for k, v in per["tfsft"].items()})
        out["max_abs_err"] = max(per["dfsft"]["max_abs_err"],
                                 per["tfsft"]["max_abs_err"])
        return out

    results["flash_fwd_struct"] = merged(fwd)
    results["flash_bwd_struct_dq"] = merged(dq_r)
    results["flash_bwd_struct_dkv"] = merged(dkv_r)


def coarse_topk(q, k, sizes, e: int, topk: int, q_group: int):
    """Per-tile top-k key tiles chosen as VSA chooses them: from the
    coarse (tile-mean) scores, averaged over groups of ``q_group`` query
    tiles, expanded to one row per tile. [B, H, nB, topk] int32."""
    from fastvideo_tpu_torch.ops import vsa

    b, h, s, d = q.shape
    nb = s // e
    qc, kc = (vsa.block_mean(t, sizes, e).float() for t in (q, k))
    scores = qc @ kc.transpose(-1, -2) * d**-0.5
    if q_group > 1:
        scores = scores.reshape(b, h, nb // q_group, q_group, nb).mean(3)
    idx = scores.topk(topk, dim=-1).indices
    return idx.repeat_interleave(nb // idx.shape[2], dim=2).int()


def sparse_bwd_case(label, q, k, v, do, idx, sizes, e, results=None):
    """K7's LSE forward, then K7 bwd on its out and LSE, each against its
    plain version on one case; with ``results``, also the backward's times,
    bounds, plain and library (compiled flex_attention's backward with the
    same BlockMask) times, and the forward's time. Returns (max abs errors
    of dq, dk, dv; of the forward's out and LSE; the forward's ms or
    None)."""
    import torch
    from torch.nn.attention.flex_attention import flex_attention

    from fastvideo_tpu_torch.ops import vsa

    scale = q.shape[-1]**-0.5
    kw = dict(scale=scale, tile_elems=e)
    check_sparse_schedule(f"vsa_sparse_bwd[{label}]", "vsa_sparse_bwd_dq",
                          q.shape[-1])
    out, lse = vsa.block_sparse_attention(q, k, v, idx, sizes,
                                          return_lse=True, **kw)
    ref, ref_lse = vsa.block_sparse_attention_plain(q, k, v, idx, sizes,
                                                    return_lse=True, **kw)
    fwd_errs = (check(f"vsa_sparse_padded_fwd[{label}]", out, ref,
                      *attn_tol(ref, torch.bfloat16)),
                check(f"vsa_sparse_padded_fwd[{label}] lse", lse, ref_lse,
                      1e-3))
    del ref, ref_lse
    got = vsa.block_sparse_attention_bwd(q, k, v, idx, sizes, out, lse, do,
                                         **kw)
    want = vsa.block_sparse_attention_bwd_plain(q, k, v, idx, sizes, out,
                                                lse, do, **kw)
    errs = [check(f"vsa_sparse_bwd[{label}] d{n}", t, w,
                  *attn_tol(w, torch.bfloat16))
            for n, t, w in zip("qkv", got, want)]
    del got, want
    if results is None:
        return errs, fwd_errs, None
    ms = kernel_device_ms(
        lambda: vsa.block_sparse_attention_bwd(q, k, v, idx, sizes, out, lse,
                                               do, **kw),
        {"dq": "vsa_sparse_bwd_dq", "dkv": "vsa_sparse_bwd_dkv"})
    whole = time_ms(lambda: vsa.block_sparse_attention_bwd(
        q, k, v, idx, sizes, out, lse, do, **kw))
    check_sparse_schedule(f"vsa_sparse_padded_fwd[{label}]",
                          "vsa_sparse_padded_fwd", q.shape[-1])
    fwd_ms = time_ms(lambda: vsa.block_sparse_attention(
        q, k, v, idx, sizes, return_lse=True, **kw))
    plain = time_ms(lambda: vsa.block_sparse_attention_bwd_plain(
        q, k, v, idx, sizes, out, lse, do, **kw), 1)
    mask = padded_block_mask(idx, sizes, q.shape[2], e) if e % 128 == 0 \
        else vsa_block_mask(idx, q.shape[2], e, e)
    flex = torch.compile(flex_attention, dynamic=False)
    lib = library_backward_ms(lambda a, b_, c: flex(a, b_, c, block_mask=mask,
                                                    scale=scale),
                              (q, k, v), do)
    fwd_lib = time_ms(lambda: flex(q, k, v, block_mask=mask, scale=scale))
    flops, fwd_bytes = padded_bound(idx, sizes, q.shape[-1])  # 4 D a pair
    fwd_bound, fwd_by = bound_ms(flops, fwd_bytes)
    results["vsa_sparse_padded_fwd"].update(
        train_lse_library_ms=fwd_lib, train_lse_bound_ms=fwd_bound)
    print(f"  vsa_sparse_padded_fwd[{label}] (K7 fwd, LSE mode): "
          f"{fwd_ms:.3f} ms kernel, {fwd_lib:.3f} ms flex_attention, bound "
          f"{fwd_bound:.3f} ms ({fwd_by}, {flops:.3e} FLOP on valid keys)",
          flush=True)
    product = flops / 2
    b, h, s, d = q.shape
    tokens = b * h * sizes.sum().item()
    io = 2.0 * 2 * tokens * d + 8.0 * tokens + 4 * idx.numel()  # k, v, stats
    (dq_b, dq_by), (dkv_b, dkv_by), (all_b, _) = bwd_bounds(
        product, io + 2.0 * 3 * tokens * d, io + 2.0 * 4 * tokens * d)
    common = dict(plain_ms=plain, library_ms=lib, backward_ms=whole,
                  backward_bound_ms=all_b,
                  shape=f"q{[b, h, s, d]} E{e} tiles{s // e} "
                  f"topk{idx.shape[-1]}")
    results["vsa_sparse_bwd_dq"] = dict(max_abs_err=errs[0], ms=ms["dq"],
                                        bound_ms=dq_b, bound_by=dq_by,
                                        **common)
    results["vsa_sparse_bwd_dkv"] = dict(max_abs_err=max(errs[1:]),
                                         ms=ms["dkv"], bound_ms=dkv_b,
                                         bound_by=dkv_by, **common)
    print(f"  vsa_sparse_bwd[{label}]: dQ {ms['dq']:.3f} ms (bound "
          f"{dq_b:.3f}), dK/dV {ms['dkv']:.3f} ms (bound {dkv_b:.3f}); the "
          f"backward {whole:.3f} ms with delta and the lists (bound "
          f"{all_b:.3f} ms: 5 products, {5 * product:.3e} FLOP on valid "
          f"keys), {plain:.3f} ms plain, {lib:.3f} ms flex_attention's "
          f"backward; K7 fwd with LSE {fwd_ms:.3f} ms", flush=True)
    return errs, fwd_errs, fwd_ms


def check_vsa_bwd(dev, results: dict) -> None:
    """K7 bwd at the training shape (q/k/v [1,12,32760,128], E 280, 117
    exact tiles, a real coarse top-24 over q_group 3, expanded per tile)
    and at the 480x848 padded shape (168 tiles of 256 with valid counts,
    top-34)."""
    import torch

    from fastvideo_tpu_torch.attention.backends.vsa import vsa_topk
    from fastvideo_tpu_torch.ops import vsa

    g = torch.Generator(device=dev).manual_seed(13)
    b, h, d, e, nb = 1, 12, 128, 280, 117

    def rnd(s):
        return torch.randn(b, h, s, d, generator=g, device=dev,
                           dtype=torch.bfloat16)

    q, k, v, do = (rnd(nb * e) for _ in range(4))
    sizes = torch.full((nb,), e, dtype=torch.int32, device=dev)
    idx = coarse_topk(q, k, sizes, e, vsa_topk(0.8, nb), 3)
    errs, fwd_errs, fwd_ms = sparse_bwd_case("480p train", q, k, v, do, idx,
                                             sizes, e, results)
    fwd = results["vsa_sparse_padded_fwd"]
    fwd.update(train_lse_ms=fwd_ms, train_max_abs_err=fwd_errs[0],
               train_lse_max_abs_err=fwd_errs[1],
               max_abs_err=max(fwd["max_abs_err"], fwd_errs[0]))
    del q, k, v, do
    grid, tile = (21, 30, 53), (4, 8, 8)
    _, _, sizes_np, _, s = vsa.tile_layout(grid, tile)
    e2 = 256
    sizes = torch.as_tensor(sizes_np, device=dev)
    valid = torch.as_tensor(vsa.tile_valid_mask(grid, tile), device=dev)
    q, k, v, do = (rnd(s) * valid[:, None] for _ in range(4))
    idx = coarse_topk(q, k, sizes, e2, vsa_topk(0.8, s // e2), 1)
    padded_errs, fwd_errs, _ = sparse_bwd_case("480x848 padded", q, k, v,
                                               do, idx, sizes, e2)
    errs += padded_errs
    fwd["max_abs_err"] = max(fwd["max_abs_err"], fwd_errs[0])
    for name in ("vsa_sparse_bwd_dq", "vsa_sparse_bwd_dkv"):
        results[name]["max_abs_err"] = max(errs)


def check_vsa_dense(dev, results: dict) -> None:
    """K2, K7 fwd (LSE mode) and K7 bwd at DMD2's shape (4n): VSA at
    sparsity 0 on 4i's grid, every one of the 117 exact tiles of 280 for
    every query tile (K2's rows for each of its 39 groups of 3), each
    against its plain version, timed beside SDPA (over every key it computes
    the same function) and the dense bounds."""
    import torch
    import torch.nn.functional as F

    from fastvideo_tpu_torch.ops import vsa

    g = torch.Generator(device=dev).manual_seed(17)
    b, h, d, e, nb, qg = 1, 12, 128, 280, 117, 3
    s = nb * e
    q, k, v, do = (torch.randn(b, h, s, d, generator=g, device=dev,
                               dtype=torch.bfloat16) for _ in range(4))
    scale = d**-0.5
    tiles = torch.arange(nb, device=dev, dtype=torch.int32)
    idx_g = tiles.expand(b, h, nb // qg, nb).contiguous()
    idx_t = tiles.expand(b, h, nb, nb).contiguous()
    sizes = torch.full((nb,), e, dtype=torch.int32, device=dev)
    kw = dict(scale=scale, tile_elems=e)
    label = f"top-{nb}"
    out = vsa.block_sparse_attention_fast(q, k, v, idx_g, **kw)
    ref = vsa.block_sparse_attention_plain(q, k, v, idx_g, **kw)
    k2_err = check(f"vsa_sparse_fwd[{label}]", out, ref,
                   *attn_tol(ref, torch.bfloat16))
    del out, ref
    k2_ms = time_ms(lambda: vsa.block_sparse_attention_fast(
        q, k, v, idx_g, **kw))
    k2_plain = time_ms(lambda: vsa.block_sparse_attention_plain(
        q, k, v, idx_g, **kw), 1, 0)
    sdpa = time_ms(lambda: F.scaled_dot_product_attention(q, k, v,
                                                          scale=scale))
    errs, fwd_errs, _ = sparse_bwd_case(label, q, k, v, do, idx_t, sizes, e)
    out, lse = vsa.block_sparse_attention(q, k, v, idx_t, sizes,
                                          return_lse=True, **kw)
    fwd_ms = time_ms(lambda: vsa.block_sparse_attention(
        q, k, v, idx_t, sizes, return_lse=True, **kw))
    fwd_plain = time_ms(lambda: vsa.block_sparse_attention_plain(
        q, k, v, idx_t, sizes, return_lse=True, **kw), 1, 0)
    ms = kernel_device_ms(
        lambda: vsa.block_sparse_attention_bwd(q, k, v, idx_t, sizes, out,
                                               lse, do, **kw),
        {"dq": "vsa_sparse_bwd_dq", "dkv": "vsa_sparse_bwd_dkv"})
    whole = time_ms(lambda: vsa.block_sparse_attention_bwd(
        q, k, v, idx_t, sizes, out, lse, do, **kw))
    bwd_plain = time_ms(lambda: vsa.block_sparse_attention_bwd_plain(
        q, k, v, idx_t, sizes, out, lse, do, **kw), 1, 0)
    sdpa_bwd = library_backward_ms(
        lambda a, b_, c: F.scaled_dot_product_attention(a, b_, c,
                                                        scale=scale),
        (q, k, v), do)
    flops, nbytes = padded_bound(idx_t, sizes, d)
    fwd_b, fwd_by = bound_ms(flops, nbytes)
    k2_b, k2_by = bound_ms(flops, nbytes - 4 * idx_t.numel()
                           - 4.0 * b * h * s + 4 * idx_g.numel())
    tokens = b * h * s
    io = 2.0 * 2 * tokens * d + 8.0 * tokens + 4 * idx_t.numel()
    (dq_b, _), (dkv_b, _), (all_b, _) = bwd_bounds(
        flops / 2, io + 2.0 * 3 * tokens * d, io + 2.0 * 4 * tokens * d)
    results["vsa_sparse_fwd"].update(
        top117_ms=k2_ms, top117_plain_ms=k2_plain, top117_bound_ms=k2_b,
        top117_library_ms=sdpa, top117_max_abs_err=k2_err)
    results["vsa_sparse_padded_fwd"].update(
        top117_lse_ms=fwd_ms, top117_plain_ms=fwd_plain,
        top117_bound_ms=fwd_b, top117_library_ms=sdpa,
        top117_max_abs_err=fwd_errs[0], top117_lse_max_abs_err=fwd_errs[1])
    for name, t, bnd, err in (("vsa_sparse_bwd_dq", ms["dq"], dq_b, errs[0]),
                              ("vsa_sparse_bwd_dkv", ms["dkv"], dkv_b,
                               max(errs[1:]))):
        results[name].update(
            top117_ms=t, top117_bound_ms=bnd, top117_backward_ms=whole,
            top117_backward_bound_ms=all_b, top117_plain_ms=bwd_plain,
            top117_library_ms=sdpa_bwd, top117_max_abs_err=err)
        results[name]["max_abs_err"] = max(results[name]["max_abs_err"], err)
    for name, err in (("vsa_sparse_fwd", k2_err),
                      ("vsa_sparse_padded_fwd", fwd_errs[0])):
        results[name]["max_abs_err"] = max(results[name]["max_abs_err"], err)
    print(f"  {label} of {nb} tiles, q/k/v[{b},{h},{s},{d}] (dense, "
          f"{flops:.3e} FLOP): K2 {k2_ms:.3f} ms (bound {k2_b:.3f}, "
          f"{k2_by}; plain {k2_plain:.3f}); K7 fwd with LSE {fwd_ms:.3f} ms "
          f"(bound {fwd_b:.3f}, {fwd_by}; plain {fwd_plain:.3f}); SDPA "
          f"{sdpa:.3f} ms; K7 bwd dQ {ms['dq']:.3f} ms (bound {dq_b:.3f}), "
          f"dK/dV {ms['dkv']:.3f} ms (bound {dkv_b:.3f}), the backward "
          f"{whole:.3f} ms with delta and the lists (bound {all_b:.3f}; "
          f"plain {bwd_plain:.3f}), SDPA's backward {sdpa_bwd:.3f} ms",
          flush=True)


def run_kernel_checks(dev, flex_struct: bool = False) -> dict:
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # compiled flex_attention, the library yardstick, compiles once for
    # each shape and mask here (12 of them); past dynamo's default limit of
    # 8 it would run eagerly, which builds the dense score matrix
    torch._dynamo.config.recompile_limit = 64
    results: dict = {}
    for check in (check_flash, check_flash_combine, check_vsa,
                  check_vsa_padded, check_dyn_sparse, check_flash_bwd,
                  check_flash_struct, check_vsa_bwd, check_vsa_dense,
                  check_conv, check_conv_int8, check_w8a8_linear,
                  check_flash_kv_mask, check_causal_distill,
                  check_fp32_decode):
        t0 = time.perf_counter()
        if check is check_w8a8_linear:
            check(dev)
        elif check is check_flash_struct:
            check(dev, results, flex=flex_struct)
        else:
            check(dev, results)
        torch.cuda.empty_cache()
        print(f"  [{check.__name__}: {time.perf_counter() - t0:.1f} s]",
              flush=True)
    decode_bound = decode_conv_bound((21, 60, 104))
    # K1 also runs the VAE mid-block attention: 21 frames x 6240 tokens,
    # one head of 384, once per decode
    vae_attn, _ = bound_ms(4.0 * 21 * 6240 * 6240 * 384, 0.0)
    k1, k2 = results["flash_fwd"]["bound_ms"], results["vsa_sparse_fwd"][
        "bound_ms"]
    print(f"  bound per FastWan 480x832 generation: K1 "
          f"{90 * k1 + vae_attn:.1f} ms (90 "
          f"cross-attention launches + {vae_attn:.2f} ms VAE attention), K2 "
          f"{90 * k2:.1f} ms (90 launches), K3 {decode_bound:.1f} ms",
          flush=True)
    # the Wan 480x848 paths decode a (21, 60, 106) latent
    decode_848 = decode_conv_bound((21, 60, 106))
    vae_attn_848, _ = bound_ms(4.0 * 21 * 6360 * 6360 * 384, 0.0)
    results["conv3d"]["w848_decode_bound_ms"] = decode_848
    print(f"  bound per Wan 480x848 decode: K3 {decode_848:.1f} ms, K1 VAE "
          f"attention {vae_attn_848:.2f} ms", flush=True)
    torch.cuda.empty_cache()
    return results


# -- phase 4: the main path at full width -------------------------------------

# FastWan2.1-T2V-1.3B: the DiT and VAE at their published sizes, UMT5 at the
# full width of UMT5-XXL with a small synthetic vocabulary
DIT_CFG = dict(num_attention_heads=12, attention_head_dim=128, in_channels=16,
               out_channels=16, text_dim=4096, freq_dim=256, ffn_dim=8960,
               num_layers=30, patch_size=[1, 2, 2],
               qk_norm="rms_norm_across_heads", cross_attn_norm=True,
               eps=1e-6)
VAE_CFG = dict(base_dim=96, z_dim=16, dim_mult=[1, 2, 4, 4], num_res_blocks=2,
               attn_scales=[], temperal_downsample=[False, True, True],
               scale_factor_temporal=4, scale_factor_spatial=8)
T5_CFG = dict(vocab_size=8192, d_model=4096, d_kv=64, d_ff=10240,
              num_layers=24, num_heads=64, relative_attention_num_buckets=32,
              relative_attention_max_distance=128,
              feed_forward_proj="gated-gelu", model_type="umt5")
# a tiny model of the same families, for the check against the plain path
TINY_DIT_CFG = dict(DIT_CFG, num_attention_heads=4, attention_head_dim=16,
                    in_channels=4, out_channels=4, text_dim=32, freq_dim=32,
                    ffn_dim=64, num_layers=2)
TINY_VAE_CFG = dict(base_dim=8, z_dim=4, dim_mult=[1, 2], num_res_blocks=1,
                    attn_scales=[], temperal_downsample=[True],
                    latents_mean=[0.0] * 4, latents_std=[1.0] * 4,
                    scale_factor_temporal=2, scale_factor_spatial=2)
# the causal Wan with a head of 128, so that its cached attention takes K5
TINY_CAUSAL_DIT_CFG = dict(TINY_DIT_CFG, num_attention_heads=1,
                           attention_head_dim=128, num_frames_per_block=3,
                           local_attn_size=5, sink_size=1)
# 32 channels wide throughout, so that its 3x3 convs take the int8 route
TINY_INT8_VAE_CFG = dict(TINY_VAE_CFG, base_dim=32, dim_mult=[1, 1])
TINY_T5_CFG = dict(T5_CFG, vocab_size=128, d_model=32, d_kv=8, d_ff=48,
                   num_layers=2, num_heads=4, relative_attention_num_buckets=8,
                   relative_attention_max_distance=16)
# 4b-4e: the 480p clip (4c/4d 848 wide). 4f: TurboDiffusion at 480p with 61
# frames, since SLA (as in the JAX package, ops/sla.py:86) takes token
# counts that are multiples of 64: 81 frames give 21 x 30 x 52 = 32,760, 61
# give 16 x 30 x 52 = 24,960 = 390 tiles
CLIP_480P = dict(height=480, width=832, num_frames=81)
TURBO_SIZE = dict(height=480, width=832, num_frames=61)
TURBO_STEPS = 4  # the family's published serving form, and its maximum
# 4j/4k: FlowUniPC steps of the BSA and NABLA generations (each with CFG)
K9_STEPS = 2


def turbo_tokens() -> int:
    t, h, w = latent_of(TURBO_SIZE)
    return t * (h // 2) * (w // 2)


PROMPT = ("w12 w7 w301 w44 w5 w900 w18 w2 w77 w1024 w3 w60, w8 w11 w250 w6")
NEGATIVE_PROMPT = "w4000 w17, w93 w2048 w5 w611, w30 w31 w32"


def random_state(module, dtype, device, gen) -> dict:
    """Random weights for every parameter of a module built on the meta
    device: matrices ~ N(0, 1/fan_in), norm scales 1, small biases."""
    import torch

    out = {}
    for name, p in module.state_dict().items():
        shape, leaf = tuple(p.shape), name.rsplit(".", 1)[-1]
        randn = torch.randn(shape, generator=gen, device=device)
        if leaf == "bias":
            t = 0.02 * randn
        elif leaf == "gamma" or (leaf == "weight" and len(shape) == 1):
            t = torch.ones(shape, device=device)
        elif leaf == "scale_shift_table":
            t = randn / shape[-1]**0.5
        elif name.endswith(("shared.weight", "relative_attention_bias.weight")):
            t = randn
        else:
            fan_in = 1
            for n in shape[1:]:
                fan_in *= n
            t = randn / fan_in**0.5
        out[name] = t.to(dtype)
    return out


def write_checkpoint(root: str, dit_cfg: dict, vae_cfg: dict, t5_cfg: dict,
                     seed: int, device: str = "cuda",
                     share: str | None = None,
                     class_name: str = "WanPipeline",
                     dit_class: str = "WanTransformer3DModel") -> str:
    """A diffusers-format Wan T2V checkpoint with random weights, written
    with the port's own safetensors writer (the VAE's decoder half). The
    DiT has the blocks of the attention backend selected when this is
    called. With ``share`` only the transformer is written; the other
    components are links to those of the checkpoint ``share``.
    ``class_name`` is model_index.json's pipeline class, ``dit_class`` the
    transformer's."""
    import torch

    from fastvideo_tpu_torch.configs.models.dits.wan import WanArchConfig
    from fastvideo_tpu_torch.configs.models.encoders.t5 import T5ArchConfig
    from fastvideo_tpu_torch.configs.models.vaes.wan import WanVAEArchConfig
    from fastvideo_tpu_torch.models.encoders.t5 import T5EncoderModel
    from fastvideo_tpu_torch.models.loader.component_loader import (
        _build_arch_config as arch)
    from fastvideo_tpu_torch.models.registry import resolve_model_cls
    from fastvideo_tpu_torch.models.loader.safetensors_io import save_file
    from fastvideo_tpu_torch.models.vaes.wan import AutoencoderKLWan

    gen = torch.Generator(device=device).manual_seed(seed)
    os.makedirs(root, exist_ok=True)

    def dump(path, obj):
        with open(path, "w") as fh:
            json.dump(obj, fh)

    dump(os.path.join(root, "model_index.json"), {
        "_class_name": class_name, "_diffusers_version": "0.33.0",
        "scheduler": ["diffusers", "UniPCMultistepScheduler"],
        "text_encoder": ["transformers", "UMT5EncoderModel"],
        "tokenizer": ["transformers", "T5TokenizerFast"],
        "transformer": ["diffusers", dit_class],
        "vae": ["diffusers", "AutoencoderKLWan"]})
    dit_cls = resolve_model_cls(dit_class)[0]
    parts = [
        ("transformer", dit_class, dit_cfg,
         lambda: dit_cls(arch(WanArchConfig, dit_cfg), device="meta"),
         torch.bfloat16, "diffusion_pytorch_model.safetensors"),
        ("vae", "AutoencoderKLWan", vae_cfg,
         lambda: AutoencoderKLWan(arch(WanVAEArchConfig, vae_cfg),
                                  device="meta"),
         torch.float32, "diffusion_pytorch_model.safetensors"),
        ("text_encoder", "UMT5EncoderModel", t5_cfg,
         lambda: T5EncoderModel(arch(T5ArchConfig, t5_cfg), device="meta"),
         torch.bfloat16, "model.safetensors"),
    ]
    if share is not None:
        parts = parts[:1]
        for sub in ("vae", "text_encoder", "tokenizer", "scheduler"):
            os.symlink(os.path.join(share, sub), os.path.join(root, sub))
    for sub, cls_name, cfg, build, dtype, fname in parts:
        d = os.path.join(root, sub)
        os.makedirs(d, exist_ok=True)
        key = "architectures" if sub == "text_encoder" else "_class_name"
        dump(os.path.join(d, "config.json"),
             {key: [cls_name] if key == "architectures" else cls_name, **cfg})
        state = random_state(build(), dtype, device, gen)
        save_file(state, os.path.join(d, fname))
        del state
    if share is not None:
        return root
    tok = os.path.join(root, "tokenizer")
    os.makedirs(tok, exist_ok=True)
    vocab = {"<pad>": 0, "</s>": 1, "<unk>": 2, " ": 3}
    vocab.update({f"w{i}": i + 4 for i in range(t5_cfg["vocab_size"] - 4)})
    dump(os.path.join(tok, "tokenizer.json"), {
        "version": "1.0", "truncation": None, "padding": None,
        "added_tokens": [], "normalizer": None,
        "pre_tokenizer": {"type": "Whitespace"}, "post_processor": None,
        "decoder": None,
        "model": {"type": "WordLevel", "vocab": vocab, "unk_token": "<unk>"}})
    dump(os.path.join(tok, "tokenizer_config.json"), {
        "tokenizer_class": "PreTrainedTokenizerFast", "pad_token": "<pad>",
        "eos_token": "</s>", "unk_token": "<unk>", "model_max_length": 512})
    sched = os.path.join(root, "scheduler")
    os.makedirs(sched, exist_ok=True)
    dump(os.path.join(sched, "scheduler_config.json"), {
        "_class_name": "UniPCMultistepScheduler", "num_train_timesteps": 1000,
        "solver_order": 2})
    return root


def psnr(a, b) -> float:
    import numpy as np

    mse = np.mean((a.astype(np.float64) - b.astype(np.float64))**2)
    return float("inf") if mse == 0 else 10 * np.log10(255.0**2 / mse)


def check_small_path(work: str, name: str, backend: str, gen_kw: dict,
                     from_kw: dict, vae_cfg: dict = TINY_VAE_CFG,
                     class_name: str = "WanPipeline",
                     conv_mode: str | None = None,
                     launched: tuple[str, ...] = (),
                     dit_cfg: dict = TINY_DIT_CFG,
                     dit_class: str = "WanTransformer3DModel") -> None:
    """The whole path on a tiny random model: the card (kernels) against the
    CPU (plain versions), same checkpoint and seed, bf16 as served. The
    kernels in ``launched`` must launch in the card's run, and no plain
    version may run there."""
    import numpy as np

    from fastvideo_tpu_torch import VideoGenerator
    from fastvideo_tpu_torch.ops import _build

    os.environ["FASTVIDEO_ATTENTION_BACKEND"] = backend
    if conv_mode:
        os.environ["FASTVIDEO_VAE_CONV3D"] = conv_mode
    ckpt = write_checkpoint(os.path.join(work, backend, name), dit_cfg,
                            vae_cfg, TINY_T5_CFG, seed=7,
                            class_name=class_name, dit_class=dit_class)
    outs = {}
    for device in ("cuda", "cpu"):
        _build.reset_counts()
        gen = VideoGenerator.from_pretrained(ckpt, device=device, **from_kw)
        outs[device] = gen.generate_video(save_video=False, **gen_kw)
        if device == "cuda" and not all(_build.LAUNCHES[k] for k in launched):
            raise SystemExit(f"tiny {name}: {launched} did not all launch: "
                             f"{_build.LAUNCHES}")
        if device == "cuda" and any(_build.PLAIN_CALLS.values()):
            raise SystemExit(f"tiny {name}: the card's run reached a plain "
                             f"version: {_build.PLAIN_CALLS}")
        if device == "cuda" and launched:
            print(f"  tiny {name}: card launches "
                  f"{json.dumps({k: _build.LAUNCHES[k] for k in launched})}",
                  flush=True)
        del gen
    os.environ.pop("FASTVIDEO_VAE_CONV3D", None)
    frames = {d: o["frames"][0] for d, o in outs.items()}
    lat = {d: o["latents"].float().cpu().numpy() for d, o in outs.items()}
    p_frames = psnr(frames["cuda"], frames["cpu"])
    span = lat["cpu"].max() - lat["cpu"].min()
    mse = float(np.mean((lat["cuda"] - lat["cpu"])**2))
    p_lat = float("inf") if mse == 0 else 10 * np.log10(span**2 / mse)
    print(f"  tiny {name} with {backend}, card vs CPU plain: frames PSNR "
          f"{p_frames:.2f} dB, latents PSNR {p_lat:.2f} dB (bar: > 35 dB)",
          flush=True)
    if not (np.isfinite(lat["cuda"]).all() and p_frames > 35 and p_lat > 35):
        raise SystemExit(f"tiny {name} with {backend}: the card disagrees "
                         "with the plain path")


def check_small_paths(work: str) -> None:
    # FastWan DMD, 9 frames at 64x64: token grid (5, 16, 16), exact
    # (1, 16, 16) VSA tiles
    check_small_path(work, "FastWan2.1-T2V-tiny-Diffusers",
                     "VIDEO_SPARSE_ATTN",
                     dict(prompt="w1 w2 w3", height=64, width=64,
                          num_frames=9, seed=11), dict(VSA_sparsity=0.5))
    # Wan UniPC + CFG, 17 frames at 40x56: token grid (9, 10, 14), which no
    # tile with a multiple of 8 tokens divides: 3 x 2 x 2 padded tiles
    cfg_kw = dict(prompt="w1 w2 w3", negative_prompt="w9 w8", height=40,
                  width=56, num_frames=17, seed=11, num_inference_steps=4,
                  guidance_scale=5.0)
    check_small_path(work, "Wan2.1-T2V-tiny-Diffusers", "VIDEO_SPARSE_ATTN",
                     cfg_kw, dict(VSA_sparsity=0.6))
    check_small_path(work, "Wan2.1-T2V-tiny-Diffusers", "SLIDING_TILE_ATTN",
                     cfg_kw, {})
    # the same path on every other self-attention backend: BSA (K9b) on the
    # padded grid (9, 10, 14); NABLA (K9a) at 9 frames of 32x64, a grid of
    # (5, 8, 16), 640 tokens; the plain-PyTorch backends (SDPA also takes
    # the text cross-attention, as in JAX)
    check_small_path(work, "Wan2.1-T2V-tiny-Diffusers", "BSA_ATTN", cfg_kw,
                     {}, launched=("dyn_sparse_qtile_fwd",))
    check_small_path(work, "Wan2.1-T2V-tiny-Diffusers", "NABLA_ATTN",
                     dict(cfg_kw, height=32, width=64, num_frames=9), {},
                     launched=("dyn_sparse_fwd",))
    for backend in ("TORCH_SDPA", "SAGE_ATTN", "VMOBA_ATTN",
                    "ATTN_QAT_TRAIN"):
        check_small_path(work, "Wan2.1-T2V-tiny-Diffusers", backend, cfg_kw,
                         {}, launched=("conv3d",))
    # TurboDiffusion: 4 rCM steps with SLA, W8A8 DiT linears and the int8
    # decode convs of a 32-channel VAE; 9 frames at 64x64, 1,280 tokens
    check_small_path(work, "TurboDiffusion-T2V-tiny", "SLA_ATTN",
                     dict(prompt="w1 w2 w3", height=64, width=64,
                          num_frames=9, seed=11, num_inference_steps=4,
                          guidance_scale=1.0),
                     dict(transformer_quant="int8"),
                     vae_cfg=TINY_INT8_VAE_CFG,
                     class_name="TurboDiffusionPipeline", conv_mode="kf_int8",
                     launched=("conv3d_int8", "vsa_sparse_padded_fwd"))
    # FastWan DMD decoded in fp32 (vae_decode_precision="fp32"): K3's fp32
    # form and K1 in fp32 at the VAE attention
    check_small_path(work, "FastWan2.1-T2V-tiny-fp32-decode",
                     "VIDEO_SPARSE_ATTN",
                     dict(prompt="w1 w2 w3", height=64, width=64,
                          num_frames=9, seed=11),
                     dict(VSA_sparsity=0.5, vae_decode_precision="fp32"),
                     launched=("conv3d", "flash_fwd"))
    # the causal Wan, one head of 128: 17 frames at 64x64 give 9 latent
    # frames of 16 x 16 tokens, 3 blocks of 3; a 5-frame window (1,280
    # keys, a 1-frame sink) takes K5, and the third block evicts
    check_small_path(work, "Wan2.1-T2V-causal-tiny", "FLASH_ATTN",
                     dict(prompt="w1 w2 w3", height=64, width=64,
                          num_frames=17, seed=11, num_inference_steps=3),
                     {}, class_name="WanCausalDMDPipeline",
                     dit_cfg=TINY_CAUSAL_DIT_CFG,
                     dit_class="CausalWanTransformer3DModel",
                     launched=("flash_fwd_kv_mask", "flash_fwd"))


def check_generation(label: str, result: dict, size: dict, launches: dict,
                     plain: dict, expect: dict) -> None:
    """Frames (of the generation ``size``) and latents of a full-width
    generation, and its kernel counts: ``expect`` maps each kernel of the
    path to its exact launch count, or None for any count above 0; other
    kernels must not launch."""
    import numpy as np
    import torch

    frames, latents = result["frames"][0], result["latents"]
    want_shape = (size["num_frames"], size["height"], size["width"], 3)
    if frames.shape != want_shape or frames.dtype != np.uint8:
        raise SystemExit(f"{label}: frames {frames.shape} {frames.dtype}")
    if not torch.isfinite(latents).all():
        raise SystemExit(f"{label}: latents are not finite")
    for name, n in launches.items():
        want = expect.get(name, 0)
        if (want is None and n == 0) or (want is not None and n != want):
            raise SystemExit(f"{label}: kernel {name} launched {n} times, "
                             f"expected {'> 0' if want is None else want}: "
                             f"{launches}")
    if any(plain.values()):
        raise SystemExit(f"{label}: the path reached a plain version: "
                         f"{plain}")
    print(f"  frames {frames.shape} uint8, mean {frames.mean():.2f}; "
          f"latents finite, std {latents.float().std().item():.4f}",
          flush=True)


def run_main_path(work: str, profile_dir: str | None = None) -> dict:
    import numpy as np
    import torch

    from fastvideo_tpu_torch import VideoGenerator
    from fastvideo_tpu_torch.ops import _build

    os.environ["FASTVIDEO_ATTENTION_BACKEND"] = "VIDEO_SPARSE_ATTN"
    t0 = time.perf_counter()
    root = os.path.join(work, "FastWan2.1-T2V-1.3B-Diffusers")
    ckpt = write_checkpoint(root, DIT_CFG, VAE_CFG, T5_CFG, seed=42)
    print(f"  checkpoint written in {time.perf_counter() - t0:.1f} s "
          f"(UMT5 depth {T5_CFG['num_layers']}; disk free "
          f"{shutil.disk_usage(work).free / 2**30:.0f} GiB)", flush=True)
    t0 = time.perf_counter()
    gen = VideoGenerator.from_pretrained(ckpt, VSA_sparsity=0.8)
    print(f"  from_pretrained in {time.perf_counter() - t0:.1f} s",
          flush=True)
    kw = dict(prompt=PROMPT, seed=42, save_video=False, **CLIP_480P)
    warm = gen.generate_video(**kw)
    print(f"  warm-up generation {warm['generation_time']:.2f} s", flush=True)
    del warm
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_counts()
    result = gen.generate_video(**kw)
    launches = dict(_build.LAUNCHES)
    plain = dict(_build.PLAIN_CALLS)
    peak = torch.cuda.max_memory_allocated() / 2**30
    times = {k: round(v, 4) for k, v in result["stage_times"].items()}
    print(f"  generation {result['generation_time']:.3f} s; stage seconds "
          f"{json.dumps(times)}; peak memory {peak:.1f} GiB", flush=True)
    print(f"  kernel launches {json.dumps(launches)}; plain calls "
          f"{json.dumps(plain)}", flush=True)
    check_generation("FastWan 480x832", result, CLIP_480P, launches, plain,
                     {"flash_fwd": None, "vsa_sparse_fwd": None,
                      "conv3d": None,
                      "flash_fwd_combine": vae_chunks(CLIP_480P)})
    # 4w's prompt embedding, from this pipeline's UMT5 (freed with it)
    with torch.inference_mode():
        emb = gen.pipeline.prompt_encoding_stage._encode_one([PROMPT], 0)
    np.save(os.path.join(work, "nft_prompt_embeds.npy"),
            emb.float().cpu().numpy())
    fp32 = run_fp32_decode(gen, kw, result["stage_times"]["DecodingStage"])
    if profile_dir:
        profile_generation(gen, kw, profile_dir, "fastwan_480x832")
    return dict(launches, fp32_decode=fp32)


def run_fp32_decode(gen, kw: dict, bf16_decode_s: float) -> dict:
    """4b's clip once more with vae_decode_precision="fp32" (same seed, so
    the same latents): every 3x3 conv of the decode through K3's fp32 form
    (the 3xTF32 schedule) and every VAE attention through K1's (its
    pre-pass, the kernel, and a merge where its keys split). Its
    DecodingStage seconds against the bf16 decode's, its launch counts and
    its frames."""
    cfg = gen.pipeline.decoding_stage.pipeline_config
    cfg.vae_decode_precision = "fp32"
    try:
        result, launches, plain, peak = timed_generation(gen, kw)
    finally:
        cfg.vae_decode_precision = "bf16"
    times = {k: round(v, 4) for k, v in result["stage_times"].items()}
    convs = vae_chunks(CLIP_480P) * sum(
        n for _, n, *_ in decoder_conv_shapes(latent_of(CLIP_480P)))
    attns, merges = fp32_vae_attn_launches(CLIP_480P)
    print(f"  the same clip decoded in fp32: DecodingStage "
          f"{times['DecodingStage']:.3f} s (bf16 {bf16_decode_s:.3f} s); "
          f"stage seconds {json.dumps(times)}; peak memory {peak:.1f} GiB; "
          f"kernel launches {json.dumps(launches)} (conv3d: {convs} on the "
          f"3xTF32 schedule; the VAE attention: {attns} of flash_fwd_tf32 and "
          f"of its pre-pass, {merges} merges)", flush=True)
    check_generation("FastWan 480x832, fp32 decode", result, CLIP_480P,
                     launches, plain, {"flash_fwd": None,
                                       "vsa_sparse_fwd": None,
                                       "conv3d": convs,
                                       "flash_fwd_tf32": attns,
                                       "flash_fwd_tf32_split": attns,
                                       "flash_fwd_combine": merges})
    return dict(decode_s=times["DecodingStage"],
                conv3d_launches=launches["conv3d"],
                flash_fwd_launches=launches["flash_fwd"],
                flash_fwd_tf32_launches=launches["flash_fwd_tf32"],
                flash_fwd_tf32_split_launches=launches[
                    "flash_fwd_tf32_split"],
                flash_fwd_combine_launches=launches["flash_fwd_combine"])


def fp32_vae_attn_launches(size: dict) -> tuple[int, int]:
    """(attentions, merges) of an fp32 decode at ``size``: one 3xTF32 K1
    (and its pre-pass) a decode chunk, over that chunk's frames, and a merge
    where the chunk's launch splits its keys (wide_splits at the 3xTF32
    schedule's rows a block on this card)."""
    import torch

    from fastvideo_tpu_torch.ops import _build
    from fastvideo_tpu_torch.ops import flash_attention as fa

    t, h, w = latent_of(size)
    step = decode_chunk_frames((t, h, w))
    frames = [1] + [min(step, t - f) for f in range(1, t, step)]
    if t <= step:
        frames = [t]
    sms = _build.num_sms(torch.device("cuda", 0))
    tokens = h * w
    merges = sum(fa.wide_splits(f, 1, tokens, tokens, sms,
                                fa.TF32_BLOCK_ROWS) > 1 for f in frames)
    return len(frames), merges


@contextlib.contextmanager
def kept_fraction_meter():
    """Collects, for each K9 call of a run, the kept fraction of its block
    mask (a device scalar, read once at the end, so no call waits on the
    host)."""
    from fastvideo_tpu_torch.ops import bsa, nabla

    fracs: list = []
    orig = nabla.mask_indices

    def metered(mask):
        fracs.append(mask.float().mean())
        return orig(mask)

    nabla.mask_indices = bsa.mask_indices = metered
    try:
        yield fracs
    finally:
        nabla.mask_indices = bsa.mask_indices = orig


def run_wan_path(work: str, backend: str, steps: int, from_kw: dict,
                 profile_dir: str | None = None,
                 size: dict | None = None,
                 kernel: str = "vsa_sparse_padded_fwd") -> dict:
    """The multistep Wan2.1-T2V-1.3B path at full width and depth (480x848,
    token grid (21, 30, 53), unless ``size`` says otherwise): one
    generation of ``steps`` FlowUniPC steps with classifier-free guidance
    (two DiT passes a step), every DiT layer's self-attention through the
    sparse kernel ``kernel``."""
    import torch

    from fastvideo_tpu_torch import VideoGenerator
    from fastvideo_tpu_torch.ops import _build

    size = size or dict(CLIP_480P, width=848)
    os.environ["FASTVIDEO_ATTENTION_BACKEND"] = backend
    label = f"Wan {size['height']}x{size['width']} {backend}"
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    root = os.path.join(work, backend, "Wan2.1-T2V-1.3B-Diffusers")
    ckpt = write_checkpoint(
        root, DIT_CFG, VAE_CFG, T5_CFG, seed=43,
        share=os.path.join(work, "FastWan2.1-T2V-1.3B-Diffusers"))
    gen = VideoGenerator.from_pretrained(ckpt, **from_kw)
    print(f"  transformer written and pipeline loaded in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    kw = dict(prompt=PROMPT, negative_prompt=NEGATIVE_PROMPT, seed=42,
              num_inference_steps=steps, guidance_scale=5.0, save_video=False,
              **size)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_counts()
    with kept_fraction_meter() as fracs:
        result = gen.generate_video(**kw)
    launches = dict(_build.LAUNCHES)
    plain = dict(_build.PLAIN_CALLS)
    peak = torch.cuda.max_memory_allocated() / 2**30
    times = {k: round(v, 4) for k, v in result["stage_times"].items()}
    layers = DIT_CFG["num_layers"]
    kept = (f"; mean kept fraction of the K9 block masks "
            f"{torch.stack(fracs).mean().item():.4f} over {len(fracs)} "
            f"calls" if fracs else "")
    print(f"  {steps} steps used; generation {result['generation_time']:.3f} "
          f"s (first call in the process for this shape); stage seconds "
          f"{json.dumps(times)}; {times['DenoisingStage'] / steps:.3f} s a "
          f"step; peak memory {peak:.1f} GiB{kept}", flush=True)
    print(f"  kernel launches {json.dumps(launches)} ({kernel}: "
          f"{layers} layers x 2 CFG passes x {steps} steps = "
          f"{layers * 2 * steps}); plain calls {json.dumps(plain)}",
          flush=True)
    check_generation(label, result, size, launches, plain,
                     {"flash_fwd": None, "conv3d": None,
                      kernel: layers * 2 * steps,
                      "flash_fwd_combine": vae_chunks(size)})
    if profile_dir:
        profile_generation(gen, kw, profile_dir,
                           f"wan_{size['height']}x{size['width']}_"
                           f"{backend.lower()}")
    del gen, result
    torch.cuda.empty_cache()
    return dict(launches, kept_fraction=(torch.stack(fracs).mean().item()
                                         if fracs else None),
                step_s=times["DenoisingStage"] / steps)


def state_bytes(module) -> int:
    """Bytes of a module's parameters and buffers."""
    return sum(t.numel() * t.element_size()
               for t in module.state_dict().values())


def latent_of(size: dict) -> tuple[int, int, int]:
    """The (T, H, W) latent of a generation size."""
    return ((size["num_frames"] - 1) // 4 + 1, size["height"] // 8,
            size["width"] // 8)


def vae_chunks(size: dict) -> int:
    """Chunks of the dispatched decode at ``size``: the first latent frame
    alone, then chunks, or one pass if none is needed. Each runs the VAE's
    attention once (K1 at a head of 384, whose key splits one
    flash_fwd_combine merges)."""
    latent = latent_of(size)
    t = latent[0]
    chunk = decode_chunk_frames(latent)
    return 1 if t <= chunk else 1 + -(-(t - 1) // chunk)


def int8_decode_launches(size: dict) -> tuple[int, int]:
    """(K4, K3) launches of one auto_int8 decode at ``size``: the convs of
    a chunk that meet the int8 rule, and the rest, times the chunks of the
    dispatched decode."""
    latent = latent_of(size)
    chunk = decode_chunk_frames(latent)
    chunks = vae_chunks(size)
    k4, k3 = int8_route_split(latent)
    split = (f"{chunks} chunks (the first latent frame, then {chunk} at a "
             f"time)" if chunks > 1 else "one pass")
    print(f"  decode in {split}: per chunk {k4} convs take K4 (auto_int8: C, "
          f"Co % 32 == 0, C >= 64, W >= 256) and {k3} take K3", flush=True)
    return k4 * chunks, k3 * chunks


def timed_generation(gen, kw: dict) -> tuple[dict, dict, dict, float]:
    """One generation with every kernel count and the peak memory reset just
    before it: (result, launches, plain calls, peak GiB)."""
    import torch

    from fastvideo_tpu_torch.ops import _build

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_counts()
    result = gen.generate_video(**kw)
    torch.cuda.synchronize()
    return (result, dict(_build.LAUNCHES), dict(_build.PLAIN_CALLS),
            torch.cuda.max_memory_allocated() / 2**30)


def run_int8_fastwan(work: str, profile_dir: str | None = None) -> dict:
    """Phase 4e: the 4b checkpoint served with all three int8 forms, as the
    JAX package's reported arm: UMT5 quantized at load (weight-only), W8A8
    DiT linears, auto_int8 decode convs."""
    import gc

    import torch

    from fastvideo_tpu_torch import VideoGenerator
    from fastvideo_tpu_torch.layers.quantization import int8
    from fastvideo_tpu_torch.models.loader import component_loader

    os.environ["FASTVIDEO_ATTENTION_BACKEND"] = "VIDEO_SPARSE_ATTN"
    os.environ["FASTVIDEO_VAE_CONV3D"] = "auto_int8"
    gc.collect()
    torch.cuda.empty_cache()
    ckpt = os.path.join(work, "FastWan2.1-T2V-1.3B-Diffusers")
    load_module = component_loader.PipelineComponentLoader.load_module
    enc: dict = {}

    def measured_load(name, *args, **kwargs):
        # device memory over the text encoder's load alone
        if name != "text_encoder":
            return load_module(name, *args, **kwargs)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        module = load_module(name, *args, **kwargs)
        torch.cuda.synchronize()
        enc.update(seconds=time.perf_counter() - t0, bytes=state_bytes(module),
                   peak=torch.cuda.max_memory_allocated() - base)
        return module

    component_loader.PipelineComponentLoader.load_module = staticmethod(
        measured_load)
    try:
        t0 = time.perf_counter()
        gen = VideoGenerator.from_pretrained(
            ckpt, VSA_sparsity=0.8, text_encoder_quant="int8-weight-only",
            transformer_quant="int8")
    finally:
        component_loader.PipelineComponentLoader.load_module = staticmethod(
            load_module)
    load_s = time.perf_counter() - t0
    bf16_bytes = os.path.getsize(os.path.join(ckpt, "text_encoder",
                                              "model.safetensors"))
    largest = 2 * max(T5_CFG["d_ff"], T5_CFG["vocab_size"]) * T5_CFG["d_model"]
    dit = gen.pipeline.modules["transformer"]
    n_q = sum(isinstance(m, int8.Int8Linear) for m in dit.modules())
    gib = 2**30
    print(f"  from_pretrained in {load_s:.1f} s; UMT5 quantized at load in "
          f"{enc['seconds']:.1f} s: {enc['bytes'] / gib:.3f} GiB on the card "
          f"({enc['bytes'] / bf16_bytes:.3f} of the bf16 checkpoint's "
          f"{bf16_bytes / gib:.3f} GiB), peak {enc['peak'] / gib:.3f} GiB "
          f"over its load; {n_q} DiT linears W8A8 ({state_bytes(dit) / gib:.3f}"
          f" GiB DiT)", flush=True)
    if enc["bytes"] > 0.55 * bf16_bytes:
        raise SystemExit("4e: the UMT5 on the card is not int8")
    if enc["peak"] > enc["bytes"] + largest + gib:
        raise SystemExit("4e: the UMT5 load held more than its int8 weights, "
                         "one bf16 tensor and 1 GiB on the card")
    if n_q != 4 * DIT_CFG["num_layers"] + 1:
        raise SystemExit(f"4e: {n_q} W8A8 DiT linears, expected 4 a block "
                         "and the patch embedding")
    kw = dict(prompt=PROMPT, seed=42, save_video=False, **CLIP_480P)
    warm = gen.generate_video(**kw)
    print(f"  warm-up generation {warm['generation_time']:.2f} s", flush=True)
    del warm
    int8.reset_forward_calls()
    result, launches, plain, peak = timed_generation(gen, kw)
    times = {k: round(v, 4) for k, v in result["stage_times"].items()}
    print(f"  generation {result['generation_time']:.3f} s; stage seconds "
          f"{json.dumps(times)}; peak memory {peak:.2f} GiB (generation)",
          flush=True)
    print(f"  kernel launches {json.dumps(launches)}; plain calls "
          f"{json.dumps(plain)}; int8 linear calls "
          f"{json.dumps(int8.FORWARD_CALLS)}", flush=True)
    k4, k3 = int8_decode_launches(CLIP_480P)
    check_generation("FastWan int8 480x832", result, CLIP_480P,
                     launches, plain,
                     {"flash_fwd": None, "vsa_sparse_fwd": None,
                      "conv3d": k3, "conv3d_int8": k4,
                      "flash_fwd_combine": vae_chunks(CLIP_480P)})
    if not all(int8.FORWARD_CALLS.values()):
        raise SystemExit(f"4e: an int8 linear form did not run: "
                         f"{int8.FORWARD_CALLS}")
    if profile_dir:
        profile_generation(gen, kw, profile_dir, "fastwan_int8_480x832")
    del gen, result
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def run_turbo_path(work: str, profile_dir: str | None = None) -> dict:
    """Phase 4f: TurboDiffusion T2V 1.3B at full width and depth,
    ``TURBO_SIZE``: ``TURBO_STEPS`` rCM steps without CFG, SLA_ATTN (top
    10 % of key blocks), W8A8 DiT linears, auto_int8 decode."""
    import gc

    import torch

    from fastvideo_tpu_torch import VideoGenerator
    from fastvideo_tpu_torch.layers.quantization import int8

    os.environ["FASTVIDEO_ATTENTION_BACKEND"] = "SLA_ATTN"
    os.environ["FASTVIDEO_VAE_CONV3D"] = "auto_int8"
    t0 = time.perf_counter()
    root = os.path.join(work, "SLA_ATTN", "TurboDiffusion-T2V-1.3B-Diffusers")
    ckpt = write_checkpoint(
        root, DIT_CFG, VAE_CFG, T5_CFG, seed=44,
        share=os.path.join(work, "FastWan2.1-T2V-1.3B-Diffusers"),
        class_name="TurboDiffusionPipeline")
    gen = VideoGenerator.from_pretrained(ckpt, transformer_quant="int8")
    print(f"  transformer written and pipeline loaded in "
          f"{time.perf_counter() - t0:.1f} s; scheduler "
          f"{type(gen.pipeline.modules['scheduler']).__name__}", flush=True)
    steps = TURBO_STEPS
    kw = dict(prompt=PROMPT, seed=42, num_inference_steps=steps,
              guidance_scale=1.0, save_video=False, **TURBO_SIZE)
    int8.reset_forward_calls()
    result, launches, plain, peak = timed_generation(gen, kw)
    times = {k: round(v, 4) for k, v in result["stage_times"].items()}
    layers = DIT_CFG["num_layers"]
    print(f"  {steps} rCM steps; generation {result['generation_time']:.3f} s "
          f"(first call in the process for this configuration); stage "
          f"seconds {json.dumps(times)}; "
          f"{times['DenoisingStage'] / steps:.3f} s a step; peak memory "
          f"{peak:.2f} GiB", flush=True)
    print(f"  kernel launches {json.dumps(launches)} (padded sparse kernel: "
          f"{layers} layers x {steps} steps = {layers * steps}); plain calls "
          f"{json.dumps(plain)}; int8 linear calls "
          f"{json.dumps(int8.FORWARD_CALLS)}", flush=True)
    k4, k3 = int8_decode_launches(TURBO_SIZE)
    check_generation("TurboDiffusion 61x480x832", result, TURBO_SIZE,
                     launches, plain,
                     {"flash_fwd": None, "vsa_sparse_padded_fwd":
                      layers * steps, "conv3d": k3, "conv3d_int8": k4,
                      "flash_fwd_combine": vae_chunks(TURBO_SIZE)})
    w8a8 = int8.FORWARD_CALLS["int8_w8a8"]
    if w8a8 != (4 * layers + 1) * steps:
        raise SystemExit(f"4f: {w8a8} W8A8 linear calls, expected "
                         f"{(4 * layers + 1) * steps}")
    if profile_dir:
        profile_generation(gen, kw, profile_dir, "turbodiffusion_480x832")
    del gen, result
    gc.collect()
    torch.cuda.empty_cache()
    return launches


# 4g/4h: the causal Wan at the FastWan/Wan2.1-1.3B widths, 3 latent frames
# a block, the default 21-frame window, no sink (bench.py's streaming rider)
CAUSAL_DIT_CFG = dict(DIT_CFG, num_frames_per_block=3, local_attn_size=-1,
                      sink_size=0)
CAUSAL_STEPS = 3
STREAM_BLOCKS = 8


def run_causal_path(work: str, profile_dir: str | None = None):
    """Phase 4g: VideoGenerator on a CausalWan-1.3B checkpoint
    (WanCausalDMDPipeline; text encoder, VAE and tokenizer linked from the
    4b checkpoint; DiT seed 45) at 81x480x832: 7 blocks of 3 latent frames,
    CAUSAL_STEPS flow-match Euler steps a block and one commit pass, every
    cached self-attention through K5. Returns (launches, generator)."""
    import torch

    from fastvideo_tpu_torch import VideoGenerator

    os.environ["FASTVIDEO_ATTENTION_BACKEND"] = "FLASH_ATTN"
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    root = os.path.join(work, "causal", "SelfForcing-Wan2.1-T2V-1.3B")
    ckpt = write_checkpoint(
        root, CAUSAL_DIT_CFG, VAE_CFG, T5_CFG, seed=45,
        share=os.path.join(work, "FastWan2.1-T2V-1.3B-Diffusers"),
        class_name="WanCausalDMDPipeline",
        dit_class="CausalWanTransformer3DModel")
    gen = VideoGenerator.from_pretrained(ckpt)
    sched = gen.pipeline.modules["scheduler"]
    print(f"  transformer written and pipeline loaded in "
          f"{time.perf_counter() - t0:.1f} s; {type(gen.pipeline).__name__}, "
          f"{type(sched).__name__}", flush=True)
    kw = dict(prompt=PROMPT, seed=42, num_inference_steps=CAUSAL_STEPS,
              save_video=False, **CLIP_480P)
    result, launches, plain, peak = timed_generation(gen, kw)
    times = {k: round(v, 4) for k, v in result["stage_times"].items()}
    layers = CAUSAL_DIT_CFG["num_layers"]
    blocks = latent_of(CLIP_480P)[0] // CAUSAL_DIT_CFG["num_frames_per_block"]
    k5 = layers * blocks * (CAUSAL_STEPS + 1)
    print(f"  {blocks} blocks x ({CAUSAL_STEPS} steps + 1 commit pass), "
          f"scheduler shift {sched.shift}; generation "
          f"{result['generation_time']:.3f} s (first call in the process for "
          f"this configuration); stage seconds {json.dumps(times)}; "
          f"{times['CausalDenoisingStage'] / blocks:.3f} s a block; peak "
          f"memory {peak:.2f} GiB", flush=True)
    print(f"  kernel launches {json.dumps(launches)} (K5: {layers} layers x "
          f"{blocks} blocks x {CAUSAL_STEPS + 1} passes = {k5}); plain calls "
          f"{json.dumps(plain)}", flush=True)
    check_generation("causal Wan 480x832", result, CLIP_480P, launches, plain,
                     {"flash_fwd_kv_mask": k5, "flash_fwd": None,
                      "conv3d": None,
                      "flash_fwd_combine": vae_chunks(CLIP_480P)})
    if profile_dir:
        profile_generation(gen, kw, profile_dir, "causal_wan_480x832")
    del result
    return launches, gen


def run_streaming(gen, spec: dict) -> tuple[dict, dict]:
    """Phase 4h: StreamingVideoGenerator on 4g's loaded modules with
    FlowMatchEulerDiscreteScheduler(shift=5.0), as the JAX package's
    streaming rider builds it: reset with the benchmark's prompt,
    STREAM_BLOCKS blocks, finalize. Steady block seconds and steady fps as
    the JAX package's run_streaming_benchmark defines them (blocks 1 on).
    Returns (launches, the stream's numbers)."""
    import statistics

    import torch

    from fastvideo_tpu_torch.entrypoints.streaming_generator import (
        StreamingVideoGenerator)
    from fastvideo_tpu_torch.models.schedulers.flow_match_euler import (
        FlowMatchEulerDiscreteScheduler)
    from fastvideo_tpu_torch.ops import _build

    mods = gen.pipeline.modules
    sgen = StreamingVideoGenerator(
        mods["transformer"], mods["vae"], mods["text_encoder"],
        mods["tokenizer"], FlowMatchEulerDiscreteScheduler(shift=5.0),
        num_inference_steps=CAUSAL_STEPS, height=480, width=832, seed=1024)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_counts()
    t0 = time.perf_counter()
    sgen.reset(spec["stream"]["prompt"])
    torch.cuda.synchronize()
    reset_s = time.perf_counter() - t0
    latencies, frames = [], []
    for _ in range(STREAM_BLOCKS):
        t0 = time.perf_counter()
        out = sgen.step()
        latencies.append(time.perf_counter() - t0)
        frames.append(int(out.shape[0]))
        if out.shape[1:] != (480, 832, 3) or out.dtype.name != "uint8":
            raise SystemExit(f"4h: block frames {out.shape} {out.dtype}")
    total = sgen.finalize()
    launches, plain = dict(_build.LAUNCHES), dict(_build.PLAIN_CALLS)
    peak = torch.cuda.max_memory_allocated() / 2**30
    steady_block_s = statistics.mean(latencies[1:])
    steady_fps = sum(frames[1:]) / sum(latencies[1:])
    layers = CAUSAL_DIT_CFG["num_layers"]
    k5 = layers * STREAM_BLOCKS * (CAUSAL_STEPS + 1)
    window = sgen.kv_caches[0]
    print(f"  reset {reset_s:.3f} s; block seconds "
          f"{[round(t, 4) for t in latencies]}; frames {frames} ({total} in "
          f"all); steady_block_s {steady_block_s:.4f}, steady_fps "
          f"{steady_fps:.3f}; peak memory {peak:.2f} GiB; window "
          f"{window['valid']} of {window['k'].shape[1]} slots valid after "
          f"{window['global_end']} tokens", flush=True)
    print(f"  kernel launches {json.dumps(launches)} (K5: {layers} layers x "
          f"{STREAM_BLOCKS} blocks x {CAUSAL_STEPS + 1} passes = {k5}); plain "
          f"calls {json.dumps(plain)}", flush=True)
    if frames != [9] + [12] * (STREAM_BLOCKS - 1):
        raise SystemExit(f"4h: frames per block {frames}")
    # one VAE attention (one split K1 at a head of 384, so one combine)
    # a one-latent-frame decode, the rest of K1 the blocks' cross-attention
    decodes = launches["flash_fwd"] - layers * STREAM_BLOCKS * (
        CAUSAL_STEPS + 1)
    if launches["flash_fwd_kv_mask"] != k5 or not launches["conv3d"] or \
            decodes <= 0 or launches["flash_fwd_combine"] != decodes:
        raise SystemExit(f"4h: kernel launches {launches}")
    if any(plain.values()):
        raise SystemExit(f"4h: the stream reached a plain version: {plain}")
    if window["global_end"] <= window["k"].shape[1]:
        raise SystemExit("4h: the window never evicted")
    return launches, dict(steady_block_s=steady_block_s,
                          steady_fps=steady_fps,
                          block_latencies_s=latencies, reset_s=reset_s,
                          peak_gib=peak)


# -- 4a (training) and 4i: the SFT trainer ------------------------------------

# the JAX repo's training cell sft_33k (benchmarks/train_step_1_3b.json):
# full-AdamW SFT of Wan2.1-T2V-1.3B, latents [accum, B, 16, 21, 60, 104]
# (81x480x832: 32,760 tokens), 512 text tokens, VSA 0.8, full remat
TRAIN_LATENTS = (1, 1, 16, 21, 60, 104)
TRAIN_EMBEDS = (1, 1, 512, 4096)
TRAIN_KW = dict(VSA_sparsity=0.8, selective_checkpointing="full",
                learning_rate=1e-5, max_grad_norm=1.0,
                weighting_scheme="uniform", seed=0,
                gradient_accumulation_steps=1, checkpointing_steps=0)
# 4a's tiny trainer: token grid (2, 16, 16), exact (2, 8, 8) VSA tiles
TINY_TRAIN_LATENTS = (1, 1, 4, 2, 32, 32)
TINY_TRAIN_EMBEDS = (1, 1, 12, 32)


class StepRecorder:
    """A tracker that keeps each step's metrics."""

    def __init__(self):
        self.rows = []

    def log(self, metrics: dict, step: int) -> None:
        self.rows.append(dict(metrics))

    def finish(self) -> None:
        pass


def train_loader(latents_shape, embeds_shape, seed: int = 0):
    """Seeded numpy batches through the port's samplers and prefetching
    loader, as the JAX repo's train-step bench builds them
    (scripts/bench_train_step.py:43-56)."""
    import numpy as np

    from fastvideo_tpu_torch.dataset.loader import PrefetchingLoader
    from fastvideo_tpu_torch.dataset.parquet import (DPSPBatchSampler,
                                                     _AccumSampler)

    rng = np.random.default_rng(seed)

    def make_batch(groups):
        return (rng.standard_normal(latents_shape).astype(np.float32),
                rng.standard_normal(embeds_shape).astype(np.float32))

    sampler = _AccumSampler(DPSPBatchSampler(64, 1, 1, 0, seed=seed), 1)
    return PrefetchingLoader(sampler, make_batch, prefetch=2)


def build_method(method: str, ckpt: str, out_dir: str, device: str,
                 training: dict, method_config: dict | None = None,
                 dmd: dict | None = None, data_path: str = ""):
    """A training method through the training entry point's own calls
    (build_from_config: resolve_method(method), its from_config, and the
    Parquet dataloader of ``data_path``). Returns (method, loader); the
    loader is None without a ``data_path``."""
    from fastvideo_tpu_torch.entrypoints.cli.train import build_from_config
    from fastvideo_tpu_torch.training.run_config import (DataSpec, DMDSpec,
                                                         ModelSpec,
                                                         TrainRunConfig)

    cfg = TrainRunConfig(
        method=method,
        model=ModelSpec(pretrained_model_path=ckpt, dit_precision="fp32"),
        data=DataSpec(path=data_path),
        training=dict(training, output_dir=out_dir, device=device),
        dmd=DMDSpec(**(dmd or {})),
        method_config=method_config or {})
    m, loader = build_from_config(cfg)
    if (loader is None) != (not data_path):
        raise SystemExit(f"data path {data_path!r} gave loader {loader}")
    getattr(m, "pipeline", m).tracker = StepRecorder()
    return m, loader


def capture_grads(optimizer, params, into: dict, role: str) -> None:
    """Keep, on the host, the gradients ``optimizer`` is handed."""
    step = optimizer.step

    def capture(*a, **k):
        into[role] = [p.grad.float().cpu() for p in params]
        return step(*a, **k)

    optimizer.step = capture


def step_with_grads(pipe, batch, **kw) -> tuple[dict, list, dict, dict]:
    """One train_one_step: its metrics, the gradients AdamW was handed (on
    the host), and the launch and plain-call counts of the step."""
    import torch

    from fastvideo_tpu_torch.ops import _build

    grads: dict = {}
    capture_grads(pipe.optimizer, pipe.params, grads, "step")
    _build.reset_counts()
    out = pipe.train_one_step(*batch, **kw)
    if pipe.device.type == "cuda":
        torch.cuda.synchronize()
    return out, grads["step"], dict(_build.LAUNCHES), dict(
        _build.PLAIN_CALLS)


def split_backwards(cfg: dict, shapes) -> int:
    """How many of a block's flash backwards, one for each (query rows,
    keys) in ``shapes``, split their dK/dV grid and so launch
    flash_bwd_dkv_reduce once (flash_attention.dkv_splits on this card)."""
    import torch

    from fastvideo_tpu_torch.ops import _build
    from fastvideo_tpu_torch.ops import flash_attention as fa

    sms = _build.num_sms(torch.device("cuda", 0))
    h, d = cfg["num_attention_heads"], cfg["attention_head_dim"]
    return sum(fa.dkv_splits(1, h, sq, skv, d, sms) > 1 for sq, skv in shapes)


def train_launches(layers: int, steps: int, reduces: int) -> dict:
    """Launches of a trainer step under full remat with VSA: each block's
    forward runs twice (the step and the recompute in the backward), its
    backward once; ``reduces`` of a block's backwards split dK/dV."""
    return {"flash_fwd": 2 * layers * steps,
            "vsa_sparse_padded_fwd": 2 * layers * steps,
            "flash_bwd_dq": layers * steps, "flash_bwd_dkv": layers * steps,
            "flash_bwd_dkv_reduce": reduces * layers * steps,
            "vsa_sparse_bwd_dq": layers * steps,
            "vsa_sparse_bwd_dkv": layers * steps}


def check_launches(label: str, launches: dict, plain: dict,
                   expect: dict) -> None:
    for name, n in launches.items():
        if n != expect.get(name, 0):
            raise SystemExit(f"{label}: kernel {name} launched {n} times, "
                             f"expected {expect.get(name, 0)}: {launches}")
    if any(plain.values()):
        raise SystemExit(f"{label}: the path reached a plain version: "
                         f"{plain}")


def adamw_agreement(card_grads, cpu_grads, card_params, cpu_params
                    ) -> tuple[float, float, float, int, int]:
    """Card against CPU after one AdamW update from the same start: the
    gradients' relative L2, the largest parameter difference, the largest
    where the two gradients agree in sign and are at least 1e-5 (there the
    first update, lr times the sign, is the same), the count of elements
    where they do not, and the count of elements."""
    import torch

    gc, gp = (torch.cat([g.flatten() for g in gs])
              for gs in (card_grads, cpu_grads))
    rel = ((gc - gp).norm() / gp.norm()).item()
    worst_all = worst_sure = 0.0
    flips = 0
    for a, b, g_card, g_cpu in zip(card_params, cpu_params, card_grads,
                                   cpu_grads):
        diff = (a - b).abs()
        worst_all = max(worst_all, diff.max().item())
        sure = (torch.sign(g_card) == torch.sign(g_cpu)) & (
            torch.minimum(g_card.abs(), g_cpu.abs()) >= 1e-5)
        flips += int((~sure).sum())
        if sure.any():
            worst_sure = max(worst_sure, diff[sure].max().item())
    return rel, worst_all, worst_sure, flips, gc.numel()


def check_small_training(work: str) -> None:
    """One SFT step of a tiny VSA Wan (heads of 16, 2 layers) on the card
    against the same step on the CPU's plain path
    (:func:`check_small_pipeline_step`)."""
    layers = TINY_DIT_CFG["num_layers"]
    check_small_pipeline_step(
        work, "sft", "sft", {}, lambda tokens: train_launches(
            layers, 1, split_backwards(TINY_DIT_CFG,
                                       [(tokens, TINY_TRAIN_EMBEDS[2])])))


def run_training(work: str, steps: int, profile_dir: str | None = None
                 ) -> dict:
    """Phase 4i: SFTMethod.from_config (through build_from_config) on the
    4b checkpoint's Wan2.1-T2V-1.3B-shaped DiT in fp32 master weights,
    then method.train over the port's PrefetchingLoader: one warm-up step,
    then ``steps`` timed ones, at the JAX repo's sft_33k cell."""
    import torch

    from fastvideo_tpu_torch.ops import _build

    os.environ["FASTVIDEO_ATTENTION_BACKEND"] = "VIDEO_SPARSE_ATTN"
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    method, _ = build_method(
        "sft", os.path.join(work, "FastWan2.1-T2V-1.3B-Diffusers"),
        os.path.join(work, "train_out"), "cuda",
        dict(TRAIN_KW, max_train_steps=1 + steps))
    pipe = method.pipeline
    n_params = sum(p.numel() for p in pipe.params)
    print(f"  SFTMethod built in {time.perf_counter() - t0:.1f} s: "
          f"{n_params / 1e9:.3f} B fp32 parameters, remat "
          f"{pipe.args.selective_checkpointing}, VSA "
          f"{pipe.current_vsa_sparsity(1)}", flush=True)
    loader = train_loader(TRAIN_LATENTS, TRAIN_EMBEDS)
    try:
        t0 = time.perf_counter()
        method.train(loader, max_steps=1)
        torch.cuda.synchronize()
        print(f"  warm-up step {time.perf_counter() - t0:.2f} s", flush=True)
        watch = {n: p.detach().clone() for n, p in
                 list(pipe.transformer.named_parameters())[:4]}
        torch.cuda.reset_peak_memory_stats()
        _build.reset_counts()
        t0 = time.perf_counter()
        method.train(loader, max_steps=1 + steps)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches, plain = dict(_build.LAUNCHES), dict(_build.PLAIN_CALLS)
        peak = torch.cuda.max_memory_allocated() / 2**30
        rows = pipe.tracker.rows[-steps:]
        if profile_dir:
            profile_train_step(method, loader, profile_dir)
    finally:
        loader.shutdown()
    moved = [not torch.equal(w, dict(pipe.transformer.named_parameters())[n])
             for n, w in watch.items()]
    print(f"  {steps} steps in {wall:.3f} s: {wall / steps:.3f} s a step; "
          f"loss {[round(r['loss'], 5) for r in rows]}, grad_norm "
          f"{[round(r['grad_norm'], 5) for r in rows]}; peak memory "
          f"{peak:.2f} GiB", flush=True)
    layers = DIT_CFG["num_layers"]
    print(f"  kernel launches {json.dumps(launches)} ({layers} layers x "
          f"{steps} steps: K1 and K7 fwd 2 a layer, each backward kernel 1); "
          f"plain calls {json.dumps(plain)}", flush=True)
    check_launches("SFT 480x832", launches, plain,
                   train_launches(layers, steps, split_backwards(
                       DIT_CFG, [(math.prod(TRAIN_LATENTS[-3:]) // 4,
                                  TRAIN_EMBEDS[2])])))
    if not (all(math.isfinite(r["loss"]) and math.isfinite(r["grad_norm"])
                for r in rows) and all(moved)):
        raise SystemExit(f"SFT 480x832: loss or grad_norm not finite, or "
                         f"parameters not moved ({moved})")
    del method, pipe
    torch.cuda.empty_cache()
    return dict(launches=launches, step_s=wall / steps, peak_gib=peak,
                loss=[r["loss"] for r in rows],
                grad_norm=[r["grad_norm"] for r in rows])


# -- 4a (causal training), 4l and 4m: dfsft and tfsft of the causal Wan -------

# 4l/4m: 4g's CausalWan-1.3B checkpoint (3 latent frames a chunk), latents
# [accum, B, 16, 21, 60, 104] (81x480x832: 7 chunks of 4,680 tokens), 512
# text tokens, fp32 masters, AdamW, full remat
DF_KW = dict(selective_checkpointing="full", learning_rate=1e-5,
             max_grad_norm=1.0, seed=0, gradient_accumulation_steps=1,
             checkpointing_steps=0)
# 4a's tiny causal student: heads of 64, 2-frame chunks of 5 x 6 tokens a
# frame, so the chunk borders (every 60 tokens) and tfsft's clean/noisy
# border (180) fall inside the kernels' 64-row tiles
TINY_DF_DIT_CFG = dict(TINY_DIT_CFG, num_attention_heads=2,
                       attention_head_dim=64, num_frames_per_block=2,
                       local_attn_size=-1, sink_size=0)
TINY_DF_LATENTS = (1, 1, 4, 6, 10, 12)


def df_launches(layers: int, steps: int, reduces: int) -> dict:
    """Launches of a dfsft / tfsft step under full remat: each block's
    forward runs twice (K1 struct for the self-attention, K1 for the
    cross-attention), its backward once (K6 struct, K6); ``reduces`` of a
    block's two backwards split dK/dV."""
    return {"flash_fwd_struct": 2 * layers * steps,
            "flash_fwd": 2 * layers * steps,
            "flash_bwd_struct_dq": layers * steps,
            "flash_bwd_struct_dkv": layers * steps,
            "flash_bwd_dq": layers * steps, "flash_bwd_dkv": layers * steps,
            "flash_bwd_dkv_reduce": reduces * layers * steps}


def df_split_backwards(cfg: dict, latents: tuple, text: int,
                       method: str) -> int:
    """split_backwards of a dfsft (tfsft: [clean | noisy], twice the rows)
    block: its self-attention and its cross-attention."""
    rows = math.prod(latents[-3:]) // 4 * (2 if method == "tfsft" else 1)
    return split_backwards(cfg, [(rows, rows), (rows, text)])


def check_small_df_training(work: str) -> None:
    """One dfsft and one tfsft step of a tiny causal Wan (heads of 64, 2
    layers, chunk and clean/noisy borders inside 64-row tiles) on the card
    against the same step on the CPU's plain path: the same checkpoint,
    seed and batch, so the same draws. bf16 compute, so: loss within 1e-2
    relative and the gradients within 3e-2 relative L2, as 4a's SFT step."""
    import numpy as np
    import torch

    os.environ["FASTVIDEO_ATTENTION_BACKEND"] = "FLASH_ATTN"
    ckpt = write_checkpoint(os.path.join(work, "train", "CausalWan-tiny"),
                            TINY_DF_DIT_CFG, TINY_VAE_CFG, TINY_T5_CFG,
                            seed=9, dit_class="CausalWanTransformer3DModel")
    rng = np.random.default_rng(9)
    batch = (rng.standard_normal(TINY_DF_LATENTS).astype(np.float32),
             rng.standard_normal(TINY_TRAIN_EMBEDS).astype(np.float32))
    layers = TINY_DF_DIT_CFG["num_layers"]
    chunk = dict(chunk_size=TINY_DF_DIT_CFG["num_frames_per_block"])
    for method in ("dfsft", "tfsft"):
        runs = {}
        for device in ("cuda", "cpu"):
            m, _ = build_method(method, ckpt, "", device,
                                dict(DF_KW, learning_rate=1e-3), chunk)
            out, grads, counts, plain_counts = step_with_grads(m.pipeline,
                                                               batch)
            if device == "cuda":
                launches, plain = counts, plain_counts
            runs[device] = (out, grads)
            del m
        check_launches(f"tiny {method} step", launches, plain, df_launches(
            layers, 1, df_split_backwards(TINY_DF_DIT_CFG, TINY_DF_LATENTS,
                                          TINY_TRAIN_EMBEDS[2], method)))
        (c_out, c_g), (p_out, p_g) = runs["cuda"], runs["cpu"]
        gc, gp = (torch.cat([g.flatten() for g in gs]) for gs in (c_g, p_g))
        rel = ((gc - gp).norm() / gp.norm()).item()
        loss_rel = abs(c_out["loss"] - p_out["loss"]) / abs(p_out["loss"])
        print(f"  tiny {method} step, card vs CPU plain: loss "
              f"{c_out['loss']:.5f} / {p_out['loss']:.5f} (rel "
              f"{loss_rel:.2e}, bar 1e-2), grad_norm {c_out['grad_norm']:.5f}"
              f" / {p_out['grad_norm']:.5f}, gradients rel L2 {rel:.2e} (bar "
              f"3e-2); card launches "
              f"{json.dumps({k: v for k, v in launches.items() if v})}",
              flush=True)
        if not (math.isfinite(c_out["loss"]) and loss_rel < 1e-2
                and rel < 3e-2):
            raise SystemExit(f"tiny {method} step: the card disagrees with "
                             "the plain path")


def run_df_training(work: str, method: str, steps: int,
                    profile_dir: str | None = None) -> dict:
    """Phases 4l (dfsft) and 4m (tfsft): the method through
    build_from_config on 4g's CausalWan-1.3B checkpoint in fp32 master
    weights, then method.train over the port's PrefetchingLoader at
    81x480x832: one warm-up step, then ``steps`` timed ones."""
    import torch

    from fastvideo_tpu_torch.ops import _build

    os.environ["FASTVIDEO_ATTENTION_BACKEND"] = "FLASH_ATTN"
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    m, _ = build_method(
        method, os.path.join(work, "causal", "SelfForcing-Wan2.1-T2V-1.3B"),
        os.path.join(work, f"{method}_out"), "cuda",
        dict(DF_KW, max_train_steps=1 + steps),
        dict(chunk_size=CAUSAL_DIT_CFG["num_frames_per_block"]))
    pipe = m.pipeline
    n_params = sum(p.numel() for p in pipe.params)
    print(f"  {type(m).__name__} built in {time.perf_counter() - t0:.1f} s: "
          f"{n_params / 1e9:.3f} B fp32 parameters, remat "
          f"{pipe.args.selective_checkpointing}, chunk {pipe.chunk_size} "
          f"frames, teacher forcing {pipe.teacher_forcing}", flush=True)
    loader = train_loader(TRAIN_LATENTS, TRAIN_EMBEDS)
    try:
        t0 = time.perf_counter()
        m.train(loader, max_steps=1)
        torch.cuda.synchronize()
        print(f"  warm-up step {time.perf_counter() - t0:.2f} s", flush=True)
        watch = {n: p.detach().clone() for n, p in
                 list(pipe.transformer.named_parameters())[:4]}
        torch.cuda.reset_peak_memory_stats()
        _build.reset_counts()
        t0 = time.perf_counter()
        m.train(loader, max_steps=1 + steps)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches, plain = dict(_build.LAUNCHES), dict(_build.PLAIN_CALLS)
        peak = torch.cuda.max_memory_allocated() / 2**30
        rows = pipe.tracker.rows[-steps:]
        if profile_dir:
            profile_train_step(m, loader, profile_dir, f"{method}_480x832")
    finally:
        loader.shutdown()
    moved = [not torch.equal(w, dict(pipe.transformer.named_parameters())[n])
             for n, w in watch.items()]
    print(f"  {steps} steps in {wall:.3f} s: {wall / steps:.3f} s a step; "
          f"loss {[round(r['loss'], 5) for r in rows]}, grad_norm "
          f"{[round(r['grad_norm'], 5) for r in rows]}; peak memory "
          f"{peak:.2f} GiB; parameters moved {all(moved)}", flush=True)
    layers = CAUSAL_DIT_CFG["num_layers"]
    print(f"  kernel launches {json.dumps(launches)} ({layers} layers x "
          f"{steps} steps: K1 struct and K1 2 a layer, each backward kernel "
          f"1); plain calls {json.dumps(plain)}", flush=True)
    check_launches(f"{method} 480x832", launches, plain,
                   df_launches(layers, steps, df_split_backwards(
                       CAUSAL_DIT_CFG, TRAIN_LATENTS, TRAIN_EMBEDS[2],
                       method)))
    if not (all(math.isfinite(r["loss"]) and math.isfinite(r["grad_norm"])
                for r in rows) and all(moved)):
        raise SystemExit(f"{method} 480x832: loss or grad_norm not finite, "
                         f"or parameters not moved ({moved})")
    del m, pipe
    torch.cuda.empty_cache()
    return dict(launches=launches, step_s=wall / steps, peak_gib=peak,
                loss=[r["loss"] for r in rows],
                grad_norm=[r["grad_norm"] for r in rows])


# -- 4a (DMD2) and 4n: DMD2 distillation of the Wan DiT ----------------------

# 4n: the 4b checkpoint's DiT three times (generator, real score, fake
# score) in fp32 masters, full remat, AdamW, a generator and a critic update
# every step, on a Snappy shard of 2 records that the port writes and reads
# (latents [16, 21, 60, 104] of 81x480x832, 512 text tokens of 4096)
DMD_KW = dict(selective_checkpointing="full", learning_rate=1e-5,
              max_grad_norm=1.0, seed=0, gradient_accumulation_steps=1,
              checkpointing_steps=0)
DMD_SPEC = dict(dfake_gen_update_ratio=1)
# the prompt's tokens in a padded text embedding; rows past them are zero
PROMPT_TOKENS = 16


def dmd2_launches(layers: int, reduces: int, steps: int = 1,
                  no_grad: int = 8) -> dict:
    """Launches of DMD2 steps that each update the generator and the critic
    with VSA at sparsity 0 (no forward context, as in JAX: every tile of
    every query tile) under full remat. No-grad forwards run K2 and K1 once
    a block: the generator update's rollout (2) and its fake, real and
    unconditional real scores (3), the critic update's rollout (3). Each
    update's gradient forward runs K7 fwd (LSE) and K1 twice a block (the
    forward and its recompute), each backward kernel once, and
    ``reduces`` of a block's flash backwards split dK/dV. AnyFlow's
    ``no_grad`` passes differ (:func:`anyflow_launches`)."""
    grad = 2
    return {"flash_fwd": (no_grad + 2 * grad) * layers * steps,
            "vsa_sparse_fwd": no_grad * layers * steps,
            "vsa_sparse_padded_fwd": 2 * grad * layers * steps,
            "flash_bwd_dq": grad * layers * steps,
            "flash_bwd_dkv": grad * layers * steps,
            "flash_bwd_dkv_reduce": grad * reduces * layers * steps,
            "vsa_sparse_bwd_dq": grad * layers * steps,
            "vsa_sparse_bwd_dkv": grad * layers * steps}


def check_small_distill(label: str, method_name: str, ckpt: str,
                        latent_shape: tuple, method_config: dict,
                        expect) -> dict:
    """One step of a distillation method (a generator and a critic update)
    of a tiny checkpoint on the card against the same step on the CPU's
    plain path: the same checkpoint, seed and embeddings, so the same
    draws (a CPU generator on both). Each role is held to the tiny SFT
    step's bars: loss within 1e-2 relative, gradients within 3e-2 relative
    L2, parameters after AdamW within 2e-6 where the two gradients agree in
    sign and are >= 1e-5; the teacher unchanged; the card's launches equal
    ``expect(out)`` (of the card's metrics). Returns the card's launches."""
    import numpy as np
    import torch

    from fastvideo_tpu_torch.ops import _build

    emb = np.random.default_rng(9).standard_normal(
        TINY_TRAIN_EMBEDS[1:]).astype(np.float32)
    runs = {}
    for device in ("cuda", "cpu"):
        method, _ = build_method(method_name, ckpt, "", device,
                                 dict(DMD_KW, learning_rate=1e-3),
                                 method_config=method_config, dmd=DMD_SPEC)
        pipe = method.pipeline
        teacher = [p.detach().clone() for p in pipe.real_score.parameters()]
        grads: dict = {}
        capture_grads(pipe.gen_opt, pipe.gen_params, grads, "generator")
        capture_grads(pipe.fake_opt, pipe.fake_params, grads, "critic")
        _build.reset_counts()
        with kv_mask_grad_guard() as guard:
            out = pipe.train_one_step(emb, np.zeros_like(emb), latent_shape)
        if device == "cuda":
            torch.cuda.synchronize()
            launches, plain = dict(_build.LAUNCHES), dict(_build.PLAIN_CALLS)
        if guard["grad"]:
            raise SystemExit(f"{label} ({device}): K5 was called in a pass "
                             f"under grad {guard['grad']} times")
        if not all(torch.equal(a, b) for a, b in
                   zip(teacher, pipe.real_score.parameters())):
            raise SystemExit(f"{label} ({device}): the teacher moved")
        params = {"generator": [p.detach().float().cpu()
                                for p in pipe.gen_params],
                  "critic": [p.detach().float().cpu()
                             for p in pipe.fake_params]}
        runs[device] = (out, grads, params)
        del method, pipe
    check_launches(label, launches, plain, expect(runs["cuda"][0]))
    (c_out, c_g, c_p), (p_out, p_g, p_p) = runs["cuda"], runs["cpu"]
    ok = True
    for role in ("generator", "critic"):
        rel, worst_all, worst_sure, flips, n = adamw_agreement(
            c_g[role], p_g[role], c_p[role], p_p[role])
        loss, norm = f"{role}_loss", f"{role}_grad_norm"
        loss_rel = abs(c_out[loss] - p_out[loss]) / abs(p_out[loss])
        print(f"  {label}, {role}, card vs CPU plain: loss "
              f"{c_out[loss]:.6f} / {p_out[loss]:.6f} (rel {loss_rel:.2e}, "
              f"bar 1e-2), grad_norm {c_out[norm]:.5f} / {p_out[norm]:.5f}, "
              f"gradients rel L2 {rel:.2e} (bar 3e-2), parameters after "
              f"AdamW: max diff {worst_all:.2e}, {worst_sure:.2e} where the "
              f"gradients agree in sign and are >= 1e-5 (bar 2e-6; {flips} "
              f"of {n} elements are not)", flush=True)
        ok = ok and (math.isfinite(c_out[loss]) and loss_rel < 1e-2
                     and rel < 3e-2 and worst_sure <= 2e-6)
    print(f"  {label} card launches "
          f"{json.dumps({k: v for k, v in launches.items() if v})}",
          flush=True)
    if not ok:
        raise SystemExit(f"{label}: the card disagrees with the plain path")
    return launches


def check_small_dmd2(work: str) -> None:
    """One DMD2 step of a tiny VSA Wan, card against CPU
    (:func:`check_small_distill`)."""
    os.environ["FASTVIDEO_ATTENTION_BACKEND"] = "VIDEO_SPARSE_ATTN"
    ckpt = write_checkpoint(os.path.join(work, "dmd2", "Wan2.1-T2V-tiny"),
                            TINY_DIT_CFG, TINY_VAE_CFG, TINY_T5_CFG, seed=9)
    tokens = math.prod(TINY_TRAIN_LATENTS[-3:]) // 4
    expect = dmd2_launches(TINY_DIT_CFG["num_layers"], split_backwards(
        TINY_DIT_CFG, [(tokens, TINY_TRAIN_EMBEDS[2])]))
    check_small_distill("tiny DMD2 step", "dmd2", ckpt,
                        TINY_TRAIN_LATENTS[1:], {}, lambda out: expect)


def shard_read_rate(path: str, columns: list[str]) -> tuple[float, float]:
    """(MB/s, seconds) of the port's reader over ``columns`` of one shard:
    the values' bytes over the wall time of read_table (a warm file)."""
    from fastvideo_tpu_torch.dataset import parquet_io

    t0 = time.perf_counter()
    table = parquet_io.read_table(path, columns)
    dt = time.perf_counter() - t0
    nbytes = sum(len(v) for c in columns for v in table[c]
                 if isinstance(v, bytes))
    return nbytes / dt / 1e6, dt


def write_dmd2_data(work: str) -> tuple[str, dict]:
    """The 4n shard (2 random fp32 records) and the reader's rates on it
    and on a compressible record (a text embedding zero past its prompt's
    tokens, as a padded prompt's is), each written by the port's writer
    with Snappy."""
    import numpy as np

    from fastvideo_tpu_torch.dataset.parquet import (record_from_sample,
                                                     write_parquet_dataset)

    rng = np.random.default_rng(0)
    latent, text = TRAIN_LATENTS[2:], TRAIN_EMBEDS[2:]

    def record(i, txt):
        return record_from_sample(
            f"r{i}", rng.standard_normal(latent, dtype=np.float32), txt,
            caption=PROMPT, width=832, height=480, num_frames=81, fps=16.0,
            duration=81 / 16)

    data = os.path.join(work, "dmd2_data")
    t0 = time.perf_counter()
    write_parquet_dataset([record(i, rng.standard_normal(
        text, dtype=np.float32)) for i in range(2)], data)
    write_s = time.perf_counter() - t0
    padded = np.zeros(text, np.float32)
    padded[:PROMPT_TOKENS] = rng.standard_normal((PROMPT_TOKENS, text[1]))
    other = os.path.join(work, "dmd2_padded")
    write_parquet_dataset([record(2, padded)], other)
    shard = os.path.join(data, "data_00000.parquet")
    cols = ["latents", "text_embedding"]
    rand_rate, rand_s = shard_read_rate(shard, cols)
    pad_rate, pad_s = shard_read_rate(
        os.path.join(other, "data_00000.parquet"), ["text_embedding"])
    rates = dict(write_s=write_s, shard_bytes=os.path.getsize(shard),
                 random_mb_s=rand_rate, random_s=rand_s,
                 padded_text_mb_s=pad_rate, padded_text_s=pad_s,
                 padded_text_bytes=os.path.getsize(
                     os.path.join(other, "data_00000.parquet")))
    print(f"  shard of 2 records written in {write_s:.2f} s "
          f"({rates['shard_bytes'] / 1e6:.1f} MB, Snappy); the port's "
          f"reader: {rand_rate:.1f} MB/s on the random records (latents and "
          f"text, {rand_s:.3f} s), {pad_rate:.1f} MB/s on a text embedding "
          f"zero past {PROMPT_TOKENS} tokens ({pad_s:.3f} s, "
          f"{rates['padded_text_bytes'] / 1e6:.2f} MB on disk)", flush=True)
    return data, rates


def checksum(module, frozen_only: bool = False) -> float:
    """sum(p) + sum(|p|) over the module's parameters in fp64; with
    ``frozen_only`` over those that do not require grad (a LoRA model's
    base), of which there must be some."""
    import torch

    params = [p for p in module.parameters()
              if not (frozen_only and p.requires_grad)]
    if not params:
        raise SystemExit(f"{type(module).__name__}: no frozen parameter")
    with torch.no_grad():
        return math.fsum(p.double().sum().item() + p.double().abs().sum()
                         .item() for p in params)


def run_dmd2(work: str, steps: int, profile_dir: str | None = None) -> dict:
    """Phase 4n: DMD2Method through build_from_config (method dmd2, a
    Parquet data.path) on the 4b checkpoint's Wan2.1-T2V-1.3B-shaped DiT,
    three times in fp32 masters, then method.train over the port's
    Parquet dataloader: one warm-up step, then ``steps`` timed ones."""
    import torch

    from fastvideo_tpu_torch.attention.backends.vsa import vsa_topk
    from fastvideo_tpu_torch.ops import _build

    os.environ["FASTVIDEO_ATTENTION_BACKEND"] = "VIDEO_SPARSE_ATTN"
    torch.cuda.empty_cache()
    data, rates = write_dmd2_data(work)
    t0 = time.perf_counter()
    method, loader = build_method(
        "dmd2", os.path.join(work, "FastWan2.1-T2V-1.3B-Diffusers"),
        os.path.join(work, "dmd2_out"), "cuda",
        dict(DMD_KW, max_train_steps=1 + steps), dmd=DMD_SPEC,
        data_path=data)
    pipe = method.pipeline
    n_params = sum(p.numel() for p in pipe.gen_params)
    tiles = math.prod(TRAIN_LATENTS[-3:]) // 4 // 280
    print(f"  DMD2Method built in {time.perf_counter() - t0:.1f} s: 3 x "
          f"{n_params / 1e9:.3f} B fp32 parameters, remat "
          f"{pipe.args.selective_checkpointing}, ratio "
          f"{pipe.dmd.dfake_gen_update_ratio}, steps "
          f"{list(pipe.dmd.dmd_denoising_steps)}; VSA top-"
          f"{vsa_topk(0.0, tiles)} of {tiles} tiles (no forward context)",
          flush=True)
    teacher = checksum(pipe.real_score)
    try:
        t0 = time.perf_counter()
        method.train(loader, max_steps=1)
        torch.cuda.synchronize()
        print(f"  warm-up step {time.perf_counter() - t0:.2f} s; peak "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB",
              flush=True)
        watch = [{n: p.detach().clone() for n, p in
                  list(m.named_parameters())[:4]}
                 for m in (pipe.generator, pipe.fake_score)]
        torch.cuda.reset_peak_memory_stats()
        _build.reset_counts()
        t0 = time.perf_counter()
        method.train(loader, max_steps=1 + steps)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches, plain = dict(_build.LAUNCHES), dict(_build.PLAIN_CALLS)
        peak = torch.cuda.max_memory_allocated() / 2**30
        rows = pipe.tracker.rows[-steps:]
        if profile_dir:
            profile_train_step(method, loader, profile_dir, "dmd2_480x832")
    finally:
        loader.shutdown()
    moved = [not torch.equal(w[n], dict(m.named_parameters())[n])
             for w, m in zip(watch, (pipe.generator, pipe.fake_score))
             for n in w]
    teacher_same = checksum(pipe.real_score) == teacher
    keys = ("generator_loss", "generator_grad_norm", "critic_loss",
            "critic_grad_norm")
    print(f"  {steps} steps in {wall:.3f} s: {wall / steps:.3f} s a step; "
          + "; ".join(f"{k} {[round(r[k], 6) for r in rows]}" for k in keys)
          + f"; peak memory {peak:.2f} GiB; teacher unchanged "
          f"{teacher_same}", flush=True)
    layers = DIT_CFG["num_layers"]
    print(f"  kernel launches {json.dumps(launches)} ({layers} layers x "
          f"{steps} steps); plain calls {json.dumps(plain)}", flush=True)
    check_launches("DMD2 480x832", launches, plain, dmd2_launches(
        layers, split_backwards(DIT_CFG, [(math.prod(TRAIN_LATENTS[-3:]) // 4,
                                           TRAIN_EMBEDS[2])]), steps))
    if not (all(math.isfinite(r[k]) for r in rows for k in keys)
            and all(moved) and teacher_same):
        raise SystemExit(f"DMD2 480x832: a loss or grad norm not finite, "
                         f"parameters not moved ({moved}) or the teacher "
                         f"changed ({teacher_same})")
    del method, pipe
    torch.cuda.empty_cache()
    return dict(launches=launches, step_s=wall / steps, peak_gib=peak,
                **{k: [r[k] for r in rows] for k in keys}, reader=rates)


# -- 4a (self_forcing), 4o, 4p and 4q: the causal distillation methods -------

# 4o-4q: 4g's CausalWan-1.3B checkpoint (3 latent frames a block, a
# 21-frame window, no sink) as every role, in fp32 masters, full remat,
# AdamW, on 4n's shard (latents [16, 21, 60, 104], 512 text tokens)
SF_METHOD = dict(denoise_steps=[1000, 757, 522])
# 4p: a stream from step 0, chunks of at most 6 latent frames (2 blocks) up
# to 27, so that it passes the 21-frame window (the caches evict) and then
# starts over
STREAM_METHOD = dict(SF_METHOD, multi_phased_distill_schedule=[
    dict(stage="streaming_long", start_step=0, streaming_max_length=27,
         streaming_chunk_size=6)])
STREAM_MAX_STEPS = 10
# timed steps after the warm-up: 4o's grad block advances a block a step,
# so its steps differ in work; 4q's steps do the same work
SF_STEPS = 1
CD_STEPS = 1
# 4q: the JAX package's defaults, the EMA updated from the first step
CD_METHOD = dict(discrete_cd_N=48, guidance_scale=3.0, ema_start_step=0)
# 4a's tiny self-forcing step: TINY_CAUSAL_DIT_CFG (one head of 128, a
# 5-frame window of 1,280 keys with a 1-frame sink), 9 latent frames of
# 16 x 16 tokens: 3 blocks, the full clip longer than the window
TINY_SF_LATENTS = (1, 4, 9, 32, 32)


def attended_keys(tokens_so_far: int, window: int) -> int:
    """Keys a pass attends once the stream holds ``tokens_so_far`` tokens
    (its own included): the sink and the window's valid slots, each token
    once, which is min(tokens, the window's whole budget)."""
    return min(tokens_so_far, window)


def causal_grad_pass_reduces(cfg: dict, passes, text: int) -> int:
    """split_backwards of the grad passes ``passes`` [(query rows, keys
    attended)]: each pass's self- and cross-attention backward."""
    return sum(split_backwards(cfg, [(sq, skv), (sq, text)])
               for sq, skv in passes)


def causal_distill_launches(layers: int, no_grad: int, grad: int,
                            reduces: int) -> dict:
    """Launches of causal Wan passes under full remat: a pass without grad
    runs K5 and K1 (cross-attention) once a block; a grad pass runs the
    self-attention's grad route (K1) and the cross-attention (K1) twice a
    block (the forward and its recompute), and K6 for both; ``reduces``
    (over the whole run) of those backwards split dK/dV."""
    return {"flash_fwd_kv_mask": no_grad * layers,
            "flash_fwd": (no_grad + 4 * grad) * layers,
            "flash_bwd_dq": 2 * grad * layers,
            "flash_bwd_dkv": 2 * grad * layers,
            "flash_bwd_dkv_reduce": reduces * layers}


def self_forcing_launches(cfg: dict, latents: tuple, text: int, steps: int,
                          grad_blocks) -> dict:
    """Launches of self-forcing steps that each update the generator (at
    the grad block of each in ``grad_blocks``) and the critic. Each
    rollout runs blocks x (steps + 1) passes, the generator's with one grad
    pass (the grad block's last); the score models run 3 full-clip passes
    without grad, the critic one with grad."""
    frame = latents[-1] * latents[-2] // 4
    nfpb = cfg["num_frames_per_block"]
    blocks = latents[-3] // nfpb
    clip, blk = blocks * nfpb * frame, nfpb * frame
    window = cfg["local_attn_size"] * frame
    no_grad = 2 * blocks * (steps + 1) + 2
    out: dict = {}
    for g in grad_blocks:
        reduces = causal_grad_pass_reduces(cfg, [
            (blk, attended_keys((g + 1) * blk, window)),
            (clip, attended_keys(clip, window))], text)
        for name, n in causal_distill_launches(cfg["num_layers"], no_grad, 2,
                                               reduces).items():
            out[name] = out.get(name, 0) + n
    return out


def stream_launches(cfg: dict, frame: int, text: int, steps: int,
                    rows: list) -> dict:
    """Launches of stream steps (each updating the generator and the
    critic), from each step's metrics: its chunk's blocks roll out on the
    live caches with a grad pass at each block's last step, the score
    models run 3 chunk passes without grad and the critic one with
    grad."""
    nfpb = cfg["num_frames_per_block"]
    window = cfg["local_attn_size"] * frame
    out: dict = {}
    for r in rows:
        nf = r["streaming_new_frames"]
        start = r["streaming_current_length"] - nf
        blocks, blk = nf // nfpb, nfpb * frame
        passes = [(blk, attended_keys((start + (j + 1) * nfpb) * frame,
                                      window)) for j in range(blocks)]
        passes.append((nf * frame, attended_keys(nf * frame, window)))
        for name, n in causal_distill_launches(
                cfg["num_layers"], blocks * steps + 3, blocks + 1,
                causal_grad_pass_reduces(cfg, passes, text)).items():
            out[name] = out.get(name, 0) + n
    return out


def causal_cd_launches(cfg: dict, tokens: int, text: int,
                       steps: int = 1) -> dict:
    """Launches of causal_cd steps under FLASH_ATTN and full remat: the
    teacher's two forwards and the EMA's one run K1 for the self- and the
    cross-attention once a block; the student's forward twice (and its
    recompute), K6 for both."""
    layers = cfg["num_layers"]
    return {"flash_fwd": 10 * layers * steps,
            "flash_bwd_dq": 2 * layers * steps,
            "flash_bwd_dkv": 2 * layers * steps,
            "flash_bwd_dkv_reduce": causal_grad_pass_reduces(
                cfg, [(tokens, tokens)], text) * layers * steps}


@contextlib.contextmanager
def kv_mask_grad_guard():
    """Counts the causal Wan's K5 calls (``calls``) and those made while
    autograd records (``grad``: a pass under grad, which must take the
    grad route instead)."""
    import torch

    from fastvideo_tpu_torch.models.dits import causal_wan

    real = causal_wan.flash_attention_kv_mask
    seen = {"calls": 0, "grad": 0}

    def counted(*args, **kw):
        seen["calls"] += 1
        seen["grad"] += torch.is_grad_enabled()
        return real(*args, **kw)

    causal_wan.flash_attention_kv_mask = counted
    try:
        yield seen
    finally:
        causal_wan.flash_attention_kv_mask = real


def check_small_self_forcing(work: str) -> None:
    """One self-forcing step of a tiny causal Wan (one head of 128, 1,280
    cached keys: K5 on the no-grad passes, the grad route's K1 and K6 on
    the generator's and the critic's passes) card against CPU
    (:func:`check_small_distill`)."""
    os.environ["FASTVIDEO_ATTENTION_BACKEND"] = "FLASH_ATTN"
    ckpt = write_checkpoint(os.path.join(work, "sf", "SelfForcing-tiny"),
                            TINY_CAUSAL_DIT_CFG, TINY_VAE_CFG, TINY_T5_CFG,
                            seed=9, dit_class="CausalWanTransformer3DModel")
    check_small_distill(
        "tiny self_forcing step", "self_forcing", ckpt, TINY_SF_LATENTS,
        SF_METHOD, lambda out: self_forcing_launches(
            TINY_CAUSAL_DIT_CFG, TINY_SF_LATENTS, TINY_TRAIN_EMBEDS[2],
            len(SF_METHOD["denoise_steps"]), [out["grad_block"]]))


def causal_ckpt(work: str) -> str:
    return os.path.join(work, "causal", "SelfForcing-Wan2.1-T2V-1.3B")


def run_training_phase(label: str, method_name: str, work: str,
                       data: str, method_config: dict, warmup: int,
                       steps: int, expect, roles, frozen,
                       profile_dir: str | None = None, until=None,
                       ckpt: str | None = None, backend: str = "FLASH_ATTN",
                       training: dict = DMD_KW, prepare=None) -> dict:
    """A training method through build_from_config on ``ckpt`` (default
    4g's causal checkpoint) and 4n's Parquet shard, then method.train:
    ``warmup`` steps, then ``steps`` timed ones (fewer where
    ``until(rows)`` of the timed steps' metrics holds first), each timed
    apart, with the process's CPU seconds, the caching allocator's retries
    and device allocations in it and the card's state after it
    (:func:`card_state`). ``prepare(method, loader)`` runs after the build
    and returns measurements of its own. Checks finite losses and grad
    norms, the trained roles (``roles``: attribute names; their trainable
    parameters where they have any) moved and the frozen parameters of
    ``frozen`` bit for bit as they were, no K5 call in a pass under grad,
    and the launches against ``expect(rows)``."""
    import torch

    from fastvideo_tpu_torch.ops import _build

    os.environ["FASTVIDEO_ATTENTION_BACKEND"] = backend
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    method, loader = build_method(
        method_name, ckpt or causal_ckpt(work),
        os.path.join(work, f"{label}_out"), "cuda",
        dict(training, max_train_steps=warmup + steps),
        method_config=method_config, dmd=DMD_SPEC, data_path=data)
    pipe = getattr(method, "pipeline", method)
    print(f"  {type(method).__name__} built in {time.perf_counter() - t0:.1f}"
          f" s: roles {roles + frozen}, remat "
          f"{pipe.args.selective_checkpointing}", flush=True)
    sums = {r: checksum(getattr(pipe, r), frozen_only=True) for r in frozen}
    extra = prepare(method, loader) if prepare else {}
    try:
        t0 = time.perf_counter()
        method.train(loader, max_steps=warmup)
        torch.cuda.synchronize()
        print(f"  warm-up ({warmup} step) {time.perf_counter() - t0:.2f} s; "
              f"peak {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB",
              flush=True)
        watch = {}
        for r in roles:
            named = list(getattr(pipe, r).named_parameters())
            named = [x for x in named if x[1].requires_grad] or named
            watch[r] = {n: p.detach().clone() for n, p in named[:4]}
        torch.cuda.reset_peak_memory_stats()
        _build.reset_counts()
        times, states = [], []
        with kv_mask_grad_guard() as guard:
            for _ in range(steps):
                before = torch.cuda.memory_stats()
                t0, cpu0 = time.perf_counter(), time.process_time()
                method.train(loader, max_steps=pipe.step + 1)
                torch.cuda.synchronize()
                times.append(time.perf_counter() - t0)
                cpu = time.process_time() - cpu0
                after = torch.cuda.memory_stats()
                grew = {k: after[k] - before[k] for k in (
                    "num_alloc_retries", "num_device_alloc")}
                states.append(
                    f"{card_state()}; the process's CPU {cpu:.3f} s; "
                    f"allocator retries {grew['num_alloc_retries']}, device "
                    f"allocations {grew['num_device_alloc']}")
                if until and until(pipe.tracker.rows[warmup:]):
                    break
        steps = len(times)
        launches, plain = dict(_build.LAUNCHES), dict(_build.PLAIN_CALLS)
        peak = torch.cuda.max_memory_allocated() / 2**30
        rows = pipe.tracker.rows[-steps:]
        if profile_dir:
            profile_train_step(method, loader, profile_dir,
                               f"{label}_480x832")
    finally:
        loader.shutdown()
    moved = {r: all(not torch.equal(w, dict(getattr(pipe, r)
                                            .named_parameters())[n])
                    for n, w in watch[r].items()) for r in roles}
    same = {r: checksum(getattr(pipe, r), frozen_only=True) == sums[r]
            for r in frozen}
    values = {k: [r[k] for r in rows] for k in rows[0]
              if k.endswith(("_loss", "_norm")) or k == "loss"}
    print(f"  {steps} steps in {sum(times):.3f} s: "
          f"{[round(t, 3) for t in times]} s each, {sum(times) / steps:.3f} "
          f"s a step; " + "; ".join(f"{k} {[round(x, 6) for x in v]}"
                                    for k, v in values.items())
          + f"; peak memory {peak:.2f} GiB; moved {moved}; unchanged {same};"
          f" K5 calls {guard['calls']}, in a pass under grad {guard['grad']}",
          flush=True)
    for i, (t, state) in enumerate(zip(times, states)):
        print(f"  step {i}: {t:.3f} s; after it {state}", flush=True)
    print(f"  kernel launches {json.dumps(launches)}; plain calls "
          f"{json.dumps(plain)}", flush=True)
    check_launches(f"{label} 480x832", launches, plain, expect(rows))
    if not (all(math.isfinite(x) for v in values.values() for x in v)
            and all(moved.values()) and all(same.values())
            and guard["grad"] == 0):
        raise SystemExit(f"{label} 480x832: a loss or grad norm not finite "
                         f"({values}), a trained role not moved ({moved}), a "
                         f"frozen one changed ({same}) or K5 under grad "
                         f"({guard['grad']})")
    del method, pipe
    torch.cuda.empty_cache()
    return dict(launches=launches, step_s=sum(times) / steps,
                step_times=times, step_states=states, peak_gib=peak,
                rows=rows, **values, **extra)


def run_self_forcing(work: str, data: str,
                     profile_dir: str | None = None) -> dict:
    """Phase 4o: self_forcing at 81x480x832 (7 blocks, denoise steps (1000,
    757, 522), a generator and a critic update a step)."""
    cfg = CAUSAL_DIT_CFG
    latents = (1,) + TRAIN_LATENTS[2:]
    return run_training_phase(
        "self_forcing", "self_forcing", work, data, SF_METHOD, 1, SF_STEPS,
        lambda rows: self_forcing_launches(
            dict(cfg, local_attn_size=21), latents, TRAIN_EMBEDS[2],
            len(SF_METHOD["denoise_steps"]),
            [r["grad_block"] for r in rows]),
        ["generator", "fake_score"], ["real_score"], profile_dir)


def run_streaming_long(work: str, data: str,
                       profile_dir: str | None = None) -> dict:
    """Phase 4p: streaming_long_tuning from step 0: the first chunk (6
    latent frames) as warm-up, then stream steps until the stream, past
    the 21-frame window, has started over (at most STREAM_MAX_STEPS)."""
    frame = TRAIN_LATENTS[-1] * TRAIN_LATENTS[-2] // 4

    def restarted(rows):
        lengths = [r["streaming_current_length"] for r in rows]
        return any(b < a for a, b in zip(lengths, lengths[1:]))

    out = run_training_phase(
        "streaming_long_tuning", "streaming_long_tuning", work, data,
        STREAM_METHOD, 1, STREAM_MAX_STEPS,
        lambda rows: stream_launches(
            dict(CAUSAL_DIT_CFG, local_attn_size=21), frame,
            TRAIN_EMBEDS[2], len(SF_METHOD["denoise_steps"]), rows),
        ["generator", "fake_score"], ["real_score"], profile_dir,
        until=restarted)
    rows = out["rows"]
    lengths = [r["streaming_current_length"] for r in rows]
    print(f"  stream: stage {[r['distill_stage_index'] for r in rows]}, new "
          f"frames {[r['streaming_new_frames'] for r in rows]}, length after "
          f"each step {lengths}", flush=True)
    if not (max(lengths) > 21 and restarted(rows)):
        raise SystemExit(f"streaming 480x832: the stream did not pass the "
                         f"window and start over ({lengths})")
    return out


def run_causal_cd(work: str, data: str,
                  profile_dir: str | None = None) -> dict:
    """Phase 4q: causal_cd at 81x480x832 under FLASH_ATTN (the student's,
    the teacher's and the EMA's full forwards), N 48, guidance 3, the EMA
    updated every step."""
    tokens = math.prod(TRAIN_LATENTS[-3:]) // 4
    return run_training_phase(
        "causal_cd", "causal_cd", work, data, CD_METHOD, 1, CD_STEPS,
        lambda rows: causal_cd_launches(CAUSAL_DIT_CFG, tokens,
                                        TRAIN_EMBEDS[2], len(rows)),
        ["student", "ema"], ["teacher"], profile_dir)


# -- 4a (LoRA, kd, AnyFlow) and 4r-4v: LoRA serving and the slice's methods --

# 4r: a rank-32 adapter in the official naming under "diffusion_model." on
# every default target of the 30 blocks (300 linears; the embedders' MLPs
# are converted only where a file names them)
LORA_RANK = 32
LORA_MODULES = ("self_attn.q", "self_attn.k", "self_attn.v", "self_attn.o",
                "cross_attn.q", "cross_attn.k", "cross_attn.v",
                "cross_attn.o", "ffn.0", "ffn.2")
# an active adapter's extra launches a call: two thin GEMMs, the scale and
# the add (LoRALinear.forward)
LORA_CALL_LAUNCHES = 4
# 4s: lora_finetune at 4i's shapes, rank 32 (alpha 32), default targets
LORA_METHOD = dict(rank=LORA_RANK, init_seed=0)
# 4t: kd at 4i's shapes with a self-distillation teacher, the cache path
KD_T_LIST = (999, 937, 833, 624)
# 4v: AnyFlow with 4 rollout steps (the schedule sets the step count; the
# JAX package checks student_sample_steps and does not read it further)
ANYFLOW_METHOD = dict(student_sample_steps=4,
                      t_list_override=[1000.0, 750.0, 500.0, 250.0, 0.0])
# the timed steps of 4s-4v, each after one warm-up step
METHOD_STEPS = 1


def write_lora_file(path: str, cfg: dict, rank: int, seed: int,
                    device: str = "cuda") -> int:
    """A bf16 adapter on every LORA_MODULES linear of ``cfg``'s blocks,
    written with the port's writer: A ~ N(0, 1/in), B ~ N(0, 0.01/r), so
    that the delta at the scaling 16 / r is about 5 % of the weight.
    Returns the file's bytes."""
    import torch

    from fastvideo_tpu_torch.models.loader.safetensors_io import save_file

    gen = torch.Generator(device=device).manual_seed(seed)
    dim = cfg["num_attention_heads"] * cfg["attention_head_dim"]
    ffn = cfg["ffn_dim"]
    tensors = {}
    for i in range(cfg["num_layers"]):
        for m in LORA_MODULES:
            fin = ffn if m == "ffn.2" else dim
            fout = ffn if m == "ffn.0" else dim
            key = f"diffusion_model.blocks.{i}.{m}"
            tensors[f"{key}.lora_A.weight"] = (torch.randn(
                rank, fin, generator=gen, device=device) / fin**0.5).to(
                torch.bfloat16)
            tensors[f"{key}.lora_B.weight"] = (torch.randn(
                fout, rank, generator=gen, device=device) *
                (0.1 / rank**0.5)).to(torch.bfloat16)
    save_file(tensors, path)
    return os.path.getsize(path)


def uint8_diff(a, b) -> int:
    import numpy as np

    return int(np.abs(a.astype(np.int16) - b.astype(np.int16)).max())


def check_small_lora(work: str) -> None:
    """A rank-4 adapter on the tiny FastWan (VSA): the card's frames
    against the CPU's plain path with the adapter active, merged and
    unmerged (PSNR > 35 dB, the tiny paths' bar), and on the card merged
    and unmerged within 8 uint8 levels of active (JAX's bar)."""
    from fastvideo_tpu_torch import VideoGenerator
    from fastvideo_tpu_torch.ops import _build

    os.environ["FASTVIDEO_ATTENTION_BACKEND"] = "VIDEO_SPARSE_ATTN"
    ckpt = write_checkpoint(os.path.join(work, "lora",
                                         "FastWan2.1-T2V-tiny-Diffusers"),
                            TINY_DIT_CFG, TINY_VAE_CFG, TINY_T5_CFG, seed=12)
    adapter = os.path.join(work, "lora", "adapter.safetensors")
    write_lora_file(adapter, TINY_DIT_CFG, 4, seed=13)
    kw = dict(prompt="w1 w2 w3", height=64, width=64, num_frames=9, seed=11,
              save_video=False)
    frames = {}
    for device in ("cuda", "cpu"):
        _build.reset_counts()
        gen = VideoGenerator.from_pretrained(ckpt, device=device,
                                             VSA_sparsity=0.5)
        gen.set_lora_adapter("tiny", adapter)
        out = {"active": gen.generate_video(**kw)["frames"][0]}
        gen.pipeline.merge_lora_weights()
        out["merged"] = gen.generate_video(**kw)["frames"][0]
        gen.pipeline.unmerge_lora_weights()
        out["unmerged"] = gen.generate_video(**kw)["frames"][0]
        if device == "cuda" and any(_build.PLAIN_CALLS.values()):
            raise SystemExit(f"tiny LoRA: the card's run reached a plain "
                             f"version: {_build.PLAIN_CALLS}")
        frames[device] = out
        del gen
    ps = {k: psnr(frames["cuda"][k], frames["cpu"][k]) for k in frames["cpu"]}
    fold = {k: uint8_diff(frames["cuda"][k], frames["cuda"]["active"])
            for k in ("merged", "unmerged")}
    print(f"  tiny LoRA (rank 4 on {10 * TINY_DIT_CFG['num_layers']} "
          f"linears), card vs CPU plain: frames PSNR "
          f"{json.dumps({k: round(v, 2) for k, v in ps.items()})} dB (bar "
          f"> 35); on the card against active: largest uint8 difference "
          f"{json.dumps(fold)} (bar <= 8)", flush=True)
    if not (all(v > 35 for v in ps.values())
            and all(v <= 8 for v in fold.values())):
        raise SystemExit("tiny LoRA: the card disagrees with the plain path")


def pretrain_launches(layers: int, steps: int, reduces: int) -> dict:
    """An anyflow_pretrain step: an SFT step's launches
    (:func:`train_launches`) and two no-grad forwards (K2 and K1 a block
    each: the finite-difference passes under VSA)."""
    out = train_launches(layers, steps, reduces)
    out["flash_fwd"] += 2 * layers * steps
    out["vsa_sparse_fwd"] = 2 * layers * steps
    return out


def kd_rollout_launches(layers: int, passes: int) -> dict:
    """The teacher rollout: ``passes`` no-grad forwards at sparsity 0."""
    return {"flash_fwd": passes * layers, "vsa_sparse_fwd": passes * layers}


def anyflow_launches(layers: int, reduces: int, steps: int,
                     rollout: int) -> dict:
    """AnyFlow steps (a generator and a critic update each) with a
    ``rollout``-step flow-map rollout: no-grad passes are the generator
    rollout's steps but its grad one, the fake, real and unconditional real
    scores, and the critic's whole rollout."""
    return dmd2_launches(layers, reduces, steps,
                         no_grad=(rollout - 1) + 3 + rollout)


def check_small_pipeline_step(work: str, label: str, method_name: str,
                              method_config: dict, expect) -> None:
    """One step of a TrainingPipeline method (sft, lora_finetune,
    anyflow_pretrain) of a tiny VSA Wan (heads of 16, 2 layers) on the card
    against the same step on the CPU's plain path: the same checkpoint,
    seed and batch, so the same draws (a CPU generator on both). bf16
    compute, so: loss within 1e-2 relative, the trainable parameters'
    gradients within 3e-2 relative L2, and those parameters after AdamW
    within 2e-6 wherever the two (clipped) gradients agree in sign and are
    at least 1e-5: AdamW's first update is lr * g / (|g| + 1e-8), lr times
    the sign where |g| >> 1e-8, and a gradient at the bf16 noise level may
    take either sign. The largest difference over all elements is printed,
    not held to a bar: two first updates never differ by more than 2 lr.
    The card's launches must equal ``expect(tokens)``."""
    import numpy as np
    import torch

    os.environ["FASTVIDEO_ATTENTION_BACKEND"] = "VIDEO_SPARSE_ATTN"
    ckpt = write_checkpoint(os.path.join(work, label, "Wan2.1-T2V-tiny"),
                            TINY_DIT_CFG, TINY_VAE_CFG, TINY_T5_CFG, seed=8)
    rng = np.random.default_rng(8)
    batch = (rng.standard_normal(TINY_TRAIN_LATENTS).astype(np.float32),
             rng.standard_normal(TINY_TRAIN_EMBEDS).astype(np.float32))
    lr = 1e-3
    runs = {}
    for device in ("cuda", "cpu"):
        method, _ = build_method(method_name, ckpt, "", device,
                                 dict(TRAIN_KW, learning_rate=lr),
                                 method_config=method_config)
        pipe = method.pipeline
        out, grads, counts, plain_counts = step_with_grads(
            pipe, batch, vsa_sparsity=0.8)
        if device == "cuda":
            launches, plain = counts, plain_counts
        params = [p.detach().float().cpu() for p in pipe.params]
        runs[device] = (out, grads, params)
        del method, pipe
    tokens = math.prod(TINY_TRAIN_LATENTS[-3:]) // 4
    check_launches(f"tiny {label} step", launches, plain, expect(tokens))
    (c_out, c_g, c_p), (p_out, p_g, p_p) = runs["cuda"], runs["cpu"]
    rel, worst_all, worst_sure, flips, n = adamw_agreement(c_g, p_g, c_p,
                                                           p_p)
    loss_rel = abs(c_out["loss"] - p_out["loss"]) / abs(p_out["loss"])
    print(f"  tiny {label} step, card vs CPU plain: loss {c_out['loss']:.5f} "
          f"/ {p_out['loss']:.5f} (rel {loss_rel:.2e}, bar 1e-2), grad_norm "
          f"{c_out['grad_norm']:.5f} / {p_out['grad_norm']:.5f}, gradients "
          f"rel L2 {rel:.2e} (bar 3e-2), parameters after AdamW: max diff "
          f"{worst_all:.2e} (no bar: a first AdamW update is +-lr), "
          f"{worst_sure:.2e} where the gradients agree in sign and are "
          f">= 1e-5 (bar 2e-6; {flips} of {n} elements are not); card "
          f"launches {json.dumps({k: v for k, v in launches.items() if v})}",
          flush=True)
    if not (math.isfinite(c_out["loss"]) and loss_rel < 1e-2 and rel < 3e-2
            and worst_sure <= 2e-6):
        raise SystemExit(f"tiny {label} step: the card disagrees with the "
                         f"plain path")


def check_small_kd(work: str) -> None:
    """kd on a tiny VSA Wan, card against CPU: the teacher's rollout (the
    DiT of another tiny checkpoint, ``teacher_model_path``) from the same
    draws (the same seed: a CPU generator on both), held to 1e-2 of its
    largest magnitude (4 bf16 passes), then one step on both from the
    CPU's trajectory at check_small_training's bars; the card's launches:
    the rollout's 4 no-grad passes, then an SFT step's (sparsity 0, no
    forward context). A teacher other than the student keeps the step's
    loss off 0, which a self-distillation teacher gives at the last t."""
    import numpy as np
    import torch

    from fastvideo_tpu_torch.ops import _build

    os.environ["FASTVIDEO_ATTENTION_BACKEND"] = "VIDEO_SPARSE_ATTN"
    ckpt = write_checkpoint(os.path.join(work, "kd", "Wan2.1-T2V-tiny"),
                            TINY_DIT_CFG, TINY_VAE_CFG, TINY_T5_CFG, seed=10)
    teacher = write_checkpoint(
        os.path.join(work, "kd", "Wan2.1-T2V-tiny-teacher"), TINY_DIT_CFG,
        TINY_VAE_CFG, TINY_T5_CFG, seed=14, share=ckpt)
    emb = np.random.default_rng(10).standard_normal(
        TINY_TRAIN_EMBEDS[1:]).astype(np.float32)
    runs, trajs = {}, {}
    layers = TINY_DIT_CFG["num_layers"]
    for device in ("cuda", "cpu"):
        method, _ = build_method("kd", ckpt, "", device,
                                 dict(DMD_KW, learning_rate=1e-3),
                                 method_config=dict(
                                     t_list=KD_T_LIST,
                                     teacher_model_path=teacher))
        _build.reset_counts()
        traj, real = method.teacher_rollout(
            emb, method.draw(TINY_TRAIN_LATENTS[1:]))
        if device == "cuda":
            torch.cuda.synchronize()
            check_launches("tiny kd rollout", dict(_build.LAUNCHES),
                           dict(_build.PLAIN_CALLS),
                           kd_rollout_launches(layers, len(KD_T_LIST)))
        trajs[device] = (traj.cpu(), real.cpu())
        runs[device] = method
    c_traj, p_traj = trajs["cuda"][0], trajs["cpu"][0]
    roll_err = ((c_traj - p_traj).abs().max() / p_traj.abs().max()).item()
    steps = {}
    for device, method in runs.items():
        grads: dict = {}
        capture_grads(method.optimizer, method.params, grads, "step")
        _build.reset_counts()
        out = method.train_one_step(*trajs["cpu"][:1], emb, trajs["cpu"][1])
        if device == "cuda":
            torch.cuda.synchronize()
            launches, plain = dict(_build.LAUNCHES), dict(_build.PLAIN_CALLS)
        steps[device] = (out, grads["step"],
                         [p.detach().float().cpu() for p in method.params])
    tokens = math.prod(TINY_TRAIN_LATENTS[-3:]) // 4
    check_launches("tiny kd step", launches, plain, train_launches(
        layers, 1, split_backwards(TINY_DIT_CFG,
                                   [(tokens, TINY_TRAIN_EMBEDS[2])])))
    (c_out, c_g, c_p), (p_out, p_g, p_p) = steps["cuda"], steps["cpu"]
    rel, worst_all, worst_sure, flips, n = adamw_agreement(c_g, p_g, c_p,
                                                           p_p)
    loss_rel = abs(c_out["kd_loss"] - p_out["kd_loss"]) / abs(
        p_out["kd_loss"])
    print(f"  tiny kd, card vs CPU plain: rollout max error "
          f"{roll_err:.2e} of its largest magnitude (bar 1e-2); step (t "
          f"index {int(c_out['kd_step_idx'])} / "
          f"{int(p_out['kd_step_idx'])}): loss {c_out['kd_loss']:.6f} / "
          f"{p_out['kd_loss']:.6f} (rel {loss_rel:.2e}, bar 1e-2), "
          f"gradients rel L2 {rel:.2e} (bar 3e-2), parameters after AdamW: "
          f"max diff {worst_all:.2e}, {worst_sure:.2e} where the gradients "
          f"agree in sign and are >= 1e-5 (bar 2e-6; {flips} of {n} "
          f"elements are not)", flush=True)
    if not (roll_err < 1e-2 and c_out["kd_step_idx"] == p_out["kd_step_idx"]
            and math.isfinite(c_out["kd_loss"]) and loss_rel < 1e-2
            and rel < 3e-2 and worst_sure <= 2e-6):
        raise SystemExit("tiny kd: the card disagrees with the plain path")


def check_small_slice(work: str) -> None:
    """4a's checks of the LoRA / kd / AnyFlow slice: the tiny FastWan with
    an adapter, one step each of lora_finetune, kd, anyflow_pretrain and
    anyflow, card against CPU."""
    layers = TINY_DIT_CFG["num_layers"]

    def reduces(tokens):
        return split_backwards(TINY_DIT_CFG, [(tokens, TINY_TRAIN_EMBEDS[2])])

    check_small_lora(work)
    check_small_pipeline_step(
        work, "lora_finetune", "lora_finetune", dict(rank=4, init_seed=1),
        lambda tokens: train_launches(layers, 1, reduces(tokens)))
    check_small_kd(work)
    check_small_pipeline_step(
        work, "anyflow_pretrain", "anyflow_pretrain", {},
        lambda tokens: pretrain_launches(layers, 1, reduces(tokens)))
    os.environ["FASTVIDEO_ATTENTION_BACKEND"] = "VIDEO_SPARSE_ATTN"
    ckpt = write_checkpoint(os.path.join(work, "anyflow", "Wan2.1-T2V-tiny"),
                            TINY_DIT_CFG, TINY_VAE_CFG, TINY_T5_CFG, seed=11)
    tokens = math.prod(TINY_TRAIN_LATENTS[-3:]) // 4
    rollout = len(ANYFLOW_METHOD["t_list_override"]) - 1
    check_small_distill(
        "tiny AnyFlow step", "anyflow", ckpt, TINY_TRAIN_LATENTS[1:],
        ANYFLOW_METHOD,
        lambda out: anyflow_launches(layers, reduces(tokens), 1, rollout))


def run_lora_serving(work: str, profile_dir: str | None = None) -> dict:
    """Phase 4r: the 4b checkpoint through VideoGenerator.from_pretrained
    (VSA 0.8), then set_lora_adapter with a rank-32 adapter on the 300
    block linears, merge_lora_weights and unmerge_lora_weights, each
    generation of 4b's clip and prompt timed after a warm-up: the base,
    the adapter active, merged and after unmerge. Checks each generation's
    frames and launches (the same as the base's: an adapter adds no
    kernel of ours), merged and unmerged within 8 uint8 levels of active,
    the base unlike active, and the weights after unmerge within the two
    roundings' bound of the base. With ``profile_dir``, one more base and
    one more active generation run under torch.profiler. Merged and
    unmerged are held to active
    at the golden gate's PSNR > 35 dB (the same function, rounded in other
    places, as the tiny paths' card against CPU); their largest uint8
    difference is printed beside JAX's tiny-model bar of 8, which a
    random-weight model this deep does not keep: unmerge's 1-ulp residue
    in a few percent of the weights alone moves it by as much."""
    import torch

    from fastvideo_tpu_torch import VideoGenerator
    from fastvideo_tpu_torch.pipelines.lora_pipeline import lora_layers

    os.environ["FASTVIDEO_ATTENTION_BACKEND"] = "VIDEO_SPARSE_ATTN"
    ckpt = os.path.join(work, "FastWan2.1-T2V-1.3B-Diffusers")
    t0 = time.perf_counter()
    gen = VideoGenerator.from_pretrained(ckpt, VSA_sparsity=0.8)
    print(f"  from_pretrained in {time.perf_counter() - t0:.1f} s",
          flush=True)
    kw = dict(prompt=PROMPT, seed=42, save_video=False, **CLIP_480P)
    runs = {}

    def run(label):
        gen.generate_video(**kw)
        result, launches, plain, peak = timed_generation(gen, kw)
        runs[label] = dict(frames=result["frames"][0],
                           s=result["generation_time"], launches=launches,
                           plain=plain, peak_gib=peak)
        print(f"  {label}: generation {result['generation_time']:.3f} s, "
              f"peak {peak:.2f} GiB", flush=True)
        check_generation(f"LoRA {label} 480x832", result, CLIP_480P,
                         launches, plain,
                         {"flash_fwd": None, "vsa_sparse_fwd": None,
                          "conv3d": None,
                          "flash_fwd_combine": vae_chunks(CLIP_480P)})

    run("base")
    if profile_dir:
        profile_generation(gen, kw, profile_dir, "lora_base_480x832")
    adapter = os.path.join(work, "lora_rank32.safetensors")
    t0 = time.perf_counter()
    nbytes = write_lora_file(adapter, DIT_CFG, LORA_RANK, seed=5)
    write_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    gen.set_lora_adapter("rank32", adapter)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    dit = gen.pipeline.get_module("transformer")
    dev = next(dit.parameters()).device
    layers = lora_layers(dit)
    active = [m for m in layers if m.lora_active]
    print(f"  adapter written in {write_s:.2f} s ({nbytes / 1e6:.1f} MB "
          f"bf16), set_lora_adapter in {load_s:.2f} s: {len(active)} of "
          f"{len(layers)} LoRA linears active, rank {active[0].rank}, "
          f"scaling {active[0].scaling}", flush=True)
    if len(active) != 10 * DIT_CFG["num_layers"]:
        raise SystemExit(f"LoRA: {len(active)} adapted linears, expected "
                         f"{10 * DIT_CFG['num_layers']}")
    calls = [0]

    def count(mod, args, out):
        calls[0] += mod.lora_active and not mod.merged

    hooks = [m.register_forward_hook(count) for m in active]
    run("active")
    for h in hooks:
        h.remove()
    calls[0] //= 2  # the warm-up's and the timed generation's
    if profile_dir:
        profile_generation(gen, kw, profile_dir, "lora_active_480x832")
    # the base weights and the merged ones on the host, off the peaks
    w0 = [m.weight.detach().cpu() for m in active]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    gen.pipeline.merge_lora_weights()
    torch.cuda.synchronize()
    merge_s = time.perf_counter() - t0
    merged_w = [m.weight.detach().cpu() for m in active]
    run("merged")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    gen.pipeline.unmerge_lora_weights()
    torch.cuda.synchronize()
    unmerge_s = time.perf_counter() - t0
    run("unmerged")
    # |u - w| <= ulp(merged) / 2 + ulp(u) / 2 (each step rounds to bf16
    # once); one ulp of w where neither crosses a power of two
    def ulp(x):
        e = torch.floor(torch.log2(x.float().abs().clamp_min(2.0**-126)))
        return torch.exp2(e - 7)

    worst = 0.0
    same = total = 0
    for m, w, mw in zip(active, w0, merged_w):
        u, w, mw = m.weight.detach(), w.to(dev), mw.to(dev)
        gap = (u.float() - w.float()).abs()
        worst = max(worst, (gap / (0.5 * ulp(mw) + 0.5 * ulp(u))).max()
                    .item())
        same += int((u == w).sum())
        total += u.numel()
    del w0, merged_w
    diffs = {k: uint8_diff(runs[k]["frames"], runs["active"]["frames"])
             for k in ("base", "merged", "unmerged")}
    ps = {k: psnr(runs[k]["frames"], runs["active"]["frames"])
          for k in ("base", "merged", "unmerged")}
    extra = calls[0] * LORA_CALL_LAUNCHES
    print(f"  merge {merge_s * 1e3:.1f} ms, unmerge {unmerge_s * 1e3:.1f} ms "
          f"({len(active)} fp32 rank-{LORA_RANK} products each); adapter "
          f"calls a generation {calls[0]}, so {extra} extra launches (2 "
          f"thin GEMMs, a scale and an add a call); against active: "
          f"frames PSNR {json.dumps({k: round(v, 2) for k, v in ps.items()})}"
          f" dB (merged and unmerged bar > 35), largest uint8 difference "
          f"{json.dumps(diffs)} (base > 0; JAX's tiny-model bar for merged "
          f"and unmerged: 8, not held here); weights after unmerge: "
          f"{same / total:.6f} equal to the base, the largest difference "
          f"{worst:.3f} of the two roundings' bound (bar <= 1)", flush=True)
    launches = runs["base"]["launches"]
    for k in ("active", "merged", "unmerged"):
        if runs[k]["launches"] != launches:
            raise SystemExit(f"LoRA {k}: launches {runs[k]['launches']} "
                             f"differ from the base's {launches}")
    if not (ps["merged"] > 35 and ps["unmerged"] > 35
            and diffs["base"] > 0 and worst <= 1.0):
        raise SystemExit("LoRA 480x832: merged or unmerged frames off the "
                         "active adapter's, the adapter changed nothing, or "
                         "unmerge did not restore the weights")
    del gen, dit, layers, active
    torch.cuda.empty_cache()
    return dict(launches=runs["active"]["launches"],
                generation_s={k: v["s"] for k, v in runs.items()},
                peak_gib={k: v["peak_gib"] for k, v in runs.items()},
                merge_s=merge_s, unmerge_s=unmerge_s, load_s=load_s,
                adapter_calls=calls[0], extra_launches=extra,
                uint8_vs_active=diffs, psnr_vs_active=ps,
                unmerge_equal=same / total,
                unmerge_worst_of_bound=worst)


def run_lora_finetune(work: str, data: str,
                      profile_dir: str | None = None) -> dict:
    """Phase 4s: lora_finetune at 4i's shapes (VSA 0.8, full remat), rank
    32 on the default targets (304 linears), on 4n's shard: the base
    frozen (its checksum unchanged), the adapters moved."""
    layers = DIT_CFG["num_layers"]
    tokens = math.prod(TRAIN_LATENTS[-3:]) // 4

    def counts(method, loader):
        pipe = method.pipeline
        n = sum(p.numel() for p in pipe.params)
        print(f"  {pipe.n_lora_layers} LoRA linears, {n} trainable "
              f"parameters ({n * 4 / 2**20:.1f} MiB fp32)", flush=True)
        if pipe.n_lora_layers != 10 * layers + 4:
            raise SystemExit(f"lora_finetune: {pipe.n_lora_layers} LoRA "
                             f"linears, expected {10 * layers + 4}")
        return dict(lora_layers=pipe.n_lora_layers, trainable=n)

    return run_training_phase(
        "lora_finetune", "lora_finetune", work, data, LORA_METHOD, 1,
        METHOD_STEPS, lambda rows: train_launches(
            layers, len(rows), split_backwards(
                DIT_CFG, [(tokens, TRAIN_EMBEDS[2])])),
        ["transformer"], ["transformer"], profile_dir,
        ckpt=os.path.join(work, "FastWan2.1-T2V-1.3B-Diffusers"),
        backend="VIDEO_SPARSE_ATTN", training=TRAIN_KW, prepare=counts)


def run_kd(work: str, data: str, profile_dir: str | None = None) -> dict:
    """Phase 4t: kd at 4i's shapes (sparsity 0: no forward context), a
    self-distillation teacher, t_list KD_T_LIST: generate_cache over 4n's
    shard (2 samples), one teacher rollout timed warm, then steps read
    from the cache."""
    import torch

    from fastvideo_tpu_torch.ops import _build

    layers = DIT_CFG["num_layers"]
    tokens = math.prod(TRAIN_LATENTS[-3:]) // 4
    cache = os.path.join(work, "kd_cache")

    def make_cache(method, loader):
        t0 = time.perf_counter()
        method.generate_cache(loader, max_samples=2)
        torch.cuda.synchronize()
        gen_s = time.perf_counter() - t0
        files = sorted(f for f in os.listdir(cache) if f.endswith(".npz"))
        sample_bytes = os.path.getsize(os.path.join(cache, files[0]))
        traj, emb, _ = next(method.iter_cache())
        draws = method.draw(tuple(traj.shape[1:]))
        _build.reset_counts()
        t0 = time.perf_counter()
        method.teacher_rollout(emb, draws)
        torch.cuda.synchronize()
        roll_s = time.perf_counter() - t0
        launches = dict(_build.LAUNCHES)
        check_launches("kd rollout 480x832", launches,
                       dict(_build.PLAIN_CALLS),
                       kd_rollout_launches(layers, len(KD_T_LIST)))
        print(f"  cache of {len(files)} samples in {gen_s:.2f} s "
              f"({sample_bytes / 1e6:.1f} MB a sample; COMPLETE "
              f"{os.path.exists(os.path.join(cache, 'COMPLETE'))}); a warm "
              f"teacher rollout ({len(KD_T_LIST)} no-grad passes) "
              f"{roll_s:.3f} s", flush=True)
        return dict(cache_s=gen_s, cache_sample_bytes=sample_bytes,
                    rollout_s=roll_s, rollout_launches=launches)

    return run_training_phase(
        "kd", "kd", work, data,
        dict(t_list=list(KD_T_LIST), teacher_path_cache=cache), 1,
        METHOD_STEPS, lambda rows: train_launches(
            layers, len(rows), split_backwards(
                DIT_CFG, [(tokens, TRAIN_EMBEDS[2])])),
        ["student"], ["teacher"], profile_dir,
        ckpt=os.path.join(work, "FastWan2.1-T2V-1.3B-Diffusers"),
        backend="VIDEO_SPARSE_ATTN", prepare=make_cache)


def run_anyflow_pretrain(work: str, data: str,
                         profile_dir: str | None = None) -> dict:
    """Phase 4u: anyflow_pretrain at 4i's shapes (VSA 0.8, full remat) on
    the 4b checkpoint, which has no delta weights: every delta_embedder
    parameter starts equal to its time_embedder one (the copy rule)."""
    import torch

    layers = DIT_CFG["num_layers"]
    tokens = math.prod(TRAIN_LATENTS[-3:]) // 4

    def copy_rule(method, loader):
        ce = method.pipeline.transformer.condition_embedder
        ok = all(torch.equal(d, t) and d.data_ptr() != t.data_ptr()
                 for d, t in zip(ce.delta_embedder.parameters(),
                                 ce.time_embedder.parameters()))
        print(f"  delta_embedder a copy of time_embedder: {ok}", flush=True)
        if not ok:
            raise SystemExit("anyflow_pretrain: the copy rule did not hold")
        return {}

    return run_training_phase(
        "anyflow_pretrain", "anyflow_pretrain", work, data, {}, 1,
        METHOD_STEPS, lambda rows: pretrain_launches(
            layers, len(rows), split_backwards(
                DIT_CFG, [(tokens, TRAIN_EMBEDS[2])])),
        ["transformer"], [], profile_dir,
        ckpt=os.path.join(work, "FastWan2.1-T2V-1.3B-Diffusers"),
        backend="VIDEO_SPARSE_ATTN", training=TRAIN_KW, prepare=copy_rule)


def run_anyflow(work: str, data: str,
                profile_dir: str | None = None) -> dict:
    """Phase 4v: anyflow at 4n's setup (the 4b checkpoint as generator,
    real and fake score in fp32 masters with the branch grown, full remat,
    sparsity 0), a 4-step flow-map rollout, a generator and a critic update
    a step, on 4n's shard."""
    layers = DIT_CFG["num_layers"]
    tokens = math.prod(TRAIN_LATENTS[-3:]) // 4
    rollout = len(ANYFLOW_METHOD["t_list_override"]) - 1
    return run_training_phase(
        "anyflow", "anyflow", work, data, ANYFLOW_METHOD, 1, METHOD_STEPS,
        lambda rows: anyflow_launches(layers, split_backwards(
            DIT_CFG, [(tokens, TRAIN_EMBEDS[2])]), len(rows), rollout),
        ["generator", "fake_score"], ["real_score"], profile_dir,
        ckpt=os.path.join(work, "FastWan2.1-T2V-1.3B-Diffusers"),
        backend="VIDEO_SPARSE_ATTN")


# -- 4a (DiffusionNFT, "ops", callbacks), the 4i "ops" step and 4w ----------

# 4w: DiffusionNFT on the 4b checkpoint's DiT at 4i's latent shape (32,760
# tokens), 1 prompt x 2 videos (the smallest group whose advantages are not
# 0), 2 sampling steps (one trained timestep), full remat, AdamW
NFT_METHOD = dict(reward_fn={"clipscore": 1.0, "pickscore": 1.0},
                  sampling={"num_steps": 2}, num_video_per_prompt=2)
NFT_LATENT = TRAIN_LATENTS[2:]
NFT_SAMPLE_STEPS = 2
# the rewards' CLIP dual tower: CLIP ViT-L/14's vision tower and CLIP-L's
# text tower, whose projection is 1024 wide to meet the vision tower's
# width (the JAX scorer takes the vision tokens' unprojected mean)
CLIP_VISION_CFG = dict(hidden_size=1024, intermediate_size=4096,
                       num_hidden_layers=24, num_attention_heads=16,
                       image_size=224, patch_size=14, num_channels=3,
                       hidden_act="quick_gelu", layer_norm_eps=1e-5,
                       projection_dim=768)
CLIP_TEXT_CFG = dict(vocab_size=49408, hidden_size=768,
                     intermediate_size=3072, num_hidden_layers=12,
                     num_attention_heads=12, max_position_embeddings=77,
                     hidden_act="quick_gelu", layer_norm_eps=1e-5,
                     eos_token_id=49407, projection_dim=1024)
TINY_CLIP_VISION_CFG = dict(CLIP_VISION_CFG, hidden_size=32,
                            intermediate_size=64, num_hidden_layers=2,
                            num_attention_heads=4, image_size=28)
TINY_CLIP_TEXT_CFG = dict(CLIP_TEXT_CFG, hidden_size=32,
                          intermediate_size=48, num_hidden_layers=2,
                          num_attention_heads=4, projection_dim=32)
# CLIP's Split pattern
CLIP_SPLIT = (r"<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d"
              r"|[\p{L}]+|[\p{N}]|[^\s\p{L}\p{N}]+")


def write_clip_tokenizer(directory: str, texts: list[str]) -> str:
    """A CLIP-layout tokenizer.json without the tokenizers package: the 256
    byte characters and their ``</w>`` forms (ids 0-511, as CLIP's), merges
    that build each word of ``texts`` left to right, the special tokens at
    CLIP's ids 49406 / 49407, CLIP's normalizer, pre-tokenizers and
    RobertaProcessing."""
    import re

    from fastvideo_tpu_torch.models.loader.tokenizer import _BYTE_CHARS

    chars = [_BYTE_CHARS[b] for b in range(256)]
    vocab = {c: i for i, c in enumerate(chars)}
    vocab.update({c + "</w>": 256 + i for i, c in enumerate(chars)})
    merges = []
    for word in sorted({w for t in texts for w in re.findall(r"\w+",
                                                               t.lower())}):
        syms = ["".join(_BYTE_CHARS[b] for b in ch.encode()) for ch in word]
        syms[-1] += "</w>"
        while len(syms) > 1:
            pair = (syms[0], syms[1])
            if pair not in merges:
                merges.append(pair)
                vocab.setdefault(pair[0] + pair[1], len(vocab))
            syms = [pair[0] + pair[1]] + syms[2:]
    specials = {"<|startoftext|>": 49406, "<|endoftext|>": 49407}
    vocab.update(specials)
    os.makedirs(directory, exist_ok=True)
    spec = {
        "version": "1.0", "truncation": None, "padding": None,
        "added_tokens": [{"id": i, "content": t, "single_word": False,
                          "lstrip": False, "rstrip": False,
                          "normalized": True, "special": True}
                         for t, i in specials.items()],
        "normalizer": {"type": "Sequence", "normalizers": [
            {"type": "NFC"},
            {"type": "Replace", "pattern": {"Regex": r"\s+"}, "content": " "},
            {"type": "Lowercase"}]},
        "pre_tokenizer": {"type": "Sequence", "pretokenizers": [
            {"type": "Split", "pattern": {"Regex": CLIP_SPLIT},
             "behavior": "Removed", "invert": True},
            {"type": "ByteLevel", "add_prefix_space": False,
             "trim_offsets": True, "use_regex": False}]},
        "post_processor": {"type": "RobertaProcessing",
                           "sep": ["<|endoftext|>", 49407],
                           "cls": ["<|startoftext|>", 49406],
                           "trim_offsets": False, "add_prefix_space": False},
        "decoder": None,
        "model": {"type": "BPE", "dropout": None,
                  "unk_token": "<|endoftext|>",
                  "continuing_subword_prefix": "",
                  "end_of_word_suffix": "</w>", "fuse_unk": False,
                  "byte_fallback": False, "vocab": vocab,
                  "merges": [f"{a} {b}" for a, b in merges]}}
    with open(os.path.join(directory, "tokenizer.json"), "w") as fh:
        json.dump(spec, fh)
    with open(os.path.join(directory, "tokenizer_config.json"), "w") as fh:
        json.dump({"tokenizer_class": "CLIPTokenizer",
                   "pad_token": "<|endoftext|>", "model_max_length": 77}, fh)
    return directory


def write_clip_dual_tower(root: str, vision_cfg: dict, text_cfg: dict,
                          seed: int, texts: list[str]) -> str:
    """The rewards' checkpoint directory: text/ and vision/ with random bf16
    weights written by the port's safetensors writer, and tokenizer/."""
    import torch

    from fastvideo_tpu_torch.models.loader.component_loader import (
        _build_arch_config as arch)
    from fastvideo_tpu_torch.models.loader.safetensors_io import save_file
    from fastvideo_tpu_torch.models.registry import resolve_model_cls

    gen = torch.Generator(device="cuda").manual_seed(seed)
    write_clip_tokenizer(os.path.join(root, "tokenizer"), texts)
    for sub, cls_name, cfg in (
            ("text", "CLIPTextModelWithProjection", text_cfg),
            ("vision", "CLIPVisionModelWithProjection", vision_cfg)):
        model_cls, arch_cls = resolve_model_cls(cls_name)
        d = os.path.join(root, sub)
        os.makedirs(d, exist_ok=True)
        with open(os.path.join(d, "config.json"), "w") as fh:
            json.dump({"architectures": [cls_name], **cfg}, fh)
        state = random_state(model_cls(arch(arch_cls, cfg), device="meta"),
                             torch.bfloat16, "cuda", gen)
        save_file(state, os.path.join(d, "model.safetensors"))
    return root


def nft_launches(layers: int, reduces: int, sample_steps: int,
                 trained: int, decodes: int = 0, chunks: int = 0) -> dict:
    """Launches of a DiffusionNFT outer step: ``sample_steps`` no-grad
    passes of the old policy, then per trained timestep the old and ref
    passes without grad and the student's under full remat (no forward
    context: VSA at sparsity 0, K2 without grad, K7 fwd and bwd with), and
    ``decodes`` VAE decodes of ``chunks`` chunks (33 convs and one VAE
    attention with its merge a chunk)."""
    no_grad = sample_steps + 2 * trained
    return {"flash_fwd": (no_grad + 2 * trained) * layers + decodes * chunks,
            "vsa_sparse_fwd": no_grad * layers,
            "vsa_sparse_padded_fwd": 2 * trained * layers,
            "flash_bwd_dq": trained * layers,
            "flash_bwd_dkv": trained * layers,
            "flash_bwd_dkv_reduce": reduces * trained * layers,
            "vsa_sparse_bwd_dq": trained * layers,
            "vsa_sparse_bwd_dkv": trained * layers,
            "conv3d": 33 * decodes * chunks,
            "flash_fwd_combine": decodes * chunks}


def frames_of_latents(lat):
    """4a's decode_fn: frames in (0, 1) from the latents' first three
    channels (the tiny VAE is not on this path)."""
    import torch

    return torch.sigmoid(lat[:, :3].float()).cpu().numpy()


def check_small_nft(work: str) -> None:
    """One DiffusionNFT outer step of a tiny VSA Wan (2 layers), its
    rewards from a tiny CLIP dual tower (both scorers), card against CPU:
    the same checkpoint, seed and prompt, so the same draws (a CPU
    generator on both). Rewards within 1e-2, the total and policy losses
    within 1e-2 relative, the gradients within 3e-2 relative L2 and the
    parameters after AdamW by check_small_pipeline_step's rule; the card's
    launches against nft_launches."""
    import numpy as np
    import torch

    os.environ["FASTVIDEO_ATTENTION_BACKEND"] = "VIDEO_SPARSE_ATTN"
    ckpt = write_checkpoint(os.path.join(work, "nft", "Wan2.1-T2V-tiny"),
                            TINY_DIT_CFG, TINY_VAE_CFG, TINY_T5_CFG, seed=12)
    clip = write_clip_dual_tower(os.path.join(work, "nft", "clip"),
                                 TINY_CLIP_VISION_CFG, TINY_CLIP_TEXT_CFG,
                                 13, [PROMPT])
    os.environ["FASTVIDEO_CLIPSCORE_WEIGHTS"] = clip
    os.environ["FASTVIDEO_PICKSCORE_WEIGHTS"] = clip
    emb = np.random.default_rng(12).standard_normal(
        (1,) + TINY_TRAIN_EMBEDS[2:]).astype(np.float32)
    runs = {}
    for device in ("cuda", "cpu"):
        method, _ = build_method("diffusion_nft", ckpt, "", device,
                                 dict(DMD_KW, learning_rate=1e-3),
                                 method_config=NFT_METHOD)
        pipe = method.pipeline
        pipe.decode_fn = frames_of_latents
        out, grads, counts, plain_counts = step_with_grads(
            pipe, ([PROMPT], emb, TINY_TRAIN_LATENTS[2:]))
        if device == "cuda":
            launches, plain = counts, plain_counts
        runs[device] = (out, grads,
                        [p.detach().float().cpu() for p in pipe.params])
        del method, pipe
    tokens = math.prod(TINY_TRAIN_LATENTS[-3:]) // 4
    check_launches("tiny NFT step", launches, plain, nft_launches(
        TINY_DIT_CFG["num_layers"], split_backwards(
            TINY_DIT_CFG, [(tokens, TINY_TRAIN_EMBEDS[2])]),
        NFT_SAMPLE_STEPS, 1))
    (c_out, c_g, c_p), (p_out, p_g, p_p) = runs["cuda"], runs["cpu"]
    rel, worst_all, worst_sure, flips, n = adamw_agreement(c_g, p_g, c_p,
                                                           p_p)
    rewards = [k for k in c_out if k.startswith("reward/")]
    reward_err = max(abs(c_out[k] - p_out[k]) for k in rewards)
    loss_rel = max(abs(c_out[k] - p_out[k]) / abs(p_out[k])
                   for k in ("total_loss", "policy_loss"))
    print(f"  tiny NFT step, card vs CPU plain: rewards "
          f"{ {k: round(c_out[k], 5) for k in rewards} } / "
          f"{ {k: round(p_out[k], 5) for k in rewards} } (max diff "
          f"{reward_err:.2e}, bar 1e-2); total loss {c_out['total_loss']:.5f}"
          f" / {p_out['total_loss']:.5f}, policy {c_out['policy_loss']:.5f} /"
          f" {p_out['policy_loss']:.5f} (rel {loss_rel:.2e}, bar 1e-2), KL "
          f"{c_out['kl_div_loss']:.3e} / {p_out['kl_div_loss']:.3e}, "
          f"grad_norm {c_out['grad_norm']:.5f} / {p_out['grad_norm']:.5f}; "
          f"gradients rel L2 {rel:.2e} (bar 3e-2); parameters after AdamW: "
          f"max diff {worst_all:.2e}, {worst_sure:.2e} where the gradients "
          f"agree in sign and are >= 1e-5 (bar 2e-6; {flips} of {n} are "
          f"not); card launches "
          f"{json.dumps({k: v for k, v in launches.items() if v})}",
          flush=True)
    if not (reward_err < 1e-2 and loss_rel < 1e-2 and rel < 3e-2
            and worst_sure <= 2e-6 and math.isfinite(c_out["total_loss"])):
        raise SystemExit("tiny NFT step: the card disagrees with the plain "
                         "path")


def check_small_remat_ops(work: str) -> None:
    """One SFT step of the tiny VSA Wan on the card under
    selective_checkpointing "ops" (the linears' outputs saved) and under
    "full", from one checkpoint, seed and batch: the same loss, the
    gradients within 1e-5 of the largest, the same launches (the attention
    kernels run again in both backwards)."""
    import numpy as np
    import torch

    os.environ["FASTVIDEO_ATTENTION_BACKEND"] = "VIDEO_SPARSE_ATTN"
    ckpt = write_checkpoint(os.path.join(work, "ops", "Wan2.1-T2V-tiny"),
                            TINY_DIT_CFG, TINY_VAE_CFG, TINY_T5_CFG, seed=15)
    rng = np.random.default_rng(15)
    batch = (rng.standard_normal(TINY_TRAIN_LATENTS).astype(np.float32),
             rng.standard_normal(TINY_TRAIN_EMBEDS).astype(np.float32))
    runs = {}
    for remat in ("ops", "full"):
        method, _ = build_method("sft", ckpt, "", "cuda", dict(
            TRAIN_KW, learning_rate=1e-3, selective_checkpointing=remat))
        pipe = method.pipeline
        out, grads, launches, plain = step_with_grads(pipe, batch,
                                                      vsa_sparsity=0.8)
        runs[remat] = (out, grads, launches, plain)
        del method, pipe
    (o_out, o_g, o_l, o_p), (f_out, f_g, f_l, f_p) = runs["ops"], runs["full"]
    diff = max((a - b).abs().max().item() for a, b in zip(o_g, f_g))
    scale = max(g.abs().max().item() for g in f_g)
    tokens = math.prod(TINY_TRAIN_LATENTS[-3:]) // 4
    expect = train_launches(TINY_DIT_CFG["num_layers"], 1, split_backwards(
        TINY_DIT_CFG, [(tokens, TINY_TRAIN_EMBEDS[2])]))
    check_launches("tiny SFT step under ops", o_l, o_p, expect)
    check_launches("tiny SFT step under full", f_l, f_p, expect)
    print(f"  tiny SFT step on the card, ops vs full: loss "
          f"{o_out['loss']:.6f} / {f_out['loss']:.6f}, grad_norm "
          f"{o_out['grad_norm']:.6f} / {f_out['grad_norm']:.6f}, largest "
          f"gradient difference {diff:.3e} of a largest gradient "
          f"{scale:.3e} (bar 1e-5 of it: the recomputes run on autograd's "
          f"thread); launches equal {o_l == f_l}", flush=True)
    if not (o_out["loss"] == f_out["loss"] and diff <= 1e-5 * scale):
        raise SystemExit("tiny SFT step: ops and full remat disagree")


def check_small_callbacks(work: str) -> None:
    """One SFT step of the tiny VSA Wan through method.train with the
    grad_clip and ema callbacks, card against CPU: the threshold set on
    both; the EMA shadows within 2e-4 + 1e-6 (the EMA keeps 0.9 of the
    shared start, so they differ by 0.1 of the parameters' gap, which two
    first AdamW updates at lr 1e-3 bound by 2e-3; 1e-6 for the lerp's
    fp32 rounding)."""
    import numpy as np

    from fastvideo_tpu_torch.training.callbacks import CallbackDict

    os.environ["FASTVIDEO_ATTENTION_BACKEND"] = "VIDEO_SPARSE_ATTN"
    ckpt = write_checkpoint(os.path.join(work, "callbacks",
                                         "Wan2.1-T2V-tiny"),
                            TINY_DIT_CFG, TINY_VAE_CFG, TINY_T5_CFG, seed=16)
    rng = np.random.default_rng(16)
    batch = (rng.standard_normal(TINY_TRAIN_LATENTS).astype(np.float32),
             rng.standard_normal(TINY_TRAIN_EMBEDS).astype(np.float32))
    shadows, thresholds = {}, {}
    for device in ("cuda", "cpu"):
        method, _ = build_method("sft", ckpt, "", device, dict(
            TRAIN_KW, learning_rate=1e-3, max_train_steps=1))
        cbs = CallbackDict({"grad_clip": {"max_grad_norm": 0.5},
                            "ema": {"decay": 0.9}})
        method.train([batch], callbacks=cbs)
        shadows[device] = [s.cpu() for s in cbs["ema"].shadow]
        thresholds[device] = method.args.max_grad_norm
        del method
    diff = max((a - b).abs().max().item()
               for a, b in zip(shadows["cuda"], shadows["cpu"]))
    print(f"  tiny SFT step with grad_clip and ema callbacks, card vs CPU: "
          f"max_grad_norm {thresholds}, EMA shadows' largest difference "
          f"{diff:.2e} (bar 2e-4 + 1e-6: 0.1 of two first AdamW updates)",
          flush=True)
    if not (thresholds["cuda"] == thresholds["cpu"] == 0.5
            and diff <= 2e-4 + 1e-6):
        raise SystemExit("tiny callbacks step: the card disagrees with the "
                         "plain path")


def check_small_rl_slice(work: str) -> None:
    """4a's checks of the DiffusionNFT / callbacks / "ops" slice."""
    check_small_nft(work)
    check_small_remat_ops(work)
    check_small_callbacks(work)


def run_ops_step(work: str) -> dict:
    """4i's shape under selective_checkpointing="ops": a warm-up step, then
    one timed step, its peak memory against 4i's. If 81 frames do not fit
    the card, the same at 41 frames (11 latent frames), and the line says
    so."""
    import torch

    from fastvideo_tpu_torch.ops import _build

    os.environ["FASTVIDEO_ATTENTION_BACKEND"] = "VIDEO_SPARSE_ATTN"
    layers = DIT_CFG["num_layers"]
    for latents in (TRAIN_LATENTS, TRAIN_LATENTS[:3] + (11,) +
                    TRAIN_LATENTS[4:]):
        torch.cuda.empty_cache()
        method, _ = build_method(
            "sft", os.path.join(work, "FastWan2.1-T2V-1.3B-Diffusers"),
            os.path.join(work, "ops_out"), "cuda",
            dict(TRAIN_KW, selective_checkpointing="ops", max_train_steps=2))
        pipe = method.pipeline
        loader = train_loader(latents, TRAIN_EMBEDS)
        try:
            method.train(loader, max_steps=1)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            _build.reset_counts()
            before = torch.cuda.memory_stats()
            t0 = time.perf_counter()
            method.train(loader, max_steps=2)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            after = torch.cuda.memory_stats()
        except torch.cuda.OutOfMemoryError as exc:
            print(f"  ops at {latents}: out of memory ({str(exc)[:120]})",
                  flush=True)
            continue
        finally:
            loader.shutdown()
            del method, pipe
        launches, plain = dict(_build.LAUNCHES), dict(_build.PLAIN_CALLS)
        peak = torch.cuda.max_memory_allocated() / 2**30
        tokens = math.prod(latents[-3:]) // 4
        check_launches(f"SFT under ops {latents}", launches, plain,
                       train_launches(layers, 1, split_backwards(
                           DIT_CFG, [(tokens, TRAIN_EMBEDS[2])])))
        grew = {k: after[k] - before[k] for k in ("num_alloc_retries",
                                                  "num_device_alloc")}
        print(f"  one step under selective_checkpointing=\"ops\" at latents "
              f"{list(latents)}: {wall:.3f} s, peak memory {peak:.2f} GiB; "
              f"launches as under full remat; allocator retries "
              f"{grew['num_alloc_retries']}, device allocations "
              f"{grew['num_device_alloc']}; after it {card_state()}",
              flush=True)
        torch.cuda.empty_cache()
        return dict(launches=launches, step_s=wall, peak_gib=peak,
                    latents=list(latents))
    raise SystemExit("SFT under ops: out of memory at 81 and 41 frames")


def nft_decoder(ckpt: str):
    """4w's decode_fn: the checkpoint's VAE, each sample decoded alone as
    4b's clip (the dispatched decode's chunks, bf16), pixels mapped from
    [-1, 1] to [0, 1], to the host."""
    import numpy as np
    import torch

    from fastvideo_tpu_torch.configs.pipelines.wan import (
        FastWanT2V480PConfig)
    from fastvideo_tpu_torch.models.loader.component_loader import (
        load_model_component)
    from fastvideo_tpu_torch.pipelines.stages.decoding import (
        dispatched_chunk_frames)

    cfg = FastWanT2V480PConfig()
    vae = load_model_component(os.path.join(ckpt, "vae"),
                               device=torch.device("cuda"),
                               precision=cfg.vae_precision,
                               model_config=cfg.vae_config)

    @torch.no_grad()
    def decode(latents):
        out = []
        for lat in latents:
            z = vae.denormalize_latents(lat[None])
            x = vae.decode(z.to(torch.bfloat16), chunk_frames=(
                dispatched_chunk_frames(z, vae.config)))
            out.append(((x.float() + 1) / 2).clamp(0, 1).cpu().numpy())
        return np.concatenate(out)

    return decode


def run_diffusion_nft(work: str, profile_dir: str | None = None) -> dict:
    """Phase 4w: diffusion_nft through build_from_config on the 4b
    checkpoint's Wan2.1-T2V-1.3B-shaped DiT (student in fp32 masters, old
    and ref as frozen copies), rewards from CLIPScore and PickScore on one
    random CLIP dual tower at ViT-L/14 / CLIP-L widths, the 4b VAE as
    decode_fn, 4b's UMT5 embedding of its prompt; a warm-up step, then one
    timed: its stages, peak memory, losses, rewards, the roles' checks and
    the launches against nft_launches."""
    import numpy as np
    import torch

    from fastvideo_tpu_torch.attention.backends.vsa import vsa_topk
    from fastvideo_tpu_torch.ops import _build
    from fastvideo_tpu_torch.training.callbacks import Callback

    os.environ["FASTVIDEO_ATTENTION_BACKEND"] = "VIDEO_SPARSE_ATTN"
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    ckpt = os.path.join(work, "FastWan2.1-T2V-1.3B-Diffusers")
    t0 = time.perf_counter()
    clip = write_clip_dual_tower(os.path.join(work, "clip_dual_tower"),
                                 CLIP_VISION_CFG, CLIP_TEXT_CFG, 17, [PROMPT])
    os.environ["FASTVIDEO_CLIPSCORE_WEIGHTS"] = clip
    os.environ["FASTVIDEO_PICKSCORE_WEIGHTS"] = clip
    embeds = np.load(os.path.join(work, "nft_prompt_embeds.npy"))
    method, _ = build_method(
        "diffusion_nft", ckpt, os.path.join(work, "nft_out"), "cuda",
        dict(DMD_KW, max_train_steps=2), method_config=NFT_METHOD)
    pipe = method.pipeline
    pipe.decode_fn = nft_decoder(ckpt)
    n_params = sum(p.numel() for p in pipe.params)
    tiles = math.prod(NFT_LATENT[-3:]) // 4 // 280
    print(f"  DiffusionNFTMethod built in {time.perf_counter() - t0:.1f} s "
          f"(the CLIP dual tower written and loaded twice, the VAE "
          f"loaded): student, old and ref of {n_params / 1e9:.3f} B fp32 "
          f"parameters, remat {pipe.args.selective_checkpointing}, "
          f"{pipe.cfg.num_video_per_prompt} videos a prompt, sampling "
          f"timesteps {pipe.sampler.schedule()[0].tolist()}, "
          f"{pipe.num_train_timesteps()}"
          f" trained timestep; UMT5 embedding {list(embeds.shape)}; VSA top-"
          f"{vsa_topk(0.0, tiles)} of {tiles} tiles (no forward context)",
          flush=True)
    rows = []

    class Record(Callback):
        def on_training_step_end(self, method, loss_dict, iteration=0):
            rows.append(dict(loss_dict, stages=dict(method.stage_seconds)))

    loader = [([PROMPT], embeds, NFT_LATENT)]
    callbacks = {"record": {"_target_": Record}}
    ref_sum = checksum(pipe.ref)
    t0 = time.perf_counter()
    method.train(loader, max_steps=1, callbacks=callbacks)
    torch.cuda.synchronize()
    print(f"  warm-up step {time.perf_counter() - t0:.2f} s; peak "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB", flush=True)
    old_sum = checksum(pipe.old)
    watch = {n: p.detach().clone() for n, p in
             list(pipe.student.named_parameters())[:4]}
    torch.cuda.reset_peak_memory_stats()
    _build.reset_counts()
    t0 = time.perf_counter()
    method.train(loader, max_steps=2, callbacks=callbacks)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, plain = dict(_build.LAUNCHES), dict(_build.PLAIN_CALLS)
    peak = torch.cuda.max_memory_allocated() / 2**30
    if profile_dir:
        profile_train_step(method, loader, profile_dir, "nft_480x832")
    row = rows[-1]
    moved = all(not torch.equal(w, dict(pipe.student.named_parameters())[n])
                for n, w in watch.items())
    ref_same = checksum(pipe.ref) == ref_sum
    old_moved = checksum(pipe.old) != old_sum
    keys = ("total_loss", "policy_loss", "kl_div_loss", "grad_norm")
    print(f"  timed step {wall:.3f} s: "
          + ", ".join(f"{k} {v:.3f} s" for k, v in row["stages"].items())
          + f"; peak memory {peak:.2f} GiB; "
          + ", ".join(f"{k} {row[k]:.6g}" for k in keys)
          + ", rewards " + json.dumps({k: round(v, 6) for k, v in row.items()
                                       if k.startswith("reward/")})
          + f", old_decay {row['old_decay']}; student moved {moved}, ref "
          f"unchanged {ref_same}, old moved on the second step {old_moved}",
          flush=True)
    print(f"  kernel launches {json.dumps(launches)}; plain calls "
          f"{json.dumps(plain)}", flush=True)
    tokens = math.prod(NFT_LATENT[-3:]) // 4
    check_launches("DiffusionNFT 480x832", launches, plain, nft_launches(
        DIT_CFG["num_layers"], split_backwards(
            DIT_CFG, [(tokens, TRAIN_EMBEDS[2])]),
        NFT_SAMPLE_STEPS, pipe.num_train_timesteps(),
        decodes=pipe.cfg.num_video_per_prompt, chunks=vae_chunks(CLIP_480P)))
    if not (all(math.isfinite(row[k]) for k in keys) and moved and ref_same
            and old_moved and row["old_decay"] > 0):
        raise SystemExit("DiffusionNFT 480x832: a loss not finite, the "
                         "student not moved, ref changed or old not moved")
    stages = row["stages"]
    del method, pipe
    torch.cuda.empty_cache()
    return dict(launches=launches, step_s=wall, peak_gib=peak,
                stage_s=stages, **{k: row[k] for k in keys})


def profile_train_step(method, loader, out_dir: str,
                       label: str = "sft_480x832") -> None:
    """One more step under torch.profiler: device time by kernel name, the
    device's busy share of the wall time, and a Chrome trace."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    pipe = getattr(method, "pipeline", method)
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        method.train(loader, max_steps=pipe.step + 1)
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    total = sum(e.self_device_time_total for e in events) / 1e6
    print(f"  profiled train step: wall {wall:.3f} s, device kernels "
          f"{total:.3f} s, device busy share {total / wall:.3f}", flush=True)
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:25]:
        print(f"    {e.self_device_time_total / 1e3:10.1f} ms  "
              f"{e.count:6d}x  {e.key[:110]}", flush=True)
    os.makedirs(out_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(out_dir, f"{label}_trace.json"))


def profile_generation(gen, kw: dict, out_dir: str, label: str) -> None:
    """One more generation under torch.profiler: device time by kernel
    name, the device's busy share of the wall time, and a Chrome trace."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    t0 = time.perf_counter()
    with profile(activities=acts) as prof:
        gen.generate_video(**kw)
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    total = sum(e.self_device_time_total for e in events) / 1e6
    print(f"  profiled generation ({label}): wall {wall:.3f} s, device kernels "
          f"{total:.3f} s, device busy share {total / wall:.3f}", flush=True)
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:20]:
        print(f"    {e.self_device_time_total / 1e3:10.1f} ms  "
              f"{e.count:6d}x  {e.key[:110]}", flush=True)
    # the VAE attention's kernels, whatever their rank: the wide K1 and its
    # merge, and the first schedule's instance that ran it before
    for sub in PROFILE_WATCH:
        hits = [e for e in events if sub in e.key]
        got = (f"{sum(e.self_device_time_total for e in hits) / 1e3:.1f} ms "
               f"in {sum(e.count for e in hits)} launches" if hits
               else "absent")
        print(f"    watched {sub}: {got}", flush=True)
    os.makedirs(out_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(out_dir, f"{label}_trace.json"))


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--profile", metavar="DIR",
                        help="also profile one generation of each full-width "
                        "path; traces into DIR")
    parser.add_argument("--vsa-steps", type=int, default=4,
                        help="FlowUniPC steps of the 480x848 VSA generation "
                        "(at least 4, so that the order-2 corrector runs)")
    parser.add_argument("--sta-steps", type=int, default=2,
                        help="FlowUniPC steps of the 480x848 STA generation "
                        "(at least 2)")
    parser.add_argument("--train-steps", type=int, default=1,
                        help="timed SFT steps of phase 4i, after one "
                        "warm-up step (at least 1)")
    parser.add_argument("--df-steps", type=int, default=1,
                        help="timed dfsft and tfsft steps of phases 4l and "
                        "4m, each after one warm-up step (at least 1)")
    parser.add_argument("--dmd-steps", type=int, default=1,
                        help="timed DMD2 steps of phase 4n, after one "
                        "warm-up step (at least 1)")
    parser.add_argument("--flex-struct", action="store_true",
                        help="also time compiled flex_attention beside K1 "
                        "struct and K6 struct in phase 3 (about 90 s)")
    args = parser.parse_args()
    if (args.vsa_steps < 4 or args.sta_steps < 2 or args.train_steps < 1
            or args.df_steps < 1 or args.dmd_steps < 1):
        parser.error("--vsa-steps must be at least 4, --sta-steps 2, "
                     "--train-steps 1, --df-steps 1 and --dmd-steps 1")

    import torch

    t_start = time.perf_counter()

    def phase(title: str) -> None:
        print(f"{title} [{time.perf_counter() - t_start:.0f} s in]",
              flush=True)

    phase(f"# phase 1: environment: python {sys.version.split()[0]}, torch "
          f"{torch.__version__}, cuda {torch.version.cuda}")
    if not torch.cuda.is_available():
        print("no CUDA device: chip_smoke.py needs an H100", file=sys.stderr)
        return 1
    card = card_line()
    print(f"  card: {card}; devices: {torch.cuda.device_count()}", flush=True)
    dev = torch.device("cuda", 0)

    from fastvideo_tpu_torch.ops import _build

    phase("# phase 2: kernel build")
    paths = _build.build_all()
    print(f"  built {sorted(paths)} in {_build.BUILD_SECONDS:.1f} s "
          f"(nvcc, sm_90a, in parallel)", flush=True)
    report_sm90_build()

    phase("# phase 3: kernel checks at the main path's shapes")
    results = run_kernel_checks(dev, args.flex_struct)
    _build.reset_counts()

    work = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                        "chip_smoke")
    shutil.rmtree(work, ignore_errors=True)
    phase("# phase 4a: tiny models, card against the plain path")
    check_small_paths(work)
    check_small_training(work)
    check_small_df_training(work)
    check_small_dmd2(work)
    check_small_self_forcing(work)
    check_small_slice(work)
    check_small_rl_slice(work)
    phase("# phase 4b: FastWan main path at full width, 81x480x832, 3 DMD "
          "steps, VSA sparsity 0.8")
    launches = run_main_path(work, args.profile)
    results["conv3d"]["fp32_decode"] = launches.pop("fp32_decode")
    # K1's fp32 form and its pre-pass run in 4b's fp32 decode
    for name in ("flash_fwd_tf32", "flash_fwd_tf32_split"):
        launches[name] = results["conv3d"]["fp32_decode"][f"{name}_launches"]
    results["flash_fwd_tf32"]["fp32_decode_s"] = results["conv3d"][
        "fp32_decode"]["decode_s"]
    phase(f"# phase 4c: Wan2.1-T2V-1.3B at full width and depth, 81x480x848, "
          f"{args.vsa_steps} FlowUniPC steps with CFG, VSA sparsity 0.8 on "
          f"padded tiles")
    vsa_launches = run_wan_path(work, "VIDEO_SPARSE_ATTN", args.vsa_steps,
                                dict(VSA_sparsity=0.8), args.profile)
    phase(f"# phase 4d: the same with SLIDING_TILE_ATTN, {args.sta_steps} "
          f"steps")
    sta_launches = run_wan_path(work, "SLIDING_TILE_ATTN", args.sta_steps, {},
                                args.profile)
    phase("# phase 4e: FastWan int8 serving at 81x480x832: UMT5 int8 "
          "weight-only (quantized at load), W8A8 DiT linears, auto_int8 "
          "decode convs")
    int8_launches = run_int8_fastwan(work, args.profile)
    phase(f"# phase 4f: TurboDiffusion T2V 1.3B at 61x480x832, "
          f"{TURBO_STEPS} rCM steps, SLA_ATTN top 10 %, W8A8 DiT linears, "
          f"auto_int8 decode")
    turbo_launches = run_turbo_path(work, args.profile)
    os.environ.pop("FASTVIDEO_VAE_CONV3D", None)
    phase(f"# phase 4g: causal Wan 1.3B (self-forcing) at full width and "
          f"depth, 81x480x832 through WanCausalDMDPipeline, {CAUSAL_STEPS} "
          f"steps a block, K5 over the 21-frame KV window")
    causal_launches, causal_gen = run_causal_path(work, args.profile)
    with open(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "benchmarks", "causal_streaming.json")) as fh:
        spec = json.load(fh)
    phase(f"# phase 4h: StreamingVideoGenerator on 4g's modules, "
          f"{STREAM_BLOCKS} blocks at 480x832, prompt from "
          f"benchmarks/causal_streaming.json")
    stream_launches, stream = run_streaming(causal_gen, spec)
    del causal_gen
    phase(f"# phase 4i: SFT training of Wan2.1-T2V-1.3B at full width and "
          f"depth (the JAX repo's sft_33k cell: 81x480x832 latents, 512 text "
          f"tokens, VSA 0.8, full remat, AdamW, fp32 master weights): 1 "
          f"warm-up + {args.train_steps} timed steps")
    train = run_training(work, args.train_steps, args.profile)
    remat_ops = run_ops_step(work)
    phase(f"# phase 4j: Wan2.1-T2V-1.3B at full width and depth, 81x480x848 "
          f"with BSA_ATTN (K9b), {K9_STEPS} FlowUniPC steps with CFG")
    bsa_run = run_wan_path(work, "BSA_ATTN", K9_STEPS, {}, args.profile,
                           kernel="dyn_sparse_qtile_fwd")
    phase(f"# phase 4k: the same at 61x480x832 with NABLA_ATTN (K9a), "
          f"{K9_STEPS} steps")
    nabla_run = run_wan_path(work, "NABLA_ATTN", K9_STEPS, {}, args.profile,
                             size=TURBO_SIZE, kernel="dyn_sparse_fwd")
    df_runs = {}
    for letter, method, what in (
            ("l", "dfsft", "diffusion forcing, the chunk-causal mask"),
            ("m", "tfsft", "teacher forcing, [clean | noisy] over 65,520 "
             "tokens")):
        phase(f"# phase 4{letter}: {method} ({what}) of CausalWan-1.3B at "
              f"full width and depth on 4g's checkpoint (81x480x832 latents, "
              f"3-frame chunks, 512 text tokens, full remat, AdamW, fp32 "
              f"master weights): 1 warm-up + {args.df_steps} timed steps")
        df_runs[method] = run_df_training(work, method, args.df_steps,
                                          args.profile)
    phase(f"# phase 4n: DMD2 distillation of Wan2.1-T2V-1.3B at full width "
          f"and depth (method dmd2 through build_from_config: the 4b "
          f"checkpoint's DiT as generator, real and fake score in fp32 "
          f"masters, full remat, AdamW, a generator and a critic update a "
          f"step, VSA at sparsity 0) on a Parquet shard the port writes and "
          f"reads: 1 warm-up + {args.dmd_steps} timed steps")
    dmd2 = run_dmd2(work, args.dmd_steps, args.profile)
    data = os.path.join(work, "dmd2_data")
    causal = ("4g's CausalWan-1.3B checkpoint as every role, fp32 masters, "
              "full remat, AdamW, on 4n's Parquet shard (81x480x832 "
              "latents, 512 text tokens)")
    phase(f"# phase 4o: self_forcing distillation of CausalWan-1.3B at full "
          f"width and depth ({causal}): 7 blocks, denoise steps "
          f"{SF_METHOD['denoise_steps']}, a generator and a critic update a "
          f"step: 1 warm-up + {SF_STEPS} timed steps")
    sf = run_self_forcing(work, data, args.profile)
    phase(f"# phase 4p: streaming_long_tuning of CausalWan-1.3B ({causal}): "
          f"a stream from step 0 in chunks of at most 6 latent frames up to "
          f"27, past the 21-frame window, until it starts over")
    stream_run = run_streaming_long(work, data, args.profile)
    phase(f"# phase 4q: causal_cd of CausalWan-1.3B ({causal}) under "
          f"FLASH_ATTN: N {CD_METHOD['discrete_cd_N']}, guidance "
          f"{CD_METHOD['guidance_scale']}, the EMA from step 0: 1 warm-up + "
          f"{CD_STEPS} timed steps")
    cd = run_causal_cd(work, data, args.profile)
    phase("# phase 4r: LoRA serving on 4b's checkpoint and prompt: a rank-32 "
          "adapter (official names under diffusion_model.) on the 300 block "
          "linears through VideoGenerator.set_lora_adapter, then merge and "
          "unmerge; the base, active, merged and unmerged generations, each "
          "timed after a warm-up")
    lora_serving = run_lora_serving(work, args.profile)
    wan = ("the 4b checkpoint's Wan2.1-T2V-1.3B-shaped DiT in fp32 masters, "
           "full remat, AdamW, on 4n's shard (81x480x832 latents, 512 text "
           "tokens)")
    phase(f"# phase 4s: lora_finetune ({wan}), rank {LORA_RANK} on the "
          f"default targets, VSA 0.8: 1 warm-up + {METHOD_STEPS} timed")
    lora_run = run_lora_finetune(work, data, args.profile)
    phase(f"# phase 4t: kd ({wan}), t_list {list(KD_T_LIST)}, a "
          f"self-distillation teacher, the cache path (generate_cache over "
          f"the shard, then steps from the cache), sparsity 0: 1 warm-up + "
          f"{METHOD_STEPS} timed")
    kd = run_kd(work, data, args.profile)
    phase(f"# phase 4u: anyflow_pretrain ({wan}), the r_embedder grown on a "
          f"checkpoint without delta weights (the copy rule), VSA 0.8: 1 "
          f"warm-up + {METHOD_STEPS} timed")
    pretrain = run_anyflow_pretrain(work, data, args.profile)
    phase(f"# phase 4v: anyflow at 4n's setup ({wan}, the branch on all "
          f"three roles), a {len(ANYFLOW_METHOD['t_list_override']) - 1}-"
          f"step flow-map rollout, a generator and a critic update a step, "
          f"sparsity 0: 1 warm-up + {METHOD_STEPS} timed")
    anyflow = run_anyflow(work, data, args.profile)
    phase(f"# phase 4w: diffusion_nft ({wan.split(', on')[0]}; old and ref "
          f"as frozen copies) through build_from_config: 1 prompt x "
          f"{NFT_METHOD['num_video_per_prompt']} videos at 81x480x832 "
          f"latents, {NFT_SAMPLE_STEPS} sampling steps, the 4b VAE as "
          f"decode_fn, CLIPScore and PickScore on a random CLIP dual tower "
          f"(ViT-L/14 vision, CLIP-L text projected to 1024), sparsity 0: 1 "
          f"warm-up + 1 timed")
    nft = run_diffusion_nft(work, args.profile)
    shutil.rmtree(work, ignore_errors=True)
    # each kernel's count comes from the path that runs it
    launches["vsa_sparse_padded_fwd"] = vsa_launches["vsa_sparse_padded_fwd"]
    results["vsa_sparse_padded_fwd"]["sta_launches"] = sta_launches[
        "vsa_sparse_padded_fwd"]
    results["vsa_sparse_padded_fwd"]["sla_launches"] = turbo_launches[
        "vsa_sparse_padded_fwd"]
    launches["conv3d_int8"] = int8_launches["conv3d_int8"]
    results["flash_fwd"]["vae_attention_launches"] = launches[
        "flash_fwd_combine"]
    results["conv3d_int8"]["turbo_launches"] = turbo_launches["conv3d_int8"]
    launches["flash_fwd_kv_mask"] = causal_launches["flash_fwd_kv_mask"]
    results["flash_fwd_kv_mask"].update(
        stream_launches=stream_launches["flash_fwd_kv_mask"],
        steady_block_s=stream["steady_block_s"],
        steady_fps=stream["steady_fps"])
    results["flash_fwd"]["causal_launches"] = causal_launches["flash_fwd"]
    # the backward kernels' counts come from 4i, as do the training counts
    # of K1 and of K7's LSE forward
    for name in ("flash_bwd_dq", "flash_bwd_dkv", "flash_bwd_dkv_reduce",
                 "vsa_sparse_bwd_dq", "vsa_sparse_bwd_dkv"):
        launches[name] = train["launches"][name]
        results[name]["train_step_s"] = train["step_s"]
    results["flash_fwd"]["train_launches"] = train["launches"]["flash_fwd"]
    results["vsa_sparse_padded_fwd"]["train_lse_launches"] = train[
        "launches"]["vsa_sparse_padded_fwd"]
    results["conv3d"]["causal_launches"] = causal_launches["conv3d"]
    # K9b's count from 4j, K9a's from 4k
    for name, run in (("dyn_sparse_qtile_fwd", bsa_run),
                      ("dyn_sparse_fwd", nabla_run)):
        launches[name] = run[name]
        results[name].update(path_kept_fraction=run["kept_fraction"],
                             path_step_s=run["step_s"])
    # the struct kernels' counts come from 4l, tfsft's beside them
    for name in ("flash_fwd_struct", "flash_bwd_struct_dq",
                 "flash_bwd_struct_dkv"):
        launches[name] = df_runs["dfsft"]["launches"][name]
        results[name].update(
            dfsft_step_s=df_runs["dfsft"]["step_s"],
            tfsft_launches=df_runs["tfsft"]["launches"][name],
            tfsft_step_s=df_runs["tfsft"]["step_s"])
    # DMD2's launches a step and seconds a step, from 4n
    for name in ("flash_fwd", "vsa_sparse_fwd", "vsa_sparse_padded_fwd",
                 "flash_bwd_dq", "flash_bwd_dkv", "flash_bwd_dkv_reduce",
                 "vsa_sparse_bwd_dq", "vsa_sparse_bwd_dkv"):
        results[name].update(
            dmd2_launches=dmd2["launches"][name] // args.dmd_steps,
            dmd2_step_s=dmd2["step_s"])
    # the causal distillation methods' launches a step and seconds a step,
    # from 4o (self_forcing), 4p (streaming_long_tuning: the timed steps'
    # sum) and 4q (causal_cd)
    for key, run, per in (("self_forcing", sf, SF_STEPS),
                          ("streaming", stream_run, 1),
                          ("causal_cd", cd, CD_STEPS)):
        for name, n in run["launches"].items():
            if n:
                results[name].update({f"{key}_launches": n // per,
                                      f"{key}_step_s": run["step_s"],
                                      f"{key}_peak_gib": run["peak_gib"]})
    results["flash_fwd_kv_mask"]["streaming_steps"] = len(
        stream_run["step_times"])
    # LoRA serving's launches a generation (4r), and the slice's methods'
    # launches, seconds and peak memory a step (4s-4v)
    for name, n in lora_serving["launches"].items():
        if n:
            results[name]["lora_serving_launches"] = n
    for key, run in (("lora_finetune", lora_run), ("kd", kd),
                     ("anyflow_pretrain", pretrain), ("anyflow", anyflow)):
        for name, n in run["launches"].items():
            if n:
                results[name].update({f"{key}_launches": n // METHOD_STEPS,
                                      f"{key}_step_s": run["step_s"],
                                      f"{key}_peak_gib": run["peak_gib"]})
    for name, n in kd["rollout_launches"].items():
        if n:
            results[name].update(kd_rollout_launches=n,
                                 kd_rollout_s=kd["rollout_s"])
    # DiffusionNFT's launches, seconds and peak memory a step (4w), and the
    # "ops" step's at 4i's shape
    for name, n in nft["launches"].items():
        if n:
            results[name].update(diffusion_nft_launches=n,
                                 diffusion_nft_step_s=nft["step_s"],
                                 diffusion_nft_peak_gib=nft["peak_gib"])
    for name, n in remat_ops["launches"].items():
        if n:
            results[name].update(remat_ops_launches=n,
                                 remat_ops_step_s=remat_ops["step_s"],
                                 remat_ops_peak_gib=remat_ops["peak_gib"])
    phase("# phase 5: the kernels line, the card line, the result line")

    kernels = []
    for name in _build.KERNELS:
        r = results[name]
        kernels.append({
            "name": name, "route": "cuda", "source": SOURCES[name],
            "replaces": REPLACES[name], "launches": launches[name], **r})
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
