"""Time the port's decode convs K3 (bf16) and K4 (int8) at their main-path
shapes, on one card, for the checkout at --root:

    python3 scripts/torch_conv_instance_times.py --root DIR [--reps N]

Each row is one call of the public wrapper ``conv3d_ndhwc`` on bf16
tensors made from a seed, timed with CUDA events over N calls after a
warm-up, at the decoder's (models/vaes/wan.py) up3 resnet conv, 96 -> 96
channels, kt 3, the hottest conv of a decode:

- ``k3_up3_832``: a 2-latent-frame chunk at 480x832, x [1,10,480,832,96]
  (8 output frames behind 2 cached ones; FastWan, TurboDiffusion, the
  causal Wan);
- ``k3_up3_848``: the same at 480x848 (the Wan UniPC paths);
- ``k3_up3_stream``: the stream's one-latent-frame chunk, x
  [1,6,480,832,96];
- ``k3_up3_first``: the first latent frame alone, x [1,1,480,832,96] with
  2 pad frames in front;
- ``k3_conv_out_832``: conv_out, 96 -> 3 channels, on the 2-frame chunk;

and K4, ``conv3d_int8`` on the same conv's int8 operands (``k4_up3_832``:
xq [1,10,480,832,96], per-tensor and per-Co scales, as the ``auto_int8``
decode of 4e and 4f runs it) and at the stream's chunk
(``k4_up3_stream``); and, the same for every checkout, cuDNN's
``F.conv3d`` on the first row's inputs (``cudnn_up3_832``, the library
yardstick) and at the stream's chunk (``cudnn_up3_stream``), and the
per-tensor quantize pass of the int8 route on the first row's x
(``quantize_up3_832``, a control: plain PyTorch, unchanged).

K3's fp32 form (a decode with ``vae_decode_precision="fp32"``) at the
same conv on fp32 tensors: the 2-frame chunk (``k3_fp32_up3_832``) and the
first latent frame alone with its 2 pad frames (``k3_fp32_up3_first``),
beside cuDNN's fp32 ``F.conv3d`` with TF32 off (``cudnn_fp32_up3_832``,
``cudnn_fp32_up3_first``), and one whole fp32 decode of a [1, 16, 21,
60, 104] latent (81x480x832) by the port's VAE with its default init
from a seed, in the dispatched decode's chunks (``fp32_decode_832``, one
decode after a warm-up).

Prints one JSON line: the card and power limit, and each row's ms. Run it
for two checkouts in turns (A, B, B, A) inside one call to compare them on
one card, e.g. with the parent under build/parent:

    for r in build/parent . . build/parent; do
        python3 scripts/torch_conv_instance_times.py --root $r; done
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys


def events_ms(fn, reps: int) -> float:
    import torch

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


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--root", required=True,
                        help="checkout whose fastvideo_tpu_torch to time")
    parser.add_argument("--reps", type=int, default=5,
                        help="calls a row")
    args = parser.parse_args()
    sys.path.insert(0, os.path.abspath(args.root))
    import torch
    import torch.nn.functional as F

    from fastvideo_tpu_torch.ops import conv3d

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(15)
    bf = torch.bfloat16
    ms = {}

    def case(t, w, co, kt=3):
        x = torch.randn(1, t, 480, w, 96, generator=g, device=dev, dtype=bf)
        wt = (torch.randn(kt, 3, 3, 96, co, generator=g, device=dev) *
              (kt * 9 * 96)**-0.5).to(bf)
        b = torch.randn(co, generator=g, device=dev).to(bf)
        return x, wt, b

    def cudnn(x, wt, b, tp):
        xc = x.permute(0, 4, 1, 2, 3)  # NCDHW view, channels-last strides
        wc = wt.permute(4, 3, 0, 1, 2).contiguous(
            memory_format=torch.channels_last_3d)
        return lambda: F.conv3d(F.pad(xc, (0, 0, 0, 0, tp, 0)), wc, b,
                                padding=(0, 1, 1))

    for label, t, w, co, tp in (("k3_up3_832", 10, 832, 96, 0),
                                ("k3_up3_848", 10, 848, 96, 0),
                                ("k3_up3_stream", 6, 832, 96, 0),
                                ("k3_up3_first", 1, 832, 96, 2),
                                ("k3_conv_out_832", 10, 832, 3, 0)):
        x, wt, b = case(t, w, co)
        ms[label] = events_ms(lambda: conv3d.conv3d_ndhwc(
            x, wt, b, time_pad=tp), args.reps)
        if label in ("k3_up3_832", "k3_up3_stream"):
            ms[label.replace("k3", "cudnn")] = events_ms(
                cudnn(x, wt, b, tp), args.reps)
            xq, sx = conv3d.quantize_int8(x)
            wq, sw = conv3d.quantize_int8(wt, dims=(0, 1, 2, 3))
            scale = sw.reshape(-1) * sx.reshape(())
            ms[label.replace("k3", "k4")] = events_ms(
                lambda: conv3d.conv3d_int8(xq, wq, scale, b.float(),
                                           time_pad=tp, out_dtype=bf),
                args.reps)
            if label == "k3_up3_832":
                ms["quantize_up3_832"] = events_ms(
                    lambda: conv3d.quantize_int8(x), args.reps)
            del xq, wq
        del x, wt, b
        torch.cuda.empty_cache()

    gf = torch.Generator(device=dev).manual_seed(16)
    for label, t, tp in (("up3_832", 10, 0), ("up3_first", 1, 2)):
        x = torch.randn(1, t, 480, 832, 96, generator=gf, device=dev)
        wt = torch.randn(3, 3, 3, 96, 96, generator=gf, device=dev) * (
            27 * 96)**-0.5
        b = torch.randn(96, generator=gf, device=dev)
        ms[f"k3_fp32_{label}"] = events_ms(lambda: conv3d.conv3d_ndhwc(
            x, wt, b, time_pad=tp), args.reps)
        ms[f"cudnn_fp32_{label}"] = events_ms(cudnn(x, wt, b, tp), args.reps)
        del x, wt, b
        torch.cuda.empty_cache()

    from fastvideo_tpu_torch.configs.models.vaes.wan import WanVAEArchConfig
    from fastvideo_tpu_torch.models.vaes.wan import AutoencoderKLWan
    from fastvideo_tpu_torch.pipelines.stages.decoding import (
        dispatched_chunk_frames)

    torch.manual_seed(17)
    cfg = WanVAEArchConfig()
    vae = AutoencoderKLWan(cfg, device=dev, dtype=torch.float32)
    z = torch.randn(1, 16, 21, 60, 104, generator=gf, device=dev)
    chunk = dispatched_chunk_frames(z, cfg)
    with torch.no_grad():
        ms["fp32_decode_832"] = events_ms(
            lambda: vae.decode(z, chunk_frames=chunk), 1)
    del vae, z

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(json.dumps({"root": args.root, "card": card, "ms": ms}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
