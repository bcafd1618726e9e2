"""The port's ``fastvideo`` CLI (port of
fastvideo_tpu/entrypoints/cli/main.py): ``generate``, ``preprocess`` and
``train``.

    python -m fastvideo_tpu_torch.entrypoints.cli.main preprocess \\
        --model-path CKPT --data-path DATA --output-dir OUT [--device cpu]

Every subcommand runs on the CUDA card unless ``--device`` names another
device. ``serve``, ``bench``, ``router-serve``, ``dashboard``, ``studio``
and ``dreamverse`` are not ported yet (the JAX CLI has them).
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import sys

logger = logging.getLogger(__name__)


def _add_device(p: argparse.ArgumentParser) -> None:
    p.add_argument("--device", default=None,
                   help="torch device to run on (default: the CUDA card)")


def _add_generate(sub: argparse._SubParsersAction) -> None:
    p = sub.add_parser("generate", help="Generate a video from a prompt")
    p.add_argument("--model-path", required=True)
    p.add_argument("--prompt", required=True)
    p.add_argument("--negative-prompt", default=None)
    p.add_argument("--height", type=int, default=480)
    p.add_argument("--width", type=int, default=832)
    p.add_argument("--num-frames", type=int, default=81)
    p.add_argument("--num-inference-steps", type=int, default=50)
    p.add_argument("--guidance-scale", type=float, default=5.0)
    p.add_argument("--seed", type=int, default=1024)
    p.add_argument("--fps", type=int, default=16)
    p.add_argument("--output-path", default="outputs/")
    p.add_argument("--num-gpus", type=int, default=1)
    p.add_argument("--sp-size", type=int, default=1)
    p.add_argument("--tp-size", type=int, default=1)
    p.add_argument("--attention-backend", default=None)
    _add_device(p)
    p.set_defaults(func=_cmd_generate)


def _cmd_generate(args: argparse.Namespace) -> int:
    from fastvideo_tpu_torch import VideoGenerator

    if args.attention_backend:
        os.environ["FASTVIDEO_ATTENTION_BACKEND"] = args.attention_backend
    gen = VideoGenerator.from_pretrained(
        args.model_path, device=args.device, num_gpus=args.num_gpus,
        sp_size=args.sp_size, tp_size=args.tp_size)
    kwargs = dict(height=args.height, width=args.width,
                  num_frames=args.num_frames,
                  num_inference_steps=args.num_inference_steps,
                  guidance_scale=args.guidance_scale, seed=args.seed,
                  fps=args.fps, output_path=args.output_path)
    if args.negative_prompt:
        kwargs["negative_prompt"] = args.negative_prompt
    result = gen.generate_video(args.prompt, **kwargs)
    logger.info("Done: %s", result.get("video_path"))
    return 0


def _add_preprocess(sub: argparse._SubParsersAction) -> None:
    p = sub.add_parser(
        "preprocess",
        help="Encode a video+caption dataset into training parquet")
    p.add_argument("--model-path", required=True,
                   help="diffusers checkpoint providing vae + text encoder")
    p.add_argument("--data-path", default=None,
                   help="dataset dir with videos.jsonl "
                        "({'path','caption'} per line) or .npy clips + "
                        "<name>.txt captions")
    p.add_argument("--data-merge-path", default=None,
                   help="<folder>,<annotations.json> merge file driving the "
                        "staged VideoCaptionMergedDataset (validation + fps "
                        "resample + transform + CFG caption dropout)")
    p.add_argument("--train-fps", type=float, default=16.0)
    p.add_argument("--max-height", type=int, default=480)
    p.add_argument("--max-width", type=int, default=832)
    p.add_argument("--training-cfg-rate", type=float, default=0.0)
    p.add_argument("--drop-short-ratio", type=float, default=0.0)
    p.add_argument("--output-dir", required=True)
    p.add_argument("--num-frames", type=int, default=None)
    p.add_argument("--samples-per-file", type=int, default=64)
    p.add_argument("--fps", type=float, default=16.0)
    p.add_argument("--workload", choices=("t2v", "i2v", "ode"),
                   default="t2v",
                   help="t2v: video+caption records; i2v: + first-frame "
                        "CLIP feature and VAE latent; ode: teacher "
                        "denoising trajectories from text-only captions")
    p.add_argument("--ode-steps", type=int, default=48,
                   help="teacher solver steps recorded per trajectory")
    p.add_argument("--ode-guidance-scale", type=float, default=6.0)
    p.add_argument("--ode-height", type=int, default=480)
    p.add_argument("--ode-width", type=int, default=832)
    p.add_argument("--ode-num-frames", type=int, default=81)
    _add_device(p)
    p.set_defaults(func=_cmd_preprocess)


_VIDEO_EXTS = (".mp4", ".mkv", ".webm", ".avi", ".mov", ".npy")


def _iter_preprocess_samples(data_path: str):
    jsonl = os.path.join(data_path, "videos.jsonl")
    if os.path.exists(jsonl):
        with open(jsonl) as fh:
            for line in fh:
                if not line.strip():
                    continue
                row = json.loads(line)
                path = row["path"]
                if not os.path.isabs(path):
                    path = os.path.join(data_path, path)
                yield {"id": row.get("id", os.path.basename(path)),
                       "video_path": path,
                       "caption": row.get("caption", "")}
        return
    for name in sorted(os.listdir(data_path)):
        if not name.lower().endswith(_VIDEO_EXTS):
            continue
        stem = os.path.splitext(name)[0]
        cap_file = os.path.join(data_path, stem + ".txt")
        caption = ""
        if os.path.exists(cap_file):
            with open(cap_file) as fh:
                caption = fh.read().strip()
        yield {"id": stem, "video_path": os.path.join(data_path, name),
               "caption": caption}


def _iter_text_samples(data_path: str):
    """Text-only records for ODE-trajectory collection: prompts.txt (one
    caption per line) or the captions of a videos.jsonl dataset."""
    txt = os.path.join(data_path, "prompts.txt")
    if os.path.exists(txt):
        with open(txt) as fh:
            for i, line in enumerate(fh):
                if line.strip():
                    yield {"id": f"prompt{i}", "caption": line.strip()}
        return
    for sample in _iter_preprocess_samples(data_path):
        yield {"id": sample["id"], "caption": sample.get("caption", "")}


def build_preprocess_pipeline(args: argparse.Namespace):
    """(the pipeline of ``args.workload`` on the checkpoint's modules, its
    tokenizer), on ``args.device`` (the CUDA card by default)."""
    from fastvideo_tpu_torch.configs.pipelines.wan import WanT2V480PConfig
    from fastvideo_tpu_torch.entrypoints.video_generator import (
        resolve_device)
    from fastvideo_tpu_torch.models.loader.component_loader import (
        PipelineComponentLoader, load_tokenizer)
    from fastvideo_tpu_torch.registry import (
        get_pipeline_config_cls_for_name)

    device = resolve_device(args.device)
    config_cls = (get_pipeline_config_cls_for_name(args.model_path)
                  or WanT2V480PConfig)
    pipeline_config = config_cls(model_path=args.model_path)

    def load(name: str):
        return PipelineComponentLoader.load_module(
            name, os.path.join(args.model_path, name), pipeline_config,
            device)

    vae, text_encoder = load("vae"), load("text_encoder")
    tokenizer = load_tokenizer(os.path.join(args.model_path, "tokenizer"))
    workload = args.workload
    if workload == "i2v":
        from fastvideo_tpu_torch.pipelines.preprocess.\
            preprocess_pipeline_i2v import PreprocessPipelineI2V

        image_encoder = (load("image_encoder") if os.path.isdir(
            os.path.join(args.model_path, "image_encoder")) else None)
        pipeline = PreprocessPipelineI2V(
            vae, text_encoder, tokenizer, image_encoder=image_encoder,
            samples_per_file=args.samples_per_file)
    elif workload == "ode":
        from fastvideo_tpu_torch.pipelines.preprocess.\
            preprocess_pipeline_ode import PreprocessPipelineODE

        arch = vae.config
        latent_shape = (
            arch.z_dim, (args.ode_num_frames - 1) // arch.scale_factor_temporal
            + 1, args.ode_height // arch.scale_factor_spatial,
            args.ode_width // arch.scale_factor_spatial)
        pipeline = PreprocessPipelineODE(
            vae, text_encoder, tokenizer, load("transformer"),
            num_inference_steps=args.ode_steps,
            guidance_scale=args.ode_guidance_scale,
            latent_shape=latent_shape,
            samples_per_file=args.samples_per_file)
    else:
        from fastvideo_tpu_torch.pipelines.preprocess.preprocess_pipeline \
            import PreprocessPipeline

        pipeline = PreprocessPipeline(vae, text_encoder, tokenizer,
                                      samples_per_file=args.samples_per_file)
    return pipeline, tokenizer


def _cmd_preprocess(args: argparse.Namespace) -> int:
    merged = bool(args.data_merge_path) and args.workload != "ode"
    if args.data_path is None and not merged:
        raise SystemExit("preprocess: --data-path or --data-merge-path "
                         "is required")
    pipeline, tokenizer = build_preprocess_pipeline(args)
    if args.workload == "ode":
        samples = _iter_text_samples(args.data_path)
    elif merged:
        from fastvideo_tpu_torch.dataset.preprocessing import (
            PreprocessDatasetArgs, VideoCaptionMergedDataset)

        ds_args = PreprocessDatasetArgs(
            num_frames=args.num_frames or 81, train_fps=args.train_fps,
            max_height=args.max_height, max_width=args.max_width,
            training_cfg_rate=args.training_cfg_rate,
            drop_short_ratio=args.drop_short_ratio)
        samples = VideoCaptionMergedDataset(args.data_merge_path, ds_args,
                                            tokenizer=tokenizer)
    else:
        samples = _iter_preprocess_samples(args.data_path)
    n = pipeline.run(samples, args.output_dir, fps=args.fps)
    logger.info("Wrote %d %s samples to %s (%s)", n, args.workload,
                args.output_dir, json.dumps(pipeline.stats))
    return 0


def _add_train(sub: argparse._SubParsersAction) -> None:
    p = sub.add_parser("train", help="Run YAML-configured training")
    p.add_argument("--config", required=True)
    p.add_argument("--resume", action="store_true")
    p.set_defaults(func=_cmd_train)


def _cmd_train(args: argparse.Namespace) -> int:
    from fastvideo_tpu_torch.entrypoints.cli.train import main as train_main

    argv = ["--config", args.config] + (["--resume"] if args.resume else [])
    return train_main(argv)


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(prog="fastvideo",
                                     description="fastvideo_tpu_torch CLI")
    sub = parser.add_subparsers(dest="command", required=True)
    _add_generate(sub)
    _add_preprocess(sub)
    _add_train(sub)
    args = parser.parse_args(argv)
    return args.func(args)


if __name__ == "__main__":
    sys.exit(main())
