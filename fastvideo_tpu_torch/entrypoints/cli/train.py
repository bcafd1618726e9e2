"""Training entry point (port of fastvideo_tpu/entrypoints/cli/train.py):

    python -m fastvideo_tpu_torch.entrypoints.cli.train --config cfg.yaml

The config tree (JSON, or the simple YAML subset of ``api/parser.py``;
unknown keys are errors):

    method: sft                 # or lora_finetune, kd, anyflow_pretrain,
                                # dmd2, anyflow, diffusion_nft; dfsft /
                                # tfsft, self_forcing,
                                # streaming_long_tuning, causal_cd (a
                                # causal checkpoint); or a dotted path to
                                # a TrainingMethod (fastvideo_tpu.* reads
                                # as fastvideo_tpu_torch.*)
    model:
      pretrained_model_path: /path/to/Diffusers-dir   # transformer/ inside
      dit_precision: fp32
    data:
      path: /path/to/parquet    # latents shards (data_00000.parquet ...)
      batch_size: 1
      text_drop_rate: 0.0
    training:                   # any TrainingArgs field
      learning_rate: 1e-5
      max_train_steps: 1000
      device: cuda              # or cpu
    dmd:                        # dmd2, anyflow, self_forcing,
                                # streaming_long_tuning
      dmd_denoising_steps: [1000, 757, 522]
      real_score_guidance_scale: 3.5
      dfake_gen_update_ratio: 5
      timestep_shift: 8.0
    method_config: {}           # dfsft / tfsft: chunk_size,
                                # min_timestep_ratio, max_timestep_ratio,
                                # precondition_outputs; self_forcing:
                                # denoise_steps; streaming_long_tuning:
                                # multi_phased_distill_schedule,
                                # streaming_chunk_size,
                                # streaming_max_length, num_latent_t,
                                # denoise_steps; causal_cd: discrete_cd_N,
                                # guidance_scale, ema_decay,
                                # ema_start_step, flow_shift;
                                # lora_finetune: rank, alpha,
                                # target_modules, init_seed; kd: t_list,
                                # teacher_model_path, teacher_path_cache;
                                # anyflow_pretrain: diffusion_ratio,
                                # consistency_ratio, epsilon, weight_type,
                                # shift, r_embedder_fusion,
                                # r_embedder_gate_value,
                                # r_embedder_deltatime_type; anyflow:
                                # student_sample_steps, t_list_override,
                                # use_mean_velocity, r_embedder_*;
                                # diffusion_nft: reward_fn, sampling,
                                # num_video_per_prompt, adv_clip_max,
                                # timestep_fraction, kl_beta, beta,
                                # decay_type, adv_mode, ema_decay
    callbacks: {}               # grad_clip, ema, validation or _target_

``method`` resolves through the plugin registry; ``data.path`` is read by
``dataset/parquet.py:build_parquet_dataloader`` (the port's own Parquet
reader).
"""

from __future__ import annotations

import argparse
import logging

from fastvideo_tpu_torch.training.run_config import (DataSpec, DMDSpec,
                                                     ModelSpec,
                                                     TrainRunConfig,
                                                     build_dataloader,
                                                     load_train_config)

logger = logging.getLogger(__name__)

__all__ = [
    "TrainRunConfig", "ModelSpec", "DataSpec", "DMDSpec",
    "load_train_config", "build_from_config", "main",
]


def build_from_config(cfg: TrainRunConfig):
    """Resolve the method plugin and build (method, dataloader)."""
    from fastvideo_tpu_torch.training.methods import resolve_method

    method_cls = resolve_method(cfg.method)
    method = method_cls.from_config(cfg)
    dataloader = build_dataloader(cfg, method.args)
    return method, dataloader


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser("fastvideo_tpu_torch train")
    parser.add_argument("--config", required=True,
                        help="YAML/JSON training config")
    parser.add_argument("--resume", action="store_true",
                        help="resume from the latest checkpoint")
    ns = parser.parse_args(argv)
    cfg = load_train_config(ns.config)
    method, dataloader = build_from_config(cfg)
    if ns.resume:
        method.resume_from_checkpoint()
    if dataloader is None:
        raise SystemExit("data.path is required to run training")
    logger.info("Starting %s training (%d steps)", cfg.method,
                method.args.max_train_steps)
    method.train(dataloader, callbacks=cfg.callbacks or None)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
