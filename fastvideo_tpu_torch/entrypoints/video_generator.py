"""VideoGenerator: the user-facing entry point (port of
fastvideo_tpu/entrypoints/video_generator.py).

    gen = VideoGenerator.from_pretrained(ckpt, VSA_sparsity=0.8)
    result = gen.generate_video("a prompt", height=480, width=832,
                                num_frames=81, seed=42)

A FastWan checkpoint runs the 3-step DMD sampler; a Wan2.1 T2V checkpoint
runs ``num_inference_steps`` FlowUniPC steps with classifier-free guidance
(``negative_prompt``, ``guidance_scale``); a TurboDiffusion checkpoint runs
1-4 rCM steps. An I2V checkpoint (``WanImageToVideoPipeline``, and
TurboDiffusion I2V) takes ``image_path`` (a PNG or a ``.npy`` image) or
``pil_image``, which in the port is the image itself as a uint8 [H, W, 3]
array (the card's machine has no PIL); a V2V checkpoint
(``WanVideoToVideoPipeline``) takes ``video_path`` (a ``.npy`` [T, H, W,
3] clip) or the frames as ``video=``. ``from_pretrained(...,
transformer_quant="int8",
text_encoder_quant="int8-weight-only")`` serves the int8 forms, and
``FASTVIDEO_VAE_CONV3D=auto_int8`` the int8 decode convs.
``set_lora_adapter(nickname, path)`` attaches a LoRA adapter
(``gen.pipeline.merge_lora_weights()`` / ``unmerge_lora_weights()`` fold it
in and out); ``lora_path`` is stored and not applied, as in JAX.

It runs on the CUDA card unless the caller passes ``device="cpu"``; with
no CUDA device and no ``device`` it raises. ``num_gpus`` > 1 spreads a
generation over that many cards (``sp_size``, ``tp_size``, ``dp_size``;
by default sp takes them all, as in the JAX package) through worker
processes, one a card (``worker/executor.py``); the frames come back from
rank 0. Under torchrun each process builds its own share instead.
``shutdown()`` stops the workers.
"""

from __future__ import annotations

import dataclasses
import logging
import os
import time
from typing import Any

import numpy as np
import torch

from fastvideo_tpu_torch.configs.pipelines.wan import WanT2V480PConfig
from fastvideo_tpu_torch.configs.sample import SamplingParam
from fastvideo_tpu_torch.fastvideo_args import FastVideoArgs
from fastvideo_tpu_torch.pipelines.batch import ForwardBatch
from fastvideo_tpu_torch.registry import get_pipeline_config_cls_for_name
from fastvideo_tpu_torch.worker.executor import Executor

logger = logging.getLogger(__name__)


def resolve_device(device: str | torch.device | None) -> torch.device:
    """``None`` means the CUDA card; a CUDA device must exist."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available: pass device=\"cpu\" to run the "
                "port on the CPU")
        return torch.device("cuda", torch.cuda.current_device())
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device!r} requested but no CUDA device "
                           "is available")
    return dev


def video_uint8(output: torch.Tensor) -> torch.Tensor:
    """[B, C, T, H, W] in [-1, 1] -> uint8 [B, C, T, H, W] on the host."""
    return ((output.clamp(-1, 1) + 1) / 2 * 255).round().to(
        torch.uint8).cpu()


def frames_uint8(output: torch.Tensor) -> list[np.ndarray]:
    """[B, C, T, H, W] in [-1, 1], or ``video_uint8``'s, -> list of
    [T, H, W, C] uint8 (views of the host video)."""
    video = output if output.dtype == torch.uint8 else video_uint8(output)
    return [v.permute(1, 2, 3, 0).numpy() for v in video]


class VideoGenerator:

    def __init__(self, fastvideo_args: FastVideoArgs, executor: Executor,
                 device: torch.device):
        self.fastvideo_args = fastvideo_args
        self.executor = executor
        self.device = device

    @property
    def pipeline(self):
        """The pipeline in this process (None behind worker processes)."""
        return self.executor.pipeline

    @classmethod
    def from_pretrained(cls, model_path: str, *,
                        device: str | torch.device | None = None,
                        num_gpus: int = 1, **kwargs) -> "VideoGenerator":
        """Load a diffusers-format checkpoint. Keyword arguments that name a
        PipelineConfig field (e.g. ``precision``) set it; the rest go to
        FastVideoArgs (e.g. ``VSA_sparsity``, ``sp_size``). A CUDA run
        asking for more cards than the machine has raises (in the worker
        processes' executor)."""
        dev = resolve_device(device)
        config_cls = get_pipeline_config_cls_for_name(model_path)
        if config_cls is None:
            logger.warning("No registered pipeline config for %s; defaulting "
                           "to Wan T2V", model_path)
            config_cls = WanT2V480PConfig
        pipeline_config = config_cls(model_path=model_path)
        pc_fields = {f.name for f in dataclasses.fields(pipeline_config)}
        for k in list(kwargs):
            if k in pc_fields:
                setattr(pipeline_config, k, kwargs.pop(k))
        args = FastVideoArgs.from_kwargs(model_path=model_path,
                                         num_gpus=num_gpus, device=str(dev),
                                         **kwargs)
        args.pipeline_config = pipeline_config
        return cls(args, Executor.get_class(args)(args, dev), dev)

    def generate_video(self, prompt: str | list[str] | None = None,
                       sampling_param: SamplingParam | None = None,
                       **kwargs) -> dict[str, Any]:
        """Returns ``frames`` (one [T, H, W, 3] uint8 array per video),
        ``latents``, ``stage_times`` (seconds by stage class name),
        ``generation_time`` (seconds) and ``forward_time`` (the pipeline's
        seconds where it ran: a worker's, behind worker processes)."""
        t0 = time.perf_counter()
        param = sampling_param or SamplingParam()
        if prompt is not None:
            kwargs["prompt"] = prompt
        param.update(kwargs)
        dmd_steps = param.dmd_denoising_steps
        if dmd_steps is None and self.fastvideo_args.pipeline_config is not None:
            dmd_steps = self.fastvideo_args.pipeline_config.dmd_denoising_steps
        batch = ForwardBatch(
            prompt=param.prompt, negative_prompt=param.negative_prompt,
            image_path=param.image_path,
            video_path=(param.video_path if isinstance(param.video_path, str)
                        else (param.video_path or [None])[0]),
            pil_image=param.pil_image,
            height=param.height, width=param.width,
            num_frames=param.num_frames, seed=param.seed,
            num_inference_steps=param.num_inference_steps,
            guidance_scale=param.guidance_scale,
            guidance_rescale=param.guidance_rescale,
            dmd_denoising_steps=dmd_steps,
            return_trajectory_latents=param.return_trajectory_latents,
            extra=dict(param.extra))
        batch.extra["num_videos_per_prompt"] = param.num_videos_per_prompt
        t_forward = time.perf_counter()
        batch = self.executor.execute_forward(batch, self.fastvideo_args)
        forward_time = batch.extra.pop("worker_forward_s",
                                       time.perf_counter() - t_forward)
        video = batch.extra.pop("video_uint8", None)
        frames = frames_uint8(batch.output if video is None else video)
        result: dict[str, Any] = {
            "prompts": param.prompt,
            "frames": frames,
            "latents": batch.latents,
            "stage_times": batch.logging_info.stage_times,
            "generation_time": time.perf_counter() - t0,
            "forward_time": forward_time,
        }
        if batch.return_trajectory_latents:
            result["trajectory_latents"] = batch.trajectory_latents
            result["trajectory_timesteps"] = batch.trajectory_timesteps
        if param.save_video:
            result["video_path"] = self.save_video(frames[0], param)
        if param.return_frames:
            return frames
        return result

    def set_lora_adapter(self, lora_nickname: str,
                         lora_path: str | None = None) -> None:
        """Load and attach a LoRA adapter to the pipeline's DiT (merge and
        unmerge through ``self.pipeline``)."""
        self.executor.set_lora_adapter(lora_nickname, lora_path)

    def shutdown(self) -> None:
        """Stop the executor (and its worker processes)."""
        self.executor.shutdown()

    @staticmethod
    def save_video(frames: np.ndarray, param: SamplingParam) -> str:
        """Write the frames as ``<name>.npy`` (no video encoder needed)."""
        os.makedirs(param.output_path, exist_ok=True)
        name = param.output_video_name
        if not name:
            prompt = (param.prompt if isinstance(param.prompt, str) else
                      (param.prompt or ["video"])[0])
            name = "".join(c if c.isalnum() or c in " _-" else ""
                           for c in prompt)[:100].strip() or "video"
        path = os.path.join(param.output_path, f"{name}.npy")
        np.save(path, frames)
        logger.info("Saved frames to %s", path)
        return path
