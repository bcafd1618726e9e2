"""StreamingVideoGenerator: interactive block-by-block generation (port of
fastvideo_tpu/entrypoints/streaming_generator.py).

    gen = StreamingVideoGenerator(transformer, vae, text_encoder, tokenizer,
                                  FlowMatchEulerDiscreteScheduler(shift=5.0))
    gen.reset("a prompt")
    frames = gen.step()      # [T, H, W, 3] uint8, one block at a time
    total = gen.finalize()

It runs the causal Wan over its rolling KV caches (each block denoised with
the caches only read, then one clean pass that commits it) and decodes each
block one latent frame at a time through the VAE's carried conv cache. The
modules must already sit on ``device``, which is the CUDA card unless the
caller passes ``device="cpu"``. ``IncrementalVideoWriter`` appends frames in
the background; with no mp4 writer importable it buffers them and writes
``<path>.npy`` at close.
"""

from __future__ import annotations

import logging
import os
import queue
import threading

import numpy as np
import torch

from fastvideo_tpu_torch.entrypoints.video_generator import resolve_device
from fastvideo_tpu_torch.layers.rotary import get_rotary_pos_embed_wan
from fastvideo_tpu_torch.pipelines.stages.latent_preparation import (
    randn_like_reference)

logger = logging.getLogger(__name__)


def _to_uint8_frames(pixels: torch.Tensor) -> torch.Tensor:
    """[B, C, T, H, W] in [-1, 1] -> [T, H, W, C] uint8 on the same device
    (batch 0): round((clip(f) + 1) * 127.5), as the JAX streaming path."""
    f = pixels[0].clamp(-1.0, 1.0)
    f = ((f + 1.0) * 127.5).round().to(torch.uint8)
    return f.permute(1, 2, 3, 0)


class IncrementalVideoWriter:
    """Background appender: each chunk is written (and freed) as it
    arrives; with no mp4 writer importable the chunks are buffered and
    saved as ``<path>.npy`` at close."""

    def __init__(self, path: str, fps: int = 16):
        self.path = path
        self.fps = fps
        self._q: queue.Queue = queue.Queue()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self) -> None:
        writer = None
        fallback: list[np.ndarray] = []
        while True:
            item = self._q.get()
            if item is None:
                break
            if writer is None and not fallback:
                try:
                    import imageio.v2 as imageio

                    os.makedirs(os.path.dirname(self.path) or ".",
                                exist_ok=True)
                    writer = imageio.get_writer(self.path, fps=self.fps,
                                                macro_block_size=None)
                except Exception as e:
                    logger.warning("mp4 writer unavailable (%s); buffering "
                                   "to .npy", e)
            if writer is not None:
                try:
                    for f in item:
                        writer.append_data(f)
                    continue
                except Exception as e:
                    logger.warning("mp4 append failed: %s", e)
                    writer.close()
                    writer = None
            fallback.append(np.asarray(item))
        if writer is not None:
            writer.close()
        elif fallback:
            os.makedirs(os.path.dirname(self.path) or ".", exist_ok=True)
            np.save(self.path + ".npy", np.concatenate(fallback))

    def add_frames(self, frames: np.ndarray) -> None:
        self._q.put(frames)

    def close(self) -> None:
        self._q.put(None)
        self._thread.join()


class StreamingVideoGenerator:
    """reset / step / finalize over the causal Wan."""

    def __init__(self, transformer, vae, text_encoder=None, tokenizer=None,
                 scheduler=None, num_inference_steps: int = 3,
                 height: int = 480, width: int = 832, seed: int = 1024,
                 dtype: torch.dtype = torch.bfloat16,
                 device: str | torch.device | None = None):
        self.transformer = transformer
        self.vae = vae
        self.text_encoder = text_encoder
        self.tokenizer = tokenizer
        self.scheduler = scheduler
        self.num_inference_steps = num_inference_steps
        self.height = height
        self.width = width
        self.seed = seed
        self.dtype = dtype
        self.device = resolve_device(device)
        self._writer: IncrementalVideoWriter | None = None
        self._reset_state()

    def _reset_state(self) -> None:
        self.kv_caches = None
        self.vae_cache = None
        self.ctx = None
        self.ca_caches = None
        self.block_index = 0
        self.frames_emitted = 0

    @torch.inference_mode()
    def reset(self, prompt: str, output_path: str | None = None) -> None:
        cfg = self.transformer.config
        sr = self.vae.config.spatial_compression_ratio
        self.lat_h = self.height // sr
        self.lat_w = self.width // sr
        _, ph, pw = cfg.patch_size
        self.frame_seqlen = (self.lat_h // ph) * (self.lat_w // pw)
        self._reset_state()
        self.kv_caches = self.transformer.init_caches(
            1, self.frame_seqlen, self.dtype, device=self.device)
        if self.text_encoder is not None and self.tokenizer is not None:
            enc = self.tokenizer([prompt], padding="max_length",
                                 max_length=512, truncation=True,
                                 return_tensors="np")
            out = self.text_encoder(
                torch.as_tensor(enc["input_ids"], device=self.device),
                torch.as_tensor(enc["attention_mask"], device=self.device))
            self.ctx = out.last_hidden_state.to(self.dtype)
        else:
            self.ctx = torch.zeros((1, 512, cfg.text_dim), dtype=self.dtype,
                                   device=self.device)
        # the text K/V of every layer, once per prompt
        self.ca_caches = self.transformer.precompute_crossattn_caches(
            self.ctx)
        # flush the writer of a previous stream before replacing it
        if self._writer is not None:
            self._writer.close()
            self._writer = None
        if output_path:
            self._writer = IncrementalVideoWriter(output_path)

    @torch.inference_mode()
    def step(self) -> np.ndarray:
        """Generate one block of frames: [T, H, W, 3] uint8."""
        cfg = self.transformer.config
        nfpb = cfg.num_frames_per_block
        pt, ph, pw = cfg.patch_size
        b = 1
        noise = randn_like_reference(
            (b, self.vae.config.z_dim, nfpb, self.lat_h, self.lat_w),
            [self.seed + self.block_index])
        cur = noise.to(self.device)
        freqs = get_rotary_pos_embed_wan(
            (nfpb // pt, self.lat_h // ph, self.lat_w // pw),
            cfg.attention_head_dim, cfg.rope_theta,
            start_frame=self.block_index * nfpb, device=self.device)
        dit = self.transformer
        self.scheduler.set_timesteps(self.num_inference_steps)
        for t_cur in self.scheduler.timesteps:
            t_arr = torch.full((b,), float(t_cur), dtype=torch.float32,
                               device=self.device)
            pred, _ = dit.forward_block(cur.to(self.dtype), self.ctx, t_arr,
                                        self.kv_caches, freqs_cis=freqs,
                                        crossattn_caches=self.ca_caches,
                                        update_caches=False)
            cur = self.scheduler.step(pred.float(), t_cur,
                                      cur.float()).prev_sample
        t_ctx = torch.zeros((b,), dtype=torch.float32, device=self.device)
        dit.forward_block(cur.to(self.dtype), self.ctx, t_ctx, self.kv_caches,
                          freqs_cis=freqs, crossattn_caches=self.ca_caches)

        # decode one latent frame at a time through the carried conv cache:
        # the same pixels as the whole block at once, at a third of the
        # decoder's peak activations; uint8 on the device
        z = self.vae.denormalize_latents(cur)
        chunks = []
        for i in range(z.shape[2]):
            pixels, self.vae_cache = self.vae.streaming_decode(
                z[:, :, i:i + 1].to(torch.bfloat16), self.vae_cache,
                is_first_chunk=self.block_index == 0 and i == 0)
            chunks.append(_to_uint8_frames(pixels).cpu().numpy())
        self.block_index += 1
        frames = np.concatenate(chunks, axis=0)
        self.frames_emitted += frames.shape[0]
        if self._writer is not None:
            self._writer.add_frames(frames)
        return frames

    def finalize(self) -> int:
        if self._writer is not None:
            self._writer.close()
            self._writer = None
        return self.frames_emitted
