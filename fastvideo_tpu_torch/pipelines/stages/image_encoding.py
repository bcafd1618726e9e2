"""Image and video conditioning stages of the Wan I2V and V2V pipelines
(port of fastvideo_tpu/pipelines/stages/image_encoding.py):

- ``ImageEncodingStage``: the CLIP vision tower's last hidden state of the
  request's image -> ``batch.image_embeds``;
- ``WanImageVAEEncodingStage``: the image resized (Pillow's LANCZOS) to the
  generation's size as frame 0, F - 1 zero frames after it, the VAE's
  encode, a posterior sample with the request's seed, normalized, with the
  4-channel first-frame mask in front -> ``batch.image_latent`` [B, 4 + z,
  T_lat, h, w];
- ``VideoVAEEncodingStage``: the source clip truncated or zero-padded to F
  frames (LANCZOS-resized where its size differs), encoded, its posterior
  mode ("argmax") or a seeded sample ("sample"), normalized ->
  ``batch.video_latent`` [B, z, T_lat, h, w].

Images come without PIL (``models/loader/image_io.py``): ``pil_image`` is
a uint8 [H, W, 3] array, ``image_path`` a PNG or a ``.npy`` image, and a
clip comes from ``extra["video"]`` or a ``.npy`` ``video_path``. The
posterior noise is drawn as the JAX stages draw it, from CPU generators
(``randn_like_reference``) in the posterior's channels-last shape.
"""

from __future__ import annotations

import numpy as np
import torch

from fastvideo_tpu_torch.fastvideo_args import FastVideoArgs
from fastvideo_tpu_torch.models.loader.image_io import (load_image,
                                                        load_video_frames,
                                                        resize_lanczos)
from fastvideo_tpu_torch.pipelines.batch import ForwardBatch
from fastvideo_tpu_torch.pipelines.stages.base import PipelineStage
from fastvideo_tpu_torch.pipelines.stages.latent_preparation import (
    randn_like_reference)


def load_request_image(batch: ForwardBatch) -> np.ndarray:
    """The request's image as uint8 [H, W, 3]: ``pil_image`` (the array)
    or the file at ``image_path``."""
    if batch.pil_image is not None:
        image = np.asarray(batch.pil_image)
        if image.dtype != np.uint8 or image.ndim != 3 or image.shape[-1] != 3:
            raise ValueError("pil_image is a uint8 [H, W, 3] array in the "
                             f"port, got {image.dtype} {image.shape}")
        return image
    if batch.image_path:
        return load_image(batch.image_path)
    raise ValueError("I2V requires pil_image or image_path")


def _posterior_sample(dist, batch: ForwardBatch) -> torch.Tensor:
    """mean + std * noise, the noise drawn per seed on the CPU in the
    posterior's channels-last shape, as the JAX stages draw it."""
    noise = randn_like_reference((1, *dist.mean.shape[1:]),
                                 batch.seeds or [batch.seed or 0])
    return dist.mean + dist.std * noise.to(dist.mean.device)


class ImageEncodingStage(PipelineStage):
    """CLIP image conditioning: the vision tower's last hidden state."""

    def __init__(self, image_encoder, *, device):
        self.image_encoder = image_encoder
        self.device = device

    def forward(self, batch: ForwardBatch,
                fastvideo_args: FastVideoArgs) -> ForwardBatch:
        if self.image_encoder is None:
            return batch
        from fastvideo_tpu_torch.models.encoders.clip import preprocess_image

        px = preprocess_image(load_request_image(batch),
                              self.image_encoder.config)
        out = self.image_encoder(torch.from_numpy(px).to(self.device))
        batch.image_embeds.append(out.last_hidden_state)
        return batch


class VideoVAEEncodingStage(PipelineStage):
    """Control-clip VAE conditioning for V2V: ``sample_mode`` "argmax" (the
    posterior mode) or "sample" (a seeded posterior sample)."""

    def __init__(self, vae, sample_mode: str = "sample", *, device):
        if sample_mode not in ("argmax", "sample"):
            raise ValueError(f"unknown sample_mode {sample_mode!r}")
        self.vae = vae
        self.sample_mode = sample_mode
        self.device = device

    @staticmethod
    def load_frames(batch: ForwardBatch) -> np.ndarray:
        """[T, H, W, C] float32 in [0, 1] (divided by 255 where its max
        passes 1.5)."""
        video = batch.extra.get("video")
        if video is None and not batch.video_path:
            raise ValueError(
                "V2V requires extra['video'] frames or video_path")
        arr = np.asarray(video if video is not None else
                         load_video_frames(batch.video_path), np.float32)
        if arr.max() > 1.5:
            arr = arr / 255.0
        if video is None and arr.ndim == 3:
            arr = arr[..., None]
        return arr

    def forward(self, batch: ForwardBatch,
                fastvideo_args: FastVideoArgs) -> ForwardBatch:
        h, w, f = batch.height, batch.width, batch.num_frames
        frames = self.load_frames(batch)[:f]
        if frames.shape[1] != h or frames.shape[2] != w:
            frames = np.stack([
                np.asarray(resize_lanczos(
                    (np.clip(fr, 0, 1) * 255).astype(np.uint8), (w, h)),
                    np.float32) / 255.0 for fr in frames])
        video = frames.transpose(3, 0, 1, 2)[None] * 2.0 - 1.0
        if video.shape[2] < f:
            # zero frames at the tail up to F
            pad = np.zeros((1, 3, f - video.shape[2], h, w), np.float32)
            video = np.concatenate([video, pad], axis=2)
        dist = self.vae.encode(torch.from_numpy(
            np.ascontiguousarray(video, np.float32)).to(self.device))
        latent = (dist.mode() if self.sample_mode == "argmax" else
                  _posterior_sample(dist, batch))
        batch.video_latent = self.vae.normalize_latents(
            latent.permute(0, 4, 1, 2, 3)).float()
        return batch


class WanImageVAEEncodingStage(PipelineStage):
    """First-frame VAE conditioning with the 4-channel first-frame mask."""

    def __init__(self, vae, *, device):
        self.vae = vae
        self.device = device

    @staticmethod
    def preprocess_pixels(image: np.ndarray, height: int,
                          width: int) -> np.ndarray:
        """uint8 [H0, W0, 3] -> fp32 [1, 3, height, width] in [-1, 1],
        LANCZOS-resized."""
        arr = np.asarray(resize_lanczos(image, (width, height)),
                         np.float32) / 127.5 - 1.0
        return arr.transpose(2, 0, 1)[None]

    def forward(self, batch: ForwardBatch,
                fastvideo_args: FastVideoArgs) -> ForwardBatch:
        if self.vae is None or self.vae.encoder is None:
            return batch
        image = load_request_image(batch)
        h, w, f = batch.height, batch.width, batch.num_frames
        arch = self.vae.config
        sr, tr = arch.spatial_compression_ratio, arch.temporal_compression_ratio
        lat_h, lat_w = h // sr, w // sr
        lat_t = (f - 1) // tr + 1

        px = torch.from_numpy(self.preprocess_pixels(image, h, w)).to(
            self.device)
        video = torch.cat([px[:, :, None], px.new_zeros((1, 3, f - 1, h, w))],
                          dim=2)
        latent = _posterior_sample(self.vae.encode(video), batch)
        del video
        latent = self.vae.normalize_latents(latent.permute(0, 4, 1, 2, 3))

        # the mask: frame 0's 1 repeated over the first tr frames, the
        # frames folded into tr channels of each latent frame
        mask = np.ones((1, 1, f, lat_h, lat_w), np.float32)
        mask[:, :, 1:] = 0
        first = np.repeat(mask[:, :, 0:1], tr, axis=2)
        mask = np.concatenate([first, mask[:, :, 1:]], axis=2)
        mask = mask.reshape(1, lat_t, tr, lat_h, lat_w).transpose(
            0, 2, 1, 3, 4)
        batch.image_latent = torch.cat(
            [torch.from_numpy(np.ascontiguousarray(mask)).to(latent.device),
             latent.float()], dim=1)
        return batch
