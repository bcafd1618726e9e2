"""I2V preprocess: clip + caption -> latents/embeds plus first-frame
conditioning Parquet (port of
fastvideo_tpu/pipelines/preprocess/preprocess_pipeline_i2v.py): besides the
T2V columns each record carries the CLIP vision tower's last hidden state
of the first frame and the first frame's own VAE latent (``SCHEMA_I2V``).
"""

from __future__ import annotations

import time

import numpy as np
import torch

from fastvideo_tpu_torch.dataset.parquet import (SCHEMA_I2V,
                                                 record_from_i2v_sample)
from fastvideo_tpu_torch.pipelines.preprocess.preprocess_pipeline import (
    PreprocessPipeline, module_device)


class PreprocessPipelineI2V(PreprocessPipeline):
    """T2V preprocessing plus the first frame's CLIP feature and latent."""

    schema = SCHEMA_I2V

    def __init__(self, vae, text_encoder, tokenizer, image_encoder=None,
                 text_len: int = 512, samples_per_file: int = 64):
        super().__init__(vae, text_encoder, tokenizer, text_len=text_len,
                         samples_per_file=samples_per_file)
        self.image_encoder = image_encoder
        self.stats["clip_s"] = 0.0

    @torch.inference_mode()
    def encode_first_frame_clip(self, frame: np.ndarray) -> np.ndarray:
        """[H, W, 3] uint8 -> the CLIP vision tower's last hidden state
        [L, D] fp32 (zeros [1, 1] with no image encoder: the column is
        written all the same)."""
        if self.image_encoder is None:
            return np.zeros((1, 1), np.float32)
        from fastvideo_tpu_torch.models.encoders.clip import preprocess_image

        t0 = time.perf_counter()
        pixels = preprocess_image(frame, self.image_encoder.config)
        out = self.image_encoder(
            torch.from_numpy(pixels).to(module_device(self.image_encoder)))
        feature = out.last_hidden_state[0].float().cpu().numpy()
        self.stats["clip_s"] += time.perf_counter() - t0
        return feature

    def encode_first_frame_latent(self, frame: np.ndarray) -> np.ndarray:
        """[H, W, 3] uint8 -> [C, 1, h, w] normalized VAE latent."""
        return self.encode_video(frame[None])

    def make_record(self, sample: dict, frames: np.ndarray, index: int,
                    fps: float) -> dict:
        latents = self.encode_video(frames)
        embeds = self.encode_text(sample.get("caption", ""))
        clip_feat = self.encode_first_frame_clip(frames[0])
        ff_latent = self.encode_first_frame_latent(frames[0])
        return record_from_i2v_sample(
            str(sample.get("id", index)), latents, embeds,
            clip_feature=clip_feat, first_frame_latent=ff_latent,
            caption=sample.get("caption", ""), width=frames.shape[2],
            height=frames.shape[1], num_frames=frames.shape[0], fps=fps,
            duration=frames.shape[0] / fps)
