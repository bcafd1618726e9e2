"""Preprocess pipeline: raw clips + captions -> latents/embeds Parquet
(port of fastvideo_tpu/pipelines/preprocess/preprocess_pipeline.py).

Each clip is VAE-encoded (the posterior's mean, normalized) and its caption
text-encoded on the device of the modules, and the records are written as
Parquet shards in ``SCHEMA_T2V``, the training data format that
``data.path`` reads.
"""

from __future__ import annotations

import logging
import os
import time
from collections.abc import Iterable

import numpy as np
import torch

from fastvideo_tpu_torch.dataset.parquet import (SCHEMA_T2V,
                                                 record_from_sample,
                                                 write_parquet_dataset)
from fastvideo_tpu_torch.models.loader import image_io

logger = logging.getLogger(__name__)


def load_video_frames(path: str, num_frames: int | None = None) -> np.ndarray:
    """A ``.npy`` clip [T, H, W, 3] uint8, cut to ``num_frames``; other
    formats raise (``models/loader/image_io.py``)."""
    frames = image_io.load_video_frames(path)
    return frames[:num_frames] if num_frames else frames


def module_device(module) -> torch.device:
    return next(module.parameters()).device


def module_dtype(module) -> torch.dtype:
    return next(module.parameters()).dtype


class PreprocessPipeline:
    """Clips and captions -> T2V records. ``stats`` sums the seconds spent
    reading clips, encoding them, encoding captions and writing shards,
    and the bytes of the shards written."""

    schema = SCHEMA_T2V

    def __init__(self, vae, text_encoder, tokenizer, text_len: int = 512,
                 samples_per_file: int = 64):
        self.vae = vae
        self.text_encoder = text_encoder
        self.tokenizer = tokenizer
        self.text_len = text_len
        self.samples_per_file = samples_per_file
        self.stats = dict(samples=0, read_s=0.0, encode_s=0.0, text_s=0.0,
                          write_s=0.0, bytes=0)

    @torch.inference_mode()
    def encode_video(self, frames: np.ndarray) -> np.ndarray:
        """[T, H, W, 3] uint8 -> normalized latents [C, T_lat, h, w] fp32,
        encoded in the VAE's precision on its device."""
        t0 = time.perf_counter()
        device = module_device(self.vae)
        pixels = torch.from_numpy(np.ascontiguousarray(frames)).to(device)
        pixels = pixels.to(torch.float32) / 127.5 - 1.0
        pixels = pixels.permute(3, 0, 1, 2)[None]  # [1, 3, T, H, W]
        dist = self.vae.encode(pixels.to(module_dtype(self.vae)))
        latent = self.vae.normalize_latents(dist.mean.permute(0, 4, 1, 2, 3))
        out = latent[0].float().cpu().numpy()
        self.stats["encode_s"] += time.perf_counter() - t0
        return out

    @torch.inference_mode()
    def encode_text(self, caption: str) -> np.ndarray:
        """The text encoder's last hidden state [text_len, D] fp32, zero at
        the padded positions."""
        t0 = time.perf_counter()
        device = module_device(self.text_encoder)
        enc = self.tokenizer([caption], padding="max_length",
                             max_length=self.text_len, truncation=True,
                             return_tensors="np")
        ids = torch.as_tensor(enc["input_ids"], device=device)
        mask = torch.as_tensor(enc["attention_mask"], device=device)
        hidden = self.text_encoder(ids, mask).last_hidden_state
        hidden = hidden * (mask[..., None] > 0)
        out = hidden[0].float().cpu().numpy()
        self.stats["text_s"] += time.perf_counter() - t0
        return out

    def read_frames(self, sample: dict) -> np.ndarray:
        t0 = time.perf_counter()
        frames = sample.get("frames")
        if frames is None:
            frames = load_video_frames(sample["video_path"])
        self.stats["read_s"] += time.perf_counter() - t0
        return frames

    def write(self, records: list[dict], output_dir: str) -> None:
        t0 = time.perf_counter()
        paths = write_parquet_dataset(records, output_dir,
                                      self.samples_per_file,
                                      schema=self.schema)
        self.stats["bytes"] += sum(os.path.getsize(p) for p in paths)
        self.stats["write_s"] += time.perf_counter() - t0

    def make_record(self, sample: dict, frames: np.ndarray, index: int,
                    fps: float) -> dict:
        latents = self.encode_video(frames)
        embeds = self.encode_text(sample.get("caption", ""))
        return record_from_sample(
            str(sample.get("id", index)), latents, embeds,
            caption=sample.get("caption", ""), width=frames.shape[2],
            height=frames.shape[1], num_frames=frames.shape[0], fps=fps,
            duration=frames.shape[0] / fps)

    def run(self, samples: Iterable[dict], output_dir: str,
            fps: float = 16.0) -> int:
        """samples: iterable of {"id", "frames" | "video_path", "caption"}."""
        os.makedirs(output_dir, exist_ok=True)
        records, total = [], 0
        for sample in samples:
            frames = self.read_frames(sample)
            records.append(self.make_record(sample, frames, total, fps))
            total += 1
            self.stats["samples"] += 1
            if len(records) >= self.samples_per_file:
                self.write(records, output_dir)
                records = []
        if records:
            self.write(records, output_dir)
        logger.info("Preprocessed %d samples -> %s", total, output_dir)
        return total
