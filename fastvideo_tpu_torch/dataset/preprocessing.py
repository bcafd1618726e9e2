"""Staged raw-video preprocessing datasets (port of
fastvideo_tpu/dataset/preprocessing.py): metadata-driven video/image +
caption datasets whose samples flow through explicit stages:

  validation -> frame sampling (fps resample + length filters)
             -> video/image transform (crop/resize/normalize)
             -> text tokenization (with CFG caption dropout)

The stages run on the host and produce uint8 frame stacks and token ids;
the VAE and text-encoder passes run on the device inside
``PreprocessPipeline`` (pipelines/preprocess/preprocess_pipeline.py).
Random draws (drop-short, caption dropout, temporal crops) come from
Python's ``random``, seeded as in the JAX package, so the two packages
draw the same. Clips are ``.npy`` arrays and images PNGs
(``models/loader/image_io.py``); other formats raise.

Resume state is the cursor over the filtered sample list.
"""

from __future__ import annotations

import json
import logging
import math
import os
import random
from collections.abc import Iterator
from dataclasses import dataclass
from typing import Any

import numpy as np

from fastvideo_tpu_torch.dataset.transform import (CenterCropResizeVideo,
                                                   TemporalRandomCrop)
from fastvideo_tpu_torch.models.loader.image_io import UNPORTED, load_image

logger = logging.getLogger(__name__)

_IMAGE_EXTS = (".png", ".jpg", ".jpeg", ".webp", ".bmp")


@dataclass
class PreprocessSample:
    """One video- or image-caption pair moving through the stages."""

    path: str
    cap: str | list[str] | None = None
    resolution: dict | None = None
    fps: float | None = None
    duration: float | None = None
    action_path: str | None = None

    # populated by stages
    num_frames: int | None = None
    sample_frame_index: list[int] | None = None
    sample_num_frames: int | None = None
    frames: np.ndarray | None = None        # uint8 [T, H, W, 3]
    pixel_values: np.ndarray | None = None  # float32 [C, T, H, W] in [-1,1]
    text: str | None = None
    input_ids: np.ndarray | None = None
    cond_mask: np.ndarray | None = None

    @property
    def is_video(self) -> bool:
        return self.path.lower().endswith(
            (".mp4", ".mkv", ".webm", ".avi", ".mov", ".npy"))

    @property
    def is_image(self) -> bool:
        return self.path.lower().endswith(_IMAGE_EXTS)

    @property
    def caption_text(self) -> str:
        if self.cap is None:
            return ""
        if isinstance(self.cap, str):
            return self.cap
        return random.Random(hash(self.path) & 0xFFFF).choice(list(self.cap))


class DatasetStage:
    """Transforming stage."""

    def process(self, sample: PreprocessSample, **kw) -> PreprocessSample:
        raise NotImplementedError


class DatasetFilterStage(DatasetStage):
    """Filtering stage: ``should_keep`` decides membership during metadata
    processing; ``process`` is a no-op unless overridden."""

    def should_keep(self, sample: PreprocessSample, **kw) -> bool:
        raise NotImplementedError

    def process(self, sample: PreprocessSample, **kw) -> PreprocessSample:
        return sample


class DataValidationStage(DatasetFilterStage):
    """Drop records without a caption, and videos without fps/duration."""

    def should_keep(self, sample: PreprocessSample, **kw) -> bool:
        if sample.cap is None:
            return False
        if sample.is_video:
            return sample.duration is not None and sample.fps is not None
        return sample.is_image


class ResolutionFilterStage(DatasetFilterStage):
    """Drop records whose source resolution is below the training target
    or outside sane aspect bounds, at metadata time, before any decode."""

    def __init__(self, min_height: int = 0, min_width: int = 0,
                 max_aspect: float = 4.0):
        self.min_height = min_height
        self.min_width = min_width
        self.max_aspect = max_aspect

    def should_keep(self, sample: PreprocessSample, **kw) -> bool:
        res = sample.resolution
        if not res:  # unknown resolution: keep, the transform will assert
            return True
        h, w = res.get("height"), res.get("width")
        if h is None or w is None:
            return True
        if h < self.min_height or w < self.min_width or h <= 0 or w <= 0:
            return False
        aspect = max(h / w, w / h)
        return aspect <= self.max_aspect


class FrameSamplingStage(DatasetFilterStage):
    """Resample source frames to ``train_fps`` and drop videos that are too
    long (beyond tolerance x target span) or, with probability
    ``drop_short_ratio``, too short."""

    def __init__(self, num_frames: int, train_fps: float,
                 speed_factor: float = 1.0,
                 video_length_tolerance_range: float = 5.0,
                 drop_short_ratio: float = 0.0, seed: int = 42):
        self.num_frames = num_frames
        self.train_fps = train_fps
        self.speed_factor = speed_factor
        self.video_length_tolerance_range = video_length_tolerance_range
        self.drop_short_ratio = drop_short_ratio
        self.rng = random.Random(seed)

    def _frame_indices(self, sample: PreprocessSample) -> np.ndarray:
        total = math.ceil(sample.fps * sample.duration)
        interval = sample.fps / self.train_fps
        return np.arange(0, total, interval).astype(int)

    def should_keep(self, sample: PreprocessSample, **kw) -> bool:
        if sample.is_image:
            return True
        if sample.duration is None or sample.fps is None:
            return False
        total = math.ceil(sample.fps * sample.duration)
        if (total / sample.fps > self.video_length_tolerance_range *
                (self.num_frames / self.train_fps * self.speed_factor)):
            return False
        idx = self._frame_indices(sample)
        return not (len(idx) < self.num_frames
                    and self.rng.random() < self.drop_short_ratio)

    def process(self, sample: PreprocessSample, temporal_sample_fn=None,
                **kw) -> PreprocessSample:
        if sample.is_image:
            sample.sample_frame_index = [0]
            sample.sample_num_frames = 1
            return sample
        assert sample.duration is not None and sample.fps is not None
        sample.num_frames = math.ceil(sample.fps * sample.duration)
        idx = self._frame_indices(sample)
        if len(idx) > self.num_frames:
            if temporal_sample_fn is not None:
                b, e = temporal_sample_fn(len(idx))
                idx = idx[b:e]
            else:
                idx = idx[:self.num_frames]
        sample.sample_frame_index = idx.tolist()
        sample.sample_num_frames = int(len(idx))
        return sample


class VideoTransformStage(DatasetStage):
    """Read the sampled frames and apply the spatial transform. Produces
    both the uint8 [T, H, W, 3] stack (what PreprocessPipeline.encode_video
    takes and normalizes on the device) and float32 [C, T, H, W] in
    [-1, 1]."""

    def __init__(self, transform=None):
        self.transform = transform

    def process(self, sample: PreprocessSample, **kw) -> PreprocessSample:
        if not sample.is_video:
            return sample
        assert os.path.exists(sample.path), f"missing file {sample.path}"
        assert sample.sample_frame_index is not None, \
            "FrameSamplingStage must run first"
        from fastvideo_tpu_torch.pipelines.preprocess.preprocess_pipeline \
            import load_video_frames

        frames = load_video_frames(sample.path)  # [T, H, W, 3] uint8
        idx = [i for i in sample.sample_frame_index if i < len(frames)]
        frames = frames[idx]
        if self.transform is not None:
            tchw = frames.transpose(0, 3, 1, 2)  # TCHW for the transforms
            tchw = self.transform(tchw)
            frames = np.clip(np.round(tchw), 0, 255).astype(
                np.uint8).transpose(0, 2, 3, 1)
        sample.frames = frames
        sample.pixel_values = (
            frames.astype(np.float32).transpose(3, 0, 1, 2) / 127.5 - 1.0)
        return sample


class ImageTransformStage(DatasetStage):
    """Load a single image as a one-frame video. Images are PNGs; other
    formats raise."""

    def __init__(self, transform=None, transform_topcrop=None):
        self.transform = transform
        self.transform_topcrop = transform_topcrop

    def process(self, sample: PreprocessSample, **kw) -> PreprocessSample:
        if not sample.is_image:
            return sample
        if not sample.path.lower().endswith(".png"):
            raise NotImplementedError(
                f"{sample.path}: the port reads PNG images; {UNPORTED}")
        img = load_image(sample.path)  # HWC u8
        frames = img[None]  # [1, H, W, 3]
        tf = self.transform_topcrop or self.transform
        if tf is not None:
            tchw = frames.transpose(0, 3, 1, 2)
            tchw = tf(tchw)
            frames = np.clip(np.round(tchw), 0, 255).astype(
                np.uint8).transpose(0, 2, 3, 1)
        sample.frames = frames
        sample.pixel_values = (
            frames.astype(np.float32).transpose(3, 0, 1, 2) / 127.5 - 1.0)
        sample.sample_num_frames = 1
        return sample


class TextTokenizeStage(DatasetStage):
    """Tokenize the caption, dropping it to "" with probability
    ``cfg_rate`` for classifier-free-guidance training (the encoder's
    pass runs on the device in the pipeline)."""

    def __init__(self, tokenizer, text_max_length: int = 512,
                 cfg_rate: float = 0.0, seed: int = 42):
        self.tokenizer = tokenizer
        self.text_max_length = text_max_length
        self.cfg_rate = cfg_rate
        self.rng = random.Random(seed)

    def process(self, sample: PreprocessSample, **kw) -> PreprocessSample:
        text = sample.caption_text
        if self.cfg_rate > 0 and self.rng.random() < self.cfg_rate:
            text = ""
        enc = self.tokenizer([text], padding="max_length",
                             max_length=self.text_max_length,
                             truncation=True, return_tensors="np")
        sample.text = text
        sample.input_ids = np.asarray(enc["input_ids"][0])
        sample.cond_mask = np.asarray(enc["attention_mask"][0])
        return sample


@dataclass
class PreprocessDatasetArgs:
    """The dataset's knobs."""

    num_frames: int = 81
    train_fps: float = 16.0
    speed_factor: float = 1.0
    video_length_tolerance_range: float = 5.0
    drop_short_ratio: float = 0.0
    text_max_length: int = 512
    training_cfg_rate: float = 0.0
    max_height: int = 480
    max_width: int = 832
    min_height: int = 0
    min_width: int = 0


class VideoCaptionMergedDataset:
    """Video/image+caption dataset merged from a ``data_merge_path`` file
    of ``<folder>,<annotations.json>`` lines, processed through the stages
    above.

    Filtering runs once over the metadata; reading, transform and
    tokenization run lazily per sample. ``state_dict`` is an exact cursor.
    """

    def __init__(self, data_merge_path: str,
                 args: PreprocessDatasetArgs | None = None, tokenizer=None,
                 transform=None, transform_topcrop=None,
                 temporal_sample=None, seed: int = 42):
        self.args = args or PreprocessDatasetArgs()
        a = self.args
        self.temporal_sample = (temporal_sample
                                or TemporalRandomCrop(a.num_frames))
        if transform is None:
            transform = CenterCropResizeVideo((a.max_height, a.max_width))
        if transform_topcrop is None:
            transform_topcrop = CenterCropResizeVideo(
                (a.max_height, a.max_width), top_crop=True)

        self.validation_stage = DataValidationStage()
        self.resolution_stage = ResolutionFilterStage(
            min_height=a.min_height, min_width=a.min_width)
        self.frame_sampling_stage = FrameSamplingStage(
            num_frames=a.num_frames, train_fps=a.train_fps,
            speed_factor=a.speed_factor,
            video_length_tolerance_range=a.video_length_tolerance_range,
            drop_short_ratio=a.drop_short_ratio, seed=seed)
        self.video_transform_stage = VideoTransformStage(transform)
        self.image_transform_stage = ImageTransformStage(
            transform, transform_topcrop)
        self.text_stage = (TextTokenizeStage(
            tokenizer, text_max_length=a.text_max_length,
            cfg_rate=a.training_cfg_rate, seed=seed)
            if tokenizer is not None else None)

        self.samples = self._process_metadata(
            self._load_raw_data(data_merge_path))
        self._cursor = 0

    @staticmethod
    def _load_raw_data(data_merge_path: str) -> list[dict]:
        """Parse ``<folder>,<json>`` lines; several pairs are
        concatenated."""
        items: list[dict] = []
        with open(data_merge_path) as fh:
            pairs = [ln.strip().split(",") for ln in fh if ln.strip()]
        for pair in pairs:
            if len(pair) != 2:
                raise ValueError(
                    f"data_merge_path line must be <folder>,<json>: {pair}")
            folder, anno = pair
            with open(anno) as fh:
                rows = json.load(fh)
            for row in rows:
                row = dict(row)
                row["path"] = os.path.join(folder, row["path"])
                if row.get("action_path"):
                    row["action_path"] = os.path.join(folder,
                                                      row["action_path"])
                items.append(row)
        return items

    def _process_metadata(self, raw: list[dict]) -> list[PreprocessSample]:
        kept: list[PreprocessSample] = []
        counts = {"validation_failed": 0, "resolution_failed": 0,
                  "frame_sampling_failed": 0}
        for row in raw:
            s = PreprocessSample(path=row["path"], cap=row.get("cap"),
                                 resolution=row.get("resolution"),
                                 fps=row.get("fps"),
                                 duration=row.get("duration"),
                                 action_path=row.get("action_path"))
            if not self.validation_stage.should_keep(s):
                counts["validation_failed"] += 1
                continue
            if not self.resolution_stage.should_keep(s):
                counts["resolution_failed"] += 1
                continue
            if not self.frame_sampling_stage.should_keep(s):
                counts["frame_sampling_failed"] += 1
                continue
            kept.append(self.frame_sampling_stage.process(
                s, temporal_sample_fn=self.temporal_sample))
        logger.info(
            "preprocess metadata: %d raw -> %d kept (%s)", len(raw),
            len(kept), ", ".join(f"{k}={v}" for k, v in counts.items()))
        return kept

    def __len__(self) -> int:
        return len(self.samples)

    def _get_item(self, idx: int) -> PreprocessSample:
        s = self.samples[idx]
        s = self.video_transform_stage.process(s)
        s = self.image_transform_stage.process(s)
        if self.text_stage is not None:
            s = self.text_stage.process(s)
        return s

    def __iter__(self) -> Iterator[dict]:
        while self._cursor < len(self.samples):
            idx = self._cursor
            self._cursor += 1
            yield self.as_pipeline_sample(self._get_item(idx), idx)
        self._cursor = 0

    def as_pipeline_sample(self, s: PreprocessSample, idx: int) -> dict:
        """The dict PreprocessPipeline.run takes."""
        out: dict[str, Any] = {
            "id": os.path.splitext(os.path.basename(s.path))[0] or str(idx),
            "frames": s.frames,
            "pixel_values": s.pixel_values,
            "path": s.path,
            "caption": s.text if s.text is not None else s.caption_text,
        }
        if s.input_ids is not None:
            out["input_ids"] = s.input_ids
            out["cond_mask"] = s.cond_mask
        if s.is_video:
            out["fps"] = s.fps
            out["duration"] = s.duration
        if s.action_path:
            out["action_path"] = s.action_path
        return out

    # exact-resume cursor
    def state_dict(self) -> dict:
        return {"cursor": self._cursor}

    def load_state_dict(self, state: dict) -> None:
        self._cursor = int(state.get("cursor", 0))


class TextDataset:
    """Prompt-only dataset: a txt/jsonl of captions tokenized through
    TextTokenizeStage, which feeds ODE-trajectory preprocessing."""

    def __init__(self, data_path: str, tokenizer=None,
                 text_max_length: int = 512, cfg_rate: float = 0.0,
                 seed: int = 42):
        self.prompts = self._load(data_path)
        self.text_stage = (TextTokenizeStage(
            tokenizer, text_max_length=text_max_length, cfg_rate=cfg_rate,
            seed=seed) if tokenizer is not None else None)
        self._cursor = 0

    @staticmethod
    def _load(data_path: str) -> list[str]:
        if os.path.isdir(data_path):
            data_path = os.path.join(data_path, "prompts.txt")
        prompts: list[str] = []
        with open(data_path) as fh:
            for line in fh:
                line = line.strip()
                if not line:
                    continue
                if line.startswith("{"):
                    row = json.loads(line)
                    line = row.get("caption") or row.get("prompt") or ""
                if line:
                    prompts.append(line)
        return prompts

    def __len__(self) -> int:
        return len(self.prompts)

    def __iter__(self) -> Iterator[dict]:
        while self._cursor < len(self.prompts):
            idx = self._cursor
            self._cursor += 1
            text = self.prompts[idx]
            out: dict[str, Any] = {"id": f"prompt{idx}", "caption": text}
            if self.text_stage is not None:
                s = self.text_stage.process(PreprocessSample(path="",
                                                             cap=text))
                out.update(text=s.text, input_ids=s.input_ids,
                           cond_mask=s.cond_mask)
            yield out
        self._cursor = 0

    def state_dict(self) -> dict:
        return {"cursor": self._cursor}

    def load_state_dict(self, state: dict) -> None:
        self._cursor = int(state.get("cursor", 0))
