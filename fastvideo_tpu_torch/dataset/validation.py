"""Validation dataset for sample generation during training (port of
fastvideo_tpu/dataset/validation.py): a csv, json, jsonl or parquet file of
prompts (a ``caption`` column), with optional ``image_path`` and
``video_path`` columns resolved against the file's directory. Samples are
padded cyclically to a multiple of the data-parallel groups, and each group
reads its own contiguous slice.

It reads csv, json and jsonl with the standard library, parquet with the
port's own reader (``dataset/parquet_io.py``), and images and clips
without PIL or imageio (``models/loader/image_io.py``: PNG or ``.npy``
images, ``.npy`` clips). ``.arrow`` files raise: the card's machine has no
pyarrow. The port trains in one process, so the data-parallel group
defaults to 1 group, id 0.
"""

from __future__ import annotations

import csv
import json
import logging
import os
import pathlib
from collections.abc import Iterator
from typing import Any

from fastvideo_tpu_torch.dataset import parquet_io
from fastvideo_tpu_torch.models.loader.image_io import (load_image,
                                                        load_video_frames)
from fastvideo_tpu_torch.parallel.mesh import DP_AXIS, current_mesh

logger = logging.getLogger(__name__)

_SUPPORTED = (".csv", ".json", ".jsonl", ".parquet")


def _load_rows(path: pathlib.Path) -> list[dict]:
    suffix = path.suffix.lower()
    if suffix == ".csv":
        with open(path, newline="") as fh:
            return [dict(r) for r in csv.DictReader(fh)]
    if suffix == ".json":
        with open(path) as fh:
            doc = json.load(fh)
        rows = doc.get("data") if isinstance(doc, dict) else doc
        if not isinstance(rows, list):
            raise ValueError(f"{path}: json validation data must be a list "
                             "or have a top-level 'data' list")
        return [dict(r) for r in rows]
    if suffix == ".jsonl":
        with open(path) as fh:
            return [json.loads(ln) for ln in fh if ln.strip()]
    if suffix == ".parquet":
        columns = parquet_io.read_table(str(path))
        names = list(columns)
        n = len(columns[names[0]]) if names else 0
        return [{k: columns[k][i] for k in names} for i in range(n)]
    if suffix == ".arrow":
        raise NotImplementedError(
            f"{path}: .arrow validation files are not ported (the card's "
            "machine has no pyarrow): ROADMAP Queue 1, the JPEG, mp4 and "
            ".arrow readers")
    raise ValueError(f"Unsupported validation dataset format {suffix}; "
                     f"supported: {_SUPPORTED}")


class ValidationDataset:

    def __init__(self, filename: str, num_dp_groups: int | None = None,
                 dp_group_id: int | None = None):
        self.filename = pathlib.Path(filename)
        self.dir = os.path.abspath(self.filename.parent)
        if not self.filename.exists():
            raise FileNotFoundError(f"File {self.filename} does not exist")

        all_samples = _load_rows(self.filename)
        self.original_total_samples = len(all_samples)
        if num_dp_groups is None or dp_group_id is None:
            num_dp_groups, dp_group_id = self._mesh_defaults()
        self.num_dp_groups = max(1, num_dp_groups)
        self.dp_group_id = dp_group_id

        # pad cyclically so every dp group gets an equal share
        rem = len(all_samples) % self.num_dp_groups
        if rem:
            all_samples = all_samples + [
                all_samples[i % len(all_samples)]
                for i in range(self.num_dp_groups - rem)
            ]
        self.total_samples = len(all_samples)
        per_group = self.total_samples // self.num_dp_groups
        self.start_idx = self.dp_group_id * per_group
        self.end_idx = self.start_idx + per_group
        self.samples = all_samples[self.start_idx:self.end_idx]
        logger.info(
            "validation dataset %s: %d samples (+%d pad) -> dp group %d/%d "
            "reads [%d:%d]", self.filename.name,
            self.original_total_samples,
            self.total_samples - self.original_total_samples,
            self.dp_group_id, self.num_dp_groups, self.start_idx,
            self.end_idx)

    @staticmethod
    def _mesh_defaults() -> tuple[int, int]:
        """(dp groups, this rank's group) from the mesh; (1, 0) with none.
        One process a card, so the group is this rank's dp index (JAX's
        single controller reads group 0's share)."""
        mesh = current_mesh()
        if mesh is None:
            return 1, 0
        return mesh.shape[DP_AXIS], mesh.coords[DP_AXIS]

    def __len__(self) -> int:
        return len(self.samples)

    def __iter__(self) -> Iterator[dict[str, Any]]:
        for raw in self.samples:
            sample = dict(raw)
            if "caption" not in sample:
                raise ValueError(
                    "validation datasets must provide a 'caption' column")
            sample["prompt"] = sample["caption"]
            sample.setdefault("image", None)
            sample.setdefault("video", None)
            for key, field, loader in (
                    ("image_path", "image", load_image),
                    ("video_path", "video", load_video_frames)):
                rel = sample.get(key)
                if not rel:
                    continue
                path = rel if os.path.isabs(rel) else os.path.join(
                    self.dir, rel)
                sample[field] = loader(path)
            yield sample
