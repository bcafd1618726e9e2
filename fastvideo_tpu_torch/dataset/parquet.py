"""Parquet dataset of precomputed latents and text embeddings (port of
fastvideo_tpu/dataset/parquet.py), on the port's own Parquet reader and
writer (``dataset/parquet_io.py``; the card's machine has no pyarrow).

Rows hold VAE latents and text embeddings as raw bytes with their shape
and dtype; ``DPSPBatchSampler`` gives the same batch to every rank of an
SP group and different batches across DP groups, seeded and resumable.
"""

from __future__ import annotations

import logging
import os
from collections.abc import Iterator

import numpy as np

from fastvideo_tpu_torch.dataset import parquet_io

logger = logging.getLogger(__name__)

# the JAX package's pyarrow_schema_t2v, in parquet_io's column kinds
SCHEMA_T2V = [
    ("id", "string"),
    ("latents", "binary"),
    ("latents_shape", "list<int32>"),
    ("latents_dtype", "string"),
    ("text_embedding", "binary"),
    ("text_embedding_shape", "list<int32>"),
    ("text_embedding_dtype", "string"),
    ("caption", "string"),
    ("width", "int32"),
    ("height", "int32"),
    ("num_frames", "int32"),
    ("fps", "float32"),
    ("duration", "float32"),
]


def record_from_sample(sample_id: str, latents: np.ndarray,
                       text_embedding: np.ndarray, caption: str = "",
                       width: int = 0, height: int = 0, num_frames: int = 0,
                       fps: float = 0.0, duration: float = 0.0) -> dict:
    return {
        "id": sample_id,
        "latents": latents.tobytes(),
        "latents_shape": list(latents.shape),
        "latents_dtype": str(latents.dtype),
        "text_embedding": text_embedding.tobytes(),
        "text_embedding_shape": list(text_embedding.shape),
        "text_embedding_dtype": str(text_embedding.dtype),
        "caption": caption,
        "width": width,
        "height": height,
        "num_frames": num_frames,
        "fps": fps,
        "duration": duration,
    }


def write_parquet_dataset(records: list[dict], out_dir: str,
                          rows_per_file: int = 256, schema=None) -> None:
    """Snappy shards ``data_{idx:05d}.parquet`` of ``rows_per_file``
    records each, numbered after the shards already in ``out_dir``."""
    os.makedirs(out_dir, exist_ok=True)
    schema = schema if schema is not None else SCHEMA_T2V
    start = len([f for f in os.listdir(out_dir) if f.endswith(".parquet")])
    for i in range(0, len(records), rows_per_file):
        chunk = records[i:i + rows_per_file]
        columns = {name: [r.get(name) for r in chunk] for name, _ in schema}
        idx = start + i // rows_per_file
        parquet_io.write_table(
            os.path.join(out_dir, f"data_{idx:05d}.parquet"), columns,
            schema)
    logger.info("Wrote %d records to %s", len(records), out_dir)


def _decode_field(row: dict, name: str) -> np.ndarray:
    arr = np.frombuffer(row[name], dtype=np.dtype(row[f"{name}_dtype"]))
    return arr.reshape(row[f"{name}_shape"]).copy()


def _tensor_columns(names) -> list[str]:
    return [c for n in names for c in (n, f"{n}_shape", f"{n}_dtype")]


class LatentsParquetMapStyleDataset:
    """Random-access dataset over Parquet shards."""

    # keep only the most recent shards resident: samplers read
    # near-sequentially within a shard, but an epoch touches every shard
    _TABLE_CACHE_MAX = 4

    def __init__(self, path: str, text_drop_rate: float = 0.0,
                 seed: int = 42, extra_columns: tuple[str, ...] = ()):
        """``extra_columns`` names more tensor columns (the i2v schema's
        ``clip_feature`` / ``first_frame_latent``); when set,
        ``__getitem__`` returns (latents, text, {col: array})."""
        self.extra_columns = tuple(extra_columns)
        self.files = sorted(
            os.path.join(path, f) for f in os.listdir(path)
            if f.endswith(".parquet"))
        if not self.files:
            raise FileNotFoundError(f"no parquet files under {path}")
        self._lens = [parquet_io.ParquetFile(f).num_rows for f in self.files]
        self._offsets = np.cumsum([0, *self._lens])
        self.text_drop_rate = text_drop_rate
        self._rng = np.random.default_rng(seed)
        self._columns = _tensor_columns(
            ("latents", "text_embedding", *self.extra_columns))
        self._tables: dict[int, dict[str, list]] = {}

    def __len__(self) -> int:
        return int(self._offsets[-1])

    def _table(self, file_idx: int) -> dict[str, list]:
        if file_idx not in self._tables:
            while len(self._tables) >= self._TABLE_CACHE_MAX:
                self._tables.pop(next(iter(self._tables)))
            self._tables[file_idx] = parquet_io.read_table(
                self.files[file_idx], self._columns)
        else:  # refresh its place in the LRU order
            self._tables[file_idx] = self._tables.pop(file_idx)
        return self._tables[file_idx]

    def __getitem__(self, idx: int):
        file_idx = int(np.searchsorted(self._offsets, idx, "right") - 1)
        row_idx = idx - int(self._offsets[file_idx])
        row = {k: v[row_idx] for k, v in self._table(file_idx).items()}
        latents = _decode_field(row, "latents")
        text = _decode_field(row, "text_embedding")
        if self.text_drop_rate and self._rng.random() < self.text_drop_rate:
            text = np.zeros_like(text)  # CFG dropout
        if self.extra_columns:
            return latents, text, {c: _decode_field(row, c)
                                   for c in self.extra_columns}
        return latents, text


class DPSPBatchSampler:
    """Seeded, resumable batch sampler; one batch per dp group per step.
    The order is a numpy permutation seeded by ``seed + epoch``, the same
    as the JAX package's."""

    def __init__(self, dataset_len: int, batch_size: int, num_dp_groups: int,
                 dp_group_rank: int = 0, seed: int = 42,
                 drop_last: bool = True):
        self.dataset_len = dataset_len
        self.batch_size = batch_size
        self.num_dp_groups = num_dp_groups
        self.dp_group_rank = dp_group_rank
        self.seed = seed
        self.drop_last = drop_last
        self.epoch = 0

    def __iter__(self) -> Iterator[list[int]]:
        rng = np.random.default_rng(self.seed + self.epoch)
        perm = rng.permutation(self.dataset_len)
        global_bs = self.batch_size * self.num_dp_groups
        n_batches = (self.dataset_len // global_bs if self.drop_last else
                     -(-self.dataset_len // global_bs))
        for b in range(n_batches):
            start = b * global_bs + self.dp_group_rank * self.batch_size
            yield [int(i) for i in perm[start:start + self.batch_size]]
        self.epoch += 1

    def state_dict(self) -> dict:
        return {"epoch": self.epoch, "seed": self.seed}

    def load_state_dict(self, state: dict) -> None:
        self.epoch = state["epoch"]
        self.seed = state["seed"]


class _AccumSampler:
    """Groups ``accum`` micro-batch index lists into one train-step item,
    leaving epoch and state to the underlying DPSPBatchSampler."""

    def __init__(self, base: DPSPBatchSampler, accum: int):
        self.base = base
        self.accum = max(1, int(accum))

    def __iter__(self):
        group: list[list[int]] = []
        for indices in self.base:
            group.append(indices)
            if len(group) == self.accum:
                yield group
                group = []

    @property
    def epoch(self) -> int:
        return self.base.epoch

    @epoch.setter
    def epoch(self, value: int) -> None:
        self.base.epoch = int(value)

    def state_dict(self) -> dict:
        return self.base.state_dict()

    def load_state_dict(self, state: dict) -> None:
        self.base.load_state_dict(state)


def build_parquet_dataloader(path: str, batch_size: int,
                             num_dp_groups: int = 1,
                             accum: int = 1, text_drop_rate: float = 0.0,
                             seed: int = 42, prefetch: int = 2):
    """Yields ([accum, B, ...] latents, [accum, B, L, D] embeds) numpy
    pairs, built by the :class:`PrefetchingLoader`'s background thread so
    that the host's reading overlaps the device's step, and resumable
    through its ``state_dict`` / ``load_state_dict``.

    ``make_batch`` reads ``dataset[i]`` twice an index, once for the
    latents and once for the text, as the JAX package does: with
    ``text_drop_rate > 0`` each read draws from the dataset's generator,
    and the text keeps the second read's draw."""
    from fastvideo_tpu_torch.dataset.loader import PrefetchingLoader

    dataset = LatentsParquetMapStyleDataset(path, text_drop_rate, seed)
    sampler = _AccumSampler(
        DPSPBatchSampler(len(dataset), batch_size * num_dp_groups, 1, 0,
                         seed), accum)

    def make_batch(groups: list[list[int]]):
        micros = []
        for batch_indices in groups:
            lat = np.stack([dataset[i][0] for i in batch_indices])
            txt = np.stack([dataset[i][1] for i in batch_indices])
            micros.append((lat, txt))
        return (np.stack([m[0] for m in micros]),
                np.stack([m[1] for m in micros]))

    return PrefetchingLoader(sampler, make_batch, prefetch=prefetch)
