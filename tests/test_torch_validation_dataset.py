"""The port's ValidationDataset against the JAX package's: the same rows,
prompts, images and clips from csv, json (a list and a "data" list),
jsonl and parquet files (written by pyarrow and by the port's own writer),
the cyclic padding across data-parallel groups, and
ValidationCallback(dataset_path=) sampling the file's prompts as JAX's
callback does. Everything here is exact."""

import csv
import json
import os

import numpy as np
import PIL.Image
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

from fastvideo_tpu.dataset.validation import (
    ValidationDataset as JaxValidationDataset)
from fastvideo_tpu.training import callbacks as jcb
from fastvideo_tpu_torch.dataset import parquet_io
from fastvideo_tpu_torch.dataset.validation import ValidationDataset
from fastvideo_tpu_torch.training import callbacks as tcb

ROWS = [
    {"caption": "a red fox in snow", "image_path": "frame0.png",
     "video_path": ""},
    {"caption": "waves at dusk", "image_path": "", "video_path": "clip.npy"},
    {"caption": "a city at night", "image_path": "", "video_path": ""},
    {"caption": "rain on a window", "image_path": "frame0.png",
     "video_path": "clip.npy"},
    {"caption": "a kite over a hill", "image_path": "", "video_path": ""},
]


@pytest.fixture()
def data_dir(tmp_path):
    rng = np.random.default_rng(0)
    PIL.Image.fromarray(rng.integers(0, 256, (12, 20, 3), np.uint8)).save(
        str(tmp_path / "frame0.png"))
    np.save(str(tmp_path / "clip.npy"),
            rng.integers(0, 256, (5, 12, 20, 3), np.uint8))
    return tmp_path


def _write(path, kind, rows):
    if kind == "csv":
        with open(path, "w", newline="") as fh:
            w = csv.DictWriter(fh, fieldnames=list(rows[0]))
            w.writeheader()
            w.writerows(rows)
    elif kind == "json":
        with open(path, "w") as fh:
            json.dump(rows, fh)
    elif kind == "json_data":
        with open(path, "w") as fh:
            json.dump({"data": rows}, fh)
    elif kind == "jsonl":
        with open(path, "w") as fh:
            fh.writelines(json.dumps(r) + "\n" for r in rows)
    elif kind == "parquet_pyarrow":
        pq.write_table(pa.Table.from_pylist(rows), path)
    else:
        parquet_io.write_table(path, {k: [r[k] for r in rows] for k in rows[0]},
                               [(k, "string") for k in rows[0]])
    return path


def _same(a, b):
    assert a.keys() == b.keys()
    for k in a:
        if isinstance(a[k], np.ndarray) or isinstance(b[k], np.ndarray):
            assert np.array_equal(np.asarray(a[k]), np.asarray(b[k])), k
        else:
            assert a[k] == b[k], k


@pytest.mark.parametrize("kind,suffix", [
    ("csv", ".csv"), ("json", ".json"), ("json_data", ".json"),
    ("jsonl", ".jsonl"), ("parquet_pyarrow", ".parquet"),
    ("parquet_port", ".parquet")])
@pytest.mark.parametrize("groups", [(1, 0), (2, 1), (3, 0), (3, 2)])
def test_rows_match_jax(data_dir, kind, suffix, groups):
    path = _write(str(data_dir / f"val{suffix}"), kind, ROWS)
    want = JaxValidationDataset(path, *groups)
    got = ValidationDataset(path, *groups)
    for attr in ("original_total_samples", "total_samples", "num_dp_groups",
                 "dp_group_id", "start_idx", "end_idx"):
        assert getattr(got, attr) == getattr(want, attr), attr
    assert len(got) == len(want) == got.total_samples // groups[0]
    want_samples, got_samples = list(want), list(got)
    assert len(got_samples) == len(want_samples) > 0
    for g, w in zip(got_samples, want_samples, strict=True):
        _same(g, w)
    if groups == (3, 2):  # 5 rows padded to 6: the last group reads 4, 0
        assert [s["prompt"] for s in got_samples] == [ROWS[4]["caption"],
                                                      ROWS[0]["caption"]]
        assert got_samples[1]["image"].shape == (12, 20, 3)


def test_errors(data_dir):
    with pytest.raises(FileNotFoundError):
        ValidationDataset(str(data_dir / "missing.csv"))
    (data_dir / "val.arrow").write_bytes(b"ARROW1")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        ValidationDataset(str(data_dir / "val.arrow"))
    bad = _write(str(data_dir / "bad.jsonl"), "jsonl", [{"prompt": "x"}])
    with pytest.raises(ValueError, match="caption"):
        list(ValidationDataset(bad))
    with open(data_dir / "bad.json", "w") as fh:
        json.dump({"rows": []}, fh)
    with pytest.raises(ValueError, match="data"):
        ValidationDataset(str(data_dir / "bad.json"))


class Sampler:
    """A method whose validation_sample records the prompts it is given."""

    def __init__(self):
        self.prompts = []

    def validation_sample(self, prompt=None, num_inference_steps=4):
        self.prompts.append((prompt, num_inference_steps))
        return {"score": float(len(prompt or ""))}


def test_validation_callback_samples_the_file(data_dir):
    path = _write(str(data_dir / "val.csv"), "csv", ROWS)
    ours, theirs = Sampler(), Sampler()
    kw = dict(every_n_steps=2, prompt="fallback", num_inference_steps=3,
              dataset_path=path, max_samples=3)
    tcb.ValidationCallback(**kw).on_training_step_end(ours, {}, iteration=4)
    jcb.ValidationCallback(**kw).on_training_step_end(theirs, {},
                                                      iteration=4)
    assert ours.prompts == theirs.prompts == [
        (r["caption"], 3) for r in ROWS[:3]]
    tcb.ValidationCallback(**kw).on_training_step_end(ours, {}, iteration=3)
    assert len(ours.prompts) == 3
