"""The port's Parquet reader and writer (``dataset/parquet_io.py``,
``dataset/snappy.py``) against pyarrow, and its latents dataset and
dataloader against the JAX package's, bit for bit."""

import os

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

from fastvideo_tpu.dataset import parquet as jparquet
from fastvideo_tpu_torch.dataset import parquet as tparquet
from fastvideo_tpu_torch.dataset import parquet_io, snappy
from fastvideo_tpu_torch.training.run_config import (DataSpec,
                                                     TrainRunConfig,
                                                     build_dataloader)
from fastvideo_tpu_torch.fastvideo_args import TrainingArgs

ROWS = 37


def _table(seed: int = 0) -> pa.Table:
    """Every column kind the reader takes, with nulls, empty and null
    lists and null list elements."""
    rng = np.random.default_rng(seed)

    def shape(i):
        if i % 7 == 0:
            return None
        if i % 7 == 1:
            return []
        return [int(x) if i % 3 else None
                for x in rng.integers(-5, 1000, int(rng.integers(1, 5)))]

    return pa.table({
        "id": pa.array([f"id{i}" if i % 5 else None for i in range(ROWS)],
                       pa.string()),
        "blob": pa.array([rng.bytes(int(rng.integers(0, 3000)))
                          for _ in range(ROWS)], pa.binary()),
        "shape": pa.array([shape(i) for i in range(ROWS)],
                          pa.list_(pa.int32())),
        "w": pa.array(rng.integers(-2**31, 2**31, ROWS), pa.int32()),
        "f": pa.array([float(rng.standard_normal()) if i % 4 else None
                       for i in range(ROWS)], pa.float32()),
        "cat": pa.array([["a", "bb", "ccc"][i % 3] for i in range(ROWS)],
                        pa.string()),
        "i64": pa.array(rng.integers(-2**60, 2**60, ROWS), pa.int64()),
        "d": pa.array(rng.standard_normal(ROWS), pa.float64()),
        "b": pa.array([bool(i % 3) for i in range(ROWS)], pa.bool_()),
    })


SCHEMA = [("id", "string"), ("blob", "binary"), ("shape", "list<int32>"),
          ("w", "int32"), ("f", "float32"), ("cat", "string"),
          ("i64", "int64"), ("d", "float64"), ("b", "bool")]


@pytest.mark.parametrize("layout", ["one_group", "groups_small_pages"])
@pytest.mark.parametrize("version", ["1.0", "2.0"])
@pytest.mark.parametrize("dictionary", [True, False],
                         ids=["dict", "plain"])
@pytest.mark.parametrize("compression", ["snappy", "none"])
def test_reader_equals_pyarrow(tmp_path, compression, dictionary, version,
                               layout):
    t = _table()
    path = str(tmp_path / "t.parquet")
    small = layout == "groups_small_pages"
    pq.write_table(t, path, compression=compression,
                   use_dictionary=dictionary, data_page_version=version,
                   row_group_size=5 if small else None,
                   data_page_size=64 if small else 1 << 20,
                   write_batch_size=3 if small else 1024)
    pf = parquet_io.ParquetFile(path)
    assert pf.num_rows == ROWS
    assert len(pf.row_groups) == (8 if small else 1)
    assert pf.read() == t.to_pydict()
    assert pf.read(["shape", "f"]) == t.select(["shape", "f"]).to_pydict()


def test_dictionary_falls_back_to_plain_inside_a_chunk(tmp_path):
    """pyarrow's dictionary outgrows its page limit: one chunk holds a
    dictionary page, an RLE_DICTIONARY data page and PLAIN data pages. By
    pyarrow's footer: a dictionary page that stopped at its limit (under
    half of the 40 distinct 300-byte values), dictionary indices, and data
    pages that hold the values it lacks, which only PLAIN values can (40
    indices take under 100 bytes)."""
    rng = np.random.default_rng(1)
    n, size = 40, 300
    t = pa.table({"blob": pa.array([rng.bytes(size) for _ in range(n)],
                                   pa.binary()),
                  "n": pa.array(np.arange(n), pa.int32())})
    path = str(tmp_path / "fallback.parquet")
    pq.write_table(t, path, dictionary_pagesize_limit=2000,
                   data_page_size=1000, write_batch_size=4)
    meta = pq.ParquetFile(path).metadata.row_group(0).column(0)
    assert meta.has_dictionary_page
    assert set(meta.encodings) == {"PLAIN", "RLE", "RLE_DICTIONARY"}
    dict_bytes = meta.data_page_offset - meta.dictionary_page_offset
    assert dict_bytes < n * size // 2
    data_bytes = meta.total_uncompressed_size - dict_bytes
    assert data_bytes >= n * size - dict_bytes
    assert parquet_io.ParquetFile(path).read() == t.to_pydict()


@pytest.mark.parametrize("page_bytes", [4096, parquet_io.PAGE_BYTES],
                         ids=["several_pages", "one_page"])
def test_pyarrow_reads_the_writers_files(tmp_path, page_bytes, monkeypatch):
    monkeypatch.setattr(parquet_io, "PAGE_BYTES", page_bytes)
    want = _table().to_pydict()
    path = str(tmp_path / "mine.parquet")
    parquet_io.write_table(path, want, SCHEMA)
    back = pq.read_table(path)
    assert back.to_pydict() == want
    assert back.schema.field("shape").type == pa.list_(
        pa.field("element", pa.int32()))
    assert back.schema.field("id").type == pa.string()
    assert back.schema.field("blob").type == pa.binary()
    chunk = pq.ParquetFile(path).metadata.row_group(0).column(1)
    assert chunk.compression == "SNAPPY"
    assert parquet_io.read_table(path) == want


def _snappy_inputs():
    rng = np.random.default_rng(2)
    return {
        "random": rng.standard_normal(300_000).astype(np.float32).tobytes(),
        "zeros": bytes(500_000),
        "overlapping_copies": b"abcdefg" * 70_000,
        "short_copies": np.repeat(rng.integers(0, 4, 100_000).astype(
            np.uint8), 3).tobytes(),
        "empty": b"",
        # a padded text embedding: rows past the prompt are zero
        "zero_rows": np.concatenate([rng.standard_normal((3, 64)), np.zeros(
            (61, 64))]).astype(np.float32).tobytes(),
    }


@pytest.mark.parametrize("kind", list(_snappy_inputs()))
def test_snappy_against_pyarrow(kind):
    data = _snappy_inputs()[kind]
    codec = pa.Codec("snappy")
    assert bytes(snappy.decompress(codec.compress(data, asbytes=True))) == \
        data
    mine = snappy.compress(data)
    assert codec.decompress(mine, decompressed_size=len(data),
                            asbytes=True) == data
    if kind in ("zeros", "zero_rows"):  # runs of one byte become copies
        assert len(mine) < len(data) // 4


def test_snappy_rejects_bad_blocks():
    with pytest.raises(snappy.SnappyError):
        snappy.decompress(b"\x05\x01")  # a copy before any output
    with pytest.raises(snappy.SnappyError):
        snappy.decompress(b"\x05\x08ab")  # a literal past the input


# -- the latents dataset against the JAX package's ---------------------------

LAT = (2, 2, 3, 4)
TXT = (5, 6)


def _records(n: int, seed: int = 3) -> list[dict]:
    rng = np.random.default_rng(seed)
    return [jparquet.record_from_sample(
        f"s{i}", rng.standard_normal(LAT).astype(np.float32),
        rng.standard_normal(TXT).astype(np.float32), caption=f"c{i}",
        width=832, height=480, num_frames=81, fps=16.0, duration=5.0625)
        for i in range(n)]


@pytest.fixture(scope="module")
def jax_shards(tmp_path_factory):
    """11 records in 3 shards written by the JAX package (pyarrow)."""
    d = str(tmp_path_factory.mktemp("shards"))
    jparquet.write_parquet_dataset(_records(11), d, rows_per_file=4)
    return d


def _same(a, b):
    assert type(a) is type(b)
    if isinstance(a, tuple):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
    elif isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _same(a[k], b[k])
    else:
        assert a.dtype == b.dtype and a.shape == b.shape
        assert np.array_equal(a, b)


def test_dataset_equals_jax(jax_shards):
    j = jparquet.LatentsParquetMapStyleDataset(jax_shards, 0.5, seed=7)
    t = tparquet.LatentsParquetMapStyleDataset(jax_shards, 0.5, seed=7)
    assert len(t) == len(j) == 11
    order = [0, 5, 10, 3, 9, 1, 4, 8, 2, 6, 7, 0, 10]
    for i in order:
        _same(t[i], j[i])
    assert len(t._tables) <= t._TABLE_CACHE_MAX


def test_dataset_extra_columns_equal_jax(tmp_path):
    rng = np.random.default_rng(4)
    recs = [jparquet.record_from_i2v_sample(
        f"s{i}", rng.standard_normal(LAT).astype(np.float32),
        rng.standard_normal(TXT).astype(np.float32),
        rng.standard_normal((1, 8)).astype(np.float32),
        rng.standard_normal((2, 1, 3, 4)).astype(np.float32))
        for i in range(5)]
    jparquet.write_parquet_dataset(recs, str(tmp_path), rows_per_file=2,
                                   schema=jparquet.pyarrow_schema_i2v())
    cols = ("clip_feature", "first_frame_latent")
    j = jparquet.LatentsParquetMapStyleDataset(str(tmp_path),
                                               extra_columns=cols)
    t = tparquet.LatentsParquetMapStyleDataset(str(tmp_path),
                                               extra_columns=cols)
    for i in range(5):
        _same(t[i], j[i])


def _take(loader, n):
    out = [next(loader) for _ in range(n)]
    return out


def test_dataloader_equals_jax_over_two_epochs_and_resume(jax_shards):
    """text_drop_rate 0.5 and accum 2: 11 records make 2 steps of 2 x 2 an
    epoch; 5 steps cross two epochs. A loader resumed from the state after
    step 3 continues as the JAX one resumed from the same state."""
    kw = dict(batch_size=2, accum=2, text_drop_rate=0.5, seed=11)
    j = jparquet.build_parquet_dataloader(jax_shards, **kw)
    t = tparquet.build_parquet_dataloader(jax_shards, **kw)
    try:
        jb, tb = _take(j, 5), _take(t, 5)
        for a, b in zip(tb, jb):
            _same(a, b)
        assert b[0].shape == (2, 2, *LAT) and b[1].shape == (2, 2, *TXT)
        # the drops reached some rows and spared others
        zero = [bool((b[1][m, r] == 0).all()) for b in tb
                for m in range(2) for r in range(2)]
        assert any(zero) and not all(zero)
    finally:
        j.shutdown()
        t.shutdown()
    j = jparquet.build_parquet_dataloader(jax_shards, **kw)
    t = tparquet.build_parquet_dataloader(jax_shards, **kw)
    try:
        _take(j, 3)
        _take(t, 3)
        state_j, state_t = j.state_dict(), t.state_dict()
        # the consumer's position; the sampler's own epoch depends on how
        # far each producer thread has run ahead, and resume overrides it
        for key in ("epoch", "batch_in_epoch"):
            assert state_j[key] == state_t[key]
    finally:
        j.shutdown()
        t.shutdown()
    j = jparquet.build_parquet_dataloader(jax_shards, **kw)
    t = tparquet.build_parquet_dataloader(jax_shards, **kw)
    try:
        j.load_state_dict(state_j)
        t.load_state_dict(state_t)
        for a, b in zip(_take(t, 3), _take(j, 3)):
            _same(a, b)
    finally:
        j.shutdown()
        t.shutdown()


def test_jax_reads_the_ports_shards(tmp_path):
    """The port's write_parquet_dataset writes the JAX layout: the same
    names and numbering after existing shards, read by the JAX dataset."""
    recs = _records(7, seed=5)
    d = str(tmp_path)
    tparquet.write_parquet_dataset(recs[:3], d, rows_per_file=2)
    tparquet.write_parquet_dataset(recs[3:], d, rows_per_file=2)
    assert sorted(os.listdir(d)) == [f"data_{i:05d}.parquet"
                                     for i in range(4)]
    j = jparquet.LatentsParquetMapStyleDataset(d)
    t = tparquet.LatentsParquetMapStyleDataset(d)
    assert len(j) == 7
    for i in range(7):
        _same(t[i], j[i])
    want = pa.Table.from_pylist(recs[:2], schema=jparquet.pyarrow_schema_t2v())
    got = pq.read_table(os.path.join(d, "data_00000.parquet"))
    assert got.to_pydict() == want.to_pydict()


def test_build_dataloader_reads_data_path(jax_shards):
    cfg = TrainRunConfig(data=DataSpec(path=jax_shards, batch_size=2))
    loader = build_dataloader(cfg, TrainingArgs(seed=5,
                                                gradient_accumulation_steps=1))
    try:
        lat, txt = next(loader)
    finally:
        loader.shutdown()
    assert lat.shape == (1, 2, *LAT) and txt.shape == (1, 2, *TXT)
    assert lat.dtype == np.float32
