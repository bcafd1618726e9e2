"""The port's preprocessing stages, datasets and validator against the JAX
package's on the CPU, over the same merge file of ``.npy`` clips and a
PNG, the same prompts and the same seeds.

Metadata filters, Python-``random`` draws (drop-short, caption dropout,
temporal crops), frame indices, token ids and masks are exact. The uint8
frames after the crop-and-resize transform are rounded from the two
resizes, which agree within 1e-5 of the largest magnitude
(``tests/test_torch_transform.py``): a value that lands on a rounding
edge (x.5 at these scales) may round to either side, so frames agree
within one level, at no more than 0.1 % of their values, and the [-1, 1]
pixel values with them.
"""

import json
import os
import random

import numpy as np
import PIL.Image
import pytest
from transformers import AutoTokenizer

from fastvideo_tpu.dataset import preprocessing as jp
from fastvideo_tpu.models.loader.export import make_word_level_tokenizer
from fastvideo_tpu.workflow import preprocess_workflow as jw
from fastvideo_tpu_torch.dataset import preprocessing as tp
from fastvideo_tpu_torch.models.loader.tokenizer import load_tokenizer
from fastvideo_tpu_torch.workflow import preprocess_workflow as tw

VOCAB = 128


@pytest.fixture(scope="module")
def tokenizers(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("tok"))
    make_word_level_tokenizer(d, VOCAB)
    return AutoTokenizer.from_pretrained(d), load_tokenizer(d)


def _rows(folder):
    """Clips of several lengths and sizes, a PNG and records that each
    filter drops."""
    rng = np.random.default_rng(0)
    rows = []
    for i, (t, h, w, fps) in enumerate([(12, 40, 56, 8.0), (7, 30, 30, 4.0),
                                        (40, 24, 36, 8.0), (3, 20, 28, 4.0),
                                        (9, 36, 20, 4.0)]):
        np.save(os.path.join(folder, f"v{i}.npy"),
                rng.integers(0, 256, (t, h, w, 3)).astype(np.uint8))
        rows.append({"path": f"v{i}.npy", "cap": [f"w{i} w{i + 1}",
                                                  f"w{i + 2}"],
                     "fps": fps, "duration": t / fps,
                     "resolution": {"height": h, "width": w}})
    PIL.Image.fromarray(rng.integers(0, 256, (26, 34, 3)).astype(
        np.uint8)).save(os.path.join(folder, "img.png"))
    rows += [
        {"path": "img.png", "cap": "w5 w6 w7"},
        {"path": "v0.npy", "fps": 8.0, "duration": 1.5},  # no caption
        {"path": "v1.npy", "cap": "w1"},  # a video without fps
        {"path": "v2.npy", "cap": "w2", "fps": 8.0, "duration": 60.0},
        {"path": "v0.npy", "cap": "w3", "fps": 8.0, "duration": 1.5,
         "resolution": {"height": 8, "width": 2}},  # aspect 4 < 1/0.25
    ]
    return rows


@pytest.fixture(scope="module")
def merge_file(tmp_path_factory):
    root = tmp_path_factory.mktemp("merge")
    folder = root / "videos"
    folder.mkdir()
    anno = root / "anno.json"
    anno.write_text(json.dumps(_rows(str(folder))))
    merge = root / "merge.txt"
    merge.write_text(f"{folder},{anno}\n")
    return str(merge)


def _datasets(merge_file, tokenizers, **kw):
    jtok, ttok = tokenizers
    args = dict(num_frames=5, train_fps=4.0, max_height=16, max_width=24,
                text_max_length=12, training_cfg_rate=0.5,
                drop_short_ratio=0.5, min_height=10, min_width=10)
    args.update(kw)
    random.seed(11)
    jds = jp.VideoCaptionMergedDataset(
        merge_file, jp.PreprocessDatasetArgs(**args), tokenizer=jtok, seed=3)
    random.seed(11)
    tds = tp.VideoCaptionMergedDataset(
        merge_file, tp.PreprocessDatasetArgs(**args), tokenizer=ttok, seed=3)
    return jds, tds


def _frames_close(got, want, key):
    assert got.shape == want.shape and got.dtype == want.dtype, key
    level = 1.0 if key == "frames" else 1.0 / 127.5 + 1e-6
    diff = np.abs(got.astype(np.float64) - want.astype(np.float64))
    assert diff.max() <= level, key
    assert np.count_nonzero(diff) <= 1e-3 * diff.size, key


@pytest.mark.parametrize("drop_short_ratio", [0.0, 0.5, 1.0])
def test_merged_dataset_matches_jax(merge_file, tokenizers,
                                    drop_short_ratio):
    jds, tds = _datasets(merge_file, tokenizers,
                         drop_short_ratio=drop_short_ratio)
    assert len(tds) == len(jds) > 0
    assert [(s.path, s.sample_frame_index, s.sample_num_frames)
            for s in tds.samples] == [
        (s.path, s.sample_frame_index, s.sample_num_frames)
        for s in jds.samples]
    got, want = list(tds), list(jds)
    assert len(got) == len(want) == len(jds)
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        for key in w:
            if key in ("frames", "pixel_values"):
                _frames_close(g[key], w[key], key)
            elif isinstance(w[key], np.ndarray):
                np.testing.assert_array_equal(g[key], w[key], err_msg=key)
                assert g[key].dtype == w[key].dtype, key
            else:
                assert g[key] == w[key], key
    assert any(w["frames"].shape[0] == 1 for w in want)  # the PNG


def test_merged_dataset_cursor_resumes(merge_file, tokenizers):
    _, tds = _datasets(merge_file, tokenizers, training_cfg_rate=0.0)
    it = iter(tds)
    first = next(it)
    state = tds.state_dict()
    assert state == {"cursor": 1}
    _, again = _datasets(merge_file, tokenizers, training_cfg_rate=0.0)
    again.load_state_dict(state)
    rest = list(again)
    assert len(rest) == len(tds) - 1
    assert rest[0]["id"] != first["id"] or len(tds) == 1


def test_stages_filter_as_jax():
    """Each filter stage on hand-made samples, including the resolution
    bounds and a short video under drop_short_ratio draws."""
    samples = [
        dict(path="a.npy", cap="x", fps=16.0, duration=5.0,
             resolution={"height": 480, "width": 832}),
        dict(path="b.npy", cap="x", fps=16.0, duration=0.5),
        dict(path="c.npy", cap=None, fps=16.0, duration=2.0),
        dict(path="d.png", cap="x"),
        dict(path="e.txt", cap="x"),
        dict(path="f.npy", cap="x", fps=30.0, duration=100.0),
        dict(path="g.npy", cap="x", fps=16.0, duration=5.0,
             resolution={"height": 100, "width": 900}),
        dict(path="h.npy", cap="x", fps=16.0, duration=5.0,
             resolution={"height": 0, "width": 10}),
    ]
    for mod in (jp, tp):
        assert [mod.DataValidationStage().should_keep(
            mod.PreprocessSample(**s)) for s in samples] == [
            True, True, False, True, False, True, True, True]
    res = [[m.ResolutionFilterStage(min_height=50).should_keep(
        m.PreprocessSample(**s)) for s in samples] for m in (jp, tp)]
    assert res[0] == res[1]
    kw = dict(num_frames=81, train_fps=16.0, drop_short_ratio=0.5, seed=5)
    jfs, tfs = jp.FrameSamplingStage(**kw), tp.FrameSamplingStage(**kw)
    draws = [[fs.should_keep(m.PreprocessSample(**samples[1]))
              for _ in range(16)] for fs, m in ((jfs, jp), (tfs, tp))]
    assert draws[0] == draws[1] and len(set(draws[0])) == 2
    for s in samples[:2] + samples[3:4]:
        random.seed(2)
        want = jfs.process(jp.PreprocessSample(**s),
                           temporal_sample_fn=lambda n: (1, 1 + 81))
        got = tfs.process(tp.PreprocessSample(**s),
                          temporal_sample_fn=lambda n: (1, 1 + 81))
        assert got.sample_frame_index == want.sample_frame_index
        assert got.sample_num_frames == want.sample_num_frames


def test_image_formats_other_than_png_raise(tmp_path):
    path = str(tmp_path / "x.jpg")
    PIL.Image.fromarray(np.zeros((8, 8, 3), np.uint8)).save(path)
    sample = tp.PreprocessSample(path=path, cap="x")
    with pytest.raises(NotImplementedError, match="ROADMAP Queue 1"):
        tp.ImageTransformStage().process(sample)
    clip = str(tmp_path / "x.mp4")
    open(clip, "wb").close()
    sample = tp.PreprocessSample(path=clip, cap="x", fps=4.0, duration=1.0,
                                 sample_frame_index=[0])
    with pytest.raises(NotImplementedError, match="ROADMAP Queue 1"):
        tp.VideoTransformStage().process(sample)


def test_text_dataset_matches_jax(tmp_path, tokenizers):
    jtok, ttok = tokenizers
    (tmp_path / "prompts.txt").write_text(
        "w1 w2 w3\n\n{\"caption\": \"w4 w5\"}\n{\"prompt\": \"w6\"}\n"
        "w7 w8 w9 w10 w11 w12 w13 w14 w15 w16 w17 w18 w19 w20\n")
    jds = jp.TextDataset(str(tmp_path), tokenizer=jtok, text_max_length=10,
                         cfg_rate=0.4, seed=9)
    tds = tp.TextDataset(str(tmp_path), tokenizer=ttok, text_max_length=10,
                         cfg_rate=0.4, seed=9)
    assert len(tds) == len(jds) == 4
    want, got = list(jds), list(tds)
    assert [w["text"] for w in want] == [g["text"] for g in got]
    assert any(w["text"] == "" for w in want)
    for g, w in zip(got, want):
        assert g["id"] == w["id"] and g["caption"] == w["caption"]
        np.testing.assert_array_equal(g["input_ids"], w["input_ids"])
        np.testing.assert_array_equal(g["cond_mask"], w["cond_mask"])
    plain = tp.TextDataset(str(tmp_path / "prompts.txt"))
    assert [s["caption"] for s in plain] == jds.prompts


def test_validator_counts_match_jax():
    rng = np.random.default_rng(4)
    samples = []
    for i in range(60):
        s = {"caption": "" if i % 7 == 0 else f"c{i}",
             "fps": float(rng.choice([0, 8, 16, 30])),
             "num_frames": int(rng.integers(0, 2000)),
             "height": int(rng.choice([240, 480, 1080, 2000])),
             "width": int(rng.choice([320, 832, 1920]))}
        if i % 11 == 0:
            del s["height"]
        samples.append(s)
    kw = dict(max_height=1080, max_width=1024, num_frames=81, train_fps=16)
    jv, tv = jw.PreprocessingDataValidator(**kw), \
        tw.PreprocessingDataValidator(**kw)
    assert [tv(s) for s in samples] == [jv(s) for s in samples]
    assert tv.filter_counts == jv.filter_counts
    assert all(tv.filter_counts.values())
    assert (tv.num_items_before_filtering, tv.num_items_after_filtering) == (
        jv.num_items_before_filtering, jv.num_items_after_filtering)
    for args in [(300, 30.0, 16.0, 81), (50, 16.0, 16.0, 81),
                 (100, 24.0, 16.0, 20)]:
        np.testing.assert_array_equal(tw.sample_frame_indices(*args),
                                      jw.sample_frame_indices(*args))
