"""The port's CLI (``python -m fastvideo_tpu_torch.entrypoints.cli.main``)
on a tiny Wan checkpoint: ``preprocess`` against the JAX package's
``fastvideo preprocess`` on the same checkpoint and clips, the JAX CLI
test's three cases (a videos.jsonl dataset, a ``--data-merge-path`` file,
no data source), the ODE workload, the refusals of formats the port does
not read, ``generate`` and ``train``.

Tolerances: as tests/test_torch_preprocess.py; the latents and text
embeddings of the two CLIs' shards within 1e-5 of the JAX values relative
to their largest magnitude (fp32 on both sides), every other column equal.
"""

import json
import os
import sys

import numpy as np
import PIL.Image
import pyarrow.parquet as pq
import pytest
import torch

from fastvideo_tpu.entrypoints.cli import main as jcli
from fastvideo_tpu_torch.dataset import parquet as tparquet
from fastvideo_tpu_torch.dataset.parquet import (
    LatentsParquetMapStyleDataset, build_ode_dataloader)
from fastvideo_tpu_torch.entrypoints.cli import main as tcli

sys.path.insert(0, os.path.dirname(__file__))

from test_torch_jax_reference import jax_plain_attention  # noqa: E402,F401
from test_torch_wan_i2v import rbg_prng  # noqa: E402
from utils import make_tiny_wan_checkpoint  # noqa: E402

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    root = tmp_path_factory.mktemp("wan_tiny_pp")
    with rbg_prng():
        return make_tiny_wan_checkpoint(
            str(root / "Wan2.1-T2V-tiny-Diffusers"))


def _jsonl_data(path, n=3, frames=5, size=16, seed=0):
    path.mkdir()
    rng = np.random.default_rng(seed)
    with open(path / "videos.jsonl", "w") as fh:
        for i in range(n):
            np.save(path / f"v{i}.npy", rng.integers(
                0, 255, (frames, size, size, 3), dtype=np.uint8))
            fh.write(json.dumps({"path": f"v{i}.npy",
                                 "caption": f"w{i} w{i + 1}"}) + "\n")
    return str(path)


def _port(argv):
    return tcli.main([*argv, "--device", "cpu"])


def test_preprocess_jsonl_matches_jax_cli(ckpt, tmp_path,
                                          jax_plain_attention):
    """The JAX CLI test's first case, on both CLIs: three clips, two a
    shard; the port's shards hold JAX's values."""
    import fastvideo_tpu.parallel as par

    data = _jsonl_data(tmp_path / "data")
    common = ["preprocess", "--model-path", ckpt, "--data-path", data,
              "--samples-per-file", "2"]
    par.destroy_mesh()
    with rbg_prng():  # the JAX loader initialises, then loads
        assert jcli.main([*common, "--output-dir",
                          str(tmp_path / "jax")]) == 0
    par.destroy_mesh()
    assert _port([*common, "--output-dir", str(tmp_path / "port")]) == 0
    files = sorted(os.listdir(tmp_path / "jax"))
    assert files == sorted(os.listdir(tmp_path / "port")) == [
        "data_00000.parquet", "data_00001.parquet"]
    for name in files:
        want = pq.read_table(tmp_path / "jax" / name).to_pydict()
        got = pq.read_table(tmp_path / "port" / name).to_pydict()
        assert list(got) == list(want)
        for col in want:
            if col in ("latents", "text_embedding"):
                for g, w, gs, ws in zip(got[col], want[col],
                                        got[f"{col}_shape"],
                                        want[f"{col}_shape"]):
                    g = np.frombuffer(g, np.float32).reshape(gs)
                    w = np.frombuffer(w, np.float32).reshape(ws)
                    err = float(np.abs(g - w).max())
                    assert err <= 1e-5 * float(np.abs(w).max()), (col, err)
            else:
                assert got[col] == want[col], col
    ds = LatentsParquetMapStyleDataset(str(tmp_path / "port"))
    assert len(ds) == 3
    latents, embeds = ds[0]
    # tiny VAE: z=4 channels, temporal factor 2 -> 3 latent frames
    assert latents.shape[:2] == (4, 3) and embeds.shape[-1] == 32


def test_preprocess_data_merge_path(ckpt, tmp_path):
    """The JAX CLI test's second case: --data-merge-path drives the staged
    VideoCaptionMergedDataset, whose validation stage drops a record
    without a caption."""
    folder = tmp_path / "videos"
    folder.mkdir()
    rng = np.random.default_rng(1)
    rows = []
    for i in range(2):
        np.save(folder / f"v{i}.npy",
                rng.integers(0, 255, (6, 24, 24, 3), dtype=np.uint8))
        rows.append({"path": f"v{i}.npy", "cap": f"w{i} w{i+1}",
                     "fps": 4.0, "duration": 1.5})
    rows.append({"path": "missing.npy"})
    anno = tmp_path / "anno.json"
    anno.write_text(json.dumps(rows))
    merge = tmp_path / "merge.txt"
    merge.write_text(f"{folder},{anno}\n")
    out = tmp_path / "parquet"
    assert _port(["preprocess", "--model-path", ckpt, "--data-merge-path",
                  str(merge), "--output-dir", str(out), "--num-frames", "5",
                  "--train-fps", "4", "--max-height", "16", "--max-width",
                  "16"]) == 0
    ds = LatentsParquetMapStyleDataset(str(out))
    assert len(ds) == 2
    latents, embeds = ds[0]
    assert latents.shape == (4, 3, 8, 8), latents.shape
    assert np.isfinite(latents).all() and np.isfinite(embeds).all()


@pytest.mark.parametrize("workload", ["t2v", "i2v", "ode"])
def test_preprocess_requires_a_data_source(ckpt, workload):
    """The JAX CLI test's third case, before any module is loaded; an ODE
    run reads prompts, so a merge file alone does not feed it."""
    argv = ["preprocess", "--model-path", ckpt, "--output-dir", "/tmp/x",
            "--workload", workload]
    with pytest.raises(SystemExit):
        _port(argv)
    if workload == "ode":
        with pytest.raises(SystemExit):
            _port([*argv, "--data-merge-path", "m.txt"])


def test_preprocess_ode_workload(ckpt, tmp_path):
    (tmp_path / "data").mkdir()
    (tmp_path / "data" / "prompts.txt").write_text("w1 w2\n\nw3 w4 w5\n")
    out = tmp_path / "ode"
    assert _port(["preprocess", "--model-path", ckpt, "--data-path",
                  str(tmp_path / "data"), "--output-dir", str(out),
                  "--workload", "ode", "--ode-steps", "3", "--ode-height",
                  "16", "--ode-width", "16", "--ode-num-frames", "5"]) == 0
    ds = tparquet.ODETrajectoryParquetDataset(str(out))
    assert len(ds) == 2
    traj, tsteps, embeds = next(build_ode_dataloader(str(out), 2))
    assert traj.shape == (2, 3, 4, 3, 8, 8) and tsteps.shape == (2, 3)
    assert (np.diff(tsteps[0]) < 0).all() and np.isfinite(traj).all()


def test_unported_formats_raise(ckpt, tmp_path):
    """An .mp4 clip and a .jpg image raise with the name of the readers'
    ROADMAP item (the card's machine has neither imageio nor PIL)."""
    data = tmp_path / "data"
    data.mkdir()
    (data / "v0.mp4").write_bytes(b"\0" * 64)
    (data / "videos.jsonl").write_text(
        json.dumps({"path": "v0.mp4", "caption": "w1"}) + "\n")
    with pytest.raises(NotImplementedError, match="ROADMAP Queue 1"):
        _port(["preprocess", "--model-path", ckpt, "--data-path", str(data),
               "--output-dir", str(tmp_path / "out")])
    folder = tmp_path / "images"
    folder.mkdir()
    PIL.Image.fromarray(np.zeros((16, 16, 3), np.uint8)).save(
        folder / "a.jpg")
    anno = tmp_path / "anno.json"
    anno.write_text(json.dumps([{"path": "a.jpg", "cap": "w1 w2"}]))
    merge = tmp_path / "merge.txt"
    merge.write_text(f"{folder},{anno}\n")
    with pytest.raises(NotImplementedError, match="ROADMAP Queue 1"):
        _port(["preprocess", "--model-path", ckpt, "--data-merge-path",
               str(merge), "--output-dir", str(tmp_path / "out2"),
               "--max-height", "16", "--max-width", "16"])


def test_generate_writes_the_generators_frames(ckpt, tmp_path):
    from fastvideo_tpu_torch import VideoGenerator

    assert tcli.main(["generate", "--model-path", ckpt, "--prompt",
                      "w1 w2 w3", "--height", "16", "--width", "16",
                      "--num-frames", "5", "--num-inference-steps", "2",
                      "--seed", "3", "--output-path", str(tmp_path),
                      "--device", "cpu"]) == 0
    saved = np.load(tmp_path / "w1 w2 w3.npy")
    want = VideoGenerator.from_pretrained(ckpt, device="cpu").generate_video(
        "w1 w2 w3", height=16, width=16, num_frames=5,
        num_inference_steps=2, guidance_scale=5.0, seed=3,
        save_video=False)["frames"][0]
    assert saved.shape == (5, 16, 16, 3) and saved.dtype == np.uint8
    np.testing.assert_array_equal(saved, want)


def test_train_delegates_to_the_train_entry(monkeypatch):
    from fastvideo_tpu_torch.entrypoints.cli import train

    seen = []
    monkeypatch.setattr(train, "main", lambda argv: seen.append(argv) or 0)
    assert tcli.main(["train", "--config", "cfg.yaml", "--resume"]) == 0
    assert tcli.main(["train", "--config", "c.json"]) == 0
    assert seen == [["--config", "cfg.yaml", "--resume"],
                    ["--config", "c.json"]]
    with pytest.raises(SystemExit):
        tcli.main(["serve", "--model-path", "x"])  # not ported yet
